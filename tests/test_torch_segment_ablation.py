"""The segment kernel's ablation probes and the breakdown scripts on the CPU.

``audio_fir_filter_tpu_torch/experiments/fast_decomp_r05.py`` holds the
CUDA ablation variants of the shipped segment kernel
(``csrc/probe_segment.cu``), which run only on the card; here each
variant's plain version, which ``chip_smoke.py`` holds the kernel against,
is held against a derivation of its own:

- ``full`` against the JAX Pallas segment kernel in interpret mode (float32:
  2e-5 of max |ref|) and the float64 oracle (<= 1 LSB @ 24-bit);
- ``no_gather`` and ``floor`` are zeros, ``no_store`` zeros with the peak
  of ``full``;
- ``rows_copy`` and ``no_arith`` against the shift written in NumPy;
- ``no_tr`` against a float64 NumPy mirror of the kernel's three passes
  with the contiguous-tile permutation written as a loop over tiles (2e-6
  of max |ref|: the plain version's output is float32);
- ``no_tw4`` against the same mirror with every four-step twiddle 1;
- each in f32, f64 and 16-bit I/O (within one PCM code where the variant
  does arithmetic), with 'same' (left = Mo2) and halo-extended (left = 0)
  inputs, at a square and a non-square four-step split.

Then the wrapper's contract, the traffic model and the three breakdown
scripts (``segment_decomp``, ``chunk_sweep``, ``batch_cfg4``) at a small
size with ``--device cpu``.
"""

import numpy as np
import pytest
import torch

from audio_fir_filter_tpu_torch.cli import main as cli_main
from audio_fir_filter_tpu_torch.experiments import batch_cfg4
from audio_fir_filter_tpu_torch.experiments import chunk_sweep
from audio_fir_filter_tpu_torch.experiments import fast_decomp_r05 as fd
from audio_fir_filter_tpu_torch.experiments import segment_decomp
from audio_fir_filter_tpu_torch.ops import kernel_design as kd
from audio_fir_filter_tpu_torch.ops import oracle
from audio_fir_filter_tpu_torch.ops import overlap_save as osv
from audio_fir_filter_tpu_torch.ops import segment_filter as sf

CPU = "cpu"
TAPS = kd.highpass_taps(0.05, 128)
# (precision, 16-bit I/O): the modes f32, f64 and i16.
MODES = {"f32": ("fast", False), "f64": ("high", False), "i16": ("fast", True)}
SMALL = ["--device", "cpu", "--block-size", "1024", "--freq", "100",
         "--slope", "200", "--sample-rate", "8000", "--reps", "1"]


def _case(mode, b, left_same=True, seed=3):
    """(plan, x, left, out_len, i16) of a small call: 2 channels around two
    hops, 'same' or halo-extended."""
    precision, i16 = MODES[mode]
    plan = osv.make_plan(TAPS, precision, b, CPU)
    out_len = 2 * plan.hop + 123
    n_in = out_len if left_same else out_len + plan.m
    x = np.random.default_rng(seed).uniform(-0.6, 0.6, (2, n_in)).astype(np.float32)
    if i16:
        x = np.clip(np.rint(x * 32768), -32768, 32767).astype(np.int16)
    return plan, torch.from_numpy(x), plan.mo2 if left_same else 0, out_len, i16


def _float(x, i16):
    x = np.asarray(x, np.float64)
    return x / 32768.0 if i16 else x


def _quantize(y):
    return np.clip(np.rint(y * 32768.0), -32768, 32767)


CASES = [(mode, b, same) for mode in MODES for b in (512, 1024)
         for same in (True, False)]


# ------------------------------------------------------- the variants

def test_full_matches_jax_pallas_interpret_and_the_oracle():
    import jax.numpy as jnp

    from audio_fir_filter_tpu.ops import fft_core as fc
    from audio_fir_filter_tpu.ops import pallas_fft as pf

    b = 1024
    h = np.zeros(b)
    h[: len(TAPS)] = TAPS[::-1]
    H2 = pf.wrap_spectrum(pf.kernel_spectrum_np(h, b, fc.ARITH_F32), fc.ARITH_F32)
    plan, x, left, n, _ = _case("f32", b)
    yj = np.asarray(pf.pallas_segment_filter(jnp.asarray(x.numpy()), len(TAPS), b,
                                             H2, arith=fc.ARITH_F32,
                                             interpret=True))
    y, peak = fd.segment_ablation(x, plan, left, n, "full")
    assert np.abs(y.numpy() - yj).max() <= 2e-5 * np.abs(yj).max()
    assert float(peak) == float(y.abs().max())
    plan, x, left, n, _ = _case("f64", b)
    y, _ = fd.segment_ablation(x, plan, left, n, "full")
    want = np.stack([oracle.direct_filter(xi.astype(np.float64), TAPS)
                     for xi in x.numpy()])
    assert oracle.max_lsb_error(y.numpy(), want, bits=24) <= 1.0
    assert torch.equal(y, sf.reference(x, plan, left, n)[0])


@pytest.mark.parametrize("mode,b,same", CASES)
def test_zero_variants_are_zeros(mode, b, same):
    plan, x, left, n, i16 = _case(mode, b, same)
    full_peak = sf.reference(x, plan, left, n, i16)[1]
    for v in ("no_gather", "floor", "no_store"):
        y, peak = fd.segment_ablation(x, plan, left, n, v, i16)
        assert y.dtype == x.dtype and y.shape == (2, n)
        assert not y.any()
        assert float(peak) == (float(full_peak) if v == "no_store" else 0.0)
    assert float(full_peak) > 0


@pytest.mark.parametrize("mode,b,same", CASES)
def test_shift_variants_against_numpy(mode, b, same):
    """y[o] = x[o + M - left] (x zero outside), divided by N2 for
    rows_copy; exact for no_arith, one PCM code for rows_copy's i16."""
    plan, x, left, n, i16 = _case(mode, b, same)
    xs = _float(x.numpy(), i16)
    d = plan.m - left
    idx = np.arange(n) + d
    shift = np.where((idx >= 0) & (idx < xs.shape[1]),
                     xs[:, np.clip(idx, 0, xs.shape[1] - 1)], 0.0)
    n2 = sf.split_shape(b)[1]
    for v, want in (("no_arith", shift), ("rows_copy", shift / n2)):
        y, peak = fd.segment_ablation(x, plan, left, n, v, i16)
        got = y.numpy().astype(np.float64)
        if i16:
            want = _quantize(want)
            assert np.abs(got - want).max() <= (0 if v == "no_arith" else 1)
        elif v == "no_arith":
            assert np.array_equal(got, want)
        else:
            assert np.abs(got - want).max() <= 1e-7 * np.abs(want).max()
        assert float(peak) == np.abs(got).max()


def _tiles(s, tc, inverse=False):
    """The contiguous-tile layout of csrc/fourstep.cuh (kStrided off),
    written as a loop: column tile t of [N1, N2] is one contiguous run of
    N1 * tc values, row-major within the tile; ``inverse`` undoes it."""
    n1, n2 = s.shape
    flat = s.ravel()
    out = np.empty_like(flat)
    for t in range(n2 // tc):
        run = slice(t * n1 * tc, (t + 1) * n1 * tc)
        if inverse:
            out.reshape(n1, n2)[:, t * tc:(t + 1) * tc] = flat[run].reshape(n1, tc)
        else:
            out[run] = s[:, t * tc:(t + 1) * tc].ravel()
    return out.reshape(n1, n2)


def _no_tr_mirror(x, taps, b, left, out_len):
    """Float64 NumPy mirror of the no_tr variant: pair k's windows as x0 +
    i*x1, column FFT (rows bit-reversed) * tw4, the tile layout, row FFT *
    H, inverse row, the layout undone, * conj(tw4), inverse column, 1/B,
    positions [M, B) written."""
    m = len(taps) - 1
    hop = b - m
    l1, l2 = sf.split(b)
    n1, n2 = 1 << l1, 1 << l2
    tc = min(n2, max(1, min(8, 4096 >> l1)))
    br1, br2 = sf._bitrev(l1), sf._bitrev(l2)
    H = sf.spectrum_layout(taps, b)
    tw4 = sf.kernel_tables(b, torch.complex128, torch.device(CPU))[0].numpy()
    c, n_in = x.shape
    pairs = (-(-out_len // hop) + 1) // 2
    y = np.zeros((c, out_len))

    def window(ch, s):
        idx = s + np.arange(b)
        ok = (idx >= 0) & (idx < n_in)
        return np.where(ok, x[ch, np.clip(idx, 0, n_in - 1)], 0.0)

    for ch in range(c):
        for k in range(pairs):
            s0 = 2 * k * hop - left
            z = (window(ch, s0) + 1j * window(ch, s0 + hop)).reshape(n1, n2)
            s1 = _tiles(np.fft.fft(z, axis=0)[br1] * tw4, tc)
            s2 = np.fft.fft(s1, axis=1)[:, br2] * H
            r = _tiles(np.fft.ifft(s2[:, br2], axis=1) * n2, tc, inverse=True)
            d = (np.fft.ifft((r * np.conj(tw4))[br1], axis=0) * n1 / b).ravel()
            for j, part in ((2 * k, d.real), (2 * k + 1, d.imag)):
                o = j * hop + np.arange(hop)
                keep = o < out_len
                y[ch, o[keep]] = part[m:][keep]
    return y


def _no_tw4_mirror(x, taps, b, left, out_len):
    """Float64 NumPy mirror of the no_tw4 variant: the kernel's passes
    (column FFT, rows bit-reversed; row FFT * H; inverse row; inverse
    column, 1/B) with every four-step twiddle 1, positions [M, B) written."""
    m = len(taps) - 1
    hop = b - m
    l1, l2 = sf.split(b)
    n1, n2 = 1 << l1, 1 << l2
    br1, br2 = sf._bitrev(l1), sf._bitrev(l2)
    H = sf.spectrum_layout(taps, b)
    c, n_in = x.shape
    pairs = (-(-out_len // hop) + 1) // 2
    y = np.zeros((c, out_len))

    def window(ch, s):
        idx = s + np.arange(b)
        ok = (idx >= 0) & (idx < n_in)
        return np.where(ok, x[ch, np.clip(idx, 0, n_in - 1)], 0.0)

    for ch in range(c):
        for k in range(pairs):
            s0 = 2 * k * hop - left
            z = (window(ch, s0) + 1j * window(ch, s0 + hop)).reshape(n1, n2)
            s1 = np.fft.fft(z, axis=0)[br1]
            s2 = np.fft.fft(s1, axis=1)[:, br2] * H
            r = np.fft.ifft(s2[:, br2], axis=1) * n2
            d = (np.fft.ifft(r[br1], axis=0) * n1 / b).ravel()
            for j, part in ((2 * k, d.real), (2 * k + 1, d.imag)):
                o = j * hop + np.arange(hop)
                keep = o < out_len
                y[ch, o[keep]] = part[m:][keep]
    return y


@pytest.mark.parametrize("mode,b,same", CASES)
def test_no_tw4_against_a_numpy_mirror_with_unit_twiddles(mode, b, same):
    plan, x, left, n, i16 = _case(mode, b, same)
    want = _no_tw4_mirror(_float(x.numpy(), i16), TAPS, b, left, n)
    y, peak = fd.segment_ablation(x, plan, left, n, "no_tw4", i16)
    got = y.numpy().astype(np.float64)
    if i16:
        assert np.abs(got - _quantize(want)).max() <= 1
    else:
        rel = 2e-6 if mode == "f64" else 2e-5
        assert np.abs(got - want).max() <= rel * np.abs(want).max()
    assert float(peak) == np.abs(got).max()
    # Without its twiddles the four-step transform is not the filter.
    full = fd.segment_ablation(x, plan, left, n, "full", i16)[0]
    assert not torch.equal(y, full)


@pytest.mark.parametrize("mode,b,same", CASES)
def test_no_tr_against_a_numpy_mirror_of_the_tile_layout(mode, b, same):
    plan, x, left, n, i16 = _case(mode, b, same)
    want = _no_tr_mirror(_float(x.numpy(), i16), TAPS, b, left, n)
    y, peak = fd.segment_ablation(x, plan, left, n, "no_tr", i16)
    got = y.numpy().astype(np.float64)
    if i16:
        assert np.abs(got - _quantize(want)).max() <= 1
    else:
        rel = 2e-6 if mode == "f64" else 2e-5
        assert np.abs(got - want).max() <= rel * np.abs(want).max()
    assert float(peak) == np.abs(got).max()
    # A different layout gives a different output (tc = 8 < N2 here).
    full = fd.segment_ablation(x, plan, left, n, "full", i16)[0]
    assert not torch.equal(y, full)


# ------------------------------------------------ wrapper, model, device

def test_cpu_tensors_take_the_plain_version_and_unknown_variants_raise(monkeypatch):
    from audio_fir_filter_tpu_torch.ops import _build

    def no_build(*a, **k):
        raise AssertionError("a CPU tensor must not build a kernel")

    monkeypatch.setattr(_build, "build", no_build)
    before = dict(fd.launches)
    for mode in MODES:
        plan, x, left, n, i16 = _case(mode, 512)
        for v in fd.VARIANTS:
            y, _ = fd.segment_ablation(x, plan, left, n, v, i16)
            want = fd.reference(x, plan, left, n, v, i16)[0]
            assert torch.equal(y, want)
    assert fd.launches == before
    plan, x, left, n, _ = _case("f32", 512)
    with pytest.raises(ValueError, match="variant must be one of"):
        fd.segment_ablation(x, plan, left, n, "tr")
    with pytest.raises(ValueError, match="variant must be one of"):
        fd.reference(x, plan, left, n, "dma")
    with pytest.raises(TypeError, match="int16"):
        fd.segment_ablation(x, plan, left, n, "full", i16_io=True)


def test_probe_segment_family_and_argtypes():
    import ctypes

    from audio_fir_filter_tpu_torch.ops import _build

    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    entries, args = _build.FAMILIES["probe_segment"]
    assert entries == ("lowcut_probe_segment_f32", "lowcut_probe_segment_f64",
                       "lowcut_probe_segment_i16")
    # The segment filter's arguments with the variant id before the stream.
    seg_args = _build.FAMILIES["segment_filter"][1]
    assert args == seg_args[:-1] + [i, p]
    assert args == [p] * 8 + [i, ll, ll, ll, i, i, i, ll, i, p]
    assert fd.VARIANTS == ("full", "no_gather", "no_store", "no_tr",
                           "rows_copy", "no_arith", "floor", "no_tw4")


@pytest.mark.parametrize("fn", [fd.verify, fd.run])
def test_the_probe_refuses_cuda_without_a_card_and_the_cpu(fn, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        fn("cuda")
    with pytest.raises(ValueError, match="time a CUDA card"):
        fn("cpu")


def test_traffic_model_counts_what_each_variant_moves():
    """The headline f64 call (2 x 1008 hops, B = 2^18, M = 38,400): 1008
    pairs cross a 4 MiB scratch four times (pass 1 writes, pass 2 reads and
    writes, pass 3 reads), the signal is read and y written once, the
    twiddle and H tables once."""
    plan = osv.make_plan(fd._probe.bench_taps(), "high", 0, CPU)
    m, hop, b = plan.m, plan.hop, plan.block_size
    seg = fd.HEADLINE_HOPS * hop
    assert (m, b) == (38400, 1 << 18)
    got = {v: fd.variant_bytes(v, plan, 2, seg + m, seg) for v in fd.VARIANTS}
    scratch = 4 * 1008 * 16 * b
    io_in, io_out, table = 4 * 2 * (seg + m), 4 * 2 * seg, 16 * b
    assert got["full"] == scratch + io_in + io_out + 3 * table == 20_532_867_072
    assert got["no_tr"] == got["full"]
    assert got["no_gather"] == got["full"] - io_in
    assert got["no_store"] == got["full"] - io_out
    assert got["rows_copy"] == got["full"] - table
    assert got["no_arith"] == got["full"] - 3 * table
    assert got["floor"] == scratch + io_out
    assert got["no_tw4"] == got["full"] - 2 * table
    i16 = fd.variant_bytes("full", plan, 2, seg, seg, i16_io=True)
    assert i16 == scratch + 2 * 2 * seg * 2 + 3 * table


@pytest.mark.parametrize("mode", ["f32", "f64"])
@pytest.mark.parametrize("same", [True, False])
@pytest.mark.parametrize("skew", [False, True])
def test_library_conv_computes_the_segment_filter(mode, same, skew):
    """The library call the kernels line times beside the full variant
    (``F.conv1d``, a cross-correlation with the taps) equals the segment
    filter's plain version, 'same' and halo-extended, for symmetric and
    skewed taps (float32 output: 2e-6 of max |ref| in f64, 1e-5 in f32)."""
    taps = TAPS * (1.0 + np.linspace(0.0, 0.5, len(TAPS))) if skew else TAPS
    precision = MODES[mode][0]
    _, x, left, n, _ = _case(mode, 1024, same)
    plan = osv.make_plan(taps, precision, 1024, CPU)
    want = sf.reference(x, plan, left, n)[0].double()
    y = fd._probe.library_conv(x, taps, precision, left, n)()
    assert y.shape == (2, 1, n)
    assert y.dtype == (torch.float64 if mode == "f64" else torch.float32)
    err = float((y[:, 0].double() - want).abs().max())
    assert err <= (2e-6 if mode == "f64" else 1e-5) * float(want.abs().max())


# ------------------------------------------------------------ scripts

def test_segment_decomp_on_the_cpu(capsys):
    assert segment_decomp.main([*SMALL, "--hops", "6"]) == 0
    out = capsys.readouterr().out
    assert "not a card time" in out
    for stage in ("kernel alone", "extended_filter_peak", "window copy",
                  "conv_chunk launches", "join + peak", "whole call"):
        assert stage in out


def test_chunk_sweep_on_the_cpu(capsys):
    assert chunk_sweep.main([*SMALL, "--hops", "6", "--chunks", "2,4"]) == 0
    out = capsys.readouterr().out
    assert "not a card time" in out
    rows = [ln.split() for ln in out.splitlines() if ln.strip()[:3] in ("f32", "f64")]
    assert len(rows) == 8          # 2 chunks x 2 modes, in each table
    assert [r[1] for r in rows] == ["2", "4"] * 4


def test_batch_cfg4_on_the_cpu_equals_single_file_runs(tmp_path):
    r = batch_cfg4.run(tmp_path, "cpu", n_files=4, seconds=0.25)
    assert r["files"] == r["outputs"] == 4
    assert r["stage_sum_s"] > 0 and r["wall_s"] > 0
    assert r["realtime_x"] == pytest.approx(4 * 0.25 / r["wall_s"])
    ins = sorted((tmp_path / "in").iterdir())
    assert [p.name for p in ins] == [f"in_{i:02d}.wav" for i in range(4)]
    for p in ins:
        single = tmp_path / f"single_{p.name}"
        assert cli_main([str(p), str(single), "-f", "20", "-s", "10",
                         "--device", "cpu"]) == 0
        assert single.read_bytes() == (tmp_path / "out" / p.name).read_bytes()
