"""The block convolution's wrapper, host tables and plain version on the CPU.

- The plain version against the JAX Pallas ``pallas_conv_real_blocks`` in
  interpret mode and a float64 NumPy circular convolution, over the full
  block [0, B) (the aliased head included): high < scale * 2^-21, fast <
  scale * 2^-18, with scale = max |exact|.
- The CUDA kernel's three passes (its bit-reversed layouts and tables from
  :func:`kernel_tables` / :func:`spectrum_layout`, the pair gather and the
  full-block scatter), mirrored in float64 NumPy, against the exact
  convolution: < scale * 2^-40 (the mirror does not round to float32).
- The wrapper's contract: even nb, float32, contiguous, [nb, B]; CPU
  tensors take the plain version and count no launch.
"""

import numpy as np
import pytest
import torch

from audio_fir_filter_tpu_torch.ops import conv_blocks as cb
from audio_fir_filter_tpu_torch.ops import overlap_save as osv
from audio_fir_filter_tpu_torch.ops import segment_filter as sf

CPU = torch.device("cpu")
_DTYPE = {osv.FAST: torch.complex64, osv.HIGH: torch.complex128}


def _case(b, nb, seed):
    """Blocks [nb, B], a decaying length-B kernel h, and the float64
    circular convolution of each block with h."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (nb, b)).astype(np.float32)
    h = rng.standard_normal(b) * np.exp(-np.arange(b) / 40.0)
    want = np.stack([np.fft.irfft(np.fft.rfft(xi.astype(np.float64))
                                  * np.fft.rfft(h), b) for xi in x])
    return x, h, want


def _plan_for_kernel(h, b, precision):
    """A plan whose kernel-layout H is the spectrum of h itself:
    spectrum_layout reverses its taps, so it is given h reversed."""
    H = torch.from_numpy(sf.spectrum_layout(h[::-1], b)).to(_DTYPE[precision])
    return osv.OverlapSavePlan(3, b, precision, CPU, H, "fourstep")


@pytest.mark.parametrize("precision", [osv.HIGH, osv.FAST])
@pytest.mark.parametrize("nb", [2, 4])
@pytest.mark.parametrize("b", [256, 1024])
def test_plain_version_matches_jax_pallas_conv(b, nb, precision):
    import jax.numpy as jnp

    from audio_fir_filter_tpu.ops import fft_core as fc
    from audio_fir_filter_tpu.ops import pallas_fft as pf

    x, h, want = _case(b, nb, seed=b + nb)
    arith = fc.ARITH_DF64 if precision == osv.HIGH else fc.ARITH_F32
    H2 = pf.wrap_spectrum(pf.kernel_spectrum_np(h, b, arith), arith)
    yj = np.asarray(pf.pallas_conv_real_blocks(jnp.asarray(x), H2, arith,
                                               interpret=True))
    yt = cb.conv_real_blocks(torch.from_numpy(x),
                             _plan_for_kernel(h, b, precision)).numpy()
    assert yt.dtype == np.float32 and yt.shape == (nb, b)
    scale = np.abs(want).max()
    tol = scale * (2.0 ** -21 if precision == osv.HIGH else 2.0 ** -18)
    for y in (yt, yj):
        assert np.abs(y - want).max() < tol


def _kernel_mirror(x, H, b):
    """Float64 NumPy mirror of csrc/conv_blocks.cu: pack blocks 2k, 2k+1 as
    x0 + i*x1, column FFT (rows left bit-reversed) * tw4, row FFT
    (bit-reversed) * H, inverse row, * conj(tw4), inverse column, 1/B, and
    write every position: Re to block 2k, Im to block 2k+1."""
    l1, l2 = sf.split(b)
    n1, n2 = 1 << l1, 1 << l2
    br1, br2 = sf._bitrev(l1), sf._bitrev(l2)
    tw4, w1, w2 = (t.numpy() for t in sf.kernel_tables(b, torch.complex128, CPU))
    assert np.allclose(w1, np.exp(-2j * np.pi * np.arange(n1 // 2) / n1))
    assert np.allclose(w2, np.exp(-2j * np.pi * np.arange(n2 // 2) / n2))
    out = np.empty(x.shape)
    for k in range(x.shape[0] // 2):
        z = (x[2 * k] + 1j * x[2 * k + 1]).reshape(n1, n2)
        s1 = np.fft.fft(z, axis=0)[br1] * tw4
        s2 = np.fft.fft(s1, axis=1)[:, br2] * H
        r = np.fft.ifft(s2[:, br2], axis=1) * n2
        d = (np.fft.ifft((r * np.conj(tw4))[br1], axis=0) * n1 / b).ravel()
        out[2 * k], out[2 * k + 1] = d.real, d.imag
    return out


@pytest.mark.parametrize("b", [256, 512, 2048])
def test_kernel_four_step_mirror_matches_exact(b):
    """Square (256 = 16 x 16) and non-square (512, 2048) splits."""
    x, h, want = _case(b, 6, seed=b)
    got = _kernel_mirror(x.astype(np.float64), sf.spectrum_layout(h[::-1], b), b)
    assert np.abs(got - want).max() < np.abs(want).max() * 2.0 ** -40


def test_block_filter_positions_m_to_b_are_the_same_filter():
    """What the path keeps: the circular convolution of a window with the
    plan's reversed taps equals the 'same' filter at positions [M, B)."""
    from audio_fir_filter_tpu.ops import kernel_design as kd
    from audio_fir_filter_tpu.ops import oracle

    taps = kd.highpass_taps(0.05, 40)
    plan = osv.make_plan(taps, osv.HIGH, 256, "cpu", engine="fourstep")
    x = np.random.default_rng(3).uniform(-1, 1, 2 * 256).astype(np.float32)
    y = cb.conv_real_blocks(torch.from_numpy(x.reshape(2, 256)), plan).numpy()
    want = np.convolve(x.astype(np.float64), taps[::-1], mode="full")
    for j in range(2):
        seg = want[j * 256 + plan.m : (j + 1) * 256]
        assert oracle.max_lsb_error(y[j, plan.m :], seg, bits=24) <= 0.5


def _plan():
    from audio_fir_filter_tpu.ops import kernel_design as kd

    return osv.make_plan(kd.highpass_taps(0.05, 40), osv.FAST, 256, "cpu",
                         engine="fourstep")


def test_wrapper_rejects_what_the_kernel_does_not_take():
    plan = _plan()
    x = torch.zeros((4, 256), dtype=torch.float32)
    with pytest.raises(ValueError, match="even"):
        cb.conv_real_blocks(x[:3], plan)
    with pytest.raises(ValueError, match="float32"):
        cb.conv_real_blocks(x.double(), plan)
    with pytest.raises(ValueError, match="contiguous"):
        cb.conv_real_blocks(torch.zeros((256, 4)).t(), plan)
    with pytest.raises(ValueError, match=r"\[nb, 256\]"):
        cb.conv_real_blocks(torch.zeros((4, 512)), plan)
    with pytest.raises(ValueError, match=r"\[nb, 256\]"):
        cb.conv_real_blocks(torch.zeros(256), plan)


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    plan = _plan()
    before = dict(cb.launches)
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (4, 256)).astype(np.float32))
    y = cb.conv_real_blocks(x, plan)
    assert torch.equal(y, cb.reference(x, plan))
    assert cb.launches == before
    assert cb.conv_real_blocks(x[:0], plan).shape == (0, 256)


def test_build_rebuilds_when_any_csrc_file_is_newer(tmp_path, monkeypatch):
    """A library older than any file under csrc/ (a header included) is
    rebuilt; one newer than all of them is reused. nvcc is faked: it only
    writes its output file."""
    import os
    import subprocess

    from audio_fir_filter_tpu_torch.ops import _build

    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    for name in ("segment_filter.cu", "conv_blocks.cu", "fourstep.cuh"):
        (csrc / name).write_text("// source\n")
    runs = []

    def fake_run(cmd, **kw):
        runs.append(cmd[-1])
        with open(cmd[cmd.index("-o") + 1], "w") as f:
            f.write("lib")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_run)

    libs = _build.build_all()
    assert sorted(p.name for p in libs) == sorted(f"lib{n}.so"
                                                  for n in _build.FAMILIES)
    assert {"libconv_blocks.so", "libsegment_filter.so"} <= {p.name for p in libs}
    assert sorted(runs) == sorted(str(csrc / f"{n}.cu") for n in _build.FAMILIES)
    stamp = max(p.stat().st_mtime for p in libs)
    for src in csrc.iterdir():
        os.utime(src, (stamp - 10, stamp - 10))
    runs.clear()
    _build.build("conv_blocks")
    assert runs == []                              # up to date: reused
    os.utime(csrc / "fourstep.cuh", (stamp + 10, stamp + 10))
    _build.build("conv_blocks")
    assert runs == [str(csrc / "conv_blocks.cu")]  # a newer header rebuilds
    with pytest.raises(ValueError, match="unknown kernel source"):
        _build.build("fourstep")


def test_each_entry_family_has_its_own_argtypes():
    import ctypes

    from audio_fir_filter_tpu_torch.ops import _build

    (seg_entries, seg_args), (conv_entries, conv_args) = (
        _build.FAMILIES["segment_filter"], _build.FAMILIES["conv_blocks"])
    assert seg_entries == tuple(f"lowcut_segment_filter_{m}"
                                for m in ("f32", "f64", "i16"))
    assert conv_entries == ("lowcut_conv_blocks_f32", "lowcut_conv_blocks_f64")
    assert len(seg_args) == 17 and len(conv_args) == 12
    # blocks, out, H, tw4, w1, w2, scratch: pointers; nb: 64-bit.
    assert conv_args[:7] == [ctypes.c_void_p] * 7
    assert conv_args[7] is ctypes.c_longlong and conv_args[-1] is ctypes.c_void_p
