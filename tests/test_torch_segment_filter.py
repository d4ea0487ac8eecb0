"""The segment filter's wrapper, host tables and plain version on the CPU.

- 16-bit I/O: the plain version against the JAX Pallas segment kernel in
  interpret mode (``i16_io=True``): <= 1 PCM code apart, each <= 1 LSB @
  16-bit from the float64 oracle, and both clamp at the rails on a loud
  input.
- The CUDA kernel's four-step arithmetic (its bit-reversed layouts and
  twiddle tables from :func:`kernel_tables` / :func:`spectrum_layout`),
  mirrored in float64 NumPy, against the oracle: <= 0.5 LSB @ 24-bit,
  which is the oracle's own float32 rounding (the mirror does not round).
- Qualifier, framing and the wrapper's input checks.
"""

import numpy as np
import pytest
import torch

from audio_fir_filter_tpu.ops import kernel_design as kd
from audio_fir_filter_tpu.ops import oracle
from audio_fir_filter_tpu_torch.ops import overlap_save as osv
from audio_fir_filter_tpu_torch.ops import segment_filter as sf

CPU = "cpu"


def test_i16_plain_version_matches_jax_pallas_i16():
    import jax.numpy as jnp

    from audio_fir_filter_tpu.ops import fft_core as fc
    from audio_fir_filter_tpu.ops import pallas_fft as pf

    taps = kd.highpass_taps(0.05, 128)
    b = 1024
    h = np.zeros(b)
    h[: len(taps)] = taps[::-1]
    H2 = pf.wrap_spectrum(pf.kernel_spectrum_np(h, b, fc.ARITH_F32),
                          fc.ARITH_F32)
    plan = osv.make_plan(taps, osv.FAST, b, CPU)
    rng = np.random.default_rng(29)
    n = 2 * plan.hop + 123
    x = rng.uniform(-0.6, 0.6, (2, n)).astype(np.float32)
    for gain in (1.0, 3.0):
        xq = np.clip(np.rint(gain * x * 32768), -32768, 32767).astype(np.int16)
        yj = np.asarray(pf.pallas_segment_filter(
            jnp.asarray(xq), len(taps), b, H2, arith=fc.ARITH_F32,
            interpret=True, i16_io=True))
        yt, peak = sf.segment_filter(torch.from_numpy(xq), plan, plan.mo2, n,
                                     i16_io=True)
        yt = yt.numpy()
        assert yt.dtype == np.int16 and yt.shape == xq.shape
        assert int(peak) == int(np.abs(yt.astype(np.int32)).max())
        assert np.abs(yt.astype(np.int32) - yj.astype(np.int32)).max() <= 1
        want = np.stack([oracle.direct_filter(
            xq[i].astype(np.float64) / 32768, taps) for i in range(2)])
        if gain == 1.0:
            for y in (yt, yj):
                err = np.abs(y.astype(np.float64) / 32768 - want).max() * 32768
                assert err <= 1.0, err
        else:
            assert np.abs(want).max() > 1.0   # the oracle really clips
            for y in (yt, yj):
                assert y.max() == 32767 or y.min() == -32768


def _kernel_mirror(x, taps, b, left, out_len, tw4=None):
    """Float64 NumPy mirror of csrc/segment_filter.cu's three passes: pack
    pair k's windows as x0 + i*x1, column FFT (rows left in bit-reversed
    order) * tw4, row FFT (bit-reversed) * H, inverse row, * conj(tw4),
    inverse column, 1/B, write positions [M, B). ``tw4``: the [N1, N2]
    four-step twiddle, by default the kernel's complex128 table."""
    m = len(taps) - 1
    hop = b - m
    l1, l2 = sf.split(b)
    n1, n2 = 1 << l1, 1 << l2
    br1, br2 = sf._bitrev(l1), sf._bitrev(l2)
    H = sf.spectrum_layout(taps, b)
    table, w1, w2 = (t.numpy() for t in sf.kernel_tables(
        b, torch.complex128, torch.device("cpu")))
    tw4 = table if tw4 is None else tw4
    assert np.allclose(w1, np.exp(-2j * np.pi * np.arange(n1 // 2) / n1))
    assert np.allclose(w2, np.exp(-2j * np.pi * np.arange(n2 // 2) / n2))
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
            s1 = np.fft.fft(z, axis=0)[br1] * tw4
            s2 = np.fft.fft(s1, axis=1)[:, br2] * H
            r = np.fft.ifft(s2[:, br2], axis=1) * n2
            d = (np.fft.ifft((r * np.conj(tw4))[br1], axis=0) * n1 / b).ravel()
            for j, part in ((2 * k, d.real), (2 * k + 1, d.imag)):
                o = j * hop + np.arange(hop)
                keep = o < out_len
                y[ch, o[keep]] = part[m:][keep]
    return y


@pytest.mark.parametrize("b,n", [(512, 901), (1024, 3000), (2048, 5000)])
def test_kernel_four_step_mirror_matches_oracle(b, n):
    """Square (1024 = 32 x 32) and non-square (512, 2048) splits."""
    taps = kd.highpass_taps(0.05, 200)
    x = np.random.default_rng(b).uniform(-1, 1, (2, n))
    y = _kernel_mirror(x, taps, b, len(taps) // 2, n)
    want = np.stack([oracle.direct_filter(xi, taps) for xi in x])
    assert oracle.max_lsb_error(y, want, bits=24) <= 0.5


def test_natural_spectrum_is_rfft_of_reversed_taps():
    taps = kd.highpass_taps(0.05, 128)
    for b in (256, 512):
        plan = osv.make_plan(taps, osv.HIGH, b, CPU)
        h = np.zeros(b)
        h[: len(taps)] = taps[::-1]
        np.testing.assert_allclose(sf.natural_spectrum(plan.H).numpy(),
                                   np.fft.rfft(h), rtol=0, atol=1e-12)


@pytest.mark.parametrize("b", [4, 256, 2048])
def test_natural_spectrum_reuses_its_cached_index(b):
    """The gather index is made once per (B, device) and kept there; the
    values are the uncached gather's."""
    taps = kd.highpass_taps(0.05, 2 if b < 256 else 128)
    H = osv.make_plan(taps, osv.HIGH, b, CPU).H
    idx = torch.from_numpy(sf._natural_index(b))
    assert torch.equal(sf.natural_spectrum(H), H.reshape(-1)[idx])
    first = sf._natural_index_on(b, H.device)
    assert sf._natural_index_on(b, H.device) is first
    hits = sf._natural_index_on.cache_info().hits
    sf.natural_spectrum(H.to(torch.complex64))
    assert sf._natural_index_on.cache_info().hits == hits + 1
    assert first.device == H.device and first.dtype == torch.int64


def test_qualifier_and_framing():
    assert sf.segment_framing(38400, 1 << 18) == ((1 << 18) - 38400, 19200)
    assert sf.segment_framing(17640, 1 << 18) == ((1 << 18) - 17640, 8820)
    assert sf.qualifies(38401, 1 << 18) and sf.qualifies(17641, 1 << 18)
    assert sf.qualifies(41, 256) and sf.qualifies(1, 4)
    assert not sf.qualifies(40, 256)          # even taps (odd M)
    assert not sf.qualifies(257, 256)         # B <= M
    assert not sf.qualifies(41, 768)          # B not a power of two
    assert not sf.qualifies(1, 2)             # below the 2 x 2 split
    assert not sf.qualifies(41, 1 << 27)      # side beyond the tile
    assert sf.split(1 << 18) == (9, 9) and sf.split(2048) == (6, 5)


def _plan():
    return osv.make_plan(kd.highpass_taps(0.05, 40), osv.FAST, 256, CPU)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    plan = _plan()
    x = torch.zeros((2, 500), dtype=torch.float32)
    with pytest.raises(TypeError):
        sf.segment_filter(x.double(), plan, plan.mo2, 500)
    with pytest.raises(TypeError):
        sf.segment_filter(x, plan, plan.mo2, 500, i16_io=True)
    with pytest.raises(ValueError, match=r"\[C, N\]"):
        sf.segment_filter(x[0], plan, plan.mo2, 500)
    with pytest.raises(ValueError, match="contiguous"):
        sf.segment_filter(x.t().contiguous().t(), plan, plan.mo2, 500)
    with pytest.raises(ValueError, match=">= 0"):
        sf.segment_filter(x, plan, -1, 500)
    high = osv.make_plan(kd.highpass_taps(0.05, 40), osv.HIGH, 256, CPU)
    with pytest.raises(ValueError, match="'fast' plan"):
        sf.segment_filter(x.to(torch.int16), high, plan.mo2, 500, i16_io=True)


def test_wrapper_rejects_even_tap_count():
    plan = _plan()
    even = osv.OverlapSavePlan(40, 256, osv.FAST, plan.device, plan.H)
    with pytest.raises(ValueError, match="does not take"):
        sf.segment_filter(torch.zeros((1, 500)), even, 19, 500)


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    plan = _plan()
    before = dict(sf.launches)
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (2, 700)).astype(np.float32))
    y, peak = sf.segment_filter(x, plan, plan.mo2, 700)
    ref, _ = sf.reference(x, plan, plan.mo2, 700)
    assert torch.equal(y, ref)
    assert sf.launches == before
    empty, p0 = sf.segment_filter(x, plan, plan.mo2, 0)
    assert empty.shape == (2, 0) and float(p0) == 0.0
