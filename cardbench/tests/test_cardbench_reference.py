"""The plain reference: its design against the program's, its blocked
FFT convolution against a direct float64 one."""

import numpy as np
import pytest
import torch

from cardbench.reference import convolve, design


def direct_same(x: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """y[i] = sum_k h[k] x[i - M/2 + k], x == 0 outside: a direct float64
    correlation of the zero-padded rows."""
    m = len(taps) - 1
    return np.stack([np.correlate(np.pad(row, (m // 2, m // 2)), taps, "valid")
                     for row in x])


@pytest.mark.parametrize("fs,f,s", [(96000, 15, 10), (44100, 20, 10), (8000, 100, 200),
                                    (48000, 440, 80)])
def test_taps_equal_the_programs_design(fs, f, s):
    from audio_fir_filter_tpu_torch.ops import kernel_design as kd

    ours = design.lowcut_taps(f, s, fs)
    theirs = kd.highpass_taps(f / fs, kd.kernel_length(s / fs))
    assert len(ours) == len(theirs)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-15)


def test_tap_counts_of_the_configurations():
    assert len(design.lowcut_taps(15, 10, 96000)) == 38401
    assert len(design.lowcut_taps(20, 10, 44100)) == 17641


@pytest.mark.parametrize("n", [1, 1000, convolve.NFFT - 5000, 2 * convolve.NFFT + 123])
def test_blocked_fft_equals_direct_float64(n):
    rng = np.random.default_rng(n)
    taps = design.lowcut_taps(100, 200, 8000)            # M = 160
    x = rng.uniform(-1, 1, (2, n))
    got = convolve.same_fir(torch.from_numpy(x), taps).numpy()
    np.testing.assert_allclose(got, direct_same(x, taps), rtol=0, atol=1e-12)


def test_long_taps_and_edges():
    rng = np.random.default_rng(3)
    taps = design.lowcut_taps(15, 10, 96000)             # M = 38,400
    x = rng.uniform(-1, 1, (1, 90_000))
    got = convolve.same_fir(torch.from_numpy(x), taps).numpy()
    np.testing.assert_allclose(got, direct_same(x, taps), rtol=0, atol=1e-11)


@pytest.mark.parametrize("precision,floor", [("float32", 1e-8), ("bfloat16", 1e-4)])
def test_controls_are_less_precise(precision, floor):
    rng = np.random.default_rng(5)
    taps = design.lowcut_taps(20, 10, 44100)
    x = torch.from_numpy(rng.uniform(-0.5, 0.5, (2, 200_000)))
    ref = convolve.same_fir(x, taps)
    ctl = convolve.same_fir(x.float(), taps, precision).double()
    gap = float((ctl - ref).abs().max())
    assert floor < gap < 1e3 * floor
