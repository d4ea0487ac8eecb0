"""The port's float64 kernel design is bit-identical to the JAX package's.

The port keeps its own copy of ``ops/kernel_design.py`` because importing
the JAX package's ``ops`` imports JAX; the two copies must not drift.
"""

import numpy as np
import pytest

from audio_fir_filter_tpu.ops import kernel_design as jkd
from audio_fir_filter_tpu_torch.ops import kernel_design as tkd

M_VALUES = [2, 200, 17640, 38400]


@pytest.mark.parametrize("m", M_VALUES)
@pytest.mark.parametrize("family", ["lowpass", "highpass", "bandpass",
                                    "bandreject", "blackman"])
def test_taps_bit_identical(family, m):
    f = {
        "lowpass": lambda k: k.lowpass_taps(0.07, m),
        "highpass": lambda k: k.highpass_taps(15.0 / 96000.0, m),
        "bandpass": lambda k: k.bandpass_taps(0.01, 0.2, m),
        "bandreject": lambda k: k.bandreject_taps(0.05, 0.06, m),
        "blackman": lambda k: k.blackman_window(m),
    }[family]
    a, b = f(tkd), f(jkd)
    assert a.dtype == b.dtype == np.float64
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bw", [10 / 44100, 10 / 96000, 0.02, 0.49])
def test_kernel_length_identical(bw):
    assert tkd.kernel_length(bw) == jkd.kernel_length(bw)


def test_windowed_sinc_and_errors_identical():
    a = tkd.WindowedSinc(0.05, 0.02).make_low_cut()
    b = jkd.WindowedSinc(0.05, 0.02).make_low_cut()
    np.testing.assert_array_equal(a.taps, b.taps)
    assert (a.mo2, a.num_taps) == (b.mo2, b.num_taps)
    x = np.random.default_rng(3).uniform(-1, 1, 400)
    for count in (None, -37, 52):
        assert a.fms(x, 10, count) == b.fms(x, 10, count)
    for k in (tkd, jkd):
        with pytest.raises(ValueError):
            k.kernel_length(0.5)
        with pytest.raises(ValueError):
            k.spectral_invert(np.ones(4))
