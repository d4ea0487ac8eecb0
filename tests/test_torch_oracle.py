"""The port's float64 oracle (``ops/oracle.py``) against the JAX package's,
on the same NumPy inputs from a seed: every function gives the same bits."""

import numpy as np
import pytest

from audio_fir_filter_tpu.ops import kernel_design as jkd
from audio_fir_filter_tpu.ops import oracle as joracle
from audio_fir_filter_tpu_torch.ops import kernel_design as tkd
from audio_fir_filter_tpu_torch.ops import oracle as toracle


def case(n, fc, bw, seed):
    x = np.random.default_rng(seed).uniform(-1, 1, n).astype(np.float32)
    return x, tkd.WindowedSinc(fc, bw).make_low_cut(), \
        jkd.WindowedSinc(fc, bw).make_low_cut()


@pytest.mark.parametrize("n,fc,bw", [(500, 0.06, 0.05), (300, 0.1, 0.08),
                                     (150, 0.05, 0.04), (4000, 0.02, 0.01)])
def test_filters_match_bit_for_bit(n, fc, bw):
    x, wt, wj = case(n, fc, bw, seed=n)
    np.testing.assert_array_equal(wt.taps, wj.taps)
    np.testing.assert_array_equal(toracle.direct_filter(x, wt.taps),
                                  joracle.direct_filter(x, wj.taps))
    np.testing.assert_array_equal(toracle.fft_filter_f64(x, wt.taps),
                                  joracle.fft_filter_f64(x, wj.taps))
    if n <= 500:
        loops = toracle.direct_filter_loops(x, wt)
        np.testing.assert_array_equal(loops, joracle.direct_filter_loops(x, wj))
        np.testing.assert_array_equal(loops, toracle.direct_filter(x, wt.taps))


@pytest.mark.parametrize("bits", [16, 24])
@pytest.mark.parametrize("peak", [0.5, 1.5, 3.0])
def test_error_metrics_match(bits, peak):
    rng = np.random.default_rng(bits)
    b = rng.uniform(-peak, peak, 1000)
    a = b + rng.normal(0, 2.0 ** -bits, 1000)
    assert toracle.quantization_lsb(bits) == joracle.quantization_lsb(bits)
    assert toracle.max_lsb_error(a, b, bits) == joracle.max_lsb_error(a, b, bits)
    assert toracle.max_scaled_lsb_error(a, b, bits) == \
        joracle.max_scaled_lsb_error(a, b, bits)


def test_fft_oracle_is_within_a_hundredth_lsb_of_the_direct_sum():
    x, wt, _ = case(4000, 0.02, 0.01, seed=3)
    a = toracle.direct_filter(x, wt.taps)
    assert toracle.max_lsb_error(a, toracle.fft_filter_f64(x, wt.taps), 24) < 0.01
