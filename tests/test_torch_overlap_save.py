"""The port's overlap-save filters (plain PyTorch version, CPU) against the
float64 oracle and against the JAX package's Pallas segment kernel.

Tolerances:
- port vs oracle: high <= 1.0 LSB @ 24-bit with no CPU slack (the port's
  high path computes in float64), fast <= 1.0 LSB @ 16-bit;
- port vs JAX: high <= high_tol_lsb24() + 1.0 LSB @ 24-bit (the JAX
  package's own CPU tolerance, plus one LSB for the port's own rounding),
  fast <= 2.0 LSB @ 16-bit (each side within 1);
- peak: equal to max|y| within rtol 1e-6.
"""

import numpy as np
import pytest
import torch

from audio_fir_filter_tpu.ops import kernel_design as kd
from audio_fir_filter_tpu.ops import oracle
from audio_fir_filter_tpu.ops import overlap_save as josv
from audio_fir_filter_tpu_torch.ops import overlap_save as osv
from audio_fir_filter_tpu_torch.ops import segment_filter as sf

from util import high_tol_lsb24

CPU = "cpu"


def make_case(n, fc=0.05, bw=0.02, seed=0, channels=None):
    ws = kd.WindowedSinc(fc, bw).make_low_cut()   # bw=0.02 -> 201 taps
    rng = np.random.default_rng(seed)
    shape = (n,) if channels is None else (channels, n)
    return rng.uniform(-1, 1, shape).astype(np.float32), ws


def run(x, plan):
    return osv.same_filter(x, plan).numpy()


def test_choose_block_size_matches_jax():
    assert osv.choose_block_size(17641) == 1 << 18   # 44.1 kHz M=17640
    assert osv.choose_block_size(38401) == 1 << 18   # 96 kHz M=38400
    for t in (3, 41, 201, 401, 4001, 8193, 17641, 38401, 76801, 300001):
        assert osv.choose_block_size(t) == josv.choose_block_size(t), t
    assert osv.choose_block_size(401, requested=3000) == 4096
    with pytest.raises(ValueError):
        osv.choose_block_size(9000, requested=4096)


@pytest.mark.parametrize("precision,bits", [(osv.FAST, 16), (osv.HIGH, 24)])
def test_matches_oracle(precision, bits):
    x, ws = make_case(n=6000, seed=1)
    plan = osv.make_plan(ws.taps, precision, 1024, CPU)
    y = run(x, plan)
    assert y.dtype == np.float32 and y.shape == x.shape
    plain = osv._same_filter_reference(torch.from_numpy(x)[None], plan)
    np.testing.assert_array_equal(plain[0].numpy(), y)
    assert oracle.max_lsb_error(y, oracle.direct_filter(x, ws.taps),
                                bits=bits) <= 1.0


def test_ulp_relative_bound_above_full_scale():
    x, ws = make_case(n=6000, seed=11)
    x = np.float32(2.4) * x                      # filtered peak in [2, 4)
    plan = osv.make_plan(ws.taps, osv.HIGH, 1024, CPU)
    y = run(x, plan)
    ref = oracle.direct_filter(x, ws.taps)
    assert 2.0 <= float(np.abs(ref).max()) < 4.0
    assert oracle.max_scaled_lsb_error(y, ref, bits=24) <= 1.0


@pytest.mark.parametrize("n", [100, 823, 824, 825, 5000])
def test_lengths_and_edges(n):
    """Lengths around block boundaries (hop = 824 at B = 1024, T = 201)."""
    x, ws = make_case(n=n, seed=2)
    plan = osv.make_plan(ws.taps, osv.HIGH, 1024, CPU)
    assert plan.hop == 824
    y = run(x, plan)
    ref = oracle.direct_filter(x, ws.taps)
    assert y.shape == ref.shape
    assert oracle.max_lsb_error(y, ref, bits=24) <= 1.0


def test_multichannel_matches_per_channel():
    x, ws = make_case(n=3000, seed=3, channels=3)
    plan = osv.make_plan(ws.taps, osv.HIGH, 1024, CPU)
    y = run(x, plan)
    for c in range(3):
        ref = oracle.direct_filter(x[c], ws.taps)
        assert oracle.max_lsb_error(y[c], ref, bits=24) <= 1.0


def test_extended_filter_equals_interior_of_same_filter():
    x, ws = make_case(n=8000, seed=4)
    plan = osv.make_plan(ws.taps, osv.HIGH, 1024, CPU)
    full = run(x, plan)
    s, e = 2000, 6000
    seg = osv.extended_filter(x[s - ws.mo2 : e + ws.mo2], plan, e - s).numpy()
    assert oracle.max_lsb_error(seg, full[s:e], bits=24) <= 1.0


def test_kernel_longer_than_signal():
    x, ws = make_case(n=100, seed=5)  # M = 200 > N = 100
    plan = osv.make_plan(ws.taps, osv.HIGH, 1024, CPU)
    assert oracle.max_lsb_error(run(x, plan), oracle.direct_filter(x, ws.taps),
                                bits=24) <= 1.0


def test_impulse_recovers_taps():
    ws = kd.WindowedSinc(0.1, 0.02).make_low_cut()
    n = ws.num_taps + 500
    x = np.zeros(n, dtype=np.float32)
    x[n // 2] = 1.0
    plan = osv.make_plan(ws.taps, osv.HIGH, 1024, CPU)
    y = run(x, plan)
    lo = n // 2 - ws.mo2
    np.testing.assert_allclose(y[lo : lo + ws.num_taps],
                               ws.taps.astype(np.float32), atol=2 ** -24)


def test_sine_passband_and_stopband():
    fs = 44100.0
    ws = kd.WindowedSinc(440.0 / fs, 300.0 / fs).make_low_cut()
    n = 3 * ws.num_taps
    t = np.arange(n) / fs
    plan = osv.make_plan(ws.taps, osv.FAST, 2048, CPU)
    low = np.sin(2 * np.pi * 20.0 * t).astype(np.float32)
    hig = np.sin(2 * np.pi * 2000.0 * t).astype(np.float32)
    k = ws.num_taps
    assert np.max(np.abs(run(low, plan)[k:-k])) < 1e-3
    assert np.max(np.abs(run(hig, plan)[k:-k] - hig[k:-k])) < 1e-2


@pytest.mark.parametrize("precision", [osv.FAST, osv.HIGH])
def test_peak_is_max_abs(precision):
    x, ws = make_case(n=5000, seed=6, channels=2)
    plan = osv.make_plan(ws.taps, precision, 1024, CPU)
    y, peak = osv.same_filter_peak(x, plan)
    assert float(peak) == pytest.approx(float(y.abs().max()), rel=1e-6)
    mo2 = ws.mo2
    ye, pe = osv.extended_filter_peak(x[:, 1000 - mo2 : 3000 + mo2], plan, 1500)
    assert ye.shape == (2, 1500)
    assert float(pe) == pytest.approx(float(ye.abs().max()), rel=1e-6)


def test_plan_contract():
    _, ws = make_case(n=10)
    for precision, dtype in ((osv.FAST, torch.complex64),
                             (osv.HIGH, torch.complex128)):
        plan = osv.make_plan(ws.taps, precision, 1024, CPU)
        assert plan.H.dtype == dtype and plan.H.shape == (32, 32)
        assert plan.device == torch.device("cpu")
        assert (plan.m, plan.mo2, plan.hop) == (200, 100, 824)
    with pytest.raises(ValueError, match="odd length"):
        osv.make_plan(np.ones(40), osv.FAST, 256, CPU)
    with pytest.raises(ValueError, match="unknown precision"):
        osv.make_plan(ws.taps, "medium", 1024, CPU)
    with pytest.raises(ValueError):
        osv.make_plan(ws.taps, osv.HIGH, 128, CPU)    # B <= M


def test_cuda_plan_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, ws = make_case(n=10)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        osv.make_plan(ws.taps, osv.FAST, 1024, "cuda")


@pytest.mark.parametrize("precision,bits", [("high", 24), ("fast", 16)])
def test_port_matches_jax_pallas_segment_kernel(precision, bits):
    """Same configuration in both packages (plan_from_jax): the port's plain
    version against the JAX Pallas segment kernel in interpret mode."""
    import jax.numpy as jnp

    rng = np.random.default_rng(17)
    taps = kd.highpass_taps(0.05, 128)           # 129 taps
    jplan = josv.make_plan(taps, precision=precision, block_size=1024,
                           engine="pallas")
    plan = osv.plan_from_jax(jplan, taps, CPU)
    assert (plan.num_taps, plan.block_size, plan.precision) == (
        jplan.num_taps, jplan.block_size, jplan.precision)
    x = rng.uniform(-1, 1, (2, 3 * plan.hop + 37)).astype(np.float32)
    yj = np.asarray(josv.same_filter(jnp.asarray(x), jplan))
    yt = run(x, plan)
    want = np.stack([oracle.direct_filter(xi, taps) for xi in x])
    assert oracle.max_lsb_error(yt, want, bits=bits) <= 1.0
    tol = high_tol_lsb24() + 1.0 if precision == "high" else 2.0
    assert oracle.max_lsb_error(yt, yj, bits=bits) <= tol
    with pytest.raises(ValueError):
        osv.plan_from_jax(jplan, taps[1:-1], CPU)


@pytest.mark.parametrize("channels", [1, 2])
def test_int16_input_takes_the_16bit_route(channels):
    """An int16 tensor through the filters is the segment kernel's 16-bit
    mode, bit for bit: 'same' framing, halo'd framing and an [N] input."""
    ws = kd.WindowedSinc(0.05, 0.02).make_low_cut()
    plan = osv.make_plan(ws.taps, "fast", 1024, CPU)
    assert osv.takes_i16(plan)
    rng = np.random.default_rng(channels)
    x16 = torch.from_numpy(np.rint(rng.uniform(-0.7, 0.7, (channels, 5000))
                                   * 32768).astype(np.int16))
    y, peak = osv.same_filter_peak(x16, plan)
    want, want_peak = sf.segment_filter(x16, plan, plan.mo2, 5000, i16_io=True)
    assert y.dtype == torch.int16 and torch.equal(y, want)
    assert torch.equal(peak, want_peak) and float(peak) > 0
    xe = x16[:, 1000 : 3000 + plan.m].contiguous()
    y, peak = osv.extended_filter_peak(xe, plan, 2000)
    want, want_peak = sf.segment_filter(xe, plan, 0, 2000, i16_io=True)
    assert torch.equal(y, want) and torch.equal(peak, want_peak)
    one, _ = osv.same_filter_peak(x16[0].numpy(), plan)
    assert torch.equal(one, sf.segment_filter(x16[:1].contiguous(), plan,
                                              plan.mo2, 5000, i16_io=True)[0][0])


@pytest.mark.parametrize("precision,engine", [("high", "auto"),
                                              ("fast", "fourstep")])
def test_int16_input_needs_a_plan_of_the_16bit_route(precision, engine):
    ws = kd.WindowedSinc(0.05, 0.02).make_low_cut()
    plan = osv.make_plan(ws.taps, precision, 1024, CPU, engine=engine)
    assert not osv.takes_i16(plan)
    with pytest.raises(ValueError, match="'fast' plan of the 'pallas'"):
        osv.same_filter_peak(torch.zeros((2, 3000), dtype=torch.int16), plan)
    with pytest.raises(ValueError, match="'fast' plan of the 'pallas'"):
        osv.extended_filter_peak(
            torch.zeros((2, 3000 + plan.m), dtype=torch.int16), plan, 3000)
