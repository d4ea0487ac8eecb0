"""The generic block path (``--engine fourstep|pease|stockham``) on the CPU.

- The port's block path against the JAX package's block paths on one
  configuration: ``engine="pallas"`` at T = 201 / B = 256, where the JAX
  segment kernel declines and ``pallas_conv_real_blocks`` runs (interpret
  mode), and ``engine="fourstep"`` at T = 193 / B = 1024 (the XLA
  four-step engine). Tolerances as in test_torch_overlap_save.py: port vs
  float64 oracle high <= 1 LSB @ 24-bit, fast <= 1 LSB @ 16-bit; port vs
  JAX high <= high_tol_lsb24() + 1 LSB @ 24-bit, fast <= 2 LSB @ 16-bit.
- extended_filter_peak on the block path: the interior of same_filter,
  and a peak over the returned samples only, never the block padding.
- Engine resolution, conv_chunk grouping, streaming and the 16-bit route
  (never taken on the block path).
"""

import importlib
import types

import numpy as np
import pytest
import torch

from audio_fir_filter_tpu.ops import kernel_design as kd
from audio_fir_filter_tpu.ops import oracle
from audio_fir_filter_tpu.ops import overlap_save as josv
from audio_fir_filter_tpu_torch import audio
from audio_fir_filter_tpu_torch.audio import Encoding
from audio_fir_filter_tpu_torch.audio.synth import create_audio_file
from audio_fir_filter_tpu_torch.ops import conv_blocks as cb
from audio_fir_filter_tpu_torch.ops import overlap_save as osv
from audio_fir_filter_tpu_torch.pipeline import (default_segment_len,
                                                 filter_array_streamed,
                                                 filter_array_streamed_i16,
                                                 process_file)
from audio_fir_filter_tpu_torch.utils.options import FilterOptions

# The module (the package re-exports its function of the same name).
pf_mod = importlib.import_module("audio_fir_filter_tpu_torch.pipeline.process_file")

from util import high_tol_lsb24

CPU = "cpu"
BITS = {"high": 24, "fast": 16}


def _case(num_taps, n, seed=0):
    """The JAX sharded tests' case: random odd-length taps around a unit
    centre tap, and a 2-channel signal."""
    rng = np.random.default_rng(seed)
    taps = rng.standard_normal(num_taps) * 0.05
    taps[num_taps // 2] += 1.0
    x = (0.4 * rng.uniform(-1, 1, (2, n))).astype(np.float32)
    return taps, x


def _check_against(yt, yj, x, taps, precision):
    bits = BITS[precision]
    want = np.stack([oracle.direct_filter(xi, taps) for xi in x])
    assert oracle.max_lsb_error(yt, want, bits=bits) <= 1.0
    tol = high_tol_lsb24() + 1.0 if precision == "high" else 2.0
    assert oracle.max_lsb_error(yt, yj, bits=bits) <= tol


@pytest.mark.parametrize("precision", ["high", "fast"])
def test_block_path_matches_jax_pallas_block_kernel(precision):
    """T = 201 at B = 256: the JAX segment kernel declines (hop <= 0 in its
    framing), so JAX runs its generic block path through
    pallas_conv_real_blocks; the port runs its own block path."""
    import jax.numpy as jnp

    from audio_fir_filter_tpu.ops import pallas_fft as pf

    assert pf.segment_path_qualifies(201, 256, interpret=True) is False
    taps, x = _case(201, 600)
    jplan = josv.make_plan(taps, precision=precision, block_size=256,
                           engine="pallas")
    plan = osv.make_plan(taps, precision, 256, CPU, engine="fourstep")
    assert (plan.block_size, plan.hop, plan.engine) == (256, 56, "fourstep")
    yj = np.asarray(josv.same_filter(jnp.asarray(x), jplan))
    yt = osv.same_filter(x, plan).numpy()
    _check_against(yt, yj, x, taps, precision)


@pytest.mark.parametrize("precision", ["high", "fast"])
def test_block_path_matches_jax_fourstep_engine(precision):
    import jax.numpy as jnp

    taps, x = _case(193, 3 * (1024 - 192) + 77, seed=1)
    jplan = josv.make_plan(taps, precision=precision, block_size=1024,
                           engine="fourstep")
    plan = osv.plan_from_jax(jplan, taps, CPU)
    assert (plan.engine, plan.conv_chunk) == ("fourstep", jplan.conv_chunk)
    yj = np.asarray(josv.same_filter(jnp.asarray(x), jplan))
    yt = osv.same_filter(x, plan).numpy()
    _check_against(yt, yj, x, taps, precision)


def test_plan_from_jax_carries_the_pallas_engine():
    taps, _ = _case(193, 10)
    jplan = josv.make_plan(taps, precision="fast", block_size=1024,
                           engine="pallas")
    assert osv.plan_from_jax(jplan, taps, CPU).engine == "pallas"


@pytest.mark.parametrize("precision", ["high", "fast"])
def test_block_path_equals_segment_path(precision):
    """Both engines compute one filter: within their precision's gate."""
    ws = kd.WindowedSinc(0.05, 0.02).make_low_cut()          # 201 taps
    x = np.random.default_rng(2).uniform(-1, 1, (3, 5000)).astype(np.float32)
    seg = osv.same_filter(x, osv.make_plan(ws.taps, precision, 1024, CPU))
    blk = osv.same_filter(x, osv.make_plan(ws.taps, precision, 1024, CPU,
                                           engine="stockham"))
    assert oracle.max_lsb_error(blk.numpy(), seg.numpy(),
                                bits=BITS[precision]) <= 1.0


def test_extended_filter_peak_is_interior_and_covers_only_out_len():
    ws = kd.WindowedSinc(0.05, 0.02).make_low_cut()
    plan = osv.make_plan(ws.taps, "high", 1024, CPU, engine="fourstep")
    x = np.random.default_rng(4).uniform(-0.5, 0.5, (2, 8000)).astype(np.float32)
    full = osv.same_filter(x, plan).numpy()
    s, e, mo2 = 2000, 6000, plan.mo2
    seg, peak = osv.extended_filter_peak(x[:, s - mo2 : e + mo2], plan, e - s)
    assert oracle.max_lsb_error(seg.numpy(), full[:, s:e], bits=24) <= 1.0
    assert float(peak) == float(seg.abs().max())

    # A loud tail past out_len lands in the last blocks' padding positions:
    # the peak must not see it.
    loud = x[:, : 3000 + 2 * mo2].copy()
    loud[:, 1500 + 2 * mo2 :] *= 50.0
    y, p = osv.extended_filter_peak(loud, plan, 1500)
    assert y.shape == (2, 1500)
    assert float(p) == float(y.abs().max())
    assert float(p) < 2.0


def test_block_path_runs_conv_chunk_groups(monkeypatch):
    ws = kd.WindowedSinc(0.05, 0.02).make_low_cut()
    plan = osv.make_plan(ws.taps, "fast", 256, CPU, engine="pease")
    assert plan.conv_chunk == osv.CONV_CHUNK == 16
    seen = []
    real = cb.conv_real_blocks

    def spy(blocks, p):
        seen.append(blocks.shape[0])
        return real(blocks, p)

    monkeypatch.setattr(cb, "conv_real_blocks", spy)
    x = np.random.default_rng(5).uniform(-1, 1, (2, 1000)).astype(np.float32)
    y, _ = osv.same_filter_peak(x, plan)
    nb = -(-1000 // plan.hop)
    nb += nb & 1                                   # 18 + 0 per channel
    assert seen == [16, 16, 4] and sum(seen) == 2 * nb
    want = np.stack([oracle.direct_filter(xi, ws.taps) for xi in x])
    assert oracle.max_lsb_error(y.numpy(), want, bits=16) <= 1.0


def test_engine_resolution_and_plan_checks():
    ws = kd.WindowedSinc(0.05, 0.02).make_low_cut()
    assert osv.resolve_engine("auto") == osv.resolve_engine("pallas") == "pallas"
    for e in osv.BLOCK_ENGINES:
        assert osv.resolve_engine(e) == e
        assert osv.make_plan(ws.taps, "fast", 1024, CPU, engine=e).engine == e
    assert osv.make_plan(ws.taps, "fast", 1024, CPU).engine == "pallas"
    with pytest.raises(ValueError, match="unknown engine"):
        osv.make_plan(ws.taps, "fast", 1024, CPU, engine="cufft")
    jplan = types.SimpleNamespace(num_taps=len(ws.taps), block_size=1024,
                                  precision="fast", engine="fourstep",
                                  conv_chunk=15)
    with pytest.raises(ValueError, match="conv_chunk"):
        osv.plan_from_jax(jplan, ws.taps, CPU)


@pytest.mark.parametrize("precision", ["high", "fast"])
def test_block_path_streamed_equals_single_call(precision):
    ws = kd.WindowedSinc(0.02, 0.025).make_low_cut()
    plan = osv.make_plan(ws.taps, precision, 1024, CPU, engine="fourstep")
    x = np.random.default_rng(0).uniform(-1, 1, (2, 20_000)).astype(np.float32)
    whole = osv.same_filter(x, plan).numpy()
    seg, peak = filter_array_streamed(x, plan, segment_len=plan.hop * 3)
    assert oracle.max_lsb_error(seg, whole, bits=BITS[precision]) <= 1.0
    assert peak == pytest.approx(float(np.abs(whole).max()), rel=1e-6)


def test_default_segment_len_bounds_the_block_matrix():
    taps = kd.highpass_taps(15.0 / 96000.0, 38400)   # M = 38,400
    seg_plan = osv.make_plan(taps, "high", 0, CPU)
    blk_plan = osv.make_plan(taps, "high", 0, CPU, engine="fourstep")
    b, hop = blk_plan.block_size, blk_plan.hop
    assert (b, hop) == (1 << 18, (1 << 18) - 38400)
    seg = default_segment_len(seg_plan)
    blk = default_segment_len(blk_plan)
    assert seg % (2 * hop) == 0 and blk % (2 * hop) == 0
    assert seg // hop == 74 and blk // hop == 64      # 2^24 / hop, 2^24 / B
    assert (blk // hop) * b <= 1 << 24


def test_streamed_i16_refuses_a_block_plan():
    ws = kd.WindowedSinc(0.02, 0.025).make_low_cut()
    plan = osv.make_plan(ws.taps, "fast", 1024, CPU, engine="fourstep")
    with pytest.raises(ValueError, match="'pallas'"):
        filter_array_streamed_i16(np.zeros((2, 100), np.int16), plan)


@pytest.mark.parametrize("engine,i16_route", [("auto", True),
                                              ("fourstep", False)])
def test_16bit_file_takes_i16_route_only_on_pallas(tmp_path, monkeypatch,
                                                   engine, i16_route):
    fs = 8000.0
    x = np.random.default_rng(6).uniform(-0.5, 0.5, (2, 6000)).astype(np.float32)
    src = tmp_path / "in16.wav"
    create_audio_file(src, x, fs, encoding=Encoding.PCM_16)
    calls = []
    real = pf_mod.filter_array_streamed_i16

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(pf_mod, "filter_array_streamed_i16", spy)
    opts = FilterOptions(freq=100.0, slope=200.0, block_size=1024, engine=engine)
    m = process_file(src, tmp_path / "out.wav", opts, show_progress=False,
                     device=CPU)
    assert m["precision"] == "fast"
    assert bool(calls) is i16_route
    taps = kd.highpass_taps(100.0 / fs, kd.kernel_length(200.0 / fs))
    xin = audio.read_audio(src).samples
    want = np.stack([oracle.direct_filter(xc, taps) for xc in xin])
    assert oracle.max_lsb_error(audio.read_audio(tmp_path / "out.wav").samples,
                                want, bits=16) <= 1.5


def test_block_path_on_cpu_counts_no_launch():
    ws = kd.WindowedSinc(0.05, 0.02).make_low_cut()
    plan = osv.make_plan(ws.taps, "high", 1024, CPU, engine="fourstep")
    before = dict(cb.launches)
    osv.same_filter(torch.zeros((2, 3000)), plan)
    assert cb.launches == before
