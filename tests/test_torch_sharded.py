"""The port's mesh-sharded filter (``audio_fir_filter_tpu_torch.parallel``)
in one process, on CPU cells (``["cpu"] * k``: the counterpart of the eight
virtual XLA host devices of tests/test_sharded.py).

Every case of tests/test_sharded.py, on the same numpy-seeded inputs,
through the JAX package's ``sharded_filter`` (8 virtual CPU devices; its
Pallas engine in interpret mode, only at B <= 1024) and the port's, against
the float64 oracle and the unsharded port. Tolerances: port vs oracle and
vs the unsharded port ``high`` <= 1 LSB @ 24-bit (the port is float64; the
JAX package's CPU slack does not apply to it), ``fast`` <= 1 LSB @ 16-bit;
port vs JAX ``high`` <= high_tol_lsb24() + 1 LSB @ 24-bit, ``fast`` <= 2
LSB @ 16-bit; peaks ``rtol=1e-5``.

Plus what the port does differently on purpose: the normalize decision
covers the real region only (a borderline peak with a padded tail), cells
that lie wholly in the padding are not filtered, and the mesh is a grid of
``(rank, device)`` cells.
"""

import numpy as np
import pytest
import torch

from audio_fir_filter_tpu.ops import kernel_design as kd
from audio_fir_filter_tpu.ops import oracle
from audio_fir_filter_tpu.ops import overlap_save as josv
from audio_fir_filter_tpu.parallel import make_mesh as jmake_mesh
from audio_fir_filter_tpu.parallel import sharded_filter as jsharded_filter
from audio_fir_filter_tpu.parallel import (
    sharded_filter_padded as jsharded_filter_padded)
from audio_fir_filter_tpu_torch.ops import overlap_save as osv
from audio_fir_filter_tpu_torch.parallel import (Cell, Mesh, make_mesh,
                                                 pad_for_mesh, sharded_filter,
                                                 sharded_filter_padded,
                                                 single_device_mesh)
from audio_fir_filter_tpu_torch.parallel import sharded_conv
from audio_fir_filter_tpu_torch.pipeline import (filter_array_streamed,
                                                 sharded_filter_streamed)

from util import high_tol_lsb24

BITS = {"high": 24, "fast": 16}
MESH_SHAPES = [(1, 1), (1, 4), (1, 8), (2, 4)]


def cpu_mesh(shape):
    return make_mesh(shape, ["cpu"] * 8)


def jax_tol(precision):
    return high_tol_lsb24() + 1.0 if precision == "high" else 2.0


def make_case(n, channels=2, bw=0.02, fc=0.05, seed=0, precision="high",
              engine=None):
    """The case of tests/test_sharded.py (T = 201, B = 1024): the signal,
    the taps, the JAX plan and the port's plan of the same configuration
    (``engine``: the port's engine, default the JAX plan's)."""
    ws = kd.WindowedSinc(fc, bw).make_low_cut()
    rng = np.random.default_rng(seed)
    # keep the filtered peak < 1 (no auto-normalize)
    x = (0.4 * rng.uniform(-1, 1, (channels, n))).astype(np.float32)
    jplan = josv.make_plan(ws.taps, precision=precision, block_size=1024)
    if engine is None:
        plan = osv.plan_from_jax(jplan, ws.taps, "cpu")
    else:
        plan = osv.make_plan(ws.taps, precision, 1024, "cpu", engine=engine)
    return x, ws, jplan, plan


def lsb(a, b, precision):
    return oracle.max_lsb_error(np.asarray(a), np.asarray(b),
                                bits=BITS[precision])


def want(x, taps):
    return np.stack([oracle.direct_filter(xi, taps) for xi in x])


# ------------------------------------------------------ tests/test_sharded.py

@pytest.mark.parametrize("precision", ["high", "fast"])
@pytest.mark.parametrize("mesh_shape", MESH_SHAPES)
def test_sharded_matches_single_device(mesh_shape, precision):
    x, ws, jplan, plan = make_case(n=8000, precision=precision)
    y, peak = sharded_filter(x, plan, cpu_mesh(mesh_shape))
    ref = osv.same_filter(x, plan).numpy()
    assert y.shape == (2, 8000) and y.dtype == torch.float32
    assert lsb(y, ref, precision) <= 1.0
    assert lsb(y, want(x, ws.taps), precision) <= 1.0
    assert np.isclose(peak, np.max(np.abs(ref)), rtol=1e-5)
    yj, pj = jsharded_filter(x, jplan, jmake_mesh(mesh_shape))
    assert lsb(y, yj, precision) <= jax_tol(precision)
    assert np.isclose(peak, float(pj), rtol=1e-5)


@pytest.mark.parametrize("precision", ["high", "fast"])
@pytest.mark.parametrize("mesh_shape", MESH_SHAPES)
def test_sharded_block_engine_matches_single_device(mesh_shape, precision):
    """The block path (one block kernel for fourstep, pease and stockham)
    under a mesh."""
    x, ws, _, plan = make_case(n=8000, precision=precision, engine="fourstep")
    y, peak = sharded_filter(x, plan, cpu_mesh(mesh_shape))
    ref = osv.same_filter(x, plan).numpy()
    assert lsb(y, ref, precision) <= 1.0
    assert lsb(y, want(x, ws.taps), precision) <= 1.0
    assert np.isclose(peak, np.max(np.abs(ref)), rtol=1e-5)


def test_sharded_matches_oracle_exact_semantics():
    """Halo exchange must reproduce zero-pad edges only at global edges."""
    x, ws, jplan, plan = make_case(n=4000, channels=1)
    # shard length 500 << kernel span tests halos hard
    y, _ = sharded_filter(x, plan, cpu_mesh((1, 8)))
    ref = oracle.direct_filter(x[0], ws.taps)
    assert lsb(y[0], ref, "high") <= 1.0
    yj, _ = jsharded_filter(x, jplan, jmake_mesh((1, 8)))
    assert lsb(y, yj, "high") <= jax_tol("high")


def test_shard_smaller_than_halo_rejected():
    """Shards shorter than Mo2: halos come from direct neighbours only, so
    this would be silently wrong. The port refuses, in the JAX package's
    words."""
    x, ws, jplan, plan = make_case(n=160, channels=1)  # shard len 20 < Mo2=100
    msg = "time shard length 20 is shorter than the half-kernel Mo2=100"
    with pytest.raises(ValueError, match=msg):
        sharded_filter(x, plan, cpu_mesh((1, 8)))
    with pytest.raises(ValueError, match=msg):
        jsharded_filter(x, jplan, jmake_mesh((1, 8)))
    # One time shard needs no halo: any length goes.
    y, _ = sharded_filter(x, plan, cpu_mesh((1, 1)))
    assert lsb(y[0], oracle.direct_filter(x[0], ws.taps), "high") <= 1.0


def test_sharded_padded_arbitrary_shapes():
    x, ws, jplan, plan = make_case(n=7777, channels=3)
    y, peak = sharded_filter_padded(x, plan, cpu_mesh((2, 4)))
    assert tuple(y.shape) == (3, 7777)
    ref = osv.same_filter(x, plan).numpy()
    assert lsb(y, ref, "high") <= 1.0
    assert np.isclose(peak, np.max(np.abs(ref)), rtol=1e-5)
    yj, _ = jsharded_filter_padded(x, jplan, jmake_mesh((2, 4)))
    assert lsb(y, yj, "high") <= jax_tol("high")
    xp, shape = pad_for_mesh(x, cpu_mesh((2, 4)))
    assert tuple(xp.shape) == (4, 7780) and shape == (3, 7777)
    assert not xp[3].any() and not xp[:, 7777:].any()
    same, _ = pad_for_mesh(xp, cpu_mesh((2, 4)))
    assert same is xp


def test_sharded_normalize_fused():
    x, ws, jplan, plan = make_case(n=8000, seed=5)
    x *= 0.1
    mesh = cpu_mesh((1, 8))
    y, peak = sharded_filter(x, plan, mesh, normalize=True)
    y = y.numpy()
    assert np.isclose(np.max(np.abs(y)), 1.0, atol=1e-5)
    # common factor: ratios preserved vs unnormalized
    y0, peak0 = sharded_filter(x, plan, mesh, normalize=False)
    assert peak0 == peak < 1.0          # the pre-scale peak either way
    mask = np.abs(y) > 1e-2
    scales = y0.numpy()[mask] / y[mask]
    assert np.allclose(scales, peak, rtol=1e-4)
    yj, pj = jsharded_filter(x, jplan, jmake_mesh((1, 8)), normalize=True)
    assert lsb(y, yj, "high") <= jax_tol("high") + 1.0
    assert np.isclose(peak, float(pj), rtol=1e-5)


def test_sharded_normalize_guards_a_zero_peak():
    _, _, _, plan = make_case(n=8)
    y, peak = sharded_filter(np.zeros((2, 8000), np.float32), plan,
                             cpu_mesh((2, 4)), normalize=True)
    assert peak == 0.0 and not y.any() and bool(torch.isfinite(y).all())


def test_sharded_auto_normalize_on_clip():
    """The clip rule: even without -n, the output is scaled by one common
    1/peak factor when the filtered peak clips."""
    x, ws, jplan, plan = make_case(n=8000, seed=3)
    x = (x * 4.0).astype(np.float32)  # drive filtered peak over 1.0
    y, peak = sharded_filter(x, plan, cpu_mesh((2, 4)), normalize=False)
    ref = osv.same_filter(x, plan).numpy()
    ref_peak = float(np.max(np.abs(ref)))
    assert ref_peak > 1.0  # the case actually exercises the clip rule
    assert np.isclose(peak, ref_peak, rtol=1e-5)
    assert lsb(y, ref / ref_peak, "high") <= 1.0
    yj, pj = jsharded_filter(x, jplan, jmake_mesh((2, 4)), normalize=False)
    assert lsb(y, yj, "high") <= jax_tol("high") + 1.0
    assert np.isclose(peak, float(pj), rtol=1e-5)


def test_sharded_indivisible_raises():
    x, ws, jplan, plan = make_case(n=8001)
    with pytest.raises(ValueError, match=r"shape \(2, 8001\) not divisible by "
                                         r"mesh \(1, 8\); pad first"):
        sharded_filter(x, plan, cpu_mesh((1, 8)))
    with pytest.raises(ValueError, match="not divisible by mesh"):
        jsharded_filter(x, jplan, jmake_mesh((1, 8)))
    with pytest.raises(ValueError, match="not divisible"):
        sharded_filter(x[:1], plan, cpu_mesh((2, 4)))       # 1 channel on D=2
    with pytest.raises(ValueError, match=r"expects \[C, N\]"):
        sharded_filter(x[0], plan, cpu_mesh((1, 1)))


def test_sharded_edge_halos_chain_segments():
    """Edge halos replace zero padding: filtering a middle segment with its
    true neighbour halos must equal the corresponding slice of the whole."""
    x, ws, jplan, plan = make_case(n=6000, channels=2)
    ref = osv.same_filter(x, plan).numpy()
    s, seg = 2000, 2000
    mo2 = plan.mo2
    edges = dict(edge_left=x[:, s - mo2 : s],
                 edge_right=x[:, s + seg : s + seg + mo2])
    y_seg, _ = sharded_filter(x[:, s : s + seg], plan, cpu_mesh((1, 8)), **edges)
    assert lsb(y_seg, ref[:, s : s + seg], "high") <= 1.0
    yj, _ = jsharded_filter(x[:, s : s + seg], jplan, jmake_mesh((1, 8)), **edges)
    assert lsb(y_seg, yj, "high") <= jax_tol("high")
    # One edge alone: the other side is the true signal edge (zeros).
    y_tail, _ = sharded_filter(x[:, 4000:], plan, cpu_mesh((2, 4)),
                               edge_left=x[:, 4000 - mo2 : 4000])
    assert lsb(y_tail, ref[:, 4000:], "high") <= 1.0


def test_sharded_streamed_matches_unsharded_and_reports_progress():
    from audio_fir_filter_tpu.pipeline.stream import (
        sharded_filter_streamed as jstreamed)

    x, ws, jplan, plan = make_case(n=9000, channels=3, seed=11)
    ticks = []
    y, peak = sharded_filter_streamed(x, plan, cpu_mesh((2, 4)),
                                      segment_len=2048,
                                      progress_cb=ticks.append)
    ref, ref_peak = filter_array_streamed(x, plan)
    assert y.shape == ref.shape and y.dtype == np.float32
    assert lsb(y, ref, "high") <= 1.0
    assert np.isclose(peak, ref_peak, rtol=1e-5)
    # The bar must actually move: several segment-sized increments summing
    # to the total. 2048 rounds up to t * hop = 4 * 824 = 3296 frames.
    assert ticks == [3 * 3296, 3 * 3296, 3 * (9000 - 2 * 3296)]
    yj, pj = jstreamed(x, jplan, jmake_mesh((2, 4)), segment_len=2048)
    assert lsb(y, yj, "high") <= jax_tol("high")
    assert np.isclose(peak, pj, rtol=1e-5)
    # One channel alone, as a 1-D array.
    y1, p1 = sharded_filter_streamed(x[0], plan, cpu_mesh((1, 4)),
                                     segment_len=2048)
    assert y1.shape == (9000,) and lsb(y1, ref[0], "high") <= 1.0


def test_sharded_streamed_no_per_segment_scaling():
    """A clipping segment must NOT be scaled alone: one global factor only."""
    x, ws, _, plan = make_case(n=6000, channels=1, seed=2)
    x = (x * 4.0).astype(np.float32)  # drive the filtered peak over 1.0
    y, peak = sharded_filter_streamed(x, plan, cpu_mesh((1, 8)),
                                      segment_len=1500)
    ref = osv.same_filter(x, plan).numpy()
    assert peak > 1.0  # the case is actually exercising the clip rule
    assert lsb(y, ref, "high") <= 1.0
    assert np.isclose(peak, np.max(np.abs(ref)), rtol=1e-5)


def test_sharded_streamed_grows_a_segment_shorter_than_the_halo():
    """A segment whose shards would be shorter than Mo2 grows to the next
    multiple of t * hop that holds Mo2 frames a shard."""
    ws = kd.WindowedSinc(0.05, 0.02).make_low_cut()         # M = 200
    plan = osv.make_plan(ws.taps, "high", 256, "cpu")       # hop 56, Mo2 100
    x = (0.4 * np.random.default_rng(4).uniform(-1, 1, (2, 5000))
         ).astype(np.float32)
    ticks = []
    y, _ = sharded_filter_streamed(x, plan, cpu_mesh((1, 8)), segment_len=100,
                                   progress_cb=ticks.append)
    # ceil(100 * 8 / (8 * 56)) * 8 * 56 = 896 frames, 112 >= Mo2 a shard.
    assert ticks[0] == 2 * 896
    assert lsb(y, osv.same_filter(x, plan).numpy(), "high") <= 1.0


# ------------------------------------------------- the segment kernel's engine

def _pallas_case(num_taps):
    """Random odd-length taps + a 2-channel signal for the engine tests."""
    rng = np.random.default_rng(0)
    taps = rng.standard_normal(num_taps) * 0.05
    taps[num_taps // 2] += 1.0
    x = (0.4 * rng.uniform(-1, 1, (2, 6144))).astype(np.float32)
    return taps, x


def _pallas_plans(taps, precision, block, engine="pallas"):
    jplan = josv.make_plan(taps, precision=precision, block_size=block,
                           engine="pallas")
    return jplan, osv.make_plan(taps, precision, block, "cpu", engine=engine)


@pytest.mark.parametrize("mesh_shape", [(1, 4), (2, 4)])
@pytest.mark.parametrize("num_taps,block,engine", [
    # The JAX segment path (interpret mode); the port's segment engine.
    (193, 1024, "pallas"),
    (201, 1024, "pallas"),
    # T = 201 at B = 256: the JAX segment path declines and its generic
    # block kernel runs; the port's block path.
    (201, 256, "fourstep"),
])
def test_sharded_pallas_engine_matches_oracle(mesh_shape, num_taps, block,
                                              engine):
    """The production engines under a mesh against the float64 oracle and
    the JAX package's Pallas engine under shard_map."""
    taps, x = _pallas_case(num_taps)
    jplan, plan = _pallas_plans(taps, "high", block, engine)
    y, peak = sharded_filter(x, plan, cpu_mesh(mesh_shape))
    ref = want(x, taps)
    assert lsb(y, ref, "high") <= 1.0
    assert np.isclose(peak, np.max(np.abs(ref)), rtol=1e-5)
    yj, pj = jsharded_filter(x, jplan, jmake_mesh(mesh_shape))
    assert lsb(y, yj, "high") <= jax_tol("high")
    assert np.isclose(peak, float(pj), rtol=1e-5)


def test_sharded_pallas_engine_fast_path():
    """The float32 segment engine under a mesh (the 16-bit production path)."""
    taps, x = _pallas_case(193)
    jplan, plan = _pallas_plans(taps, "fast", 1024)
    y, _ = sharded_filter(x, plan, cpu_mesh((2, 4)))
    assert lsb(y, want(x, taps), "fast") <= 1.0
    yj, _ = jsharded_filter(x, jplan, jmake_mesh((2, 4)))
    assert lsb(y, yj, "fast") <= jax_tol("fast")


def test_sharded_pallas_engine_edge_halos_and_normalize():
    """Segment chaining (host-fed edge halos) and the fused normalize with
    the segment engine in the cells."""
    taps, x = _pallas_case(193)
    _, plan = _pallas_plans(taps, "high", 1024)
    mesh = cpu_mesh((1, 4))
    ref = want(x, taps)
    s, seg = 2048, 2048
    mo2 = plan.mo2
    y_seg, _ = sharded_filter(
        x[:, s : s + seg], plan, mesh,
        edge_left=x[:, s - mo2 : s], edge_right=x[:, s + seg : s + seg + mo2])
    assert lsb(y_seg, ref[:, s : s + seg], "high") <= 1.0
    yn, _ = sharded_filter(x, plan, mesh, normalize=True)
    assert np.isclose(np.max(np.abs(yn.numpy())), 1.0, atol=1e-5)


def test_sharded_streamed_pallas_engine():
    """What ``--mesh DxT`` does for a long file: host segment streaming
    (edge-halo chaining) over the mesh (halos between shards) running the
    segment engine."""
    from audio_fir_filter_tpu.pipeline.stream import (
        sharded_filter_streamed as jstreamed)

    taps, x = _pallas_case(193)
    jplan, plan = _pallas_plans(taps, "high", 1024)
    y, peak = sharded_filter_streamed(x, plan, cpu_mesh((1, 4)),
                                      segment_len=2048)
    ref = want(x, taps)
    assert lsb(y, ref, "high") <= 1.0
    assert np.isclose(peak, np.max(np.abs(ref)), rtol=1e-5)
    yj, pj = jstreamed(x, jplan, jmake_mesh((1, 4)), segment_len=2048)
    assert lsb(y, yj, "high") <= jax_tol("high")
    assert np.isclose(peak, pj, rtol=1e-5)


# ------------------------------------- the normalize decision and the padding

def _ring_case(inside: float):
    """A signal and taps whose output rings louder just past the signal's
    end than anywhere inside it: one spike of height 1 on the last sample,
    a centre tap of ``inside`` and a tap of 1.05 three places before the
    centre. out[N-1] = inside; out[N+2] = 1.05 lies in the zero padding."""
    taps = np.zeros(201)
    taps[100] = inside
    taps[97] = 1.05
    x = np.zeros((2, 7997), np.float32)      # pads by 3 to a multiple of 8
    x[:, -1] = 1.0
    x[:, 1000] = 0.5                         # something in the middle too
    return taps, x


@pytest.mark.parametrize("inside,scaled", [(0.98, False), (1.02, True)])
def test_normalize_is_decided_on_the_real_region(inside, scaled):
    """A peak just below and just above 1.0 in the real region, with a
    louder ring in the padded tail: the port decides as the unsharded path
    does. The JAX package's ``sharded_filter_padded`` takes its peak over
    the padding and scales both."""
    taps, x = _ring_case(inside)
    plan = osv.make_plan(taps, "high", 1024, "cpu")
    ref, ref_peak = osv.same_filter_peak(x, plan)
    ref, ref_peak = ref.numpy(), float(ref_peak)
    assert np.isclose(ref_peak, max(inside, 1.05 * 0.5), rtol=1e-6)
    y, peak = sharded_filter_padded(x, plan, cpu_mesh((1, 8)))
    assert np.isclose(peak, ref_peak, rtol=1e-6)
    expect = ref / ref_peak if scaled else ref
    assert lsb(y, expect, "high") <= 1.0

    jplan = josv.make_plan(taps, precision="high", block_size=1024)
    yj, pj = jsharded_filter_padded(x, jplan, jmake_mesh((1, 8)))
    assert np.isclose(float(pj), 1.05, rtol=1e-5)            # the ring's peak
    assert lsb(yj, ref / 1.05, "high") <= high_tol_lsb24() + 1.0
    if not scaled:
        assert lsb(yj, y, "high") > 1000.0                   # where they differ


def test_streamed_peak_ignores_the_last_segment_s_padding():
    """The last segment is zero-padded to the segment length; its ring past
    the signal's end (here 1.05 * the last sample, Mo2 frames on) must not
    reach the peak."""
    taps = np.zeros(201)
    taps[100], taps[0] = 0.9, 1.05
    x = np.zeros((3, 5000), np.float32)
    x[:, -1] = 1.0
    plan = osv.make_plan(taps, "high", 1024, "cpu")
    y, peak = sharded_filter_streamed(x, plan, cpu_mesh((2, 4)),
                                      segment_len=3296)
    ref, ref_peak = filter_array_streamed(x, plan)
    assert np.isclose(peak, ref_peak, rtol=1e-6) and np.isclose(peak, 0.9)
    assert lsb(y, ref, "high") <= 1.0


def test_cells_wholly_in_the_padding_are_not_filtered(monkeypatch):
    x, ws, _, plan = make_case(n=2100, channels=1)
    calls = []
    real = osv.extended_filter_peak
    monkeypatch.setattr(osv, "extended_filter_peak",
                        lambda xe, p, n: calls.append((xe.shape[0], n))
                        or real(xe, p, n))
    xp = np.zeros((2, 8000), np.float32)
    xp[:1, :2100] = x
    y, peak = sharded_filter(xp, plan, make_mesh((2, 8), ["cpu"] * 16),
                             valid=(1, 2100))
    # Row 0 only; its shards of 1000 frames: two whole, 100 frames of the third.
    assert calls == [(1, 1000), (1, 1000), (1, 100)]
    ref = osv.same_filter(x, plan).numpy()
    assert lsb(y[:1, :2100], ref, "high") <= 1.0
    assert not y[1].any() and not y[:, 2100:].any()
    assert np.isclose(peak, np.max(np.abs(ref)), rtol=1e-6)


# ------------------------------------------------------------------- the mesh

def test_make_mesh_shapes_cells_and_errors(monkeypatch):
    mesh = make_mesh(devices=["cpu"] * 8)
    assert isinstance(mesh, Mesh) and mesh.shape == (1, 8)       # all on time
    assert mesh.axis_names == ("data", "time")
    mesh = make_mesh((2, 3), ["cpu"] * 8)
    assert mesh.shape == (2, 3)
    assert mesh.cells[1][2] == Cell(0, torch.device("cpu"))
    assert mesh.is_local(0) and mesh.ranks() == {0}
    assert single_device_mesh("cpu").shape == (1, 1)
    with pytest.raises(ValueError, match=r"mesh shape \(2, 8\) needs 16 devices, "
                                         "have 8"):
        make_mesh((2, 8), ["cpu"] * 8)
    # The JAX package's message has the same shape.
    with pytest.raises(ValueError, match=r"mesh shape \(2, 8\) needs 16 devices, "
                                         "have 8"):
        jmake_mesh((2, 8))
    with pytest.raises(ValueError, match="at least"):
        make_mesh((0, 2), ["cpu"] * 8)
    # Default cells are the visible cards: none here, and never the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match=r"needs 2 devices, have 0"):
        make_mesh((1, 2))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_mesh((1, 1), ["cuda"])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        single_device_mesh()
    # Another process's cell needs a group that has that rank.
    with pytest.raises(ValueError, match="rank 1 of a group of 1"):
        make_mesh((1, 2), [(0, "cpu"), (1, "cpu")])


def test_halo_exchange_in_one_process():
    """Tails go right and heads go left; mesh edges get zeros or the
    caller's edge halos; one time shard or Mo2 = 0 adds only the edges."""
    x = torch.arange(2 * 12, dtype=torch.float32).reshape(2, 12)
    mesh = cpu_mesh((2, 3))
    shards = {(i, j): x[i : i + 1, 4 * j : 4 * j + 4]
              for i in range(2) for j in range(3)}
    out = sharded_conv._halo_exchange(shards, 2, mesh)
    for i in range(2):
        row = torch.cat([torch.zeros(2), x[i], torch.zeros(2)])
        for j in range(3):
            assert torch.equal(out[(i, j)][0], row[4 * j : 4 * j + 8])
    el = torch.full((2, 2), -1.0)
    er = torch.full((2, 2), -2.0)
    out = sharded_conv._halo_exchange(shards, 2, mesh, el, er)
    assert torch.equal(out[(1, 0)][0, :2], el[1])
    assert torch.equal(out[(1, 2)][0, -2:], er[1])
    assert torch.equal(out[(1, 1)], torch.cat([x[1:, 2:4], x[1:, 4:8],
                                               x[1:, 8:10]], dim=1))
    one = sharded_conv._halo_exchange({(0, 0): x}, 2, cpu_mesh((1, 1)), el, None)
    assert torch.equal(one[(0, 0)], torch.cat([el, x, torch.zeros(2, 2)], dim=1))
    none = sharded_conv._halo_exchange(shards, 0, mesh)
    assert all(torch.equal(none[k], shards[k]) for k in shards)


def test_plan_for_device_keeps_one_copy_per_device():
    _, _, _, plan = make_case(n=8)
    assert osv.plan_for_device(plan, "cpu") is plan
    meta = osv.plan_for_device(plan, "meta")
    assert meta is osv.plan_for_device(plan, torch.device("meta"))
    assert meta.device == meta.H.device == torch.device("meta")
    assert (meta.num_taps, meta.block_size, meta.engine) == (
        plan.num_taps, plan.block_size, plan.engine)
    assert plan.H.device.type == "cpu"
