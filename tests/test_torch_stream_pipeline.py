"""The port's streamed routes keep one segment in flight (device='cpu').

``filter_array_streamed`` (both engines), ``filter_array_streamed_i16``
and ``sharded_filter_streamed`` run through ``pipeline.stream._pipelined``:
segment k + 1 is dispatched before segment k is drained, as the JAX
stream's ``pending`` list does. On the CPU the same code runs with plain
tensors, so these tests hold it to:

- byte-identical outputs and equal peaks against a synchronous
  per-segment loop written here (the loop the port ran before);
- the JAX package's streamed routes on the same numpy inputs, within the
  tolerances of tests/test_torch_pipeline.py and tests/test_torch_sharded.py
  (high_tol_lsb24() + 1 LSB @ 24-bit; 1 LSB @ 16-bit for ``fast``, 2 on a
  mesh; peaks rtol 1e-5);
- the order of dispatches and drains, and no read of a segment's result
  on the host except the non-blocking copy;
- error propagation: a failing segment raises, and progress never reports
  it or any later segment.

Filter: T = 161 taps at B = 1024 (hop 864, Mo2 80); segments of 2 hops.
"""

import numpy as np
import pytest
import torch

from audio_fir_filter_tpu.ops import kernel_design as kd
from audio_fir_filter_tpu.ops import oracle
from audio_fir_filter_tpu.ops import overlap_save as josv
from audio_fir_filter_tpu.parallel import make_mesh as jmake_mesh
from audio_fir_filter_tpu.pipeline import stream as jstream
from audio_fir_filter_tpu_torch.ops import overlap_save as osv
from audio_fir_filter_tpu_torch.ops import segment_filter as sf
from audio_fir_filter_tpu_torch.parallel import (Cell, Mesh, make_mesh,
                                                 sharded_conv, sharded_filter)
from audio_fir_filter_tpu_torch.pipeline import stream
from audio_fir_filter_tpu_torch.pipeline.stream import (
    filter_array_streamed, filter_array_streamed_i16, sharded_filter_streamed)

from util import high_tol_lsb24

TAPS = kd.WindowedSinc(0.02, 0.025).make_low_cut().taps      # T = 161
HOP = 1024 - (len(TAPS) - 1)                                  # 864
SEG = 2 * HOP
N = 7 * HOP + 123            # four segments, the last one short
BITS = {"high": 24, "fast": 16}


def signal(channels, n=N, seed=0, scale=0.4):
    rng = np.random.default_rng(seed)
    return (scale * rng.uniform(-1, 1, (channels, n))).astype(np.float32)


def pcm(channels, n=N, seed=0):
    return np.rint(signal(channels, n, seed, 0.7) * 32768).astype(np.int16)


def plan(precision="high", engine="auto"):
    return osv.make_plan(TAPS, precision, 1024, "cpu", engine=engine)


def cpu_mesh(shape):
    return make_mesh(shape, ["cpu"] * (shape[0] * shape[1]))


def edge_slice(x, g0, g1):
    """x[:, g0:g1] with zeros outside [0, N), always a new array."""
    buf = np.zeros((x.shape[0], g1 - g0), x.dtype)
    s0, s1 = max(0, g0), min(x.shape[1], g1)
    if s1 > s0:
        buf[:, s0 - g0 : s1 - g0] = x[:, s0:s1]
    return buf


def segments(n, seg):
    return [(s, min(n, s + seg)) for s in range(0, n, seg)]


# ------------------------------------------- the synchronous loops, written out

def sync_streamed(x, p, seg):
    out, peak, mo2 = np.empty_like(x), 0.0, p.mo2
    for s, e in segments(x.shape[1], seg):
        xe = torch.from_numpy(edge_slice(x, s - mo2, e + mo2))
        y, pk = osv.extended_filter_peak(xe, p, e - s)
        out[:, s:e] = y.numpy()
        peak = max(peak, float(pk))
    return out, peak


def sync_streamed_i16(x16, p, seg):
    c, n = x16.shape
    out, peak, mo2 = np.empty_like(x16), 0, p.mo2
    for s, e in segments(n, seg):
        if (s, e) == (0, n):
            xe, left = x16, mo2
        else:
            xe, left = edge_slice(x16, s - mo2, e + mo2), 0
        y, pk = sf.segment_filter(torch.from_numpy(np.ascontiguousarray(xe)),
                                  p, left, e - s, i16_io=True)
        out[:, s:e] = y.numpy()
        peak = max(peak, int(pk))
    return out, peak, peak >= 32767


def sync_sharded(x, p, mesh, seg):
    """The mesh loop: ``seg`` already a multiple of t * hop."""
    c, n = x.shape
    d, _ = mesh.shape
    cp = -(-c // d) * d
    x_in = np.zeros((cp, n), np.float32)
    x_in[:c] = x
    out, peak, mo2 = np.empty_like(x), 0.0, p.mo2
    for s, e in segments(n, seg):
        y, pk = sharded_filter(edge_slice(x_in, s, s + seg), p, mesh,
                               edge_left=edge_slice(x_in, s - mo2, s),
                               edge_right=edge_slice(x_in, s + seg, s + seg + mo2),
                               auto_scale=False, valid=(c, e - s))
        out[:, s:e] = y[:c, : e - s].numpy()
        peak = max(peak, pk)
    return out, peak


def lsb(a, b, bits):
    return oracle.max_lsb_error(np.asarray(a), np.asarray(b), bits=bits)


# ------------------------------------------------------------ byte-identical

@pytest.mark.parametrize("channels", [1, 2, 3])
@pytest.mark.parametrize("engine", ["pallas", "fourstep"])
@pytest.mark.parametrize("precision", ["high", "fast"])
def test_streamed_is_byte_identical_to_the_synchronous_loop(precision, engine,
                                                            channels):
    p = plan(precision, engine)
    x = signal(channels, seed=channels)
    ticks = []
    y, peak = filter_array_streamed(x, p, segment_len=SEG,
                                    progress_cb=ticks.append)
    ref, ref_peak = sync_streamed(x, p, SEG)
    assert y.dtype == np.float32 and np.array_equal(y, ref)
    assert peak == ref_peak and isinstance(peak, float)
    assert ticks == [channels * (e - s) for s, e in segments(N, SEG)]


@pytest.mark.parametrize("n", [N, SEG, 5 * HOP])
@pytest.mark.parametrize("channels", [1, 2])
def test_streamed_i16_is_byte_identical_to_the_synchronous_loop(channels, n):
    """Several segments with a short last one, one whole segment (the
    kernel pads the signal's edges) and a whole number of segments."""
    p = plan("fast")
    x16 = pcm(channels, n, seed=7)
    y, peak, sat = filter_array_streamed_i16(x16, p, segment_len=SEG)
    ref, ref_peak, ref_sat = sync_streamed_i16(x16, p, SEG)
    assert y.dtype == np.int16 and np.array_equal(y, ref)
    assert peak == ref_peak and type(peak) is int and sat == ref_sat


def test_streamed_i16_reports_the_rails():
    p = plan("fast")
    x16 = np.full((2, N), 32767, np.int16)
    x16[:, ::3] = -32768
    y, peak, sat = filter_array_streamed_i16(x16, p, segment_len=SEG)
    ref, ref_peak, ref_sat = sync_streamed_i16(x16, p, SEG)
    assert np.array_equal(y, ref) and peak == ref_peak >= 32767 and sat and ref_sat


@pytest.mark.parametrize("channels", [2, 3])
@pytest.mark.parametrize("engine", ["pallas", "fourstep"])
@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_sharded_streamed_is_byte_identical_to_the_synchronous_loop(
        shape, engine, channels):
    p = plan("high", engine)
    mesh = cpu_mesh(shape)
    seg = shape[1] * HOP
    x = signal(channels, seed=3)
    ticks = []
    y, peak = sharded_filter_streamed(x, p, mesh, segment_len=seg,
                                      progress_cb=ticks.append)
    ref, ref_peak = sync_sharded(x, p, mesh, seg)
    assert np.array_equal(y, ref) and peak == ref_peak
    assert ticks == [channels * (e - s) for s, e in segments(N, seg)]


def test_mesh_1x1_stream_equals_the_single_device_stream():
    p = plan("high")
    x = signal(2, seed=5)
    y, peak = sharded_filter_streamed(x, p, cpu_mesh((1, 1)), segment_len=SEG)
    ref, ref_peak = filter_array_streamed(x, p, segment_len=SEG)
    assert np.array_equal(y, ref) and peak == ref_peak


# --------------------------------------------------------- agreement with JAX

@pytest.mark.parametrize("precision,engine", [("fast", "pallas"),
                                              ("fast", "fourstep"),
                                              ("high", "pallas")])
def test_streamed_agrees_with_jax(precision, engine):
    """The JAX plan's engine on the CPU is its XLA four-step FFT."""
    jplan = josv.make_plan(TAPS, precision=precision, block_size=1024)
    x = signal(2, seed=11)
    y, peak = filter_array_streamed(x, plan(precision, engine),
                                    segment_len=SEG)
    yj, pj = jstream.filter_array_streamed(x, jplan, segment_len=SEG)
    bits = BITS[precision]
    tol = high_tol_lsb24() + 1.0 if bits == 24 else 1.0
    assert lsb(y, yj, bits) <= tol
    assert np.isclose(peak, float(pj), rtol=1e-5)
    want = np.stack([oracle.direct_filter(xc, TAPS) for xc in x])
    assert lsb(y, want, bits) <= 1.0


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_sharded_streamed_agrees_with_jax(shape):
    jplan = josv.make_plan(TAPS, precision="fast", block_size=1024)
    x = signal(3, seed=17)
    seg = shape[1] * HOP
    y, peak = sharded_filter_streamed(x, plan("fast"), cpu_mesh(shape),
                                      segment_len=seg)
    yj, pj = jstream.sharded_filter_streamed(x, jplan, jmake_mesh(shape),
                                             segment_len=seg)
    assert lsb(y, yj, 16) <= 2.0
    assert np.isclose(peak, float(pj), rtol=1e-5)


# ------------------------------------------------- order, reads and errors

# Reading a tensor's values on the host: on the card each waits for it.
HOST_READS = {"item", "__float__", "__int__", "__index__", "__bool__",
              "cpu", "numpy", "tolist"}


class Watched(torch.Tensor):
    """A segment's result that logs every host read of its values."""

    reads: list = []

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in HOST_READS:
            cls.reads.append(name)
        with torch._C.DisableTorchFunctionSubclass():
            return func(*args, **(kwargs or {}))


def _watch(t):
    return t.as_subclass(Watched)


# route: (module and name of its per-segment filter call, the call's
# results wrapped, the route run on ``progress_cb``)
ROUTES = {
    "float": (osv, "extended_filter_peak",
              lambda r: tuple(map(_watch, r)),
              lambda cb: filter_array_streamed(signal(2), plan("high"),
                                               segment_len=SEG, progress_cb=cb)),
    "fourstep": (osv, "extended_filter_peak",
                 lambda r: tuple(map(_watch, r)),
                 lambda cb: filter_array_streamed(
                     signal(2), plan("fast", "fourstep"), segment_len=SEG,
                     progress_cb=cb)),
    "i16": (osv, "extended_filter_peak",
            lambda r: tuple(map(_watch, r)),
            lambda cb: filter_array_streamed_i16(pcm(2), plan("fast"),
                                                 segment_len=SEG,
                                                 progress_cb=cb)),
    "mesh": (sharded_conv, "_filter_cells",
             lambda r: ({k: _watch(v) for k, v in r[0].items()},
                        [_watch(v) for v in r[1]]),
             lambda cb: sharded_filter_streamed(signal(2), plan("high"),
                                                cpu_mesh((1, 2)),
                                                segment_len=SEG,
                                                progress_cb=cb)),
}


def _record(monkeypatch, route, fail_at=None):
    """Patch the route's filter call and return (log, progress_cb): the log
    gets ("dispatch", k) per segment filtered, ("drain", k) per segment
    reported; the call raises on segment ``fail_at``."""
    module, name, watch, run = ROUTES[route]
    real = getattr(module, name)
    log, count = [], {"dispatch": 0, "drain": 0}

    def tick(kind):
        log.append((kind, count[kind]))
        count[kind] += 1

    def recorder(*args, **kwargs):
        if count["dispatch"] == fail_at:
            raise RuntimeError(f"segment {fail_at} failed")
        tick("dispatch")
        return watch(real(*args, **kwargs))

    monkeypatch.setattr(module, name, recorder)
    return log, lambda _n: tick("drain"), run


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_next_segment_is_dispatched_before_the_last_is_drained(monkeypatch,
                                                               route):
    log, cb, run = _record(monkeypatch, route)
    Watched.reads.clear()
    run(cb)
    k = len(segments(N, SEG))
    # JAX's pending rule: dispatch k + 1, then drain k; at most two
    # undrained; drains in order; the last one after the loop.
    want = [("dispatch", 0)]
    for j in range(1, k):
        want += [("dispatch", j), ("drain", j - 1)]
    assert log == want + [("drain", k - 1)]
    # A segment's result reaches the host only by its non-blocking copy.
    assert Watched.reads == []


@pytest.mark.parametrize("fail_at", [0, 1, 2, 3])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_a_failing_segment_raises_and_is_never_reported(monkeypatch, route,
                                                        fail_at):
    log, cb, run = _record(monkeypatch, route, fail_at=fail_at)
    with pytest.raises(RuntimeError, match=f"segment {fail_at} failed"):
        run(cb)
    drained = [j for kind, j in log if kind == "drain"]
    # Segment fail_at - 1 was dispatched but not yet drained.
    assert drained == list(range(max(fail_at - 1, 0)))


# ------------------------------------------------------------ the pieces

@pytest.mark.parametrize("g0,width", [(-80, 300), (-500, 100), (5900, 400),
                                      (7000, 50), (100, 200), (-10, N + 20)])
def test_stage_is_the_edge_padded_slice(g0, width):
    x = signal(3)
    dst = torch.full((3, width), np.nan)
    got = stream._stage(dst, x, g0)
    assert got is dst
    assert np.array_equal(dst.numpy(), edge_slice(x, g0, g0 + width))


def test_host_buffers_are_reused_and_grow():
    slot = {}
    a = stream._host_buffer(slot, False, "x", (2, 10), torch.float32)
    b = stream._host_buffer(slot, False, "x", (2, 7), torch.float32)
    assert a.is_contiguous() and b.is_contiguous()
    assert b.data_ptr() == a.data_ptr()
    c = stream._host_buffer(slot, False, "x", (3, 10), torch.float32)
    assert c.shape == (3, 10) and slot["x"].numel() == 30
    p = stream._host_buffer(slot, False, "peak", (), torch.float32)
    assert p.shape == ()


def test_as_input_passes_a_ready_tensor_through():
    p = plan("high")
    t = torch.zeros((2, 100), dtype=torch.float32)
    got, squeeze = osv._as_input(t, p)
    assert got is t and not squeeze
    one, squeeze = osv._as_input(t[0], p)
    assert one.data_ptr() == t.data_ptr() and squeeze


def test_sharded_streamed_refuses_a_mesh_of_other_processes():
    p = plan("high")
    mesh = Mesh(((Cell(0, torch.device("cpu")), Cell(1, torch.device("cpu"))),))
    with pytest.raises(ValueError, match="this process's cells"):
        sharded_filter_streamed(signal(2), p, mesh, segment_len=SEG)
