"""Host <-> device streaming of long signals through the plan's kernel.

Counterpart of ``audio_fir_filter_tpu/pipeline/stream.py``: one device, and
a mesh of cells (:func:`sharded_filter_streamed`).
The time axis is cut into segments; each segment is filtered with
kernel-length halos taken from its neighbours in host memory, so segment
seams are exact and only the true signal edges are zero-padded. The output
peak comes back with each segment (from the segment kernel, or reduced on
the device on the block path), over that segment's valid samples only.

Every route keeps one segment in flight, as the JAX stream does with its
``pending`` list (``audio_fir_filter_tpu/pipeline/stream.py:94-106``, the
16-bit route ``:174-189``, the mesh ``:267-285``), where JAX's async
dispatch overlaps host slicing of segment k + 1 with device compute of
segment k. Here (:func:`_pipelined`) each segment is staged in one host
copy into a pinned buffer (zeros at the true signal edges), uploaded with
``non_blocking``, filtered on PyTorch's current stream, and copied back
into a pinned buffer with ``non_blocking``, an event recorded after it.
Segment k + 1 is dispatched before segment k is drained: the drain waits on
k's event, copies into the output and only then reads k's peak. A pinned
buffer is refilled two segments later, after the drain that waited for its
copies. Nothing on the way reads a device value on the host before the
drain, so the host's staging of k + 1 overlaps the card's work on k. A
single-segment signal takes one plain synchronous call: there is nothing
to overlap.
"""

from __future__ import annotations

import collections
import functools

import numpy as np
import torch

from ..ops import overlap_save as osv
from ..parallel import sharded_conv
from ..parallel.distributed import process_info


def default_segment_len(plan: osv.OverlapSavePlan, target: int = 1 << 24,
                        channels: int = 2) -> int:
    """Segment body length: an even number of hops near ``target`` frames
    per channel for stereo, scaled by 2/channels so the total per segment
    stays fixed. 2^24 frames bounds one segment's device memory (float32
    input and output, ~0.25 GiB in stereo, plus the kernel's scratch of at
    most 0.25 GiB) and makes a 10-minute 96 kHz file span several segments.
    An even hop count fills every complex pair of the kernel.

    The block path materializes one B-point block per hop, B / hop times
    the segment, and returns as many; there the hop count is ``target / B``
    so its block matrix, not the segment, stays within the budget."""
    per_ch = max(1 << 20, 2 * target // max(2, channels))
    per_block = plan.hop if plan.engine == osv.PALLAS else plan.block_size
    k = max(2, per_ch // per_block)
    return (k + (k & 1)) * plan.hop


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _segments(n: int, seg: int):
    for s in range(0, n, seg):
        yield s, min(n, s + seg)


def _stage(dst: torch.Tensor, x: np.ndarray, g0: int) -> torch.Tensor:
    """Fill host ``dst`` [C, W] with x[:, g0 : g0 + W], zeros outside
    [0, N): a segment's one host copy, edge padding included."""
    n, w = x.shape[1], dst.shape[1]
    a = min(max(-g0, 0), w)          # first column inside the signal
    b = min(max(n - g0, a), w)       # end of the columns inside it
    dst[:, :a].zero_()
    dst[:, a:b].copy_(torch.from_numpy(x[:, g0 + a : g0 + b]))
    dst[:, b:].zero_()
    return dst


def _upload(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t.to(device, non_blocking=True)


def _host_buffer(slot: dict, pin: bool, key, shape, dtype) -> torch.Tensor:
    """A contiguous [shape] host tensor of ``slot``, kept for the next
    segment of the slot (pinned when ``pin``): a view of the first elements
    of one flat buffer per key, so a short last segment reuses it."""
    n = int(np.prod(shape, dtype=np.int64))
    flat = slot.get(key)
    if flat is None or flat.dtype != dtype or flat.numel() < n:
        flat = slot[key] = torch.empty(max(n, 1), dtype=dtype, pin_memory=pin)
    return flat[:n].view(shape)


def _pipelined(segments, dispatch, out: np.ndarray, device: torch.device,
               progress_cb) -> float:
    """Run ``dispatch`` over ``segments`` with at most two segments in
    flight, as the JAX stream's ``pending`` does (its ``stream.py:94-106``):
    segment k + 1 is dispatched before segment k is drained into ``out``.

    ``dispatch(s, e, buffer)`` stages segment [s, e) into host tensors from
    ``buffer(key, shape, dtype)``, uploads them with :func:`_upload` and
    launches; it returns ``(y, peak)`` on the device, where
    ``y[:C, :e - s]`` is ``out[:, s:e]`` and ``peak`` a 0-d tensor. Both
    are copied into host buffers without blocking and an event is recorded
    after them; the drain waits on that event, then copies into ``out``,
    reads the peak and reports ``C * (e - s)`` to ``progress_cb``. Returns
    the largest peak.

    Segment k uses the host buffers of slot k % 2. They are refilled for
    segment k + 2 only after segment k's drain, whose event follows its
    upload and download on the same stream. On a ``device`` that is the
    CPU the same code runs on plain tensors, with no pinning and no
    events. A failure raises; segments drained before it have been
    reported to ``progress_cb``, later ones are not."""
    pin = device.type == "cuda"
    slots = ({}, {})
    pending = collections.deque()
    rows = out.shape[0]
    out_t = torch.from_numpy(out)
    peak = 0.0

    def drain() -> float:
        s, e, y, p, done = pending.popleft()
        if done is not None:
            done.synchronize()
        out_t[:, s:e].copy_(y[:rows, : e - s])
        if progress_cb:
            progress_cb(rows * (e - s))
        return float(p)

    for k, (s, e) in enumerate(segments):
        buffer = functools.partial(_host_buffer, slots[k % 2], pin)
        y, p = dispatch(s, e, buffer)
        y_host = buffer("y", y.shape, y.dtype).copy_(y, non_blocking=True)
        p_host = buffer("peak", (), p.dtype).copy_(p, non_blocking=True)
        done = None
        if pin:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(y.device))
        pending.append((s, e, y_host, p_host, done))
        if len(pending) >= 2:
            peak = max(peak, drain())
    while pending:
        peak = max(peak, drain())
    return peak


def _streamed(x: np.ndarray, plan: osv.OverlapSavePlan, segment_len: int,
              progress_cb) -> tuple[np.ndarray, float]:
    """(y, peak) of planar [C, N] (or [N]) ``x``, float32 or int16 PCM (the
    filters take the 16-bit route by the dtype): one segment in one
    synchronous ``same_filter_peak`` (the kernel pads the edges), more as
    halo'd segments through ``extended_filter_peak`` in :func:`_pipelined`."""
    if x.ndim == 1:
        y, peak = _streamed(x[None, :], plan, segment_len, progress_cb)
        return y[0], peak
    c, n = x.shape
    if n == 0:
        return x.copy(), 0.0
    seg = segment_len or default_segment_len(plan, channels=c)
    if n <= seg:
        y, peak = osv.same_filter_peak(_to_device(x, plan.device), plan)
        if progress_cb:
            progress_cb(c * n)
        return y.cpu().numpy(), float(peak)

    mo2 = plan.mo2
    dtype = torch.int16 if x.dtype == np.int16 else torch.float32

    def dispatch(s, e, buffer):
        xe = _stage(buffer("x", (c, e - s + 2 * mo2), dtype), x, s - mo2)
        return osv.extended_filter_peak(_upload(xe, plan.device), plan, e - s)

    out = np.empty((c, n), dtype=x.dtype)
    peak = _pipelined(_segments(n, seg), dispatch, out, plan.device,
                      progress_cb)
    return out, peak


def filter_array_streamed(
    x: np.ndarray,
    plan: osv.OverlapSavePlan,
    segment_len: int = 0,
    progress_cb=None,
) -> tuple[np.ndarray, float]:
    """Filter planar [C, N] float32 through the plan's device in segments.

    Returns ``(y [C, N] float32, peak)``: the zero-padded 'same' filter of
    :func:`..ops.overlap_save.same_filter`, plus the global max|y| from the
    kernel. ``progress_cb(num_samples)`` is called per finished segment
    with C * segment frames.
    """
    return _streamed(np.asarray(x, dtype=np.float32), plan, segment_len,
                     progress_cb)


def filter_array_streamed_i16(
    x16: np.ndarray,
    plan: osv.OverlapSavePlan,
    segment_len: int = 0,
    progress_cb=None,
) -> tuple[np.ndarray, int, bool]:
    """16-bit-native streaming: int16 PCM [C, N] -> int16 PCM, float32
    arithmetic, the codec's quantization inside the kernel.

    Returns ``(y16, peak16, saturated)``: peak16 is the global max |PCM
    code| and ``saturated`` is True when an output reached the int16 rails
    (quantization may have clipped; the caller redoes the file in float32
    to honour normalize-on-clip). Raises ValueError for a plan the kernel's
    16-bit mode does not take (:func:`..ops.overlap_save.takes_i16`: a
    'fast' plan of the segment kernel's engine, ``pallas``)."""
    if not osv.takes_i16(plan):
        raise ValueError("16-bit-native filtering needs a 'fast' plan of the "
                         f"'pallas' engine; got engine={plan.engine!r}, "
                         f"precision={plan.precision!r}")
    if x16.dtype != np.int16:
        raise TypeError(f"expected int16 PCM, got {x16.dtype}")
    out, peak = _streamed(x16, plan, segment_len, progress_cb)
    return out, int(peak), peak >= 32767


def sharded_filter_streamed(
    x: np.ndarray,
    plan: osv.OverlapSavePlan,
    mesh,
    segment_len: int = 0,
    progress_cb=None,
) -> tuple[np.ndarray, float]:
    """Mesh-sharded analog of :func:`filter_array_streamed`, on a mesh of
    this process's cells.

    Cuts [C, N] into fixed segments, filters each across the mesh (halos
    between the shards; host-fed edge halos chain the segments), and
    reports progress per segment. The segment length is that of one device
    (:func:`default_segment_len`), rounded up to a multiple of ``t * hop``
    and grown until a shard holds at least Mo2 frames, so each shard gets
    ``segment / t`` frames.

    Returns (y [C, N] float32, global pre-scale peak). Normalization is
    the caller's single common scale: no per-segment scaling ever happens
    (``auto_scale=False``). The peak covers the real region only: neither
    the zero tail of the last segment nor the channels padded to the data
    axis.
    """
    x = np.asarray(x, np.float32)
    if x.ndim == 1:
        y, peak = sharded_filter_streamed(x[None, :], plan, mesh,
                                          segment_len, progress_cb)
        return y[0], peak
    c, n = x.shape
    if n == 0:
        return x.copy(), 0.0
    if not mesh.is_local(process_info()[0]):
        raise ValueError("sharded_filter_streamed needs a mesh of this "
                         "process's cells")
    d, t = mesh.shape
    mo2, quantum = plan.mo2, t * plan.hop
    seg = segment_len or default_segment_len(plan, channels=c)
    seg = max(1, -(-seg // quantum)) * quantum
    if t > 1 and seg // t < mo2:
        seg = -(-mo2 * t // quantum) * quantum

    cp = -(-c // d) * d
    if cp != c:
        # Channels pad once to the data axis (tiny for realistic meshes);
        # the time axis is never padded whole: each segment assembles its
        # own edge-padded staging buffers.
        x_in = np.zeros((cp, n), np.float32)
        x_in[:c] = x
    else:
        x_in = x

    cd, sh = cp // d, seg // t
    dev0 = mesh.cells[0][0].device

    def dispatch(s, e, buffer):
        # Each cell's shard is staged on its own, so that every upload
        # reads one contiguous pinned buffer.
        shards = {}
        for i in range(d):
            for j in range(t):
                shard = buffer(("shard", i, j), (cd, sh), torch.float32)
                _stage(shard, x_in[i * cd : (i + 1) * cd], s + j * sh)
                shards[(i, j)] = _upload(shard, mesh.cells[i][j].device)
        left, right = (
            _upload(_stage(buffer(side, (cp, mo2), torch.float32), x_in, g0),
                    dev0)
            for side, g0 in (("left", s - mo2), ("right", s + seg)))
        valid = (c, e - s)
        parts, peaks = sharded_conv._filter_cells(shards, plan, mesh, (cp, seg),
                                                  left, right, valid)
        y = sharded_conv._join(parts, mesh, (cp, seg), valid)
        return y, torch.stack([p.to(dev0) for p in peaks]).amax()

    out = np.empty((c, n), dtype=np.float32)
    return out, _pipelined(_segments(n, seg), dispatch, out, dev0, progress_cb)
