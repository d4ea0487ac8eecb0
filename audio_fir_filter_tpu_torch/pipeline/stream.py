"""Host <-> device streaming of long signals through the plan's kernel.

Counterpart of ``audio_fir_filter_tpu/pipeline/stream.py``: one device, and
a mesh of cells (:func:`sharded_filter_streamed`).
The time axis is cut into segments; each segment is filtered with
kernel-length halos taken from its neighbours in host memory, so segment
seams are exact and only the true signal edges are zero-padded. The output
peak comes back with each segment (from the segment kernel, or reduced on
the device on the block path), over that segment's valid samples only.

Host <-> device copies are synchronous: each segment is copied up,
filtered and copied back before the next. Overlapping them (pinned buffers,
a side stream) is open work in ROADMAP.md.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import overlap_save as osv
from ..ops import segment_filter as sf
from ..parallel.sharded_conv import sharded_filter


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


def _edge_slice(x: np.ndarray, g0: int, g1: int) -> np.ndarray:
    """x[:, g0:g1] with zeros outside [0, N) — one segment-sized buffer."""
    c, n = x.shape
    s0, s1 = max(0, g0), min(n, g1)
    if s0 == g0 and s1 == g1:
        return x[:, g0:g1]  # interior segment: a view, no copy
    buf = np.zeros((c, g1 - g0), dtype=x.dtype)
    buf[:, s0 - g0 : s1 - g0] = x[:, s0:s1]
    return buf


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _segments(n: int, seg: int):
    for s in range(0, n, seg):
        yield s, min(n, s + seg)


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
    if x.ndim == 1:
        y, peak = filter_array_streamed(x[None, :], plan, segment_len,
                                        progress_cb)
        return y[0], peak
    x = np.asarray(x, dtype=np.float32)
    c, n = x.shape
    if n == 0:
        return x.copy(), 0.0
    seg = segment_len or default_segment_len(plan, channels=c)
    if n <= seg:
        # Single segment: the edge zero padding happens inside the kernel.
        y, peak = osv.same_filter_peak(_to_device(x, plan.device), plan)
        if progress_cb:
            progress_cb(c * n)
        return y.cpu().numpy(), float(peak)

    mo2 = plan.mo2
    out = np.empty((c, n), dtype=np.float32)
    peak = 0.0
    for s, e in _segments(n, seg):
        xe = _to_device(_edge_slice(x, s - mo2, e + mo2), plan.device)
        yj, pj = osv.extended_filter_peak(xe, plan, e - s)
        out[:, s:e] = yj.cpu().numpy()
        peak = max(peak, float(pj))
        if progress_cb:
            progress_cb(c * (e - s))
    return out, peak


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
    16-bit mode does not take (it needs a 'fast' plan of the segment
    kernel's engine, ``pallas``, and a qualifying shape)."""
    if (plan.engine != osv.PALLAS or plan.precision != osv.FAST
            or not sf.qualifies(plan.num_taps, plan.block_size)):
        raise ValueError(
            "16-bit-native filtering needs a 'fast' plan of the 'pallas' "
            f"engine that the segment filter takes; got engine={plan.engine!r}, "
            f"precision={plan.precision!r}, num_taps={plan.num_taps}, "
            f"B={plan.block_size}")
    if x16.ndim == 1:
        y, p, sat = filter_array_streamed_i16(x16[None, :], plan,
                                              segment_len, progress_cb)
        return y[0], p, sat
    if x16.dtype != np.int16:
        raise TypeError(f"expected int16 PCM, got {x16.dtype}")
    c, n = x16.shape
    if n == 0:
        return x16.copy(), 0, False

    seg = segment_len or default_segment_len(plan, channels=c)
    mo2 = plan.mo2
    out = np.empty((c, n), dtype=np.int16)
    peak = 0
    for s, e in _segments(n, seg):
        if s == 0 and e == n:
            xe, left = _to_device(x16, plan.device), mo2
        else:
            xe = _to_device(_edge_slice(x16, s - mo2, e + mo2), plan.device)
            left = 0
        yj, pj = sf.segment_filter(xe, plan, left, e - s, i16_io=True)
        out[:, s:e] = yj.cpu().numpy()
        peak = max(peak, int(pj))
        if progress_cb:
            progress_cb(c * (e - s))
    return out, peak, peak >= 32767


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

    out = np.empty((c, n), dtype=np.float32)
    peak = 0.0
    for s, e in _segments(n, seg):
        yj, pj = sharded_filter(
            _edge_slice(x_in, s, s + seg), plan, mesh,
            edge_left=_edge_slice(x_in, s - mo2, s),
            edge_right=_edge_slice(x_in, s + seg, s + seg + mo2),
            auto_scale=False, valid=(c, e - s))
        out[:, s:e] = yj[:c, : e - s].cpu().numpy()
        peak = max(peak, pj)
        if progress_cb:
            progress_cb(c * (e - s))
    return out, peak
