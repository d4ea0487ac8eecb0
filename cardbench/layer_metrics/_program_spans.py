"""What the layer readers of the host wrapper and of the kernel boundaries
share: the program's own spans, call by call, and the card's idle time
in the traced window split into kernel boundaries, the host wrapper and
the caller.

The program's spans come from ``audio_fir_filter_tpu_torch.utils.spans``
(recorded while the profiler of a traced window is active): an outermost
``filter`` span a call, with its ``segment.prepare`` and
``segment.launch`` children. Each is matched to the harness's ``filter``
span whose host interval holds it; that span's start and end on the host
clock (``Record.spans``) and on the trace's clock (``rec.trace.spans``)
give the offset that carries the program's spans, on the same host clock,
onto the trace's clock, call by call. A program without that module, or
a window in which it recorded nothing, gives no calls and no split.

Idle time: each gap between device operations in the window is queued
from the host launch of the operation that ends it (the launch times
``cardbench/trace.py`` parses per kernel), and not queued before it; an
operation whose launch is not in the trace ends a gap that was not queued
at all. The split (:func:`split`):

- boundary: the queued part of each gap that ends at a kernel launched
  inside a ``segment.launch`` span, other than the first kernel launched
  there: the card waiting between two passes of the C entry point's loop
  that were both already queued;
- wrapper: the rest of the idle time while the host was inside a
  ``filter`` span: nothing queued, or the launch latency of the call's
  first kernels (the peak's fill, the first pass);
- caller: the rest, outside the program's spans.

Times here are microseconds.
"""

from __future__ import annotations

import bisect
import math
import statistics
from collections import defaultdict

from ..trace import union


def recorded() -> list[dict]:
    """The program's recorded spans; none for a program without them."""
    try:
        from audio_fir_filter_tpu_torch.utils import spans
    except ImportError:
        return []
    return spans.spans()


def calls(rec) -> list[dict]:
    """The window's program calls, in order: ``host_us`` (the ``filter``
    span's host duration), ``spans`` (the call's spans by name: a list of
    ``(start, end)`` on the trace's clock, or on the host's when the call
    has no ``offset_us``), ``launches`` (its ``segment.launch`` spans as
    ``(start, end, kernels)``, on the same clock), ``offset_us`` (trace
    minus host clock, None without a trace) and ``kernels`` (the sum of
    its launches' kernels)."""
    got = recorded()
    roots = sorted((s for s in got if s["parent"] is None and s["name"] == "filter"),
                   key=lambda s: s["t0_ns"])
    starts = [s["t0_ns"] for s in roots]
    members = defaultdict(list)
    for s in got:
        members[s["call"]].append(s)
    trace_spans = rec.trace.spans if rec.trace is not None else {}
    out = []
    for h in rec.spans_named("filter"):
        i = bisect.bisect_left(starts, h["t0"] * 1e9)
        if i == len(roots) or roots[i]["t1_ns"] > h["t1"] * 1e9:
            continue
        root = roots[i]
        offset = None
        if h["label"] in trace_spans:
            a, b = trace_spans[h["label"]]
            offset = ((a - h["t0"] * 1e6) + (b - h["t1"] * 1e6)) / 2
        by_name = defaultdict(list)
        launches = []
        for s in members[root["call"]]:
            iv = (s["t0_ns"] / 1e3 + (offset or 0.0), s["t1_ns"] / 1e3 + (offset or 0.0))
            by_name[s["name"]].append(iv)
            if s["name"] == "segment.launch":
                launches.append((*iv, s["info"].get("kernels", 0)))
        out.append({"host_us": (root["t1_ns"] - root["t0_ns"]) / 1e3,
                    "spans": dict(by_name), "launches": launches,
                    "offset_us": offset, "kernels": sum(k for _, _, k in launches)})
    return out


def overlap(xs, ys) -> float:
    """Length of the intersection of two merged, sorted interval lists."""
    i = j = 0
    tot = 0.0
    while i < len(xs) and j < len(ys):
        a, b = xs[i]
        c, d = ys[j]
        tot += max(0.0, min(b, d) - max(a, c))
        if b < d:
            i += 1
        else:
            j += 1
    return tot


def gaps(trace) -> dict | None:
    """The window's length and its idle gaps, in order, as ``(start,
    queued_from, end)``: ``end`` is where the next operation starts (or
    the window ends), ``queued_from`` the host launch of that operation
    held inside the gap (``end`` when it was not launched in the trace).
    None without a traced window."""
    w = trace.window() if trace is not None else None
    if w is None or w[1] <= w[0]:
        return None
    lo, hi = w
    launched = {}
    for at, a, _ in trace._kernels:     # (host launch, start, end)
        launched[a] = min(launched.get(a, at), at)
    busy = union((a, b) for _, _, a, b, _ in trace.ops)
    out, edge = [], lo
    for a, b in busy + [(math.inf, math.inf)]:
        if a > edge:
            end = min(a, hi)
            out.append((edge, min(max(launched.get(a, a), edge), end), end))
        edge = max(edge, b)
        if edge >= hi:
            break
    return {"window": hi - lo, "gaps": out}


def boundary_kernels(trace, cs) -> tuple[set, int, int]:
    """``(starts, boundaries, exact)``: the device start of every kernel
    launched inside a ``segment.launch`` span of calls ``cs`` other than
    the span's first; their number; and the launch spans in which the
    trace holds exactly the span's ``kernels``."""
    at = trace._kernel_at
    starts, exact = set(), 0
    for c in cs:
        for t0, t1, k in c["launches"]:
            i, j = bisect.bisect_left(at, t0), bisect.bisect_right(at, t1)
            starts.update(a for _, a, _ in trace._kernels[i + 1:j])
            exact += j - i == k
    return starts, len(starts), exact


def split(rec) -> dict | None:
    """The traced window's idle time split as the module says: ``window``,
    ``idle``, ``boundary``, ``wrapper``, ``caller`` (lengths); the
    wrapper's part in ``segment.prepare`` and ``segment.launch`` and its
    queued part (``wrapper_prepare``, ``wrapper_launch``,
    ``wrapper_queued``); ``boundaries`` (kernels that end a boundary),
    ``exact`` (launch spans whose kernels the trace holds exactly),
    ``launch_spans``; and the ``calls``. None without a traced window or
    without the program's spans in it."""
    parts = gaps(rec.trace)
    cs = [c for c in calls(rec) if c["offset_us"] is not None]
    if parts is None or not cs:
        return None
    starts, boundaries, exact = boundary_kernels(rec.trace, cs)
    boundary, rest, queued = 0.0, [], []
    for s, q, e in parts["gaps"]:
        if e in starts:
            boundary += e - q
            e = q
        elif q < e:
            queued.append((q, e))
        if s < e:
            rest.append((s, e))

    def inside(name):
        return union(iv for c in cs for iv in c["spans"].get(name, []))

    filt = inside("filter")
    wrapper = overlap(rest, filt)
    idle = sum(e - s for s, _, e in parts["gaps"])
    return {"window": parts["window"], "idle": idle, "boundary": boundary,
            "wrapper": wrapper, "caller": idle - boundary - wrapper,
            "wrapper_prepare": overlap(rest, inside("segment.prepare")),
            "wrapper_launch": overlap(rest, inside("segment.launch")),
            "wrapper_queued": overlap(queued, filt), "boundaries": boundaries,
            "exact": exact, "launch_spans": sum(len(c["launches"]) for c in cs),
            "calls": cs}


def median(values) -> float | None:
    values = list(values)
    return statistics.median(values) if values else None
