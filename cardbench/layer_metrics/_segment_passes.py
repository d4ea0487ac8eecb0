"""What the readers of the segment kernel's passes share: the program's
``segment.launch`` spans of the window's calls, each with its info (the
split it ran, the pairs it filtered, pass 1's ring) and the device time
of each pass it launched.

A launch span is placed on the trace's clock as ``_program_spans.calls``
places it, by the offset of its call's harness ``filter`` span; its info
is found again by its start on the host clock. Its kernels are those
whose host launch the trace holds inside it (as
``_program_spans.boundary_kernels`` finds them), each taken to its pass
by its name. A program whose launch spans carry no ``pairs`` (one older
than these fields) gives no launches here, and the readers then read
nothing. Times are microseconds.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from . import _program_spans as ps

PASSES = ("cols_forward", "rows_multiply", "cols_inverse")
# Host starts of one span, on the host clock and carried there and back
# through the trace's clock, differ by float rounding alone.
_SAME_US = 0.01


def launches(rec) -> list[dict]:
    """The window's ``segment.launch`` spans that carry ``pairs``, in
    order: ``t0``, ``t1`` (trace clock), ``info`` and ``passes`` (device
    us of each of :data:`PASSES` launched in the span). Empty without a
    traced window or without such spans."""
    if rec.trace is None:
        return []
    mine = sorted(((s["t0_ns"] / 1e3, s["info"]) for s in ps.recorded()
                   if s["name"] == "segment.launch" and "pairs" in s["info"]),
                  key=lambda s: s[0])
    if not mine:
        return []
    starts = [t for t, _ in mine]
    trace = rec.trace
    names = {(a, b): name for cat, name, a, b, _ in trace.ops if cat == "kernel"}
    out = []
    for c in ps.calls(rec):
        if c["offset_us"] is None:
            continue
        for t0, t1, _ in c["launches"]:
            host = t0 - c["offset_us"]
            i = bisect.bisect_left(starts, host - _SAME_US)
            if i == len(starts) or starts[i] > host + _SAME_US:
                continue
            i0 = bisect.bisect_left(trace._kernel_at, t0)
            i1 = bisect.bisect_right(trace._kernel_at, t1)
            passes = defaultdict(float)
            for _, a, b in trace._kernels[i0:i1]:
                for p in PASSES:
                    if p in names.get((a, b), ""):
                        passes[p] += b - a
            out.append({"t0": t0, "t1": t1, "info": mine[i][1],
                        "passes": dict(passes)})
    return out


def split_note(ls) -> str:
    """The splits and pass 1 ring depths the launches ran, as ``10x9 (ring
    2)``, each once."""
    got = sorted({(s["info"].get("log_n1"), s["info"].get("log_n2"),
                   s["info"].get("pass1_ring")) for s in ls})
    return ", ".join(f"{a}x{b} (ring {r})" for a, b, r in got)


def us_per_pair(ls) -> dict:
    """Each pass's device us over the pairs of the launches that ran it:
    the window's totals."""
    pairs = sum(s["info"]["pairs"] for s in ls)
    return {p: sum(s["passes"].get(p, 0.0) for s in ls) / pairs
            for p in PASSES} if pairs else {}
