"""``kernel.boundary_idle_share``: the share of the traced window in which
the card was idle between two passes of the segment kernel's C entry
point that were both already queued: the queued part of each gap that
ends at a kernel launched inside the program's ``segment.launch`` span,
other than the first kernel launched there (``_program_spans.split``).
The note gives the kernels a call issued (the spans' ``kernels``), the
boundaries that ended a gap and the idle time per boundary."""

from . import _program_spans as ps


def read(rec):
    got = ps.split(rec)
    if got is None:
        return None
    per_call = sorted({c["kernels"] for c in got["calls"]})
    n = got["boundaries"]
    each = f"{got['boundary'] / n:.3f} us a boundary" if n else "no boundary"
    return {"value": 100.0 * got["boundary"] / got["window"],
            "note": f"{got['boundary'] / 1e6:.6f} s over {len(got['calls'])} calls of "
                    f"{'/'.join(map(str, per_call))} kernels; {n} boundaries "
                    f"in the trace, {each}; {got['exact']} of {got['launch_spans']} launch "
                    "spans hold exactly their kernels in the trace"}
