"""``wrapper.idle_share``: the share of the traced window in which the card
was idle, other than at a kernel boundary, while the host was inside the
program's ``filter`` span (``ops/overlap_save``'s filters, down to the
segment kernel's C entry point), placed on the trace's clock call by call
(``_program_spans.split``): nothing queued, or the launch latency of the
call's first kernels. The note splits it into ``segment.prepare``,
``segment.launch`` and the rest of the span, gives its queued part, and
the idle time outside both parts: the caller's."""

from . import _program_spans as ps


def read(rec):
    got = ps.split(rec)
    if got is None:
        return None
    w, prep, launch = got["wrapper"], got["wrapper_prepare"], got["wrapper_launch"]
    return {"value": 100.0 * w / got["window"],
            "note": f"{w / 1e6:.6f} s over {len(got['calls'])} calls: prepare "
                    f"{prep / 1e6:.6f} s, launch {launch / 1e6:.6f} s, rest "
                    f"{(w - prep - launch) / 1e6:.6f} s; queued (first launches) "
                    f"{got['wrapper_queued'] / 1e6:.6f} s; caller (neither a boundary "
                    f"nor in the span) {got['caller'] / 1e6:.6f} s, "
                    f"{100.0 * got['caller'] / got['window']:.4f} %"}
