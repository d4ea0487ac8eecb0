"""``wrapper.host_us_per_call``: the median host duration of the program's
``filter`` span over the window's calls, on the host clock (recorded
under the traced window's profiler, so it holds the spans' own cost,
about 4 us a span there, and the profiler's own cost of each launch). The note gives the medians of its
``segment.prepare`` and ``segment.launch`` spans."""

from . import _program_spans as ps


def _median_us(cs, name):
    m = ps.median(b - a for c in cs for a, b in c["spans"].get(name, []))
    return "none" if m is None else f"{m:.3f} us"


def read(rec):
    cs = ps.calls(rec)
    if not cs:
        return None
    return {"value": ps.median(c["host_us"] for c in cs),
            "note": f"{len(cs)} calls; medians: prepare "
                    f"{_median_us(cs, 'segment.prepare')}, launch "
                    f"{_median_us(cs, 'segment.launch')}"}
