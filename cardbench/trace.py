"""Reading a ``torch.profiler`` Chrome trace of the window.

Device operations are the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events. A kernel belongs to a harness span
(``cardbench.<name>#<id>``, a ``user_annotation``) when the host call that
launched it, found by its correlation id, lies inside the span; a kernel
whose launch is not in the trace belongs to the span in which it started
(every harness span around a filter call ends after the card has
finished). Times in the trace are microseconds; everything here returns
seconds.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def union(intervals) -> list[tuple[float, float]]:
    """Merged, sorted [start, end) intervals."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(merged, lo: float, hi: float) -> float:
    """Length of ``merged`` (from :func:`union`) inside [lo, hi)."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merged)


class Trace:
    def __init__(self, events: list[dict]) -> None:
        self.ops = []          # (cat, name, start_us, end_us, correlation)
        self.spans = {}        # label -> (start_us, end_us)
        launches = {}
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                self.ops.append((cat, e.get("name", "?"), ts, ts + dur, corr))
            elif cat in LAUNCH_CATS and corr is not None:
                launches[corr] = ts
            elif cat == "user_annotation" and e.get("name", "").startswith("cardbench."):
                self.spans[e["name"]] = (ts, ts + dur)
        # Kernels by the time of their launch on the host.
        self._kernels = sorted((launches.get(corr, a), a, b)
                               for cat, _, a, b, corr in self.ops if cat == "kernel")
        self._kernel_at = [k[0] for k in self._kernels]
        self.matched = sum(corr in launches for cat, _, _, _, corr in self.ops
                           if cat == "kernel")
        self._busy = union((a, b) for _, _, a, b, _ in self.ops)

    def summary(self) -> str:
        kernels = len(self._kernels)
        return (f"trace: {len(self.ops)} device operations, {kernels} kernels "
                f"({self.matched} matched to their host launch), "
                f"{len(self.spans)} harness spans")

    @classmethod
    def load(cls, path) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    def window(self) -> tuple[float, float] | None:
        for label, iv in self.spans.items():
            if label.startswith("cardbench.window"):
                return iv
        return None

    def busy_s(self) -> float:
        """Seconds in the window in which any device operation ran."""
        w = self.window()
        return covered(self._busy, *w) / 1e6 if w else 0.0

    def window_s(self) -> float:
        w = self.window()
        return (w[1] - w[0]) / 1e6 if w else 0.0

    def kernels_in(self, label: str) -> list[tuple[float, float]]:
        """[start, end) in microseconds of the kernels of span ``label``."""
        if label not in self.spans:
            return []
        lo, hi = self.spans[label]
        i = bisect.bisect_left(self._kernel_at, lo)
        j = bisect.bisect_right(self._kernel_at, hi)
        return [(a, b) for _, a, b in self._kernels[i:j]]

    def device_ops(self, top: int = 10) -> list[list]:
        """The device operations that took most time: [name, seconds]."""
        tot = defaultdict(float)
        for _, name, a, b, _ in self.ops:
            tot[name] += (b - a) / 1e6
        return [[n, s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """Idle device time in the window by what the host was doing: each
        gap between device operations is split over the harness spans it
        overlaps (they do not nest, the window aside), the rest goes to
        "host: outside any span"; [label, seconds], largest first."""
        w = self.window()
        if w is None:
            return []
        lo, hi = w
        inner = sorted((a, b, lab.split("#")[0]) for lab, (a, b) in self.spans.items()
                       if not lab.startswith("cardbench.window"))
        ends = [b for _, b, _ in inner]
        tot = defaultdict(float)
        edge = lo
        for a, b in self._busy + [(hi, hi)]:
            a, b = max(a, lo), min(b, hi)
            if a > edge:
                rest = a - edge
                i = bisect.bisect_right(ends, edge)
                while i < len(inner) and inner[i][0] < a:
                    s0, s1, name = inner[i]
                    part = min(a, s1) - max(edge, s0)
                    if part > 0:
                        tot[f"host: {name}"] += part / 1e6
                        rest -= part
                    i += 1
                tot["host: outside any span"] += max(rest, 0.0) / 1e6
            edge = max(edge, b)
        return [[n, s] for n, s in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]
