"""Console progress reporting.

Reimplementation of the reference's progress subsystem
(the reference's ProgressBar.h). The reference updates a bar from N worker
threads through an atomic counter + mutex (`ThreadSafeProgress`,
ProgressBar.h:58-82) because its hot loop runs on host threads. Here the hot
loop runs on the device, so progress is driven by host-side *block completion*
counts — far coarser-grained — but the console UX is kept identical:
an 80-char ``[====>   ] 42.0 %`` bar redrawn periodically, with a
``[=====] 100.0 %`` final line (ProgressBar.h:34-54).
"""

from __future__ import annotations

import sys
import threading


class ProgressBar:
    """80-char console progress bar.

    Unlike the reference (which counts individual samples and redraws every
    ``interval`` counts, ProgressBar.h:18-47), we count arbitrary work units
    (samples) and redraw whenever the rendered bar or percentage would
    change, or at most every ``interval`` report calls.
    """

    def __init__(self, goal: float, interval: int = 1, bar_width: int = 80,
                 stream=None, enabled: bool = True):
        self._goal = max(float(goal), 1.0)
        self._interval = max(int(interval), 1)
        self._bar_width = int(bar_width)
        self._step = 0.0
        self._counter = 0
        self._last_pos = -1
        self._last_pct = -1.0
        self._stream = stream if stream is not None else sys.stdout
        self._enabled = enabled and (stream is not None or sys.stdout.isatty())

    def update(self, n: float = 1.0) -> None:
        self._step += n
        self._counter += 1
        if self._counter < self._interval:
            return
        self._counter = 0
        self._draw()

    def _draw(self) -> None:
        if not self._enabled:
            return
        progress = min(self._step / self._goal, 1.0)
        pos = int(round(self._bar_width * progress))
        pct = round(progress * 100, 1)
        if pos == self._last_pos and pct == self._last_pct:
            return
        self._last_pos, self._last_pct = pos, pct
        bar = "=" * pos + ">" + " " * (self._bar_width - pos)
        self._stream.write(f"\r[{bar}] {pct:.1f} %  ")
        self._stream.flush()

    def set_progress(self, step: float) -> None:
        """Set the absolute completed count and redraw immediately.

        Public API for adapters that track their own counter (e.g.
        :class:`ThreadSafeProgress`) rather than accumulating via
        :meth:`update`."""
        self._step = float(step)
        self._counter = 0
        self._draw()

    def final(self) -> None:
        # Reference prints a full bar with one extra '=' (ProgressBar.h:49-52).
        if not self._enabled:
            return
        self._stream.write("\r[" + "=" * (self._bar_width + 1) + "] 100.0 %        \n")
        self._stream.flush()

    def clear(self) -> None:
        self._step = 0.0


class ThreadSafeProgress:
    """Thread-safe adapter over :class:`ProgressBar`.

    Kept for API parity with the reference (ProgressBar.h:58-82) and used
    when multiple host I/O workers report concurrently. Batches reports and
    takes the lock only every ``max(total/100, 1000)`` units, matching the
    reference's contention-avoidance rule (ProgressBar.h:63). One lock is
    held across the counter update AND the redraw (as the reference holds
    its mutex across the whole refresh, ProgressBar.h:70-79), so an
    interleaved reporter can never draw a stale total.
    """

    def __init__(self, bar: ProgressBar, total: int):
        self._bar = bar
        self._total = max(int(total), 1)
        self._report_interval = max(self._total // 100, 1000)
        self._lock = threading.Lock()
        self._counter = 0

    def report(self, count: int) -> None:
        with self._lock:
            old = self._counter
            self._counter = new = old + count
            if ((new // self._report_interval) > (old // self._report_interval)
                    or new >= self._total):
                self._bar.set_progress(new)
