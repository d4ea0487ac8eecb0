"""What a run records for the metric readers, and the context a traffic
kind works in.

The window's jobs (latency and audio samples), the harness's own spans
around each call into the program (host clock, and a ``record_function``
of the same name and id when the run is traced), and after a traced
window the parsed trace. Nothing is recorded
outside the window: set-up and warm-up run with recording off.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from pathlib import Path


class Record:
    def __init__(self, cfg: dict | None = None) -> None:
        self.cfg = cfg or {}
        self.on = False
        self.tracing = False
        self.jobs: list[dict] = []
        self.spans: list[dict] = []
        self.setup_s = 0.0
        self.window_s = 0.0
        self.trace = None
        self._ids = 0

    def job(self, latency_s: float, samples: int, clock: str = "host") -> None:
        """One finished job: ``latency_s`` on the ``clock`` it was read
        from ("host" or "device"), and the audio samples it filtered."""
        if self.on:
            self.jobs.append({"latency_s": latency_s, "samples": samples,
                              "clock": clock})

    @contextlib.contextmanager
    def span(self, name: str, **info):
        """Host-clock span ``name`` around a call into the program; traced
        as ``cardbench.<name>#<id>``. ``info`` holds the work it covers."""
        if not self.on:
            yield
            return
        self._ids += 1
        sid = self._ids
        label = f"cardbench.{name}#{sid}"
        if self.tracing:
            from torch.profiler import record_function
            cm = record_function(label)
        else:
            cm = contextlib.nullcontext()
        t0 = time.perf_counter()
        with cm:
            yield
        self.spans.append({"name": name, "id": sid, "label": label, "t0": t0,
                           "t1": time.perf_counter(), **info})

    def spans_named(self, name: str) -> list[dict]:
        return [s for s in self.spans if s["name"] == name]


@dataclasses.dataclass
class Ctx:
    """A run's fixed inputs: the configuration and the cell's parameters
    (both as read from their files), the seed, the device, a scratch
    directory under ``TMPDIR``, and the record."""

    cfg: dict
    params: dict
    limits: dict
    seed: int
    device: object
    workdir: Path
    rec: Record
