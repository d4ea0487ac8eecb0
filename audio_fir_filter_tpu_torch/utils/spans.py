"""Spans: named host-clock intervals at the program's layer boundaries.

    with span("segment.launch") as s:
        if s:                        # recording: build the info only then
            s.set(chunks=6, kernels=18)
        ...

A recorded span holds its name, its start and end on the host clock
(``time.perf_counter_ns``, the clock of ``time.perf_counter``), its parent
(the span open around it on the same thread), a call id (the id of the
outermost span open on that thread when it started, so every span of one
call into the program shares it) and its ``info``. Recorded spans go to
one bounded store in memory, the oldest dropped first, and are read back
with :func:`spans`. While a ``torch.profiler`` profile is active a span
also enters the profiler's fast record function ``lowcut.<name>``
(``cpu_op`` in a Chrome trace; about 1-2 us, a tenth of
``torch.profiler.record_function``), so the trace shows it on the trace's
own clock beside the kernels it launched.

Recording is on while a ``torch.profiler`` profile is active, and inside
``recording(True)``; ``recording(False)`` turns it off even under a
profiler. Off, :func:`span` tests the switch and returns the shared
:data:`NULL` span: it allocates nothing and enters no record function;
``NULL`` is false, ``NULL.seconds`` is None and ``NULL.set`` and
``NULL.end`` do nothing. :func:`timed` is a span that measures its host
seconds whether recording is on or not, and is recorded only when it is.

Names follow the program's layers: ``filter`` (one call of the overlap-save
filters), ``segment.prepare`` and ``segment.launch`` (the segment kernel's
wrapper before and around its C entry point), and ``stage.<name>`` (the
stages of one file in the pipeline).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import marshal
import threading
import time

from torch.autograd import profiler as _profiler

try:
    from torch._C._profiler import _RecordFunctionFast as _mark
except ImportError:     # a torch without it: the public, slower one
    from torch.profiler import record_function as _mark

PREFIX = "lowcut."
# Spans the store holds: three a filter call, so about 43,000 calls.
MAX_SPANS = 1 << 17

_store: collections.deque = collections.deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
_local = threading.local()
# Open bodies of recording(False) and recording(True), for all threads.
_forced = [0, 0]
_lock = threading.Lock()
# None: record while a torch.profiler profile is active; True / False:
# always / never (while a recording(...) body is open; off wins).
_mode: bool | None = None


class _Null:
    """The span handed out while recording is off: it records nothing."""

    __slots__ = ()
    seconds = None

    def __bool__(self) -> bool:
        return False

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **info) -> None:
        pass

    def end(self) -> None:
        pass


NULL = _Null()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One span; enter it once. ``kept``: recorded (in the store, the
    trace and the parent chain), else only timed."""

    __slots__ = ("name", "info", "id", "parent", "call", "t0_ns", "t1_ns",
                 "_mark", "_kept")

    def __init__(self, name: str, kept: bool = True) -> None:
        self.name = name
        self.info = {}
        self.t1_ns = None
        self._mark = None
        self._kept = kept

    def __enter__(self) -> "Span":
        if self._kept:
            stack = _stack()
            outer = stack[-1] if stack else None
            self.id = next(_ids)
            self.parent = outer.id if outer else None
            self.call = outer.call if outer else self.id
            stack.append(self)
            if _profiler._is_profiler_enabled:
                self._mark = _mark(PREFIX + self.name)
                self._mark.__enter__()
        self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end()
        return False

    def end(self) -> None:
        """End the span here, before its ``with`` block does; the block's
        end then changes nothing. Call it from the innermost open span."""
        if self.t1_ns is not None:
            return
        self.t1_ns = time.perf_counter_ns()
        if self._kept:
            if self._mark is not None:
                self._mark.__exit__(None, None, None)
                self._mark = None
            _stack().pop()
            # Kept as bytes, which the garbage collector does not count: a
            # store of tuples and dicts would make it run more often, and
            # its passes longer, while the program records.
            _store.append(marshal.dumps((self.name, self.id, self.parent, self.call,
                                         self.t0_ns, self.t1_ns, self.info)))

    def set(self, **info) -> None:
        """Add ``info`` known only once the span is open: plain values
        (str, int, float, bool, None)."""
        self.info.update(info)

    @property
    def seconds(self) -> float | None:
        """Host seconds from start to end; None while the span is open."""
        return None if self.t1_ns is None else (self.t1_ns - self.t0_ns) / 1e9


def _on() -> bool:
    on = _mode
    return _profiler._is_profiler_enabled if on is None else on


def span(name: str):
    """A context manager around the work of ``name``: a :class:`Span` when
    recording is on, else :data:`NULL`. Give it its info with ``set``."""
    return Span(name) if _on() else NULL


def timed(name: str) -> Span:
    """A :class:`Span` of ``name`` that always measures its ``seconds``,
    and is recorded only when recording is on."""
    return Span(name, _on())


@contextlib.contextmanager
def recording(on: bool = True):
    """Record every span while the body runs (``on``), or none, a profiler
    or not. One setting for every thread: while bodies of both kinds are
    open, off wins; when the last body ends, spans are recorded under a
    profiler again."""

    def settle(step: int) -> None:
        global _mode
        with _lock:
            _forced[on] += step
            _mode = False if _forced[False] else (True if _forced[True] else None)

    settle(1)
    try:
        yield
    finally:
        settle(-1)


def spans() -> list[dict]:
    """The recorded spans in the order they ended, oldest first: ``name``,
    ``id``, ``parent`` (None for an outermost span), ``call``, ``t0_ns``,
    ``t1_ns`` (``time.perf_counter_ns``) and ``info``."""
    keys = ("name", "id", "parent", "call", "t0_ns", "t1_ns", "info")
    return [dict(zip(keys, marshal.loads(s))) for s in list(_store)]


def clear() -> None:
    """Drop every recorded span."""
    _store.clear()
