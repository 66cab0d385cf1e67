"""The port's span log: where a call's host time goes, on the host clock.

Tracing is on exactly while a torch profiler records anywhere in the
process (``torch.autograd.profiler._is_profiler_enabled``, a process-wide
flag that the profiler sets on start and clears on stop). There is no other
switch.

- Off, :func:`span` returns one shared no-op context: one attribute read,
  no clock read, nothing recorded.
- On, a span records ``(id, parent, name, thread, start_ns, end_ns,
  attrs)`` on ``time.perf_counter_ns()``. Its parent is the innermost span
  open on the same thread, or the id given as ``parent=``, which carries a
  request's identity across a hand-off between threads (the
  ``MicroBatcher`` collector to its flush workers). Records go to a
  bounded in-memory log (:data:`CAPACITY` spans); once it is full, spans are
  dropped and counted (:func:`dropped`) until :func:`clear`.
- Each span also opens a profiler range of its name
  (``torch._C._profiler._RecordFunctionFast``), on a thread that a profiler
  records and nowhere else: the thread that started it, or every thread
  when it was started with ``experimental_config=torch._C._profiler.
  _ExperimentalConfig(profile_all_threads=True)``. The span then shows in
  the profiler's Chrome trace on that thread, as an operator (category
  ``cpu_op``). On a thread that is not recorded the range costs a check and
  no more; ``torch.profiler.record_function`` and the direct binding under
  it open a range on every thread, recorded or not, which cost two flush
  workers issuing at once 2.7 ms of a 15 ms segmented search on an H100
  host. The log itself holds every thread's spans either way.

Readers (the benchmark's metrics) call :func:`spans`, :func:`dropped` and
:func:`clear` after the measured window; nothing is written out before.

Names in use: ``batcher.window``, ``batcher.scan``, ``batcher.deliver``
(:mod:`~innr_tpu_torch.serving`); ``index.call``, ``index.to_device``,
``index.segment``, ``index.merge``, ``index.to_host``
(:mod:`~innr_tpu_torch.batch`, :mod:`~innr_tpu_torch.segmented`);
``dispatch.k1_pass``
(:mod:`~innr_tpu_torch.kernels.knn`, with the pass's re-scored-pair device
counter as ``rescored`` on the card).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

__all__ = ["Span", "span", "on", "current_id", "spans", "dropped", "clear", "CAPACITY"]

CAPACITY = 1 << 20


class Span(NamedTuple):
    """One finished span; times on ``time.perf_counter_ns()``."""

    id: int
    parent: int | None
    name: str
    thread: int
    start_ns: int
    end_ns: int
    attrs: dict


class _Off:
    """The span returned while tracing is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Log:
    """The bounded span log. A record is kept by one ``list.append``, which
    the interpreter lock makes atomic; a drop, rare, takes a lock."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.records: list = []
        self.dropped = 0
        self.dropped_starts = (None, None)  # (earliest, latest) start of a dropped span
        self.ids = itertools.count(1)
        self.local = threading.local()
        self.lock = threading.Lock()

    def add(self, rec: tuple) -> None:
        if len(self.records) < self.capacity:
            self.records.append(rec)
            return
        start = rec[4]
        with self.lock:
            self.dropped += 1
            lo, hi = self.dropped_starts
            self.dropped_starts = (start if lo is None else min(lo, start),
                                   start if hi is None else max(hi, start))

    def stack(self) -> list:
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = []
            return self.local.stack


_LOG = _Log(CAPACITY)


class _On:
    """A span while tracing is on."""

    __slots__ = ("id", "parent", "name", "attrs", "start_ns", "_range")

    def __init__(self, name: str, parent, attrs: dict):
        self.id = next(_LOG.ids)
        self.parent = parent
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        stack = _LOG.stack()
        if self.parent is None and stack:
            self.parent = stack[-1].id
        stack.append(self)
        self._range = _RecordFunctionFast(self.name)
        self._range.__enter__()
        # After the range's own stamp, as a caller stamps after entering a
        # record_function: the two copies of a span then agree.
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self._range.__exit__(None, None, None)
        stack = _LOG.stack()
        if stack and stack[-1] is self:
            stack.pop()
        _LOG.add((self.id, self.parent, self.name, threading.get_ident(), self.start_ns, end,
                  self.attrs))
        return False

    def set(self, **attrs) -> None:
        """Adds attributes to the span (known only once it has begun)."""
        self.attrs.update(attrs)


def on() -> bool:
    """Whether spans are recorded now: a torch profiler records somewhere in
    the process."""
    return _profiler._is_profiler_enabled


def span(name: str, parent: int | None = None, **attrs):
    """A context manager that records ``name`` from entry to exit while
    tracing is on (see the module docstring); the shared no-op otherwise.
    ``parent``: a span id from another thread (:func:`current_id`), else
    the innermost open span of this thread."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _On(name, parent, attrs)


def current_id() -> int | None:
    """The id of the innermost span open on this thread, or None."""
    stack = _LOG.stack()
    return stack[-1].id if stack else None


def spans(t0_ns: int | None = None, t1_ns: int | None = None) -> list:
    """The logged spans whose start lies in ``[t0_ns, t1_ns]`` (either end
    open when None), in the order they ended, as :class:`Span` records."""
    lo = -1 if t0_ns is None else t0_ns
    hi = float("inf") if t1_ns is None else t1_ns
    return [Span(*r) for r in list(_LOG.records) if lo <= r[4] <= hi]


def dropped(t0_ns: int | None = None, t1_ns: int | None = None) -> int:
    """Spans dropped since :func:`clear` because the log was full. With a
    range: that count if a dropped span may have started in ``[t0_ns,
    t1_ns]`` (the range of the dropped spans' starts meets it), else 0."""
    lo, hi = _LOG.dropped_starts
    if lo is None:
        return 0
    if (t0_ns is not None and hi < t0_ns) or (t1_ns is not None and lo > t1_ns):
        return 0
    return _LOG.dropped


def clear() -> None:
    """Empties the log and its dropped count (open spans are kept)."""
    with _LOG.lock:
        _LOG.records = []
        _LOG.dropped = 0
        _LOG.dropped_starts = (None, None)
