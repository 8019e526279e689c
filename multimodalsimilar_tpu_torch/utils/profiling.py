"""Profiling helpers (counterpart of
multimodalsimilar_tpu/utils/profiling.py).

* ``trace(logdir)`` — a ``torch.profiler`` context (host and, with a
  card, device activity) whose trace is written to ``logdir`` as
  TensorBoard's profiler plugin reads it (``*.pt.trace.json``, also
  loadable in Perfetto), where the JAX package writes a ``jax.profiler``
  trace. Inside it every ``span`` is also a ``record_function`` range, so
  the trace shows the program's stages on the kernels' timeline.
* ``span(name)`` and ``count(name, n)`` — the program's own spans and
  counters, where the work happens (the similarity jobs, the embedders'
  stream, the Trainer and its prefetch). They record into every open
  record: one that ``recording()`` opens, and ``PROFILED``, which is
  opened afresh when a ``torch.profiler`` session starts (``trace``, or
  a profile any caller opens) and closed when it stops, so it holds the
  latest session's spans and counts. With no record open, ``span``
  returns one shared no-op after a flag check and ``count`` does nothing.
  A span is ``(name, parent, thread, start ns, end ns)``: the parent is
  the innermost span the same thread had open, and both ends are
  ``time.time_ns()``, the wall clock that ``torch.profiler``'s event
  times are on, so a span and a device interval compare directly.
* ``StepTimer`` — copied: a cheap steady-state throughput meter that
  skips warm-up steps and reports examples/sec from the median step.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import List, Optional

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

# PROFILED keeps at most this many spans (the newest), so a profile held
# open for a whole run cannot grow without bound
PROFILED_SPANS = 1 << 20

_RECORDS: tuple = ()        # the open records (replaced, never mutated)
_ANNOTATE = 0               # trace() contexts open
_LOCK = threading.Lock()
_LOCAL = threading.local()  # each thread's stack of open span names


class Record:
    """What the recorder kept: ``spans``, each ``(name, parent, thread,
    start ns, end ns)`` in the order they closed, and ``counters``."""

    def __init__(self, limit: Optional[int] = None):
        self.spans = collections.deque(maxlen=limit) if limit else []
        self.counters: collections.Counter = collections.Counter()


# the record of the latest torch.profiler session (None before the first)
PROFILED: Optional[Record] = None


def enabled() -> bool:
    """Whether ``span`` and ``count`` record now."""
    return bool(_RECORDS)


def _open(rec: Record) -> None:
    global _RECORDS
    with _LOCK:
        _RECORDS = _RECORDS + (rec,)


def _close(rec: Record) -> None:
    global _RECORDS
    with _LOCK:
        _RECORDS = tuple(r for r in _RECORDS if r is not rec)


def _follow_profiler() -> None:
    """Open a fresh ``PROFILED`` whenever a ``torch.profiler`` session
    starts and close it when the session stops, by wrapping the two
    functions that torch's profilers call at those points."""
    start = getattr(_autograd_profiler, "_run_on_profiler_start", None)
    stop = getattr(_autograd_profiler, "_run_on_profiler_stop", None)
    if start is None or stop is None:
        return

    def on_start():
        global PROFILED
        start()
        if PROFILED is not None:
            _close(PROFILED)
        PROFILED = Record(PROFILED_SPANS)
        _open(PROFILED)

    def on_stop():
        stop()
        if PROFILED is not None:
            _close(PROFILED)

    _autograd_profiler._run_on_profiler_start = on_start
    _autograd_profiler._run_on_profiler_stop = on_stop


_follow_profiler()


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "parent", "start", "targets", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.targets = _RECORDS
        self.range = None
        if _ANNOTATE:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        _stack().pop()
        entry = (self.name, self.parent, threading.get_ident(), self.start,
                 end)
        for rec in self.targets:
            rec.spans.append(entry)
        return False


def span(name: str):
    """A context manager that records ``name`` from entry to exit into
    the records open at entry, and the shared no-op when none is."""
    if _RECORDS:
        return _Span(name)
    return _NO_SPAN


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of every open record."""
    if _RECORDS:
        with _LOCK:
            for rec in _RECORDS:
                rec.counters[name] += n


@contextlib.contextmanager
def recording():
    """Open a record; yields the ``Record`` that this context fills (in
    memory; nothing is written)."""
    rec = Record()
    _open(rec)
    try:
        yield rec
    finally:
        _close(rec)


@contextlib.contextmanager
def trace(logdir: str):
    """A ``torch.profiler`` trace written to ``logdir``; the program's
    spans are recorded (into ``PROFILED``) and annotated in it."""
    global _ANNOTATE
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        with _LOCK:
            _ANNOTATE += 1
        try:
            yield prof
        finally:
            with _LOCK:
                _ANNOTATE -= 1


class StepTimer:
    def __init__(self, skip_first: int = 2):
        self.skip_first = skip_first
        self._steps: List[float] = []
        self._last: Optional[float] = None
        self._seen = 0

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self._seen += 1
            if self._seen > self.skip_first:
                self._steps.append(now - self._last)
        self._last = now

    def summary(self, batch_size: int = 1) -> dict:
        if not self._steps:
            return {}
        arr = np.asarray(self._steps)
        # examples_per_sec from the p50 step, not the mean: a step that
        # waits on a checkpoint write or an eval pass is an outlier that
        # would skew the mean for the whole run
        return {
            "steps": len(arr),
            "mean_ms": float(arr.mean() * 1e3),
            "p50_ms": float(np.percentile(arr, 50) * 1e3),
            "p95_ms": float(np.percentile(arr, 95) * 1e3),
            "examples_per_sec": float(batch_size
                                      / np.percentile(arr, 50)),
        }
