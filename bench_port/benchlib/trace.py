"""Spans from the benchmark's own files, and the device trace of a window.

``Spans.span(name)`` (or ``begin`` and ``end`` across calls) times a call
into the program on the host clock, and keeps its wall-clock bounds in
nanoseconds and its thread. ``DeviceTrace`` runs ``torch.profiler`` with
CUDA activity alone over the measured window (recording every host
operation as well would slow a host-paced step by half), whose event
times are on the same wall clock, and reduces it: the seconds in which an
operation ran on the device (the union of kernel, copy and set
intervals), the device time of each kernel by name, and the idle gaps,
each named by the innermost span that the main thread had open when the
gap began."""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, List, Tuple

NO_SPAN = "no_benchmark_span_open"


class Spans:
    def __init__(self, traced: bool):
        self.traced = traced
        self.times: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        # (start ns, end ns, name, thread) on the wall clock
        self.wall: List[Tuple[int, int, str, int]] = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str):
        token = self.begin(name)
        try:
            yield
        finally:
            self.end(token)

    def begin(self, name: str) -> tuple:
        """Open ``name`` across calls; ``end`` closes it."""
        return name, time.perf_counter(), time.time_ns()

    def end(self, token: tuple) -> None:
        name, t0, w0 = token
        t1, w1 = time.perf_counter(), time.time_ns()
        with self._lock:
            self.times[name].append((t0, t1))
            self.wall.append((w0, w1, name, threading.get_ident()))

    def total(self, name: str, start: float = float("-inf"),
              end: float = float("inf")) -> float:
        """Seconds inside ``name`` spans that began in [start, end]."""
        return sum(b - a for a, b in self.times.get(name, ())
                   if start <= a <= end)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class DeviceTrace:
    """``torch.profiler`` over one window; ``start`` and ``stop`` bracket
    it, ``summary`` reduces it."""

    def __init__(self):
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    def summary(self, spans: Spans) -> dict:
        """``busy_s``, ``window_s`` (the ``window`` span), the kernel
        seconds by name, the ten longest kernels by total time and the
        ten longest idle gaps with their span names."""
        from torch.autograd import DeviceType
        device = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA \
                    and not e.is_user_annotation():
                start = e.start_ns()
                device.append((start, start + e.duration_ns(), e.name()))
        windows = [s for s in spans.wall if s[2] == "window"]
        if not windows:
            raise RuntimeError("no window span was recorded")
        w0, w1, _, main = windows[-1]
        by_name: Dict[str, float] = defaultdict(float)
        clipped = []
        for a, b, name in device:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                clipped.append((a, b))
                by_name[name] += (b - a) * 1e-9
        busy = _union(clipped)
        busy_s = sum(b - a for a, b in busy) * 1e-9
        gaps = []
        prev = w0
        for a, b in busy + [(w1, w1)]:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        main_spans = sorted((s for s in spans.wall
                             if s[3] == main and s[2] != "window"),
                            key=lambda s: s[0])
        longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
        named = [((b - a) * 1e-9, _open_span(main_spans, a))
                 for a, b in longest]
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {"busy_s": busy_s, "window_s": (w1 - w0) * 1e-9,
                "kernels": dict(by_name),
                "device_ops": [[n, s] for n, s in top],
                "idle_gaps": [[n, s] for s, n in named]}


def _open_span(spans, t: int) -> str:
    """The innermost span open at ``t`` (the latest-started one that
    covers it)."""
    best = None
    for a, b, name, _ in spans:
        if a > t:
            break
        if b >= t:
            best = name
    return best or NO_SPAN
