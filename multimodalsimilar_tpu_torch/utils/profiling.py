"""Profiling helpers (counterpart of
multimodalsimilar_tpu/utils/profiling.py).

* ``trace(logdir)`` — a ``torch.profiler`` context (host and, with a
  card, device activity) whose trace is written to ``logdir`` as
  TensorBoard's profiler plugin reads it (``*.pt.trace.json``, also
  loadable in Perfetto), where the JAX package writes a ``jax.profiler``
  trace.
* ``StepTimer`` — copied: a cheap steady-state throughput meter that
  skips warm-up steps and reports examples/sec from the median step.
"""

from __future__ import annotations

import contextlib
import time
from typing import List, Optional

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


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
