"""Metric accumulators and the JSONL metric stream.

Copied from ``multimodalsimilar_tpu/train/metrics.py`` (it imports no JAX);
the ``metrics.jsonl`` lines have the same format in both packages.

The reference uses torchmetrics.Accuracy — accumulated over the *entire run*
without reset (a known wart, SURVEY.md §8) — and micro-F1 for CV validation
(cv_classifier_train_daodian.py:173). For single-label multiclass, micro-F1
equals accuracy (TP = correct, FP = FN = incorrect), so one accumulator
covers both; ours resets per eval window.
"""

from __future__ import annotations

import json
import sys
from typing import Dict


class MeanAccumulator:
    def __init__(self):
        self.total = 0.0
        self.count = 0

    def update(self, value: float, weight: int = 1):
        self.total += float(value) * weight
        self.count += weight

    def compute(self) -> float:
        return self.total / max(self.count, 1)

    def reset(self):
        self.total, self.count = 0.0, 0


class MetricLogger:
    """JSONL metric stream + stdout, with optional TensorBoard scalars.

    The reference logs Loss/train, Acc/train, Acc/test via SummaryWriter
    (nlp_classifier_train.py:61,136-137,156); passing ``tensorboard_dir``
    reproduces that (scalars named '{prefix}{metric}'), while the JSONL file
    is the machine-readable stream. tensorboard is imported only when asked
    for.
    """

    def __init__(self, path=None, tensorboard_dir=None):
        self.path = path
        self._fh = open(path, "a") if path else None
        self._tb = None
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(tensorboard_dir)
            except Exception as e:
                print(f"tensorboard_dir={tensorboard_dir!r} requested but "
                      f"SummaryWriter unavailable ({e}); JSONL metrics "
                      f"only", file=sys.stderr, flush=True)

    def log(self, step: int, metrics: Dict[str, float], prefix: str = ""):
        rec = {"step": step}
        rec.update({(f"{prefix}{k}"): float(v) for k, v in metrics.items()})
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self._tb:
            for k, v in rec.items():
                if k != "step":
                    self._tb.add_scalar(k, v, step)
        pretty = " ".join(f"{k}={v:.5g}" for k, v in rec.items()
                          if k != "step")
        print(f"[step {step}] {pretty}", flush=True)

    def close(self):
        if self._fh:
            self._fh.close()
        if self._tb:
            self._tb.close()
