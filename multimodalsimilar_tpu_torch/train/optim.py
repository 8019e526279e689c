"""Optimizer and LR schedule of the text ArcFace recipes (counterpart of
multimodalsimilar_tpu/train/optim.py).

* ``linear_schedule_with_warmup`` — HF ``get_scheduler("linear", ...)``
  semantics (nlp_classifier_train.py:91-97): linear ramp 0 -> lr over the
  warmup steps, then linear decay to 0 at total steps; fractional warmup
  is accepted. Computed in float32 like the JAX schedule, so both give
  the same value at every step.
* ``dual_group_adamw`` — the reference's two-optimizer pattern (tower and
  ArcFace head, nlp_classifier_train.py:89-97) as one ``torch.optim.AdamW``
  with two parameter groups, each with its own schedule. ``GroupSchedules``
  sets every group's LR from its schedule at the optimizer-step count, so
  the LR at optimizer step t equals optax's schedule at count t.

``adamp``, ``timm_cosine_schedule`` and ``cosine_warm_restarts`` come with
the CV training slice.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

Schedule = Callable[[int], float]

# The set of head-module names: a parameter whose module path holds one of
# them trains in the head group.
HEAD_NAMES = frozenset({"head", "lv1_head", "lv2_head", "tag_head",
                        "classifier"})


def linear_schedule_with_warmup(lr: float, warmup_steps: float,
                                total_steps: int) -> Schedule:
    warmup = int(warmup_steps)
    f32 = np.float32

    def schedule(step: int) -> float:
        step = f32(step)
        if step < warmup:
            return float(f32(lr) * (step / f32(max(warmup, 1))))
        decay_span = f32(max(total_steps - warmup, 1))
        decay = max(f32(0.0), (f32(total_steps) - step) / decay_span)
        return float(f32(lr) * f32(decay))

    return schedule


class GroupSchedules:
    """One schedule per optimizer parameter group, stepped once per
    optimizer step (call ``step()`` after ``optimizer.step()``). The LR
    of group i at optimizer step t is ``schedules[i](t)``."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 schedules: Sequence[Schedule]):
        if len(schedules) != len(optimizer.param_groups):
            raise ValueError(f"{len(schedules)} schedules for "
                             f"{len(optimizer.param_groups)} groups")
        self.optimizer = optimizer
        self.schedules = list(schedules)
        self.count = 0
        self._apply()

    def _apply(self) -> None:
        for group, sched in zip(self.optimizer.param_groups, self.schedules):
            group["lr"] = sched(self.count)

    def step(self) -> None:
        self.count += 1
        self._apply()

    def state_dict(self) -> Dict[str, int]:
        return {"count": self.count}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self.count = int(state["count"])
        self._apply()


def is_head_param(name: str) -> bool:
    """Does the parameter path (``named_parameters`` name) run through a
    head module?"""
    return bool(set(name.split(".")) & HEAD_NAMES)


def dual_group_adamw(model: nn.Module, tower_schedule: Schedule,
                     head_schedule: Schedule, weight_decay: float = 0.0,
                     head_weight_decay: float = None, b1: float = 0.9,
                     b2: float = 0.999, eps: float = 1e-8
                     ) -> Tuple[torch.optim.AdamW, GroupSchedules]:
    """AdamW with a tower group and a head group split by parameter path
    (``is_head_param``), each with its own schedule and weight decay
    (``head_weight_decay`` defaults to ``weight_decay``). AdamW's decoupled
    decay is optax.adamw's: both subtract lr * wd * p from the old p."""
    tower, head = [], []
    for name, p in model.named_parameters():
        if p.requires_grad:
            (head if is_head_param(name) else tower).append(p)
    if head_weight_decay is None:
        head_weight_decay = weight_decay
    opt = torch.optim.AdamW(
        [{"params": tower, "weight_decay": weight_decay},
         {"params": head, "weight_decay": head_weight_decay}],
        lr=0.0, betas=(b1, b2), eps=eps)
    return opt, GroupSchedules(opt, [tower_schedule, head_schedule])
