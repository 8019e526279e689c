"""The Trainer: one loop for the reference training recipes (counterpart of
multimodalsimilar_tpu/train/trainer.py), on one device.

* dual-LR parameter groups (``train/optim.py``), the per-epoch margin
  curriculum (update_m, cv_classifier_train_daodian.py:292), periodic
  margin-free eval (is_test=True, nlp_classifier_train.py:142-156) and
  periodic checkpoints (``train/checkpoint.py``);
* the ArcFace margin is a host float handed to the head on every step, so
  a curriculum step changes one kernel argument;
* dropout and drop-path masks come from a ``torch.Generator`` on the
  training device that the Trainer owns, re-seeded from ``(seed, step)``
  before every micro-step, so a resumed run draws the masks an unbroken
  run would have;
* BatchNorm running statistics are module buffers: they move on every
  micro-step in ``train()`` mode and travel in ``state()`` and the
  checkpoints with the weights;
* ``grad_accum`` = K follows ``optax.MultiSteps``: the mean gradient of K
  micro-steps feeds one optimizer step. ``step`` counts micro-steps (the
  checkpoint key, as in the JAX package); schedules, ``eval_every``,
  ``save_every`` and ``log_every`` count optimizer steps and fire on
  accumulation boundaries;
* ``profile_dir``: a ``torch.profiler`` trace (``utils/profiling.py``) of
  ``profile_num_steps`` steps after micro-step ``profile_start_step``.

The JAX package's mesh placements (class-sharded heads, TP, SP, PP,
bf16 gradient all-reduce) are multi-GPU work (ROADMAP A17): their
``TrainerConfig`` fields raise when set.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import deque
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from multimodalsimilar_tpu_torch.data.prefetch import prefetch_to_device
from multimodalsimilar_tpu_torch.models.bert import set_dropout_generator
from multimodalsimilar_tpu_torch.train.checkpoint import CheckpointManager
from multimodalsimilar_tpu_torch.train.metrics import (MeanAccumulator,
                                                       MetricLogger)
from multimodalsimilar_tpu_torch.train.tasks import Task
from multimodalsimilar_tpu_torch.utils.devices import resolve_device
from multimodalsimilar_tpu_torch.utils.profiling import StepTimer, trace

# TrainerConfig fields of the JAX package's multi-device layouts (ROADMAP
# A17), with the value that leaves them off
_NOT_PORTED = {"model_parallel_heads": False, "tensor_parallel": False,
               "sequence_parallel": False, "pipeline_parallel": False,
               "bf16_grad_allreduce": False}


def _f32(x: float) -> float:
    """The margin is a float32 in the JAX TrainState; keep the same
    rounding so both packages log and apply the same margin."""
    return float(np.float32(x))


@dataclasses.dataclass
class TrainerConfig:
    eval_every: int = 100          # nlp_classifier_train.py:142
    save_every: int = 1000         # :158
    log_every: int = 20
    margin_delta_per_epoch: float = 0.0   # 0.04 for the cv recipe (:292)
    margin_init: float = 0.40
    margin_max: float = 1.0
    checkpoint_dir: Optional[str] = None
    metrics_path: Optional[str] = None
    tensorboard_dir: Optional[str] = None
    # A fresh (non-resume) fit() into a populated checkpoint_dir refuses to
    # run unless this is set.
    overwrite: bool = False
    # save() blocks only for the copy of the state to the host; the disk
    # write overlaps the next steps. The end-of-fit save is always durable.
    async_save: bool = False
    seed: int = 0
    # micro-steps per optimizer step (optax.MultiSteps' every_k_schedule)
    grad_accum: int = 1
    profile_dir: Optional[str] = None     # torch.profiler trace output
    profile_start_step: int = 3           # past the warm-up steps
    profile_num_steps: int = 5
    # multi-device layouts (see _NOT_PORTED): raise when set
    model_parallel_heads: bool = False
    tensor_parallel: bool = False
    sequence_parallel: bool = False
    pipeline_parallel: bool = False
    bf16_grad_allreduce: bool = False

    def __post_init__(self):
        bad = [k for k, off in _NOT_PORTED.items()
               if getattr(self, k) != off]
        if bad:
            raise NotImplementedError(
                f"TrainerConfig {bad}: the multi-device layouts are not "
                f"ported to the PyTorch trainer (ROADMAP A17)")
        if self.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got "
                             f"{self.grad_accum}")


class Trainer:
    """``make_optimizer(model) -> (optimizer, schedules)``, e.g.
    ``lambda m: dual_group_adamw(m, tower_sched, head_sched, 0.01)``. The
    model (``task.model``) moves to ``device``, which defaults to the card
    and raises without one unless it is ``"cpu"``."""

    def __init__(self, task: Task, make_optimizer: Callable,
                 config: TrainerConfig = TrainerConfig(), device="cuda"):
        self.device = resolve_device(device)
        self.task = task
        self.config = config
        self.model = task.model.to(self.device)
        self.optimizer, self.schedules = make_optimizer(self.model)
        self.logger = MetricLogger(config.metrics_path,
                                   config.tensorboard_dir)
        self.ckpt = (CheckpointManager(config.checkpoint_dir,
                                       async_save=config.async_save)
                     if config.checkpoint_dir else None)
        self.generator = torch.Generator(device=self.device)
        set_dropout_generator(self.model, self.generator)
        self.step = 0
        self.margin = _f32(config.margin_init)
        self.timer = StepTimer(skip_first=2)

    # -- state ----------------------------------------------------------

    def state(self) -> dict:
        """The training state a checkpoint holds (live references): the
        model's parameters and buffers (BatchNorm statistics), optimizer,
        schedules, margin and, between accumulation boundaries, the
        gradients accumulated so far."""
        grads = {name: p.grad for name, p in self.model.named_parameters()
                 if p.grad is not None}
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "schedulers": self.schedules.state_dict(),
                "margin": self.margin, "accum_grads": grads}

    def load_state(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.schedules.load_state_dict(state["schedulers"])
        self.step = int(state["step"])
        self.margin = _f32(state["margin"])
        grads = state.get("accum_grads", {})
        for name, p in self.model.named_parameters():
            p.grad = (grads[name].to(p.device, p.dtype) if name in grads
                      else None)

    # -- steps ------------------------------------------------------------

    def train_step(self, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """One micro-step on a device batch (an optimizer step at every
        ``grad_accum``-th); returns its metrics as device scalars (no host
        sync)."""
        accum = self.config.grad_accum
        self.model.train()
        self.generator.manual_seed((self.config.seed << 32) + self.step)
        loss, metrics = self.task.train_loss(batch, self.margin)
        # the accumulated gradient is the mean of the micro-steps'
        (loss / accum if accum > 1 else loss).backward()
        self.step += 1
        if self.step % accum == 0:
            self.optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
            self.schedules.step()
        return metrics

    def eval_step(self, batch: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        self.model.eval()
        with torch.no_grad():
            return self.task.eval_metrics(batch)

    # -- curriculum ------------------------------------------------------

    def update_margin(self, delta: float) -> None:
        """ArcMarginProduct.update_m semantics (arcface.py:35-42): apply
        only if the result stays within [1e-6, margin_max]."""
        new_m = self.margin + delta
        if 1e-6 <= new_m <= self.config.margin_max:
            self.margin = _f32(new_m)

    # -- evaluation -------------------------------------------------------

    def evaluate(self, batches: Iterator) -> Dict[str, float]:
        """Mean metrics over a split. Depth-2 lagged readback: batch N-2's
        scalars are read while batch N runs, which overlaps the readback
        and bounds the batches held on the device."""
        accs: Dict[str, MeanAccumulator] = {}
        pending: deque = deque()

        def consume(metrics, n):
            for k, v in metrics.items():
                accs.setdefault(k, MeanAccumulator()).update(float(v), n)

        for batch in prefetch_to_device(batches, self.device):
            n = int(next(iter(batch.values())).shape[0])
            pending.append((self.eval_step(batch), n))
            if len(pending) > 2:
                consume(*pending.popleft())
        while pending:
            consume(*pending.popleft())
        return {k: a.compute() for k, a in accs.items()}

    # -- main loop ---------------------------------------------------------

    def fit(self, train_source, num_epochs: int, batch_size: int,
            eval_source=None, eval_batch_size: Optional[int] = None,
            sampler_fn=None, shuffle: bool = True,
            resume: bool = False) -> dict:
        """Run the training recipe; returns ``state()``.

        ``sampler_fn(epoch) -> WeightedSampler | None`` plugs in the
        class-balanced sampling of the _v2/_daodian recipes.
        ``resume=True`` restores the latest checkpoint of
        ``checkpoint_dir`` and continues from its step, margin and
        optimizer state; without it, a populated ``checkpoint_dir`` is
        refused unless ``overwrite`` is set. Warm starts load weights into
        the model before the Trainer is built."""
        cfg = self.config
        if cfg.margin_delta_per_epoch and not self.task.dynamic_margin:
            raise ValueError(
                "margin_delta_per_epoch is configured but this task's loss "
                "ignores the Trainer's margin — the curriculum would be "
                "logged but never reach the loss")
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            if resume:
                self.load_state(self.ckpt.restore())
                self.logger.log(self.step, {"resumed": 1.0})
            elif not cfg.overwrite:
                raise ValueError(
                    f"checkpoint_dir {self.ckpt.directory!r} already holds "
                    f"checkpoints (latest step {self.ckpt.latest_step()}). "
                    f"Pass resume=True (--resume) to continue that run, "
                    f"overwrite=True (--overwrite) to discard it, or point "
                    f"at a fresh directory.")
            else:
                self.ckpt.clear()
        timer = self.timer = StepTimer(skip_first=2)
        accum = cfg.grad_accum
        prev_loss = None
        trained = False
        with contextlib.ExitStack() as profiling:
            profiled = False
            for epoch in range(num_epochs):
                sampler = sampler_fn(epoch) if sampler_fn else None
                it = train_source.batches(batch_size, shuffle=shuffle,
                                          seed=cfg.seed, epoch=epoch,
                                          sampler=sampler)
                for batch in prefetch_to_device(it, self.device):
                    metrics = self.train_step(batch)
                    trained = True
                    step = self.step          # micro-steps
                    # depth-1 lagged sync: read the PREVIOUS step's loss,
                    # so the host stays at most one step ahead of the
                    # device and each timer tick is a real step time
                    if prev_loss is not None:
                        float(prev_loss)
                    prev_loss = metrics["loss"]
                    timer.tick()
                    if cfg.profile_dir and not profiled:
                        if step == cfg.profile_start_step:
                            profiling.enter_context(trace(cfg.profile_dir))
                        elif step >= (cfg.profile_start_step
                                      + cfg.profile_num_steps):
                            profiling.close()
                            profiled = True
                    # cadence on accumulation boundaries, in optimizer
                    # steps (the micro-steps themselves at accum = 1)
                    if step % accum:
                        continue
                    opt_step = step // accum
                    if opt_step % cfg.log_every == 0:
                        # the CURRENT step's metrics (a sync on log steps)
                        m = {k: float(v) for k, v in metrics.items()}
                        summary = timer.summary(batch_size)
                        if summary:
                            m["examples_per_sec"] = summary[
                                "examples_per_sec"]
                            m["step_ms_p50"] = summary["p50_ms"]
                        m["margin"] = self.margin
                        if accum > 1:
                            m["opt_step"] = float(opt_step)
                        self.logger.log(step, m, prefix="train/")
                    if eval_source is not None \
                            and opt_step % cfg.eval_every == 0:
                        # the whole split, the final partial batch included
                        ev = self.evaluate(eval_source.batches(
                            eval_batch_size or batch_size, shuffle=False,
                            drop_remainder=False))
                        self.logger.log(step, ev, prefix="eval/")
                    if self.ckpt and opt_step % cfg.save_every == 0:
                        self.ckpt.save(step, self.state())
                if cfg.margin_delta_per_epoch:
                    self.update_margin(cfg.margin_delta_per_epoch)
        if self.ckpt and trained:
            self.ckpt.save(self.step, self.state(), force=True)
            self.ckpt.wait()   # the end-of-run save must be durable
        return self.state()
