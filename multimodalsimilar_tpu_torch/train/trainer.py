"""The Trainer: one loop for the reference training recipes (counterpart of
multimodalsimilar_tpu/train/trainer.py), on one device or over a mesh.

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
  ``profile_num_steps`` steps after micro-step ``profile_start_step``;
  the recorder's spans (``train.step`` over ``train.forward``,
  ``train.backward`` and ``train.optimizer``; ``train.sync``,
  ``train.log``, ``train.eval``, ``train.save`` in ``fit``) show in it;
* the logged ``examples_per_sec`` is the examples over the wall time
  since the previous log step (the first interval starts after the
  warm-up steps that ``StepTimer`` skips); ``step_ms_p50`` is
  ``StepTimer``'s median step.

Over a ``mesh`` (``parallel/mesh.py``; every rank builds the same Trainer
and iterates the same global batches) the step computes what the JAX
package's pjit step computes on the whole batch:

* each rank takes its block of the batch (``shard_batch``) and the mean
  loss over it; at each accumulation boundary the gradients are meaned
  over the data group in f32 (``_reduce_gradients``: flat buckets, one
  all-reduce each, after the backward), and BatchNorm normalizes with
  the global batch's statistics (``models/efficientnet.py:batch_norm``);
* ``bf16_grad_allreduce`` (``--bf16_grads``, JAX
  ``_train_step_bf16_impl``) all-reduces the gradients in bfloat16,
  normalizes each shard with its own statistics and means the running
  ones over the data group after every micro-step; it refuses an
  indivisible batch and a class-sharded head;
* ``model_parallel_heads`` (``--model_parallel``) cuts each ArcFace head
  whose class count divides by the model axis to this rank's block of
  classes, with its optimizer moments (``ArcFaceHead.shard``; the tasks
  take the loss over the model group, the fused loss included); the
  rest stay whole, and when nothing divides the Trainer raises, as JAX
  does;
* ``tensor_parallel`` (``--tensor_parallel``) cuts the BERT towers to
  Megatron's blocks over the same model group (``parallel/tp.py``), and
  ``sequence_parallel`` runs their residual stream in sequence blocks
  (``parallel/sp.py``; the gradients of the parameters that see only
  this rank's block are summed over the model group before the
  data-group mean); AdamP reduces its channel sums of every cut
  parameter over the model group (``AdamP.shard``);
* ``pipeline_parallel`` (``--pipeline_parallel M``) trains a model built
  inside ``parallel/pp.py:building(mesh)``: each rank holds its stage's
  layers of every pipeline-parallel BERT encoder, and only their
  optimizer moments, and runs the GPipe schedule over the model group;
  the embeddings' gradient, which stage 0 alone has (the others hold
  zeros), is summed over the model group before the data-group mean,
  and the pooler and heads, which every stage runs alike on the
  broadcast result, need nothing;
* dropout masks are drawn from ``(seed, step)`` mixed with the rank's
  data coordinate (the ranks of one data coordinate see one batch and
  draw the same masks);
* metrics are meaned over the data group where they are logged, eval
  sums over the whole split; rank 0 alone writes metrics and
  checkpoints, the latter in the one-card layout with every cut
  parameter and every stage's layers gathered (``full_state``), and
  ``load_state`` cuts them again.

The JAX Trainer's refusals of the layouts that do not compose are kept
word for word and in its order (``check_layouts``), and so are its
refusals of a half-configured pipeline: a Trainer with
``pipeline_parallel`` over a model that holds no stage, and a first
step that ran the schedule without the configured microbatches.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from typing import Callable, Dict, Iterator, Optional

import numpy as np
import torch

from multimodalsimilar_tpu_torch.data.prefetch import prefetch_to_device
from multimodalsimilar_tpu_torch.models.bert import set_dropout_generator
from multimodalsimilar_tpu_torch.models.efficientnet import set_stats_mesh
from multimodalsimilar_tpu_torch.parallel.mesh import (DATA_AXIS,
                                                       MODEL_AXIS, Shard,
                                                       create_mesh,
                                                       shard_batch)
from multimodalsimilar_tpu_torch.parallel import pp
from multimodalsimilar_tpu_torch.train.checkpoint import (CheckpointManager,
                                                          gather_shards,
                                                          gather_stages,
                                                          shard_state,
                                                          stage_state)
from multimodalsimilar_tpu_torch.train.metrics import MetricLogger
from multimodalsimilar_tpu_torch.train.tasks import Task
from multimodalsimilar_tpu_torch.utils.devices import resolve_device
from multimodalsimilar_tpu_torch.utils.profiling import (StepTimer, span,
                                                        trace)

# the JAX Trainer's refusal of pipeline with tensor or sequence parallelism
PP_WITH_TP = ("pipeline_parallel and tensor/sequence_parallel shard the same "
              "mesh model axis in incompatible layouts (stacked stages vs "
              "per-layer weight splits) — pick one")
# the JAX Trainer's refusals of a half-configured pipeline
PP_NO_STAGES = ("pipeline_parallel is on but the state holds no stacked "
                "layer tree (pp_layers) — build the model with "
                "pipeline_parallel=True in its BertConfig (cli does this "
                "automatically)")
PP_NOT_APPLIED = (
    "TrainerConfig.pipeline_parallel is on but the model applied no "
    "pipeline_parallel behavior — build the model with "
    "pipeline_parallel=True in its BertConfig (cli does this "
    "automatically); if it already is, the per-chip batch likely failed to "
    "split into pp_microbatches equal microbatches (batch_size must divide "
    "by data_axis * pp_microbatches) and the step rode the sequential "
    "fallback")
# gradient elements per all-reduce of _reduce_gradients
BUCKET_ELEMENTS = 8 * 2**20


def _f32(x: float) -> float:
    """The margin is a float32 in the JAX TrainState; keep the same
    rounding so both packages log and apply the same margin."""
    return float(np.float32(x))


def _stages(model) -> dict:
    """Module name -> encoder of every pipeline stage in ``model``."""
    from multimodalsimilar_tpu_torch.models.bert import BertEncoderModel
    return {name: m for name, m in model.named_modules()
            if isinstance(m, BertEncoderModel) and m.pp is not None}


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
    # shard the ArcFace heads' classes over the mesh's model axis
    model_parallel_heads: bool = False
    # all-reduce data-parallel gradients in bfloat16 (per-shard BatchNorm)
    bf16_grad_allreduce: bool = False
    # Megatron tensor parallelism of the BERT towers over the model axis
    tensor_parallel: bool = False
    # their residual stream in sequence blocks (needs tensor_parallel and
    # a model built with BertConfig.sequence_parallel)
    sequence_parallel: bool = False
    # GPipe stages of the BERT towers over the model axis (a model built
    # inside parallel.pp.building)
    pipeline_parallel: bool = False

    def __post_init__(self):
        if self.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got "
                             f"{self.grad_accum}")


def check_layouts(cfg: TrainerConfig, mesh) -> None:
    """The JAX Trainer's refusals of layouts that do not compose, in its
    order and words (the command line calls it before it builds a
    pipeline stage)."""
    if cfg.bf16_grad_allreduce and (cfg.model_parallel_heads
                                    or cfg.tensor_parallel
                                    or cfg.pipeline_parallel):
        raise ValueError(
            "bf16_grad_allreduce is a pure-DP path (shard_map over the "
            "data axis with fully replicated params); it cannot compose "
            "with model_parallel_heads/tensor_parallel/"
            "pipeline_parallel — pick one")
    if cfg.pipeline_parallel:
        if cfg.tensor_parallel or cfg.sequence_parallel:
            raise ValueError(PP_WITH_TP)
        pp.check_mesh(mesh)
    if cfg.tensor_parallel and mesh.model <= 1:
        raise ValueError(
            "tensor_parallel requires a mesh model axis > 1 (e.g. "
            "--model_parallel 2); on this mesh every tower weight "
            "would silently stay replicated")
    if cfg.sequence_parallel:
        if not cfg.tensor_parallel:
            raise ValueError(
                "sequence_parallel shards the residual stream over the "
                "tensor-parallel mesh group — it requires "
                "tensor_parallel (pass --tensor_parallel too)")
        from multimodalsimilar_tpu_torch.parallel.sp import check_mesh
        check_mesh(mesh)


class Trainer:
    """``make_optimizer(model) -> (optimizer, schedules)``, e.g.
    ``lambda m: dual_group_adamw(m, tower_sched, head_sched, 0.01)``. The
    model (``task.model``) moves to ``device``, which defaults to the card
    and raises without one unless it is ``"cpu"``. ``mesh`` defaults to
    ``create_mesh()``: every rank on the data axis (one rank without a
    process group)."""

    def __init__(self, task: Task, make_optimizer: Callable,
                 config: TrainerConfig = TrainerConfig(), device="cuda",
                 mesh=None):
        self.device = resolve_device(device)
        self.task = task
        self.config = config
        self.mesh = mesh if mesh is not None else create_mesh()
        check_layouts(config, self.mesh)
        self.model = task.model.to(self.device)
        # name -> encoder of each pipeline-parallel stage, and the
        # parameters whose gradients only stage 0 holds
        self.stages = _stages(self.model)
        self.pipeline_partial = []
        if config.pipeline_parallel:
            self.pipeline_partial = self._check_stages()
        elif self.stages:
            raise ValueError(
                "the model holds pipeline stages (built inside "
                "parallel.pp.building) but TrainerConfig.pipeline_parallel "
                "is off")
        self._pp_checked = False
        # name -> Shard of each parameter cut to this rank's block over
        # the model group (heads, tensor-parallel tower weights), and the
        # parameters whose gradients are partial over it (sequence
        # parallelism)
        self.shards = {}
        self.sequence_partial = []
        if config.model_parallel_heads and self.mesh.model > 1:
            self.shards = self._shard_heads()
        if config.tensor_parallel:
            from multimodalsimilar_tpu_torch.parallel.tp import (
                tensor_parallel)
            tp_shards, self.sequence_partial = tensor_parallel(
                self.model, self.mesh, config.sequence_parallel)
            self.shards.update(tp_shards)
        self.optimizer, self.schedules = make_optimizer(self.model)
        if self.shards and hasattr(self.optimizer, "shard"):
            self.optimizer.shard({s.param: s.dim
                                  for s in self.shards.values()}, self.mesh)
        if not config.bf16_grad_allreduce \
                and self.mesh.group(DATA_AXIS) is not None:
            set_stats_mesh(self.model, self.mesh)   # global statistics
        self.logger = (MetricLogger(config.metrics_path,
                                    config.tensorboard_dir)
                       if self.mesh.rank == 0 else None)
        self.ckpt = (CheckpointManager(config.checkpoint_dir,
                                       async_save=config.async_save)
                     if config.checkpoint_dir else None)
        self.generator = torch.Generator(device=self.device)
        set_dropout_generator(self.model, self.generator)
        self.step = 0
        self.margin = _f32(config.margin_init)

    # -- placement ------------------------------------------------------

    def _check_stages(self) -> list:
        """A pipeline-parallel Trainer's model holds this rank's stage of
        each pipeline-parallel encoder, over this mesh; returns the names
        of the embeddings' parameters."""
        if not self.stages:
            raise ValueError(PP_NO_STAGES)
        partial = []
        for name, enc in self.stages.items():
            if enc.pp.mesh.shape != self.mesh.shape:
                raise ValueError(
                    f"{name}: built for a {enc.pp.mesh.shape} mesh, trained "
                    f"over {self.mesh.shape}")
            partial += [f"{name}.embeddings.{n}" for n, _ in
                        enc.embeddings.named_parameters()]
        return partial

    def _shard_heads(self) -> dict:
        """Cut each ArcFace head whose class count divides by the model
        axis to this rank's block; raise when none does (the JAX
        package's ``_place_state`` diagnosis, its messages)."""
        from multimodalsimilar_tpu_torch.models.heads import ArcFaceHead
        from multimodalsimilar_tpu_torch.train.optim import HEAD_NAMES
        n = self.mesh.model
        sharded, skipped = {}, []
        for name, mod in self.model.named_modules():
            if not (isinstance(mod, ArcFaceHead)
                    and set(name.split(".")) & HEAD_NAMES):
                continue
            classes = mod.weight.shape[0]
            if classes % n:
                skipped.append((f"{name}.weight", classes))
                continue
            mod.shard(self.mesh)
            sharded[f"{name}.weight"] = Shard(mod.weight, 0, classes)
        if skipped and not sharded:
            detail = ", ".join(f"{k} (classes={c}, {c} % {n} != 0)"
                               for k, c in sorted(set(skipped)))
            raise ValueError(
                f"model_parallel={n} cannot shard any head: {detail}. "
                f"Pick an N dividing the class count (e.g. 10205 = "
                f"5*13*157 -> N=5), or drop --model_parallel.")
        if skipped:
            names = ", ".join(sorted({k for k, _ in skipped}))
            print(f"model_parallel={n}: replicating indivisible heads "
                  f"{names} (sharded {len(sharded)} weight shapes)",
                  flush=True)
        return sharded

    def _batch_norms(self):
        return [m for m in self.model.modules()
                if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]

    # -- state ----------------------------------------------------------

    def state(self) -> dict:
        """The training state a checkpoint holds (live references; a
        class-sharded head as this rank's block): the model's parameters
        and buffers (BatchNorm statistics), optimizer, schedules, margin
        and, between accumulation boundaries, the gradients accumulated
        so far."""
        grads = {name: p.grad for name, p in self.model.named_parameters()
                 if p.grad is not None}
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "schedulers": self.schedules.state_dict(),
                "margin": self.margin, "accum_grads": grads}

    def full_state(self) -> dict:
        """``state()`` in the one-card layout: every cut parameter, its
        optimizer moments and its gradient so far gathered over the model
        group (a collective: every rank calls it)."""
        state = self.state()
        if self.shards:
            state = gather_shards(state, self.shards, self.optimizer,
                                  self.mesh)
        if self.stages:
            state = gather_stages(state, self.stages, self.model,
                                  self.optimizer, self.mesh)
        return state

    def load_state(self, state: dict) -> None:
        """Load a ``full_state()`` (the one-card layout), keeping this
        rank's stage and cutting every sharded parameter to this rank's
        block."""
        if self.stages:
            state = stage_state(state, self.stages, self.model,
                                self.optimizer)
        if self.shards:
            state = shard_state(state, self.shards, self.optimizer,
                                self.mesh)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.schedules.load_state_dict(state["schedulers"])
        self.step = int(state["step"])
        self.margin = _f32(state["margin"])
        grads = state.get("accum_grads", {})
        for name, p in self.model.named_parameters():
            p.grad = (grads[name].to(p.device, p.dtype) if name in grads
                      else None)

    def _save(self, step: int, force: bool = False) -> dict:
        """Rank 0 writes ``full_state()``; every rank meets at a barrier
        once the copy to the host is made. Returns the state written."""
        state = self.full_state()
        if self.mesh.rank == 0:
            self.ckpt.save(step, state, force=force)
        self.mesh.barrier()
        return state

    # -- steps ------------------------------------------------------------

    def _mask_seed(self) -> int:
        """Dropout's seed for this micro-step: ``(seed, step)``, mixed
        with the rank's data coordinate (unchanged on coordinate 0)."""
        base = (self.config.seed << 32) + self.step
        return (base ^ (self.mesh.data_index * 0x9E3779B97F4A7C15)) \
            & (2**64 - 1)

    def train_step(self, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """One micro-step on this rank's block of a batch (``shard_batch``;
        the whole batch on one device), an optimizer step at every
        ``grad_accum``-th; returns its metrics as device scalars (no host
        sync)."""
        with span("train.step"):
            accum = self.config.grad_accum
            self.model.train()
            self.generator.manual_seed(self._mask_seed())
            applied = pp.applied_count()
            with span("train.forward"):
                loss, metrics = self.task.train_loss(batch, self.margin)
            if self.stages and not self._pp_checked:
                if pp.applied_count() == applied:
                    raise ValueError(PP_NOT_APPLIED)
                self._pp_checked = True
            with span("train.backward"):
                # the accumulated gradient is the mean of the micro-steps'
                (loss / accum if accum > 1 else loss).backward()
            if self.config.bf16_grad_allreduce:
                self._mean_batch_norm_statistics()
            self.step += 1
            if self.step % accum == 0:
                with span("train.optimizer"):
                    self._reduce_gradients()
                    self.optimizer.step()
                    self.optimizer.zero_grad(set_to_none=True)
                    self.schedules.step()
            return metrics

    def _reduce_gradients(self) -> None:
        """Sum the sequence- and pipeline-partial gradients over the model
        group, then mean every gradient over the data group: flat buckets
        of up to
        ``BUCKET_ELEMENTS``, one all-reduce each, in f32 (or bfloat16
        under ``bf16_grad_allreduce``, cast back after the mean, as JAX's
        ``pmean(g.astype(bf16))``)."""
        partial = self.sequence_partial + self.pipeline_partial
        if partial:
            params = dict(self.model.named_parameters())
            self._all_reduce_buckets(
                [params[n].grad for n in partial
                 if params[n].grad is not None], MODEL_AXIS, "sum",
                torch.float32)
        if self.mesh.group(DATA_AXIS) is None:
            return
        self._all_reduce_buckets(
            [p.grad for p in self.model.parameters() if p.grad is not None],
            DATA_AXIS, "mean", torch.bfloat16
            if self.config.bf16_grad_allreduce else torch.float32)

    def _all_reduce_buckets(self, grads, axis, op, dtype) -> None:
        bucket, size = [], 0
        for i, g in enumerate(grads):
            bucket.append(g)
            size += g.numel()
            if size < BUCKET_ELEMENTS and i + 1 < len(grads):
                continue
            flat = torch.cat([b.reshape(-1) for b in bucket]).to(dtype)
            self.mesh.all_reduce(flat, axis, op)
            for b, part in zip(bucket, flat.split([b.numel()
                                                   for b in bucket])):
                b.copy_(part.view_as(b))
            bucket, size = [], 0

    def _mean_batch_norm_statistics(self) -> None:
        """``--bf16_grads``: each shard normalized with its own statistics;
        the float running statistics are meaned over the data group, all
        of them in one flat all-reduce."""
        bufs = [b for m in self._batch_norms()
                for b in (m.running_mean, m.running_var)]
        if not bufs or self.mesh.group(DATA_AXIS) is None:
            return
        flat = torch.cat([b.reshape(-1) for b in bufs])
        self.mesh.all_reduce(flat, DATA_AXIS, "mean")
        for b, part in zip(bufs, flat.split([b.numel() for b in bufs])):
            b.copy_(part.view_as(b))

    def _mean_metrics(self, metrics: Dict[str, torch.Tensor]
                      ) -> Dict[str, float]:
        """A step's metrics meaned over the data group, as host floats."""
        if not metrics:
            return {}
        t = torch.stack([v.detach().float().reshape(()) for v in
                         metrics.values()])
        t = self.mesh.all_reduce(t, DATA_AXIS, "mean")
        return dict(zip(metrics, t.tolist()))

    def eval_step(self, batch: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        self.model.eval()
        with torch.no_grad():
            return self.task.eval_metrics(batch)

    def _shards(self, batches, strict: bool = False):
        """(this rank's block of each host batch, its weight): the weight
        is the batch's rows over the data axis, so the weighted sums over
        the ranks count every row once, a batch left whole included."""
        for b in batches:
            n = int(next(iter(b.values())).shape[0])
            yield shard_batch(self.mesh, b, strict=strict), n / self.mesh.data

    # -- curriculum ------------------------------------------------------

    def update_margin(self, delta: float) -> None:
        """ArcMarginProduct.update_m semantics (arcface.py:35-42): apply
        only if the result stays within [1e-6, margin_max]."""
        new_m = self.margin + delta
        if 1e-6 <= new_m <= self.config.margin_max:
            self.margin = _f32(new_m)

    # -- evaluation -------------------------------------------------------

    def evaluate(self, batches: Iterator) -> Dict[str, float]:
        """Mean metrics over a split (every rank gets the same numbers).
        Depth-2 lagged readback: batch N-2's scalars are read while batch
        N runs, which overlaps the readback and bounds the batches held on
        the device."""
        sums: Dict[str, list] = {}
        pending: deque = deque()

        def consume(metrics, w):
            for k, v in metrics.items():
                acc = sums.setdefault(k, [0.0, 0.0])
                acc[0] += float(v) * w
                acc[1] += w

        weights: deque = deque()
        host = self._shards(batches)

        def blocks():
            for b, w in host:
                weights.append(w)
                yield b

        for batch in prefetch_to_device(blocks(), self.device):
            pending.append((self.eval_step(batch), weights.popleft()))
            if len(pending) > 2:
                consume(*pending.popleft())
        while pending:
            consume(*pending.popleft())
        if not sums:
            return {}
        t = torch.tensor([v for acc in sums.values() for v in acc],
                         dtype=torch.float64, device=self.device)
        t = self.mesh.all_reduce(t, DATA_AXIS).tolist()
        return {k: t[2 * i] / t[2 * i + 1] for i, k in enumerate(sums)}

    def _log(self, step: int, metrics: Dict[str, float],
             prefix: str) -> None:
        if self.logger is not None:
            self.logger.log(step, metrics, prefix=prefix)

    # -- main loop ---------------------------------------------------------

    def fit(self, train_source, num_epochs: int, batch_size: int,
            eval_source=None, eval_batch_size: Optional[int] = None,
            sampler_fn=None, shuffle: bool = True,
            resume: bool = False) -> dict:
        """Run the training recipe; returns ``full_state()``.

        ``sampler_fn(epoch) -> WeightedSampler | None`` plugs in the
        class-balanced sampling of the _v2/_daodian recipes.
        ``resume=True`` restores the latest checkpoint of
        ``checkpoint_dir`` and continues from its step, margin and
        optimizer state; without it, a populated ``checkpoint_dir`` is
        refused unless ``overwrite`` is set. Warm starts load weights into
        the model before the Trainer is built. ``batch_size`` is the
        global batch, split over the data axis."""
        cfg = self.config
        if cfg.margin_delta_per_epoch and not self.task.dynamic_margin:
            raise ValueError(
                "margin_delta_per_epoch is configured but this task's loss "
                "ignores the Trainer's margin — the curriculum would be "
                "logged but never reach the loss")
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            if resume:
                self.load_state(self.ckpt.restore())
                self._log(self.step, {"resumed": 1.0}, "")
            elif not cfg.overwrite:
                raise ValueError(
                    f"checkpoint_dir {self.ckpt.directory!r} already holds "
                    f"checkpoints (latest step {self.ckpt.latest_step()}). "
                    f"Pass resume=True (--resume) to continue that run, "
                    f"overwrite=True (--overwrite) to discard it, or point "
                    f"at a fresh directory.")
            else:
                self.mesh.barrier()      # every rank has looked
                if self.mesh.rank == 0:
                    self.ckpt.clear()
                self.mesh.barrier()
        timer = self.timer = StepTimer(skip_first=2)
        accum = cfg.grad_accum
        prev_loss = None
        trained = False
        # the logged rate: examples over the wall time since the last log
        # step, or since the warm-up steps that the timer skips (each log
        # step syncs, so each interval holds its steps' device work)
        ticks, logged_at, examples = 0, None, 0
        with contextlib.ExitStack() as profiling:
            profiled = False
            for epoch in range(num_epochs):
                sampler = sampler_fn(epoch) if sampler_fn else None
                it = train_source.batches(batch_size, shuffle=shuffle,
                                          seed=cfg.seed, epoch=epoch,
                                          sampler=sampler)
                blocks = (b for b, _ in self._shards(
                    it, strict=cfg.bf16_grad_allreduce))
                for batch in prefetch_to_device(blocks, self.device):
                    metrics = self.train_step(batch)
                    examples += batch_size
                    trained = True
                    step = self.step          # micro-steps
                    # depth-1 lagged sync: read the PREVIOUS step's loss,
                    # so the host stays at most one step ahead of the
                    # device and each timer tick is a real step time
                    if prev_loss is not None:
                        with span("train.sync"):
                            float(prev_loss)
                    prev_loss = metrics["loss"]
                    timer.tick()
                    ticks += 1
                    if ticks == timer.skip_first + 1:
                        logged_at, examples = time.perf_counter(), 0
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
                        with span("train.log"):
                            # the CURRENT step's metrics (a sync on log
                            # steps)
                            m = self._mean_metrics(metrics)
                            now = time.perf_counter()
                            summary = timer.summary(batch_size)
                            if summary:
                                m["examples_per_sec"] = examples / (
                                    now - logged_at)
                                m["step_ms_p50"] = summary["p50_ms"]
                            logged_at, examples = now, 0
                            m["margin"] = self.margin
                            if accum > 1:
                                m["opt_step"] = float(opt_step)
                            self._log(step, m, "train/")
                    if eval_source is not None \
                            and opt_step % cfg.eval_every == 0:
                        with span("train.eval"):
                            # the whole split, the final partial batch
                            # included
                            ev = self.evaluate(eval_source.batches(
                                eval_batch_size or batch_size,
                                shuffle=False, drop_remainder=False))
                            self._log(step, ev, "eval/")
                    if self.ckpt and opt_step % cfg.save_every == 0:
                        with span("train.save"):
                            self._save(step)
                if cfg.margin_delta_per_epoch:
                    self.update_margin(cfg.margin_delta_per_epoch)
        if not (self.ckpt and trained):
            return self.full_state()
        # the end-of-run save must be durable; its state is the result (one
        # gather over the model group, not two)
        state = self._save(self.step, force=True)
        if self.mesh.rank == 0:
            self.ckpt.wait()
        self.mesh.barrier()
        return state
