"""Optimizers and LR schedules of the training recipes (counterpart of
multimodalsimilar_tpu/train/optim.py).

* ``linear_schedule_with_warmup`` — HF ``get_scheduler("linear", ...)``
  semantics (nlp_classifier_train.py:91-97): linear ramp 0 -> lr over the
  warmup steps, then linear decay to 0 at total steps; fractional warmup
  is accepted.
* ``cosine_warm_restarts`` — torch ``CosineAnnealingWarmRestarts(T_0)``
  (cv_classifier_train_daodian.py:264-267), per step with
  ``steps_per_epoch`` scaling.
* ``timm_cosine_schedule`` — timm ``CosineLRScheduler(t_initial,
  warmup_t, warmup_lr_init)`` as cv_classifier_train.py:68-72 uses it:
  per-epoch LR, the cosine not shifted by the warmup, ``lr_min`` after
  ``t_initial`` epochs.
* ``AdamP`` — timm ``AdamP`` (Heo et al.) with the JAX package's channel
  views (``adamp_views``), as a ``torch.optim.Optimizer``; over a mesh
  (``AdamP.shard``) the sums behind its projection of a parameter cut
  over the model group are reduced over that group, so every rank
  projects its block as one device projects the whole.
* ``dual_group`` / ``dual_group_adamw`` — the reference's two-optimizer
  pattern (tower and head, nlp_classifier_train.py:89-97; dual AdamP,
  cv_classifier_train.py:68-72) as one optimizer with two parameter
  groups, each with its own schedule. ``GroupSchedules`` sets every
  group's LR from its schedule at the optimizer-step count, so the LR at
  optimizer step t equals optax's schedule at count t.

Every schedule computes in float32 like the JAX schedules, so both give
the same value at every step.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from multimodalsimilar_tpu_torch.parallel.mesh import MODEL_AXIS

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


def cosine_warm_restarts(lr: float, t0_epochs: int, steps_per_epoch: int,
                         t_mult: int = 1, eta_min: float = 0.0) -> Schedule:
    """eta_min + (lr - eta_min) * (1 + cos(pi * t_cur / T_i)) / 2,
    restarting every T_i epochs, T_{i+1} = T_i * t_mult."""
    t0 = t0_epochs * steps_per_epoch
    f32 = np.float32

    def schedule(step: int) -> float:
        step = f32(step)
        if t_mult == 1:
            t_cur, t_i = np.fmod(step, f32(t0)), f32(t0)
        else:
            # closed form for geometric restarts
            n = np.floor(np.log1p(f32(t_mult - 1) * step / f32(t0))
                         / f32(math.log(t_mult)))
            power = f32(t_mult) ** n
            t_cur = step - f32(t0) * (power - f32(1)) / f32(t_mult - 1)
            t_i = f32(t0) * power
        cos = f32(1) + np.cos(f32(np.pi) * t_cur / t_i)
        return float(f32(eta_min) + f32((lr - eta_min) * 0.5) * cos)

    return schedule


def timm_cosine_schedule(lr: float, t_initial: int, steps_per_epoch: int,
                         warmup_t: int = 5, warmup_lr_init: float = 1e-3,
                         lr_min: float = 0.0) -> Schedule:
    """timm CosineLRScheduler with t_in_epochs=True, warmup_prefix=False,
    cycle_limit=1. The LR is a function of the epoch t:

      t < warmup_t:   warmup_lr_init + t * (lr - warmup_lr_init) / warmup_t
      t < t_initial:  lr_min + (lr - lr_min) / 2 * (1 + cos(pi t / t_initial))
      t >= t_initial: lr_min   (the cooldown epochs)
    """
    f32 = np.float32

    def schedule(step: int) -> float:
        t = f32(step) // f32(steps_per_epoch)
        if t >= t_initial:
            return float(f32(lr_min))
        if t < warmup_t:
            return float(f32(warmup_lr_init) + t * f32(lr - warmup_lr_init)
                         / f32(max(warmup_t, 1)))
        cos = f32(1) + np.cos(f32(np.pi) * t / f32(t_initial))
        return float(f32(lr_min) + f32((lr - lr_min) * 0.5) * cos)

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
    """``dual_group`` of ``torch.optim.AdamW``."""
    return dual_group(model, torch.optim.AdamW, tower_schedule,
                      head_schedule, weight_decay, head_weight_decay,
                      betas=(b1, b2), eps=eps)


# (view shape, channel axis) of a parameter for AdamP's channel test
View = Tuple[Tuple[int, ...], int]


def adamp_views(model: nn.Module) -> Dict[nn.Parameter, View]:
    """The channel view the JAX package's ``adamp`` takes of each weight
    whose torch layout differs from Flax's: JAX views a weight per channel
    as ``moveaxis(x, -1, 0)`` (Flax puts output features last). For
    torch ``Linear`` and ``Conv2d`` weights that is dim 0, the default.
    The exceptions: ArcFace head weights ([C, D] in both packages, so JAX
    takes D columns) and embedding tables ([V, H], H columns) take axis 1;
    BERT's query, key and value weights (Flax kernels [in, heads,
    head_dim]) take the head_dim axis of a (heads, head_dim, in) view, and
    their biases (Flax [heads, head_dim], so projected) axis 1 of a
    (heads, head_dim) view. ViT: ``cls_token`` [1, 1, D] and
    ``pos_embed`` [1, N, D] take axis 2 (D, Flax's last axis); the packed
    ``attn.qkv`` weight [3D, D] (Flax [D, 3, heads, head_dim]) the
    head_dim axis of a (3, heads, head_dim, D) view, and its bias (Flax
    [3, heads, head_dim], so projected) axis 2 of (3, heads, head_dim).
    Everything else, ConvNeXt included (its depthwise [C, 1, 7, 7] is
    Flax's [7, 7, 1, C]), takes dim 0."""
    from multimodalsimilar_tpu_torch.models.bert import BertLayer
    from multimodalsimilar_tpu_torch.models.heads import ArcFaceHead
    from multimodalsimilar_tpu_torch.models.vit import ViT, ViTBlock
    views: Dict[nn.Parameter, View] = {}
    for m in model.modules():
        if isinstance(m, (ArcFaceHead, nn.Embedding)):
            views[m.weight] = (tuple(m.weight.shape), 1)
        elif isinstance(m, BertLayer):
            nh = m.num_heads
            for name in ("query", "key", "value"):
                lin = getattr(m.attention.self, name)
                out, inp = lin.weight.shape
                views[lin.weight] = ((nh, out // nh, inp), 1)
                views[lin.bias] = ((nh, out // nh), 1)
        elif isinstance(m, ViT):
            for p in (m.cls_token, m.pos_embed):
                views[p] = (tuple(p.shape), 2)
        elif isinstance(m, ViTBlock):
            nh, qkv = m.num_heads, m.attn.qkv
            d = qkv.weight.shape[1]
            views[qkv.weight] = ((3, nh, d // nh, d), 2)
            views[qkv.bias] = ((3, nh, d // nh), 2)
    return views


def _channel_rows(x: torch.Tensor, view: View) -> torch.Tensor:
    shape, axis = view
    return x.reshape(shape).movedim(axis, 0).reshape(shape[axis], -1)


def _view_dim(shape: tuple, view: View, dim: int) -> int:
    """The dimension of ``view`` whose blocks are the blocks of dimension
    ``dim`` of a parameter of ``shape`` (the view splits ``dim`` with its
    leading factor first)."""
    before = math.prod(shape[:dim])
    for k in range(len(view[0])):
        if math.prod(view[0][:k]) == before:
            return k
    raise ValueError(f"no dimension of the view {view} starts at dim {dim} "
                     f"of {shape}")


def _adamp_project(p, g, perturb, view: View, delta, wd_ratio, eps,
                   split=None):
    """AdamP's tangent-space projection, as the JAX package's
    ``_adamp_project`` computes it: candidate channel and layer views,
    selected with ``where`` (no host sync). Returns (perturb, the
    weight-decay factor as a 0-d tensor).

    ``split`` = (mesh, view dimension): ``p`` is this rank's block of a
    parameter cut along that dimension over the mesh's model group. Where
    the blocks split the view's rows (the channel axis), each row is
    whole here and only the test's max over rows spans the group; where
    they split the rows' contents, the per-row sums (and the length of
    a row) span it. Both are reduced over the group, so every rank
    decides and projects as one device does for the whole."""
    mesh, vdim = split if split is not None else (None, None)

    def candidate(rows, rows_split):
        pv, gv, nv = rows(p), rows(g), rows(perturb)
        sums = torch.stack([(pv * gv).sum(1), (pv * pv).sum(1),
                            (gv * gv).sum(1)])
        length = pv.shape[1]
        content = mesh is not None and not rows_split
        if content:
            sums = mesh.all_reduce(sums, MODEL_AXIS)
            length *= mesh.model
        dot, np_, ng = sums[0], sums[1].sqrt(), sums[2].sqrt()
        cos = (dot / (np_.clamp_min(eps) * ng.clamp_min(eps))).abs()
        top = cos.max()
        if mesh is not None and rows_split:
            top = mesh.all_reduce(top.reshape(1), MODEL_AXIS, "max")[0]
        cond = top < delta / math.sqrt(length)
        pn = pv / (np_[:, None] + eps)
        radial = (pn * nv).sum(1, keepdim=True)
        if content:
            radial = mesh.all_reduce(radial, MODEL_AXIS)
        return cond, nv - pn * radial

    shape, axis = view
    c1, proj1 = candidate(lambda x: _channel_rows(x, view), vdim == axis)
    moved = (shape[axis],) + shape[:axis] + shape[axis + 1:]
    proj1 = proj1.reshape(moved).movedim(0, axis).reshape(p.shape)
    c2, proj2 = candidate(lambda x: x.reshape(1, -1), False)
    out = torch.where(c1, proj1,
                      torch.where(c2, proj2.reshape(p.shape), perturb))
    one = torch.ones((), dtype=p.dtype, device=p.device)
    return out, torch.where(c1 | c2, one * wd_ratio, one)


class AdamP(torch.optim.Optimizer):
    """timm's AdamP (cv_classifier_train.py:68): Adam moments, and on
    weights that look scale-invariant (|cos(w, g)| below
    delta / sqrt(row length) in the channel or the whole-layer view) the
    radial part of the update removed and the weight decay scaled by
    ``wd_ratio``. Per step, with t counted from 1:

      m, v    <- Adam moments of g
      perturb  = m_hat / (sqrt(v) / sqrt(1 - b2^t) + eps)
                 (nesterov: b1 m + (1 - b1) g in place of m)
      p       <- p - (lr / (1 - b1^t)) perturb - lr wd wd_factor p

    in the JAX package's order of operations. ``views`` maps a parameter
    to its (shape, channel axis), ``adamp_views(model)``; others take
    dim-0 rows, and 1-d parameters (in their view) are not projected."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 delta: float = 0.1, wd_ratio: float = 0.1,
                 nesterov: bool = False,
                 views: Dict[nn.Parameter, View] = None):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay,
                                      delta=delta, wd_ratio=wd_ratio,
                                      nesterov=nesterov))
        self.views = dict(views or {})
        self.splits: Dict[nn.Parameter, tuple] = {}

    def shard(self, dims: Dict[nn.Parameter, int], mesh) -> None:
        """The parameters cut over ``mesh``'s model group, with the
        dimension each was cut on (the Trainer's shards): their
        projections reduce over the group. Every rank steps together."""
        for p, dim in dims.items():
            view = self.views.get(p, (tuple(p.shape), 0))
            self.splits[p] = (mesh, _view_dim(tuple(p.shape), view, dim))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamP takes no closure")
        for group in self.param_groups:
            b1, b2 = group["betas"]
            eps, lr = group["eps"], group["lr"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                state = self.state[p]
                if not state:
                    state["step"] = torch.zeros((), dtype=torch.float32,
                                                device=p.device)
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                state["step"] += 1
                t = state["step"]
                bc1 = 1 - b1 ** t
                bc2 = 1 - b2 ** t
                m = state["exp_avg"].mul_(b1).add_((1 - b1) * g)
                v = state["exp_avg_sq"].mul_(b2).add_((1 - b2) * g * g)
                denom = torch.sqrt(v) / torch.sqrt(bc2) + eps
                perturb = ((b1 * m + (1 - b1) * g) if group["nesterov"]
                           else m) / denom
                view = self.views.get(p, (tuple(p.shape), 0))
                wd = 1.0
                if len(view[0]) > 1:
                    perturb, wd = _adamp_project(
                        p, g, perturb, view, group["delta"],
                        group["wd_ratio"], eps, self.splits.get(p))
                update = -(lr / bc1) * perturb
                if group["weight_decay"] > 0:
                    update = update - lr * group["weight_decay"] * wd * p
                p.add_(update)


def dual_group(model: nn.Module, optimizer: type, tower_schedule: Schedule,
               head_schedule: Schedule, weight_decay: float = 0.0,
               head_weight_decay: float = None, **kw
               ) -> Tuple[torch.optim.Optimizer, GroupSchedules]:
    """``optimizer`` (``torch.optim.AdamW`` or ``AdamP``; ``kw`` to its
    constructor) over a tower group and a head group split by parameter
    path (``is_head_param``), each with its own schedule and weight
    decay (``head_weight_decay`` defaults to ``weight_decay``). AdamW's
    decoupled decay is optax.adamw's: both subtract lr * wd * p from the
    old p."""
    tower, head = [], []
    for name, p in model.named_parameters():
        if p.requires_grad:
            (head if is_head_param(name) else tower).append(p)
    if head_weight_decay is None:
        head_weight_decay = weight_decay
    opt = optimizer([{"params": tower, "weight_decay": weight_decay},
                     {"params": head, "weight_decay": head_weight_decay}],
                    lr=0.0, **kw)
    return opt, GroupSchedules(opt, [tower_schedule, head_schedule])
