"""Fused ArcFace + softmax cross-entropy over class tiles (counterpart of
multimodalsimilar_tpu/ops/arcface_loss.py: ``arcface_ce_loss``,
``cosine_argmax``).

Softmax-CE needs three reductions of the [B, C] margin logits: the max,
the sum of exponentials and the target logit. ``arcface_ce_loss`` keeps
them online over class tiles, so the [B, C] logits never exist:

  forward:  per tile, the cosine of normalized x against the normalized
            weight tile, the margin on the target column, folded into a
            running (max, sumexp, target);
  backward: re-scans the tiles, rebuilds each tile's softmax from the
            saved (max, sumexp), and accumulates dx and dW tile by tile
            through the margin and both row normalizations.

It computes CE(arcface_logits(x, W, label, m, s), label) per example,
with the JAX module's formulas (the rsqrt normalization, the margin from
cos m and sin m). The JAX package runs it as a ``lax.scan`` (not Pallas),
so here it is a ``torch.autograd.Function`` whose per-tile products go to
``ops/topk.py:f32_products``: f32-accurate whatever the TF32 flag says.
Peak memory O(B·D + T·D + B·T) for tile T instead of O(B·C). The margin
is a float, so it gets no gradient (the JAX ``custom_vjp`` returns one
for a traced margin).

With a ``mesh`` the weight is this rank's block of classes (a head cut
over the mesh's model group, ``--model_parallel``) and the label each
row's column in it (-1 on another block): the forward streams the block,
then combines its (max, sum of exponentials, target logit) over the
model group, as ``train/tasks.py:_ShardedCrossEntropy`` does with whole
logits, and the backward scales the block's softmax by those global
statistics. The gradient of x is this block's share (the caller sums it
over the group, ``parallel/mesh.py:copy_to_group``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from multimodalsimilar_tpu_torch.ops.topk import f32_products
from multimodalsimilar_tpu_torch.parallel.mesh import MODEL_AXIS

EPS = 1e-12


def _inv_norms(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rsqrt(max(|v|^2, eps^2)), |v|^2 > eps^2) per row."""
    ss = (v * v).sum(-1, keepdim=True)
    return torch.rsqrt(ss.clamp_min(EPS * EPS)), ss > EPS * EPS


def _norm_rows(v: torch.Tensor) -> torch.Tensor:
    return v * _inv_norms(v)[0]


def _norm_rows_vjp(v: torch.Tensor, dvn: torch.Tensor) -> torch.Tensor:
    """The gradient through ``_norm_rows`` at ``v`` for output cotangent
    ``dvn``: dvn r - v r^3 <dvn, v> (the clamp's branch passes no
    gradient to the norm)."""
    r, live = _inv_norms(v)
    radial = v * (r * r * r) * (dvn * v).sum(-1, keepdim=True)
    return dvn * r - torch.where(live, radial, 0.0)


def _margin(cosine: torch.Tensor, is_target: torch.Tensor, m: float,
            s: float, easy_margin: bool):
    """(s * logits of the tile, d logits / d cosine on the target
    column)."""
    mt = torch.tensor(m, dtype=torch.float32, device=cosine.device)
    cos_m, sin_m = torch.cos(mt), torch.sin(mt)
    inside = 1.0 - cosine * cosine
    sine = torch.sqrt(inside.clamp(0.0, 1.0))
    phi = cosine * cos_m - sine * sin_m
    dsine = torch.where(inside > 0, -cosine / sine.clamp_min(EPS), 0.0)
    dphi = cos_m - sin_m * dsine
    apply = cosine > 0 if easy_margin else cosine + cos_m > 0
    phi = torch.where(apply, phi, cosine if easy_margin
                      else cosine - sin_m * mt)
    dphi = torch.where(apply, dphi, 1.0)
    return s * torch.where(is_target, phi, cosine), dphi


def _tiles(weight: torch.Tensor, label: torch.Tensor, tile_c: int):
    """(start, the tile's f32 weight rows, its is-target mask [B, T])."""
    for start in range(0, weight.shape[0], tile_c):
        w_tile = weight[start:start + tile_c].float()
        col = torch.arange(start, start + w_tile.shape[0],
                           device=weight.device)
        yield start, w_tile, col[None, :] == label.long()[:, None]


class ArcFaceCELoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, label, m, s, easy_margin, tile_c,
                mesh=None):
        xn = _norm_rows(x.float())
        b = x.shape[0]
        run_max = torch.full((b,), float("-inf"), device=x.device)
        run_sum = torch.zeros((b,), device=x.device)
        target = torch.zeros((b,), device=x.device)
        for _, w_tile, is_target in _tiles(weight, label, tile_c):
            logits, _ = _margin(f32_products(xn, _norm_rows(w_tile)),
                                is_target, m, s, easy_margin)
            new_max = torch.maximum(run_max, logits.max(1).values)
            # rescale the running sum to the new max (online logsumexp)
            run_sum = run_sum * torch.exp(run_max - new_max) + torch.exp(
                logits - new_max[:, None]).sum(1)
            target = target + torch.where(is_target, logits, 0.0).sum(1)
            run_max = new_max
        if mesh is not None:     # the statistics of every class block
            top = mesh.all_reduce(run_max.clone(), MODEL_AXIS, "max")
            run_sum = mesh.all_reduce(run_sum * torch.exp(run_max - top),
                                      MODEL_AXIS)
            target = mesh.all_reduce(target, MODEL_AXIS)
            run_max = top
        ctx.save_for_backward(x, weight, label, run_max, run_sum)
        ctx.margin = (m, s, easy_margin, tile_c)
        return run_max + torch.log(run_sum) - target

    @staticmethod
    def backward(ctx, g):
        x, weight, label, run_max, run_sum = ctx.saved_tensors
        m, s, easy_margin, tile_c = ctx.margin
        x32 = x.float()
        xn = _norm_rows(x32)
        g = g.float()
        dxn = torch.zeros_like(xn)
        dw = torch.empty(weight.shape, dtype=torch.float32,
                         device=weight.device)
        for start, w_tile, is_target in _tiles(weight, label, tile_c):
            wn = _norm_rows(w_tile)
            logits, dphi = _margin(f32_products(xn, wn), is_target, m, s,
                                   easy_margin)
            # d loss / d logits = softmax - onehot, from the saved stats
            p = torch.exp(logits - run_max[:, None]) / run_sum[:, None]
            dlogits = g[:, None] * (p - is_target.float())
            dcos = s * dlogits * torch.where(is_target, dphi, 1.0)
            dxn += f32_products(dcos, wn.T)
            dw[start:start + w_tile.shape[0]] = _norm_rows_vjp(
                w_tile, f32_products(dcos.T, xn.T))
        dx = _norm_rows_vjp(x32, dxn).to(x.dtype)
        return dx, dw.to(weight.dtype), None, None, None, None, None, None


def arcface_ce_loss(x: torch.Tensor, weight: torch.Tensor,
                    label: torch.Tensor, m: float, s: float = 64.0,
                    easy_margin: bool = False,
                    tile_c: int = 1024, mesh=None) -> torch.Tensor:
    """Per-example ArcFace cross-entropy [B], blockwise over classes:
    x [B, D] (any float type), weight [C, D], label [B] (-1 = no target:
    the loss is the log-sum-exp alone). Differentiable in x and weight.
    ``mesh``: ``weight`` is this rank's block of the classes over the
    mesh's model group (see the module docstring)."""
    if x.dim() != 2 or weight.dim() != 2 or x.shape[1] != weight.shape[1] \
            or label.shape != (x.shape[0],):
        raise ValueError(f"x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)} and label "
                         f"{tuple(label.shape)} must be [B, D], [C, D] "
                         f"and [B]")
    return ArcFaceCELoss.apply(x, weight, label, float(m), float(s),
                               bool(easy_margin), int(tile_c), mesh)


@torch.no_grad()
def cosine_max(x: torch.Tensor, weight: torch.Tensor,
               tile_c: int = 1024) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise (max, argmax) of the cosine logits [B] (f32, int64): the
    margin-free top-1 prediction without the [B, C] matrix; ties go to
    the lower class. No gradient (metrics only)."""
    xn = _norm_rows(x.float())
    b = x.shape[0]
    best_val = torch.full((b,), float("-inf"), device=x.device)
    best_idx = torch.zeros((b,), dtype=torch.int64, device=x.device)
    no_label = torch.full((b,), -1, device=x.device)
    for start, w_tile, _ in _tiles(weight, no_label, tile_c):
        cosine = f32_products(xn, _norm_rows(w_tile))
        tile_val, tile_idx = cosine.max(1)
        take = tile_val > best_val
        best_val = torch.where(take, tile_val, best_val)
        best_idx = torch.where(take, tile_idx + start, best_idx)
    return best_val, best_idx


def cosine_argmax(x: torch.Tensor, weight: torch.Tensor,
                  tile_c: int = 1024) -> torch.Tensor:
    """The argmax of ``cosine_max``."""
    return cosine_max(x, weight, tile_c)[1]
