"""Pipeline parallelism (GPipe) of the BERT text tower (counterpart of
multimodalsimilar_tpu/parallel/pp.py), over the mesh's model group.

The JAX package stacks the L layers into one ``[L, ...]`` tree sharded
over the model axis and runs the schedule as one SPMD program
(``lax.scan`` over the ticks, ``lax.ppermute`` between stages, JAX's AD
for the backward). The port runs one process per stage:

* a model built inside ``building(mesh)`` holds, in every BERT encoder
  whose ``BertConfig.pipeline_parallel`` is set, only this rank's
  ``L/P`` layers, under their global names ``encoder.layer.{i}``
  (``models/bert.py``); its optimizer moments follow;
* ``gpipe`` runs the schedule as a loop over ``T = M + P - 1`` ticks: at
  tick t every rank hands its previous tick's output to the next stage
  (``Mesh.shift``, JAX's ``ppermute`` over (i, i + 1); stage 0 receives
  zeros), and stage s runs microbatch ``t - s`` through its layers when
  ``0 <= t - s < M`` (stage 0 takes it from the input). Idle ticks run
  nothing and hand on zeros;
* the last stage's M outputs, concatenated, go to every rank of the
  model group (``broadcast_from``, JAX's ``psum`` of a tensor that is
  zero off the last stage), where the pooler and the heads run;
* the backward is driven by the schedule, not left to autograd's order:
  the ticks run in reverse, stage s back-propagates its tick's output
  gradient (from the next stage's reverse shift, on the last stage from
  the broadcast result) through its layers for that microbatch and hands
  its input's gradient to the previous stage. Every rank issues the same
  shifts in the same order in both directions, whatever its stage and
  whatever its autograd graph holds, so no rank waits on a hand-off its
  neighbour skips. Stage 0 returns the input's gradient; the others
  return zeros for it (the embeddings' gradient is theirs on stage 0
  only: the Trainer sums it over the model group).

A local batch that does not split into M microbatches (an eval batch's
tail) runs the same schedule with M = 1: JAX's sequential fallback, which
gathers each layer as its scan needs it, has no counterpart where each
rank holds only its own layers. ``applied_count`` counts the runs with
the configured M (the Trainer's half-configured check).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, List

import torch

from multimodalsimilar_tpu_torch.parallel.mesh import (MODEL_AXIS,
                                                       broadcast_from)

_TLS = threading.local()


def check_mesh(mesh) -> None:
    """The JAX package's ``pp._check_mesh``: one stage is no pipeline."""
    if mesh.shape.get(MODEL_AXIS, 1) <= 1:
        raise ValueError(
            f"pipeline_parallel needs a mesh model axis > 1, got "
            f"{dict(mesh.shape)} — pass --model_parallel N or drop "
            f"--pipeline_parallel")


@dataclasses.dataclass(frozen=True)
class Stage:
    """One encoder's stage on this rank: the mesh and the global indices
    of the layers it holds."""
    mesh: object
    layers: range


@contextlib.contextmanager
def building(mesh):
    """Models built inside (this thread only) hold this rank's stage of
    each pipeline-parallel BERT encoder; restores the previous scope on
    exit."""
    check_mesh(mesh)
    prev = building_mesh()
    _TLS.mesh = mesh
    try:
        yield
    finally:
        _TLS.mesh = prev


def building_mesh():
    """The mesh of the enclosing ``building`` scope, or None."""
    return getattr(_TLS, "mesh", None)


def applied_count() -> int:
    """How many times this thread ran the schedule with the configured
    microbatch count."""
    return getattr(_TLS, "applied", 0)


def stage_of(num_layers: int, mesh) -> Stage:
    """This rank's stage of ``num_layers`` layers over the model group."""
    n = mesh.model
    if num_layers % n:
        raise ValueError(
            f"pipeline_parallel: {num_layers} layers not divisible by the "
            f"mesh model axis ({n} stages)")
    size = num_layers // n
    first = mesh.model_index * size
    return Stage(mesh, range(first, first + size))


def microbatch(x: torch.Tensor, m: int) -> List[torch.Tensor]:
    """``x`` cut into ``m`` equal blocks of rows (views)."""
    b = x.shape[0]
    if b % m:
        raise ValueError(f"pipeline microbatching: per-chip batch {b} not "
                         f"divisible by pp_microbatches={m}")
    return list(x.split(b // m))


def _ticks(run, xs, masks, mesh, grad: bool):
    """The forward ticks; (inputs, outputs) of this stage's microbatches,
    each input a leaf that takes its gradient when ``grad``."""
    n, s, m = mesh.model, mesh.model_index, len(xs)
    rows = xs[0].shape[0]
    zeros = torch.zeros_like(xs[0])
    ins: list = [None] * m
    outs: list = [None] * m
    state = zeros
    for t in range(m + n - 1):
        recv = mesh.shift(state) if t else zeros
        mu, state = t - s, zeros
        if 0 <= mu < m:
            h = (xs[mu] if s == 0 else recv).detach().requires_grad_(grad)
            with torch.set_grad_enabled(grad):
                y = run(h, masks[mu], slice(mu * rows, (mu + 1) * rows))
            ins[mu], outs[mu], state = h, y, y.detach()
    return ins, outs


def _result(outs, x, mesh) -> torch.Tensor:
    if mesh.model_index == mesh.model - 1:
        return torch.cat([y.detach() for y in outs])
    return torch.zeros_like(x)


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mask_bias, run, mesh, m):
        ins, outs = _ticks(run, microbatch(x, m), microbatch(mask_bias, m),
                           mesh, grad=True)
        ctx.graph, ctx.mesh = (ins, outs), mesh
        return _result(outs, x, mesh)

    @staticmethod
    def backward(ctx, grad):
        (ins, outs), mesh = ctx.graph, ctx.mesh
        del ctx.graph
        n, s, m = mesh.model, mesh.model_index, len(outs)
        last = s == n - 1
        grads = microbatch(grad, m) if last else None
        zeros = torch.zeros_like(outs[0])
        g_x: list = [None] * m
        g_out = zeros          # this stage's output gradient at tick t
        for t in reversed(range(m + n - 1)):
            mu, g_in = t - s, zeros
            if 0 <= mu < m:
                torch.autograd.backward(outs[mu],
                                        grads[mu] if last else g_out)
                g_in = ins[mu].grad
                g_x[mu] = g_in
            if t:
                g_out = mesh.shift(g_in, reverse=True)
        g = torch.cat(g_x) if s == 0 else torch.zeros_like(grad)
        return g, None, None, None, None


def gpipe(run: Callable, x: torch.Tensor, mask_bias: torch.Tensor, mesh,
          microbatches: int) -> torch.Tensor:
    """``x`` [B, ...] through the stages' layers over the model group of
    ``mesh``, in ``microbatches`` microbatches (see the module
    docstring); every rank gets the result. ``run(h, mask_bias, rows)``
    applies this rank's layers to the microbatch ``h`` (rows ``rows`` of
    the local batch) with its rows of ``mask_bias``."""
    m = int(microbatches)
    if m < 1:
        raise ValueError(f"pp_microbatches must be >= 1, got {m}")
    if x.shape[0] % m:
        m = 1                      # the stages in turn (see above)
    else:
        _TLS.applied = applied_count() + 1
    if torch.is_grad_enabled() and x.requires_grad:
        out = _GPipe.apply(x, mask_bias, run, mesh, m)
    else:
        _, outs = _ticks(run, microbatch(x, m), microbatch(mask_bias, m),
                         mesh, grad=False)
        out = _result(outs, x, mesh)
    return broadcast_from(out, mesh, mesh.model - 1)
