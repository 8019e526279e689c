"""The (data, model) device mesh over ``torch.distributed`` (counterpart
of multimodalsimilar_tpu/parallel/mesh.py).

The JAX package runs one SPMD program over a ``jax.sharding.Mesh`` and
lets XLA insert the collectives. The port runs one process per card
(``torchrun``, or ``parallel/spawn.py`` in the tests and
``chip_smoke.py``) and calls the collectives itself, on two families of
process groups:

* rank ``r`` sits at mesh coordinate ``(r // model, r % model)``, as
  ``np.asarray(devices).reshape(data, model)`` places devices in JAX;
* its **data group** holds the ranks with its model coordinate (the
  gradient all-reduce, the corpus-sharded search, BatchNorm's global
  statistics); its **model group** the ranks with its data coordinate,
  which see the same batch (the class-sharded ArcFace heads, the tensor-
  and sequence-parallel tower of ``parallel/tp.py``).

The autograd functions at the end are the collectives a model runs in its
forward, each with its conjugate in the backward (Megatron's ``f``/``g``
and the sequence-parallel pair): ``copy_to_group`` (identity, then an
all-reduce of the gradient), ``reduce_from_group`` (all-reduce, then the
identity), ``reduce_scatter_along`` / ``gather_along`` (a reduce-scatter
or an all-gather along one dimension, the other in the backward),
``split_along`` (this rank's block of a tensor every rank holds whole,
gathered in the backward) and ``broadcast_from`` (one rank's tensor on
every rank of the group, the pipeline's last stage's result). The
pipeline's stage hand-off, ``Mesh.shift`` (JAX's ``ppermute`` over the
pairs (i, i + 1)), is called by the schedule itself in both directions
(``parallel/pp.py`` drives its own backward).

Without a process group (a plain one-process run) the mesh is 1 x 1 and
every collective is the identity. With one, even of one rank, every
collective runs through the backend: NCCL when each rank has its own
card, gloo on the CPU.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import sys
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
# how long a collective may wait for its peers before the rank fails
TIMEOUT = datetime.timedelta(seconds=300)
# how long a serving follower waits for the next request (Mesh.control_group)
IDLE_TIMEOUT = datetime.timedelta(days=365)


def init_distributed(device="cuda") -> int:
    """Join the process group that ``torchrun`` describes in the
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``/``MASTER_PORT``); returns the world size.

    On a card each rank takes ``cuda:LOCAL_RANK`` as its current device
    and the backend is NCCL; ``device="cpu"`` joins over gloo. The failure
    policy is the JAX package's (``mesh.py:40-53``): a plain one-process
    run (``WORLD_SIZE`` unset or 1) goes on as world 1 without a process
    group, and a cluster that was asked for but cannot be joined raises
    rather than run N independent jobs."""
    if dist.is_initialized():
        return dist.get_world_size()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        print("torch.distributed not initialized (WORLD_SIZE unset or 1); "
              "single-process mode", file=sys.stderr, flush=True)
        return 1
    rank = int(os.environ["RANK"])
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world, timeout=TIMEOUT)
    return world


class Mesh:
    """This rank's view of a ``(data, model)`` mesh: the shape, its
    coordinates, its two process groups and the collectives over them.
    Build it with ``create_mesh``."""

    def __init__(self, data: int, model: int, rank: int = 0,
                 groups: Optional[Dict[str, Any]] = None):
        self.data, self.model, self.rank = data, model, rank
        self._groups = groups or {}
        self._control = None

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def distributed(self) -> bool:
        """True when the collectives run through a process group."""
        return bool(self._groups)

    def group(self, axis: str):
        """The process group of ``axis`` (None without one)."""
        return self._groups.get(axis)

    def __repr__(self) -> str:
        return (f"Mesh(data={self.data}, model={self.model}, "
                f"rank={self.rank}, distributed={self.distributed})")

    # -- collectives ------------------------------------------------------

    def all_reduce(self, t: torch.Tensor, axis: str = DATA_AXIS,
                   op: str = "sum") -> torch.Tensor:
        """``t`` reduced in place over ``axis`` (``op``: sum, mean, max or
        min); returns ``t``. A mean divides the sum by the axis size."""
        group = self.group(axis)
        if group is None:
            return t
        red = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
               "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[op]
        dist.all_reduce(t, op=red, group=group)
        if op == "mean":
            t.div_(self.shape[axis])
        return t

    def all_gather(self, t: torch.Tensor,
                   axis: str = DATA_AXIS) -> torch.Tensor:
        """[axis size, *t.shape]: ``t`` of every rank of the axis, in
        coordinate order."""
        group = self.group(axis)
        if group is None:
            return t[None]
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.shape[axis])]
        dist.all_gather(parts, t, group=group)
        return torch.stack(parts)

    def all_gather_rows(self, t: torch.Tensor,
                        axis: str = DATA_AXIS) -> torch.Tensor:
        """The rows of ``t`` [n_r, ...] of every rank of the axis,
        concatenated in coordinate order; ``n_r`` may differ by rank."""
        if self.group(axis) is None:
            return t
        n = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
        counts = self.all_gather(n, axis)[:, 0].tolist()
        pad = torch.zeros((max(counts),) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        pad[:t.shape[0]] = t
        parts = self.all_gather(pad, axis)
        return torch.cat([p[:c] for p, c in zip(parts, counts)])

    def reduce_scatter(self, t: torch.Tensor, dim: int,
                       axis: str = MODEL_AXIS) -> torch.Tensor:
        """The sum of ``t`` over ``axis``, cut along ``dim`` into as many
        equal blocks as the axis has ranks: this rank's block (a new
        tensor; ``t`` is left as it is). NCCL and gloo, on the CPU and on
        CUDA tensors, both run the tensor-in, tensor-out collective."""
        group = self.group(axis)
        if group is None:
            return t
        n = self.shape[axis]
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} not divisible "
                             f"by {n} ranks")
        x = t.movedim(dim, 0).contiguous()
        out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, group=group)
        return out.movedim(0, dim)

    def all_gather_dim(self, t: torch.Tensor, dim: int,
                       axis: str = MODEL_AXIS) -> torch.Tensor:
        """``t`` of every rank of ``axis`` concatenated along ``dim`` in
        coordinate order (equal shapes)."""
        group = self.group(axis)
        if group is None:
            return t
        x = t.movedim(dim, 0).contiguous()
        out = x.new_empty((x.shape[0] * self.shape[axis],)
                          + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out.movedim(0, dim)

    def _peer(self, index: int, axis: str) -> int:
        """The global rank at coordinate ``index`` of this rank's ``axis``
        group."""
        if axis == MODEL_AXIS:
            return self.data_index * self.model + index
        return index * self.model + self.model_index

    def _index(self, axis: str) -> int:
        return self.model_index if axis == MODEL_AXIS else self.data_index

    def shift(self, t: torch.Tensor, reverse: bool = False,
              axis: str = MODEL_AXIS) -> torch.Tensor:
        """JAX's ``ppermute`` over the pairs (i, i + 1) of ``axis`` (the
        pairs (i + 1, i) when ``reverse``): ``t`` goes to the next rank of
        the group and the previous rank's ``t`` comes back; the first rank
        (the last when ``reverse``) has no previous one and gets zeros.
        Every rank of the group calls it with a tensor of one shape and
        dtype. The backend is chosen, not tried: NCCL moves the tensors
        between the cards, gloo moves host tensors, so a CUDA tensor goes
        through a host copy each way."""
        out = torch.zeros_like(t)
        group, n = self.group(axis), self.shape[axis]
        if group is None or n == 1:
            return out
        step = -1 if reverse else 1
        dst, src = self._index(axis) + step, self._index(axis) - step
        host = t.is_cuda and dist.get_backend(group) == "gloo"
        send = t.detach().to("cpu" if host else t.device).contiguous()
        recv = torch.empty_like(send)
        ops = []
        if 0 <= src < n:
            ops.append(dist.P2POp(dist.irecv, recv, self._peer(src, axis),
                                  group))
        if 0 <= dst < n:
            ops.append(dist.P2POp(dist.isend, send, self._peer(dst, axis),
                                  group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if 0 <= src < n:
            out.copy_(recv)
        return out

    def broadcast(self, t: torch.Tensor, index: int,
                  axis: str = MODEL_AXIS) -> torch.Tensor:
        """``t`` of the rank at coordinate ``index`` of ``axis``, in place
        on every rank of the group; returns ``t``."""
        group = self.group(axis)
        if group is not None:
            dist.broadcast(t, src=self._peer(index, axis), group=group)
        return t

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        """``obj`` of global rank ``src`` on every rank."""
        if not self.distributed:
            return obj
        box: List[Any] = [obj]
        dist.broadcast_object_list(box, src=src)
        return box[0]

    def barrier(self) -> None:
        if self.distributed:
            dist.barrier()

    def control_group(self):
        """A gloo group over every rank whose collectives, on host
        tensors, wait without a practical time limit: the serving
        followers block in it between requests, however long the daemon
        stays idle (``pipelines/sharded_serving.py``). Made at the first
        call, which is a collective: every rank calls it at the same
        point."""
        if self._control is None:
            self._control = dist.new_group(backend="gloo",
                                           timeout=IDLE_TIMEOUT)
        return self._control


def create_mesh(data: Optional[int] = None, model: int = 1) -> Mesh:
    """The ``(data, model)`` mesh over every rank of the process group
    (one rank, without one). With ``model=1`` every rank sits on the data
    axis. Every rank must call it, in the same order as its other
    ``create_mesh`` calls: building the process groups is collective."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data is None:
        if world % model != 0:
            raise ValueError(f"{world} devices not divisible by "
                             f"model={model}")
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} devices")
    if not dist.is_initialized():
        return Mesh(data, model)
    rank = dist.get_rank()
    layout = np.arange(world).reshape(data, model)
    groups = {}
    for axis, lines in ((MODEL_AXIS, layout), (DATA_AXIS, layout.T)):
        for ranks in lines:
            group = dist.new_group([int(r) for r in ranks])
            if rank in ranks:
                groups[axis] = group
    return Mesh(data, model, rank, groups)


class Shard(NamedTuple):
    """A parameter cut to this rank's block along ``dim`` over the model
    group (a class-sharded head, a tensor-parallel weight), and the
    length of that dimension in the one-card layout."""
    param: torch.nn.Parameter
    dim: int
    size: int


def _block(n: int, parts: int, index: int) -> slice:
    if n % parts:
        raise ValueError(f"{n} rows not divisible by {parts} shards")
    step = n // parts
    return slice(index * step, (index + 1) * step)


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """Which block of each array this rank holds (the JAX package's
    NamedShardings: batch on ``data``, ArcFace class weights [C, D] on
    ``model``, the retrieval corpus [N, D] on ``data``)."""

    mesh: Mesh

    def batch(self, n: int) -> slice:
        return _block(n, self.mesh.data, self.mesh.data_index)

    def class_sharded(self, num_classes: int) -> slice:
        return _block(num_classes, self.mesh.model, self.mesh.model_index)

    def corpus_sharded(self, n: int) -> slice:
        return _block(n, self.mesh.data, self.mesh.data_index)


def shard_batch(mesh: Mesh, batch: Dict[str, Any],
                strict: bool = False) -> Dict[str, Any]:
    """This rank's part of a host batch (numpy arrays or tensors, the
    same global batch on every rank): each leaf whose leading dim divides
    by the data axis is cut to this rank's block of rows; the rest
    (scalars, metadata, an indivisible batch) stay whole on every rank,
    as the JAX package replicates them. ``strict=True`` refuses an
    indivisible leaf instead (the ``--bf16_grads`` path, whose per-rank
    gradients would otherwise each cover the whole batch)."""
    n_data = mesh.data
    bad = [tuple(v.shape) for v in batch.values()
           if getattr(v, "ndim", 0) >= 1 and v.shape[0] % n_data]
    if strict and bad:
        raise ValueError(
            f"bf16_grad_allreduce: batch dims {bad} are not divisible by "
            f"the data axis ({n_data} devices); pad the batch (batch "
            f"sources do by default) or drop --bf16_grads")
    if n_data == 1:
        return batch
    rows = MeshRules(mesh).batch
    return {k: v[rows(v.shape[0])] if getattr(v, "ndim", 0) >= 1
            and v.shape[0] % n_data == 0 else v for k, v in batch.items()}


# -- collectives in the forward, with their conjugates in the backward -------

class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad.contiguous().clone(),
                                   ctx.axis), None, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.reduce_scatter(x, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_gather_dim(grad, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, partial_grads):
        ctx.mesh, ctx.dim, ctx.partial = mesh, dim, partial_grads
        return mesh.all_gather_dim(x, dim)

    @staticmethod
    def backward(ctx, grad):
        mesh, dim = ctx.mesh, ctx.dim
        if ctx.partial:
            return mesh.reduce_scatter(grad, dim), None, None, None
        return _own_block(grad, mesh, dim), None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return _own_block(x, mesh, dim)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_gather_dim(grad.contiguous(), ctx.dim), None, None


class _BroadcastFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, index):
        ctx.source = mesh.model_index == index
        return mesh.broadcast(x.detach().contiguous().clone(), index)

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.source else torch.zeros_like(grad)), None, None


def _own_block(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    size = x.shape[dim] // mesh.model
    return x.narrow(dim, mesh.model_index * size, size).contiguous()


def copy_to_group(x: torch.Tensor, mesh: Mesh,
                  axis: str = MODEL_AXIS) -> torch.Tensor:
    """Identity; the backward sums the gradient over ``axis`` (the input
    of a product whose blocks lie on the ranks: each adds its share)."""
    return _CopyToGroup.apply(x, mesh, axis)


def reduce_from_group(x: torch.Tensor, mesh: Mesh,
                      axis: str = MODEL_AXIS) -> torch.Tensor:
    """The sum of every rank's partial ``x`` over ``axis``; the backward
    passes the (whole, equal on every rank) gradient through."""
    return _ReduceFromGroup.apply(x, mesh, axis)


def reduce_scatter_along(x: torch.Tensor, mesh: Mesh,
                         dim: int) -> torch.Tensor:
    """The sum of every rank's partial ``x`` over the model group, this
    rank's block along ``dim``; the backward all-gathers the blocks'
    gradients."""
    return _ReduceScatter.apply(x, mesh, dim)


def gather_along(x: torch.Tensor, mesh: Mesh, dim: int,
                 partial_grads: bool = True) -> torch.Tensor:
    """Every rank's block of ``x`` along ``dim``, concatenated over the
    model group. The backward reduce-scatters when each rank's gradient
    of the whole is partial (the input of a column-parallel product);
    with ``partial_grads=False`` (the whole used alike on every rank) it
    keeps this rank's block of it."""
    return _Gather.apply(x, mesh, dim, partial_grads)


def split_along(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of an ``x`` every rank of the model
    group holds whole; the backward all-gathers the blocks' gradients."""
    return _Split.apply(x, mesh, dim)


def broadcast_from(x: torch.Tensor, mesh: Mesh, index: int) -> torch.Tensor:
    """``x`` of the rank at model coordinate ``index`` on every rank of the
    model group (what the others pass only gives the shape). The result
    is used alike on every rank, past the model group's sum of the
    partial gradients (a class-sharded head's ``copy_to_group``), so every
    rank's gradient of it is the whole: the backward keeps the source's
    and gives the others zeros."""
    return _BroadcastFrom.apply(x, mesh, index)
