"""Sequence parallelism of the BERT text tower (counterpart of
multimodalsimilar_tpu/parallel/sp.py), Megatron-SP over the tensor-
parallel model group.

The JAX package constrains the residual stream to ``P(data, model)`` at
the boundary points of ``models/bert.py:170-190`` (the outputs of the
row-parallel attention and MLP products and of both LayerNorms, and the
embeddings' LayerNorm) and lets GSPMD pick the collectives. The port
calls them itself (``parallel/mesh.py``): between those points each rank
holds its block of the sequence, [B, S/N, H];

* into a column-parallel product the blocks are all-gathered (the
  backward reduce-scatters the partial gradients): ``from_sequence``;
* out of a row-parallel product the partial sums are reduce-scattered
  along the sequence (the backward all-gathers): ``to_sequence``;
* a tensor every rank holds whole (a replicated block's output, the
  position and type embeddings) is split into blocks (the backward
  all-gathers), and one that leaves the region for replicated work (the
  pooler's token 0) is gathered, the backward keeping this rank's block.

A length S that does not divide by N is padded to the next multiple
inside the region, as XLA pads internally (JAX ``sp.py``: correctness
never depends on divisibility); the pad rows never reach attention or an
output.

The LayerNorms and the row-parallel biases then see only this rank's
block of the sequence, so their gradients are partial: the Trainer sums
them over the model group before the data-group mean
(``sequence_partial``).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from multimodalsimilar_tpu_torch.parallel.mesh import (MODEL_AXIS,
                                                       gather_along,
                                                       reduce_scatter_along,
                                                       split_along)


def check_mesh(mesh) -> None:
    """The JAX package's ``sp._check_mesh``: a model axis of 1 has no
    group to shard the sequence over."""
    if mesh.shape.get(MODEL_AXIS, 1) <= 1:
        raise ValueError(
            f"sequence_parallel needs a mesh model axis > 1, got "
            f"{dict(mesh.shape)} — pass --model_parallel N (with "
            f"--tensor_parallel) or drop --sequence_parallel")


def padded(S: int, n: int) -> int:
    """S rounded up to a multiple of the n ranks."""
    return -(-S // n) * n


def _pad(t: torch.Tensor, S_pad: int) -> torch.Tensor:
    """``t`` [B, S, ...] with zero rows up to S_pad along dim 1."""
    extra = S_pad - t.shape[1]
    if not extra:
        return t
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, extra))


def seq_block(t: torch.Tensor, mesh, S: int) -> torch.Tensor:
    """This rank's block of the (padded) sequence of ``t`` [B, S, ...],
    without a collective (a dropout mask drawn whole)."""
    S_pad = padded(S, mesh.model)
    size = S_pad // mesh.model
    return _pad(t, S_pad).narrow(1, mesh.model_index * size, size)


def to_sequence(y: torch.Tensor, mesh, partial: bool) -> torch.Tensor:
    """[B, S, H] into the region: reduce-scattered along the sequence when
    each rank holds partial sums (a row-parallel product), split when
    every rank holds it whole."""
    y = _pad(y, padded(y.shape[1], mesh.model))
    if partial:
        return reduce_scatter_along(y, mesh, 1)
    return split_along(y, mesh, 1)


def from_sequence(x: torch.Tensor, mesh, partial_grads: bool,
                  S: int) -> torch.Tensor:
    """The region's blocks all-gathered to the [B, S, H] sequence, the pad
    rows dropped. ``partial_grads``: the whole feeds a column-parallel
    product (each rank's gradient of it is partial: reduce-scattered in
    the backward); else it feeds work every rank does alike (the backward
    keeps this rank's block)."""
    return gather_along(x, mesh, 1, partial_grads)[:, :S]


# per layer, the parameters that act on the sequence blocks (besides the
# embeddings' LayerNorm); the row-parallel biases only where their block
# is sharded
_LAYER_NORMS = ("attention.output.LayerNorm", "output.LayerNorm")
_ROW_BIASES = (("attention", "attention.output.dense.bias"),
               ("mlp", "output.dense.bias"))


def sequence_partial(encoder, prefix: str) -> List[str]:
    """The names (under ``prefix``) of ``encoder``'s parameters whose
    gradients are partial under sequence parallelism: summed over the
    model group before the data-group mean."""
    tp = encoder.tp
    names = [f"{prefix}embeddings.LayerNorm.{w}" for w in ("weight", "bias")]
    for i in range(len(encoder.encoder.layer)):
        layer = f"{prefix}encoder.layer.{i}."
        names += [f"{layer}{ln}.{w}" for ln in _LAYER_NORMS
                  for w in ("weight", "bias")]
        names += [f"{layer}{bias}" for block, bias in _ROW_BIASES
                  if getattr(tp, block)]
    return names
