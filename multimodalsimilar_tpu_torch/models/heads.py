"""ArcFace head (counterpart of multimodalsimilar_tpu/models/heads.py).

One [num_classes, dim] f32 weight with xavier-uniform init; margin logits
when given a label, plain cosine logits in eval (``is_test=True``) or
without a label. The margin is an argument, so the per-epoch curriculum
only changes a float. The device picks the margin path: the CUDA kernel
for CUDA tensors, its plain version for CPU tensors (``ops/arcface.py``);
there is no ``use_fused`` switch.

``shard(mesh)`` keeps only this rank's block of classes on the mesh's
model axis (the JAX package's ``class_sharded`` placement,
``--model_parallel``): the head then returns the [B, C / model] logits
of its own classes, the margin kernel unchanged on them (a label on
another rank's block becomes -1, no target here), and ``train/tasks.py``
takes the loss and accuracy over the model group. The embedding enters
through ``parallel/mesh.py:copy_to_group`` (identity; the backward sums
the gradient over the model group), so each rank's tower receives the
gradient of every block.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from multimodalsimilar_tpu_torch.ops.arcface import (
    ArcFaceParams, arcface_logits_fused, cosine_logits)
from multimodalsimilar_tpu_torch.parallel.mesh import (MeshRules,
                                                       copy_to_group)


class ArcFaceHead(nn.Module):
    def __init__(self, num_classes: int, dim: int,
                 params_af: ArcFaceParams = ArcFaceParams(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.params_af = params_af
        self.weight = nn.Parameter(torch.empty(num_classes, dim,
                                               dtype=torch.float32))
        self.reset_parameters(generator)
        # the class-sharding layout, set by ``shard``: the mesh whose
        # model axis holds the blocks (None: the head is whole) and the
        # first class of this rank's block
        self.mesh = None
        self.column_offset = 0

    @property
    def num_classes(self) -> int:
        """The classes of the whole head, every block's."""
        n = self.weight.shape[0]
        return n if self.mesh is None else n * self.mesh.model

    def shard(self, mesh) -> slice:
        """Keep this rank's block of classes (``MeshRules.class_sharded``:
        the class count must divide by the model axis); returns it."""
        rows = MeshRules(mesh).class_sharded(self.num_classes)
        self.weight = nn.Parameter(self.weight.detach()[rows].clone())
        self.mesh, self.column_offset = mesh, rows.start
        return rows

    def local_labels(self, labels: torch.Tensor) -> torch.Tensor:
        """Each label's column in this rank's block, -1 where another
        block holds it (the labels as they are when the head is whole)."""
        if self.mesh is None:
            return labels
        local = labels - self.column_offset
        return torch.where((local >= 0) & (local < self.weight.shape[0]),
                           local, torch.full_like(local, -1))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """xavier-uniform: U(-a, a) with a = sqrt(6 / (C + D)); nothing
        is drawn for a weight on the ``meta`` device (built to be
        loaded)."""
        if self.weight.is_meta:
            return
        bound = math.sqrt(6.0 / sum(self.weight.shape))
        with torch.no_grad():
            w = torch.empty(self.weight.shape, dtype=torch.float32)
            w.uniform_(-bound, bound, generator=generator)
            self.weight.copy_(w)

    def forward(self, x: torch.Tensor, label: Optional[torch.Tensor] = None,
                m: Optional[float] = None, is_test: bool = False
                ) -> torch.Tensor:
        if self.mesh is not None:
            x = copy_to_group(x, self.mesh)
            if label is not None:
                label = self.local_labels(label)
        if is_test or label is None:
            return cosine_logits(x, self.weight)
        af = self.params_af
        return arcface_logits_fused(x, self.weight, label,
                                    af.m if m is None else m, af.s,
                                    af.easy_margin)
