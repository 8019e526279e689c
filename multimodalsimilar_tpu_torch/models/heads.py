"""ArcFace head (counterpart of multimodalsimilar_tpu/models/heads.py).

One [num_classes, dim] f32 weight with xavier-uniform init; margin logits
when given a label, plain cosine logits in eval (``is_test=True``) or
without a label. The margin is an argument, so the per-epoch curriculum
only changes a float. The device picks the margin path: the CUDA kernel
for CUDA tensors, its plain version for CPU tensors (``ops/arcface.py``);
there is no ``use_fused`` switch.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from multimodalsimilar_tpu_torch.ops.arcface import (
    ArcFaceParams, arcface_logits_fused, cosine_logits)


class ArcFaceHead(nn.Module):
    def __init__(self, num_classes: int, dim: int,
                 params_af: ArcFaceParams = ArcFaceParams(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.params_af = params_af
        self.weight = nn.Parameter(torch.empty(num_classes, dim,
                                               dtype=torch.float32))
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """xavier-uniform: U(-a, a) with a = sqrt(6 / (C + D))."""
        bound = math.sqrt(6.0 / sum(self.weight.shape))
        with torch.no_grad():
            w = torch.empty(self.weight.shape, dtype=torch.float32)
            w.uniform_(-bound, bound, generator=generator)
            self.weight.copy_(w)

    def forward(self, x: torch.Tensor, label: Optional[torch.Tensor] = None,
                m: Optional[float] = None, is_test: bool = False
                ) -> torch.Tensor:
        if is_test or label is None:
            return cosine_logits(x, self.weight)
        af = self.params_af
        return arcface_logits_fused(x, self.weight, label,
                                    af.m if m is None else m, af.s,
                                    af.easy_margin)
