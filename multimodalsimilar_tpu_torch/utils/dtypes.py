"""Mixed-precision dtype policy.

Counterpart of ``multimodalsimilar_tpu/utils/dtypes.py``.

Parameters are stored in ``param_dtype``; matmuls and activations run in
``compute_dtype``; softmax, LayerNorm and pooling run in ``reduce_dtype``.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    reduce_dtype: torch.dtype = torch.float32

    @classmethod
    def full_precision(cls) -> "DTypePolicy":
        return cls(param_dtype=torch.float32, compute_dtype=torch.float32,
                   reduce_dtype=torch.float32)

    @classmethod
    def inference(cls) -> "DTypePolicy":
        """bf16 end to end, including LayerNorm, softmax and the pooler;
        the policy of every embedding pipeline."""
        return cls(param_dtype=torch.float32, compute_dtype=torch.bfloat16,
                   reduce_dtype=torch.bfloat16)
