"""Text embedding tower over the BERT stack.

Counterpart of ``multimodalsimilar_tpu/models/towers.py``:
``TextTower(pool='cls')`` returns the encoder's tanh pooler output,
``TextTower(pool='mean')`` the masked mean over ``last_hidden_state``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from multimodalsimilar_tpu_torch.models.bert import BertConfig, BertEncoderModel
from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy


def masked_mean_pool(last_hidden_state: torch.Tensor,
                     input_ids: torch.Tensor,
                     attention_mask: Optional[torch.Tensor],
                     reduce_dtype: torch.dtype) -> torch.Tensor:
    """Masked mean over the sequence axis (towers.py:20-33)."""
    h = last_hidden_state.to(reduce_dtype)
    if attention_mask is None:
        attention_mask = torch.ones(input_ids.shape, dtype=torch.int32,
                                    device=h.device)
    mask = attention_mask.to(h.dtype)[:, :, None]
    total = torch.sum(h * mask, dim=1)
    denom = torch.sum(attention_mask.to(h.dtype), dim=1, keepdim=True)
    return total / denom


class TextTower(nn.Module):
    def __init__(self, config: BertConfig, pool: str = "cls",
                 policy: DTypePolicy = DTypePolicy()):
        super().__init__()
        if pool not in ("cls", "mean"):
            raise ValueError(f"unknown pool {pool!r}")
        self.pool = pool
        self.policy = policy
        self.encoder = BertEncoderModel(config, policy)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None
                ) -> torch.Tensor:
        out = self.encoder(input_ids, attention_mask, token_type_ids)
        if self.pool == "cls":
            return out["pooler_output"]
        return masked_mean_pool(out["last_hidden_state"], input_ids,
                                attention_mask, self.policy.reduce_dtype)
