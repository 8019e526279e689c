"""``reference/bert.py``'s encoder in train mode: the same float32 forward
with inverted dropout at BERT's four sites (after the embeddings'
LayerNorm; on the attention probabilities; on the attention output and
on the MLP output, before their residual LayerNorms), each mask drawn
from one generator in that order, layer by layer, as a float32 tensor of
the masked tensor's shape with ``bernoulli_(1 - p)`` (Flax's
``nn.Dropout``, as the port draws them). Then the [CLS] token's tanh
pooler. Products go through ``q`` (``reference/bert.py:fp8`` for the
comparison's control)."""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from reference.bert import _lin, _ln_apply, _same
from reference.efficientnet import Masks


def encode(params: Dict[str, torch.Tensor], cfg: dict,
           input_ids: torch.Tensor, attention_mask: torch.Tensor,
           masks: Masks, q=_same) -> torch.Tensor:
    """The tanh pooler output [B, H], float32."""
    B, S = input_ids.shape
    H, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    hd, eps = H // nh, cfg["layer_norm_eps"]
    p_h, p_a = cfg["hidden_dropout_prob"], cfg["attention_probs_dropout_prob"]
    dev = input_ids.device
    h = (params["embeddings.word_embeddings.weight"][input_ids.long()]
         + params["embeddings.position_embeddings.weight"][
             torch.arange(S, device=dev)][None]
         + params["embeddings.token_type_embeddings.weight"][0])
    h = masks.drop(_ln_apply(h, params, "embeddings.LayerNorm", eps), p_h,
                   (B, S, H))
    bias = torch.where(attention_mask[:, None, None, :] > 0,
                       torch.zeros((), device=dev),
                       torch.full((), torch.finfo(torch.float32).min,
                                  device=dev))
    for i in range(cfg["num_hidden_layers"]):
        p = f"encoder.layer.{i}."

        def heads(name):
            return _lin(h, params, p + name, q).view(B, S, nh, hd) \
                .transpose(1, 2)

        qh, kh, vh = (heads("attention.self.query"),
                      heads("attention.self.key"),
                      heads("attention.self.value"))
        scores = q(qh) @ q(kh).transpose(-1, -2) / math.sqrt(hd)
        probs = masks.drop(torch.softmax(scores + bias, dim=-1), p_a,
                           (B, nh, S, S))
        ctx = (q(probs) @ q(vh)).transpose(1, 2).reshape(B, S, H)
        attn = masks.drop(_lin(ctx, params, p + "attention.output.dense",
                               q), p_h, (B, S, H))
        h = _ln_apply(h + attn, params, p + "attention.output.LayerNorm",
                      eps)
        mlp = masks.drop(_lin(F.gelu(_lin(h, params,
                                          p + "intermediate.dense", q)),
                              params, p + "output.dense", q), p_h, (B, S, H))
        h = _ln_apply(h + mlp, params, p + "output.LayerNorm", eps)
    return torch.tanh(_lin(h[:, 0], params, "pooler.dense", q))
