"""BERT/RoBERTa encoder in PyTorch — the text tower backbone.

Counterpart of ``multimodalsimilar_tpu/models/bert.py`` (``BertEncoderModel``):

* word + position + token-type embeddings, then LayerNorm (eps 1e-12);
* post-LN layers with the exact-erf GELU (HF ``gelu``);
* attention scores and softmax in ``reduce_dtype``, with the additive mask
  ``finfo(reduce_dtype).min``; the tanh pooler in ``reduce_dtype``.

Attention is plain ``torch.matmul``, softmax and ``torch.matmul``, as the
JAX package leaves it to XLA. Dropout sits at the JAX module's four sites
(after the embeddings LayerNorm, on the attention probabilities, on the
attention output and on the MLP output). It acts only in ``train()``
mode, and its masks come from the ``torch.Generator`` handed to
``set_dropout_generator`` (the trainer owns it), never from the global
RNG. The encoder is built in ``eval()`` mode, like the JAX module's
``deterministic=True`` default. Casts follow the JAX module's dtype policy
point for point: linear layers run in ``compute_dtype``, LayerNorm in
``reduce_dtype``, and the residual stream is kept in ``compute_dtype``.
Parameter names follow HF ``BertModel``, so
``multimodalsimilar_tpu/models/hf_import.py:bert_params_from_torch`` loads
this module's ``state_dict`` into the JAX model. ``fused_qkv``, remat and
the sequence and pipeline parallel layouts are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 21128              # bert-base-chinese / roberta-wwm vocab
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1

    @classmethod
    def tiny(cls, **kw) -> "BertConfig":
        """Small config for tests."""
        base = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
                    intermediate_size=128, max_position_embeddings=64)
        base.update(kw)
        return cls(**base)

    @classmethod
    def roberta_wwm_ext(cls, **kw) -> "BertConfig":
        """hfl/chinese-roberta-wwm-ext (base, 768-d)."""
        return cls(**kw)

    @classmethod
    def roberta_wwm_ext_large(cls, **kw) -> "BertConfig":
        """hfl/chinese-roberta-wwm-ext-large."""
        return cls(hidden_size=1024, num_layers=24, num_heads=16,
                   intermediate_size=4096, **kw)


def _linear(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype):
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


def _layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype):
    return F.layer_norm(x.to(dtype), ln.normalized_shape,
                        ln.weight.to(dtype), ln.bias.to(dtype), ln.eps)


def flax_layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype
                    ) -> torch.Tensor:
    """Flax ``LayerNorm(dtype=dtype)``: statistics, normalization and
    scale in f32 whatever ``x``'s dtype, the result cast to ``dtype``
    (the ViT, ConvNeXt and int8 towers)."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                        ln.bias.float(), ln.eps).to(dtype)


class _Module(nn.Module):
    """Attribute holder, so parameter paths read like HF's."""


class Dropout(nn.Module):
    """Inverted dropout (Flax ``nn.Dropout``: kept values scaled by
    1/(1-p)) whose masks come from ``self.generator``. Off in ``eval()``
    mode and at p = 0; in ``train()`` mode with p > 0 it raises without a
    generator rather than draw from the global RNG."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def mask_shape(self, x: torch.Tensor) -> tuple:
        return x.shape

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("dropout in train() mode needs a generator: "
                               "call set_dropout_generator first")
        keep = torch.empty(self.mask_shape(x), dtype=torch.float32,
                           device=x.device)
        keep.bernoulli_(1.0 - self.p, generator=self.generator)
        return torch.where(keep > 0, x / (1.0 - self.p), 0.0).to(x.dtype)


def set_dropout_generator(module: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Hand ``generator`` to every ``Dropout`` under ``module``."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, policy: DTypePolicy):
        super().__init__()
        H, inter = cfg.hidden_size, cfg.intermediate_size
        self.num_heads = cfg.num_heads
        self.policy = policy
        kw = dict(dtype=policy.param_dtype)
        self.attention = _Module()
        self.attention.self = _Module()
        for name in ("query", "key", "value"):
            setattr(self.attention.self, name, nn.Linear(H, H, **kw))
        self.attention.output = _Module()
        self.attention.output.dense = nn.Linear(H, H, **kw)
        self.attention.output.LayerNorm = nn.LayerNorm(
            H, eps=cfg.layer_norm_eps, **kw)
        self.intermediate = _Module()
        self.intermediate.dense = nn.Linear(H, inter, **kw)
        self.output = _Module()
        self.output.dense = nn.Linear(inter, H, **kw)
        self.output.LayerNorm = nn.LayerNorm(H, eps=cfg.layer_norm_eps, **kw)
        self.attention.self.dropout = Dropout(cfg.attention_dropout)
        self.attention.output.dropout = Dropout(cfg.hidden_dropout)
        self.output.dropout = Dropout(cfg.hidden_dropout)

    def _attention(self, h: torch.Tensor, mask_bias: torch.Tensor):
        cd, rd = self.policy.compute_dtype, self.policy.reduce_dtype
        B, S, H = h.shape
        nh = self.num_heads
        hd = H // nh
        sa = self.attention.self

        def heads(lin):   # [B, S, H] -> [B, nh, S, hd]
            return _linear(h, lin, cd).view(B, S, nh, hd).transpose(1, 2)

        q, k, v = heads(sa.query), heads(sa.key), heads(sa.value)
        scores = torch.matmul(q.to(rd), k.to(rd).transpose(-1, -2))
        scores = scores / torch.sqrt(torch.tensor(hd, dtype=rd,
                                                  device=h.device))
        probs = sa.dropout(torch.softmax(scores + mask_bias, dim=-1))
        ctx = torch.matmul(probs.to(cd).to(rd), v.to(rd))
        ctx = ctx.transpose(1, 2).reshape(B, S, H)
        return _linear(ctx.to(cd), self.attention.output.dense, cd)

    def forward(self, h: torch.Tensor, mask_bias: torch.Tensor):
        cd, rd = self.policy.compute_dtype, self.policy.reduce_dtype
        attn = self.attention.output.dropout(self._attention(h, mask_bias))
        h = _layer_norm(h + attn, self.attention.output.LayerNorm, rd).to(cd)
        mlp = F.gelu(_linear(h, self.intermediate.dense, cd))  # erf form
        mlp = self.output.dropout(_linear(mlp, self.output.dense, cd))
        return _layer_norm(h + mlp, self.output.LayerNorm, rd).to(cd)


class BertEncoderModel(nn.Module):
    """Embeddings + transformer stack + tanh pooler (= HF BertModel)."""

    def __init__(self, config: BertConfig,
                 policy: DTypePolicy = DTypePolicy()):
        super().__init__()
        cfg = self.config = config
        self.policy = policy
        kw = dict(dtype=policy.param_dtype)
        H = cfg.hidden_size
        self.embeddings = _Module()
        self.embeddings.word_embeddings = nn.Embedding(cfg.vocab_size, H, **kw)
        self.embeddings.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, H, **kw)
        self.embeddings.token_type_embeddings = nn.Embedding(
            cfg.type_vocab_size, H, **kw)
        self.embeddings.LayerNorm = nn.LayerNorm(H, eps=cfg.layer_norm_eps,
                                                 **kw)
        self.embeddings.dropout = Dropout(cfg.hidden_dropout)
        self.encoder = _Module()
        self.encoder.layer = nn.ModuleList(
            BertLayer(cfg, policy) for _ in range(cfg.num_layers))
        self.pooler = _Module()
        self.pooler.dense = nn.Linear(H, H, **kw)
        self.eval()

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        cd, rd = self.policy.compute_dtype, self.policy.reduce_dtype
        B, S = input_ids.shape
        dev = input_ids.device
        if attention_mask is None:
            attention_mask = torch.ones((B, S), dtype=torch.int32, device=dev)
        if token_type_ids is None:
            token_type_ids = torch.zeros((B, S), dtype=torch.int32,
                                         device=dev)
        emb = self.embeddings
        h = (emb.word_embeddings(input_ids.long())
             + emb.position_embeddings(torch.arange(S, device=dev))[None]
             + emb.token_type_embeddings(token_type_ids.long()))
        h = emb.dropout(_layer_norm(h, emb.LayerNorm, rd)).to(cd)

        # additive attention bias: 0 for attended, big-negative for padding
        mask_bias = torch.where(attention_mask[:, None, None, :] > 0,
                                torch.zeros((), dtype=rd, device=dev),
                                torch.full((), torch.finfo(rd).min,
                                           dtype=rd, device=dev))
        for layer in self.encoder.layer:
            h = layer(h, mask_bias)
        pooled = _linear(h[:, 0], self.pooler.dense, cd)
        pooled = torch.tanh(pooled.to(rd))
        return {"last_hidden_state": h, "pooler_output": pooled}


def init_bert_weights(module: nn.Module, generator: torch.Generator
                      ) -> None:
    """HF BertModel's init (initializer_range 0.02), drawn from
    ``generator``: normal(0, 0.02) weights and embeddings, zero biases,
    unit LayerNorm scales."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                w = torch.empty(m.weight.shape, dtype=torch.float32)
                w.normal_(0.0, 0.02, generator=generator)
                m.weight.copy_(w)
                if isinstance(m, nn.Linear) and m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

