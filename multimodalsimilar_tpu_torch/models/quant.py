"""int8 weights and dynamic int8 activations for the text tower (inference).

Counterpart of ``multimodalsimilar_tpu/models/quant.py``: the six
projections of every encoder layer (query, key, value, attention output,
intermediate, output) hold int8 weights with one f32 scale per output
channel, and quantize their input with one dynamic scale per tensor:

    y = f32(q(x) @ q(W)) * s_x * s_w + b,   q(v) = round(clip(v / s, ±127))

with ``s_x = max(|x|) / 127`` over the whole [B, S, H] input, padded rows
and positions included (so a row's embedding depends on its batch, as in
the JAX package). Embeddings, LayerNorms, softmax, the attention products
and the pooler stay in f32, the attention probabilities in
``compute_dtype``, as the JAX module keeps them.

The int8 x int8 -> int32 product is ``jax.lax.dot_general`` in XLA there,
not a Pallas kernel; here it is ``torch._int_mm`` on a card (cuBLASLt;
operands padded with zeros to what it accepts: more than 16 rows, inner
and outer sizes multiples of 8 — exact, and the scale is taken before)
and an exact f64 product on the CPU (at K = 3,072 a sum can reach
127^2 * 3,072 ~ 4.95e7, past f32's exact 2^24, so never f32).

* ``quantize_weight`` <- ``_quantize_weight``: a torch [out, in] weight ->
  int8 [out, in] and f32 [out] scales, bit for bit the JAX values of the
  transposed kernel.
* ``quantize_bert_state`` <- ``quantize_bert_params``: the port's
  HF-named ``BertEncoderModel`` state_dict -> ``QuantBertEncoderModel``'s.
* ``QuantLinear`` <- ``QuantDense``; ``QuantBertEncoderModel``;
  ``QuantTextEmbModel`` (``cls`` or ``mean`` pooling,
  ``models.towers.masked_mean_pool``) — ``predict_emb`` as
  ``TextEmbedder`` calls it.
* ``quantize_text_tower`` <- ``quantize_text_tower_params``: an
  ``NlpTextClassifier`` (or a ``TextTower``) -> a ``QuantTextEmbModel``;
  the ArcFace head is dropped.

Parameter names follow HF ``BertModel``; a quantized projection holds
``weight_q`` (int8 [out, in]), ``scale`` and ``bias`` as buffers.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multimodalsimilar_tpu_torch.models.bert import (BertConfig, _Module,
                                                     flax_layer_norm)
from multimodalsimilar_tpu_torch.models.towers import masked_mean_pool
from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy

_QUANT = ("attention.self.query", "attention.self.key",
          "attention.self.value", "attention.output.dense",
          "intermediate.dense", "output.dense")
_INT_MM_MIN_ROWS = 17     # torch._int_mm on CUDA: more than 16 rows
_INT_MM_MULTIPLE = 8      # ... and inner and outer sizes multiples of 8


def quantize_weight(weight) -> tuple:
    """A torch [out, in] weight -> (int8 [out, in], f32 [out] scales):
    per output channel ``scale = max(max|w| / 127, 1e-8)`` and
    ``q = clip(round(w / scale), -127, 127)``, in numpy f32 as the JAX
    package computes it on the [in, out] kernel (half to even)."""
    w = np.asarray(weight.detach().cpu() if hasattr(weight, "detach")
                   else weight, np.float32)
    scale = np.abs(w).max(axis=1) / 127.0
    scale = np.maximum(scale, 1e-8)
    q = np.clip(np.round(w / scale[:, None]), -127, 127).astype(np.int8)
    return torch.from_numpy(q), torch.from_numpy(scale.astype(np.float32))


def quantize_bert_state(state_dict: Mapping[str, torch.Tensor],
                        config: BertConfig) -> Dict[str, torch.Tensor]:
    """The port's ``BertEncoderModel`` state_dict (HF names, no prefix)
    -> ``QuantBertEncoderModel``'s: each projection of ``_QUANT`` in every
    layer becomes ``weight_q``, ``scale`` and ``bias``; embeddings,
    LayerNorms and the pooler pass through as f32."""
    out: Dict[str, torch.Tensor] = {}
    quant = {f"encoder.layer.{i}.{p}" for i in range(config.num_layers)
             for p in _QUANT}
    for name, t in state_dict.items():
        base, _, part = name.rpartition(".")
        if base in quant:
            if part == "weight":
                out[f"{base}.weight_q"], out[f"{base}.scale"] = \
                    quantize_weight(t)
            else:
                out[name] = t.detach().float().clone()
        else:
            out[name] = t.detach().float().clone()
    return out


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _int_mm_padded(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """``torch._int_mm(x_q, w_q.T)`` with zero rows and columns added to
    reach its CUDA shapes (more than 16 rows, inner and outer sizes
    multiples of 8) and sliced off after: exact, as zeros add nothing."""
    M, K = x_q.shape
    N = w_q.shape[0]
    Mp = max(M, _INT_MM_MIN_ROWS)
    Kp, Np = _round_up(K, _INT_MM_MULTIPLE), _round_up(N, _INT_MM_MULTIPLE)
    if (Mp, Kp) != (M, K):
        x_q = F.pad(x_q, (0, Kp - K, 0, Mp - M))
    if (Np, Kp) != (N, K):
        w_q = F.pad(w_q, (0, Kp - K, 0, Np - N))
    return torch._int_mm(x_q, w_q.t())[:M, :N]


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact int32 [M, N] product of int8 x_q [M, K] and the int8 weight
    w_q [N, K] (x_q @ w_q.T): on a card ``torch._int_mm``
    (``_int_mm_padded``), on the CPU an f64 matmul (BLAS; exact, as every
    partial sum is an integer of at most 127^2 K < 2^53, and the result
    fits int32 for K < 133,000)."""
    if x_q.device.type == "cuda":
        return _int_mm_padded(x_q, w_q)
    return torch.matmul(x_q.double(), w_q.double().t()).to(torch.int32)


class QuantLinear(nn.Module):
    """``QuantDense``: int8 weight [out, in] with per-output f32 scales
    and an f32 bias; the input quantized by one dynamic scale over the
    whole tensor. Returns f32."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.register_buffer("weight_q", torch.zeros(
            (out_features, in_features), dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_features))
        self.register_buffer("bias", torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        s_x = torch.clamp_min(x32.abs().max() / 127.0, 1e-8)
        x_q = torch.clamp(torch.round(x32 / s_x), -127, 127).to(torch.int8)
        y = int8_matmul(x_q.reshape(-1, x_q.shape[-1]), self.weight_q)
        y = y.float() * s_x * self.scale + self.bias
        return y.reshape(x.shape[:-1] + (y.shape[-1],))


class _QuantLayer(nn.Module):
    def __init__(self, cfg: BertConfig, policy: DTypePolicy):
        super().__init__()
        H, inter = cfg.hidden_size, cfg.intermediate_size
        self.num_heads, self.policy = cfg.num_heads, policy
        eps = cfg.layer_norm_eps
        self.attention = _Module()
        self.attention.self = _Module()
        for name in ("query", "key", "value"):
            setattr(self.attention.self, name, QuantLinear(H, H))
        self.attention.output = _Module()
        self.attention.output.dense = QuantLinear(H, H)
        self.attention.output.LayerNorm = nn.LayerNorm(H, eps=eps)
        self.intermediate = _Module()
        self.intermediate.dense = QuantLinear(H, inter)
        self.output = _Module()
        self.output.dense = QuantLinear(inter, H)
        self.output.LayerNorm = nn.LayerNorm(H, eps=eps)

    def _attention(self, h: torch.Tensor, mask_bias: torch.Tensor):
        cd = self.policy.compute_dtype
        B, S, H = h.shape
        nh = self.num_heads
        hd = H // nh
        sa = self.attention.self

        def heads(lin):   # [B, S, H] -> [B, nh, S, hd], f32
            return lin(h).view(B, S, nh, hd).transpose(1, 2)

        q, k, v = heads(sa.query), heads(sa.key), heads(sa.value)
        scores = torch.matmul(q, k.transpose(-1, -2))
        # made on the device, so no copy from the host waits on the stream
        scores = scores / torch.full((), hd, dtype=torch.float32,
                                     device=h.device).sqrt()
        probs = torch.softmax(scores + mask_bias, dim=-1).to(cd)
        # bf16 x bf16 products summed in f32 (preferred_element_type)
        ctx = torch.matmul(probs.float(), v.to(cd).float())
        ctx = ctx.transpose(1, 2).reshape(B, S, H)
        return self.attention.output.dense(ctx)

    def forward(self, h: torch.Tensor, mask_bias: torch.Tensor):
        attn = self._attention(h, mask_bias)
        h = flax_layer_norm(h.float() + attn,
                            self.attention.output.LayerNorm, torch.float32)
        mlp = F.gelu(self.intermediate.dense(h))         # erf form, f32
        mlp = self.output.dense(mlp)
        return flax_layer_norm(h + mlp, self.output.LayerNorm, torch.float32)


class QuantBertEncoderModel(nn.Module):
    """The int8 BERT encoder (inference only; ``BertEncoderModel``'s
    outputs contract: ``last_hidden_state`` and ``pooler_output``, both
    f32)."""

    def __init__(self, config: BertConfig,
                 policy: DTypePolicy = DTypePolicy.inference()):
        super().__init__()
        cfg = self.config = config
        self.policy = policy
        H = cfg.hidden_size
        self.embeddings = _Module()
        self.embeddings.word_embeddings = nn.Embedding(cfg.vocab_size, H)
        self.embeddings.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, H)
        self.embeddings.token_type_embeddings = nn.Embedding(
            cfg.type_vocab_size, H)
        self.embeddings.LayerNorm = nn.LayerNorm(H, eps=cfg.layer_norm_eps)
        self.encoder = _Module()
        self.encoder.layer = nn.ModuleList(
            _QuantLayer(cfg, policy) for _ in range(cfg.num_layers))
        self.pooler = _Module()
        self.pooler.dense = nn.Linear(H, H)
        self.eval()

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                token_type_ids: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
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
        h = flax_layer_norm(h, emb.LayerNorm, torch.float32)
        f32 = torch.float32
        mask_bias = torch.where(attention_mask[:, None, None, :] > 0,
                                torch.zeros((), dtype=f32, device=dev),
                                torch.full((), torch.finfo(f32).min,
                                           dtype=f32, device=dev))
        for layer in self.encoder.layer:
            h = layer(h, mask_bias)
        pooled = torch.tanh(self.pooler.dense(h[:, 0]))
        return {"last_hidden_state": h, "pooler_output": pooled}


class QuantTextEmbModel(nn.Module):
    """The int8 text tower for serving: ``QuantBertEncoderModel`` and
    ``TextTower``'s pooling, with ``predict_emb`` as ``TextEmbedder``
    calls it. ``--int8`` on ``embed``, ``similar nlp`` and ``serve``
    builds it with ``quantize_text_tower``."""

    # one activation scale spans the whole padded batch, so pad is part
    # of the output (``TextEmbedder`` cuts its batches only to a ladder)
    padding_invariant = False

    def __init__(self, config: BertConfig, pool: str = "cls",
                 policy: DTypePolicy = DTypePolicy.inference()):
        super().__init__()
        if pool not in ("cls", "mean"):
            raise ValueError(f"unknown pool {pool!r}")
        self.pool, self.policy = pool, policy
        self.encoder = QuantBertEncoderModel(config, policy)
        self.eval()

    def predict_emb(self, input_ids, attention_mask=None,
                    token_type_ids=None) -> torch.Tensor:
        out = self.encoder(input_ids, attention_mask, token_type_ids)
        if self.pool == "cls":
            return out["pooler_output"]
        return masked_mean_pool(out["last_hidden_state"], input_ids,
                                attention_mask, self.policy.reduce_dtype)


def quantize_text_tower(model: nn.Module) -> QuantTextEmbModel:
    """An ``NlpTextClassifier`` (or a ``TextTower``) -> the
    ``QuantTextEmbModel`` of its tower's weights under the tower's dtype
    policy, on the CPU (the embedder moves it); the head is dropped."""
    tower = getattr(model, "tower", model)
    enc = tower.encoder
    qmodel = QuantTextEmbModel(enc.config, pool=tower.pool,
                               policy=tower.policy)
    state = {k: v.cpu() for k, v in enc.state_dict().items()}
    qmodel.encoder.load_state_dict(quantize_bert_state(state, enc.config))
    return qmodel
