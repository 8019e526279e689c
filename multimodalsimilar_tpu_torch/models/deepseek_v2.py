"""DeepSeek-V2 (V2-Lite's shape) as a text embedding tower.

The layer equations are those of the published ``modeling_deepseek.py``
(deepseek-ai/DeepSeek-V2-Lite): token embeddings, then in each layer
``h += attn(RMSNorm(h))`` and ``h += mlp(RMSNorm(h))``, then a final
RMSNorm; the embedding is the masked mean of its output
(``towers.py:masked_mean_pool``), in float32.

* RMSNorm: computed in float32, cast back to the input's dtype, then
  times the scale (in the weights' dtype).
* Multi-head latent attention (no q-LoRA): ``q_proj`` gives each head
  ``qk_nope_head_dim`` + ``qk_rope_head_dim``; ``kv_a_proj_with_mqa``
  gives the latent ``c`` (``kv_lora_rank``) and one rotary key head
  shared by all heads; ``kv_b_proj(RMSNorm(c))`` gives each head's
  non-rotary key and value. Rotary positions use the published layout
  (pairs de-interleaved, then ``rotate_half``) with YaRN frequencies;
  attention is causal, its scores and softmax in float32, scaled by
  ``head_dim^-0.5 * m^2`` with ``m = 0.1 * mscale_all_dim * ln(factor)
  + 1``; ``o_proj`` back to the hidden size.
* The first ``first_k_dense_replace`` layers have a dense SiLU-gated MLP;
  the others a mixture of experts (``ops/moe.py``): a float32 router with
  softmax scores and greedy top-k, the routed experts' grouped products,
  plus the shared experts as one MLP of ``n_shared_experts`` x the expert
  width. No token is dropped.

Causal attention with right padding and routing without a capacity limit
leave a row's real tokens untouched by its pad, so the tower is
``padding_invariant``. Weights are held in ``dtype`` (bfloat16 on the
card; float32 in the CPU comparisons) and used as they are, with no cast
a call; the router's weight is held in float32, which a bfloat16
checkpoint's values fill exactly. Parameter names follow the published
checkpoint's without its ``model.`` prefix, except that each MoE layer
holds its routed experts stacked (``mlp.experts.gate_up`` [E, 2I, H],
``mlp.experts.down`` [E, H, I]); ``models/hf_import.py`` converts.

Spans (``utils/profiling.py``): ``moe.route`` (router, top-k, sort and
end rows), ``moe.experts`` (the grouped products and the shared
experts), ``moe.combine``; the counters are ``ops/moe.py``'s.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodalsimilar_tpu_torch.models.towers import masked_mean_pool
from multimodalsimilar_tpu_torch.ops import moe
from multimodalsimilar_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class DeepseekV2Config:
    """The published ``config.json`` keys this tower reads (V2-Lite's
    values by default; ``rope_scaling`` flattened to ``rope_*``)."""
    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_shared_experts: int = 2
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = False
    first_k_dense_replace: int = 1
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_factor: float = 40.0
    rope_original_max_position: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 0.707
    rope_mscale_all_dim: float = 0.707
    bos_token_id: int = 100000
    initializer_range: float = 0.006

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @classmethod
    def tiny(cls, **kw) -> "DeepseekV2Config":
        """Small config for tests: one dense and two MoE layers, 8 experts
        of which 2 a token and 1 shared, YaRN bending at 16 positions."""
        base = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
                    moe_intermediate_size=32, num_hidden_layers=3,
                    num_attention_heads=4, n_shared_experts=1,
                    n_routed_experts=8, num_experts_per_tok=2,
                    kv_lora_rank=32, qk_nope_head_dim=16,
                    qk_rope_head_dim=8, v_head_dim=16,
                    rope_original_max_position=16, bos_token_id=500,
                    initializer_range=0.1)
        base.update(kw)
        return cls(**base)

    @classmethod
    def from_hf(cls, hf: dict) -> "DeepseekV2Config":
        """The config of a published ``config.json``; raises on the
        options this tower does not compute (q-LoRA, grouped top-k,
        scoring other than softmax, rope other than YaRN)."""
        unsupported = {
            "q_lora_rank": hf.get("q_lora_rank") is not None,
            "topk_method": hf.get("topk_method", "greedy") != "greedy",
            "scoring_func": hf.get("scoring_func", "softmax") != "softmax",
            "moe_layer_freq": hf.get("moe_layer_freq", 1) != 1,
            "rope_scaling": (hf.get("rope_scaling") or {}).get("type")
            != "yarn"}
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise ValueError(f"DeepseekV2Config.from_hf: unsupported "
                             f"options {bad}")
        rs = hf["rope_scaling"]
        keys = {f.name for f in dataclasses.fields(cls)}
        kw = {k: hf[k] for k in keys if k in hf}
        kw.update(rope_factor=rs["factor"],
                  rope_original_max_position=rs[
                      "original_max_position_embeddings"],
                  rope_beta_fast=rs["beta_fast"],
                  rope_beta_slow=rs["beta_slow"],
                  rope_mscale=rs["mscale"],
                  rope_mscale_all_dim=rs["mscale_all_dim"])
        return cls(**kw)


def _yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def _correction_dim(rotations: float, cfg: DeepseekV2Config) -> float:
    d = cfg.qk_rope_head_dim
    return (d * math.log(cfg.rope_original_max_position
                         / (rotations * 2 * math.pi))
            / (2 * math.log(cfg.rope_theta)))


def yarn_inv_freq(cfg: DeepseekV2Config, device=None) -> torch.Tensor:
    """float32 [d/2] on ``device``: ``f / factor`` below the ramp, ``f``
    above it, a linear blend between ``floor(corr(beta_fast))`` and
    ``ceil(corr(beta_slow))``. Made on the device from scalars, so no
    host copy waits for the stream."""
    d = cfg.qk_rope_head_dim
    f = 1.0 / (cfg.rope_theta ** (torch.arange(
        0, d, 2, dtype=torch.float32, device=device) / d))
    low = max(math.floor(_correction_dim(cfg.rope_beta_fast, cfg)), 0)
    high = min(math.ceil(_correction_dim(cfg.rope_beta_slow, cfg)), d - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(d // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    extra = 1.0 - ramp
    return f / cfg.rope_factor * (1.0 - extra) + f * extra


def softmax_scale(cfg: DeepseekV2Config) -> float:
    m = _yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim)
    return cfg.q_head_dim ** -0.5 * m * m


def rope_cos_sin(cfg: DeepseekV2Config, length: int, dtype: torch.dtype,
                 device=None):
    """cos and sin [length, d] of positions 0..length-1, in ``dtype``;
    YaRN's cos/sin scale is 1 when ``mscale`` equals ``mscale_all_dim``."""
    t = torch.arange(length, device=device, dtype=torch.float32)
    freqs = torch.outer(t, yarn_inv_freq(cfg, device))
    emb = torch.cat((freqs, freqs), dim=-1)
    scale = (_yarn_mscale(cfg.rope_factor, cfg.rope_mscale)
             / _yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim))
    return (emb.cos() * scale).to(dtype), (emb.sin() * scale).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """The published layout: each head's pairs de-interleaved, then
    ``x * cos + rotate_half(x) * sin``."""
    b, h, s, d = x.shape
    x = x.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return x * cos + torch.cat((-x2, x1), dim=-1) * sin


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.float()
        h = h * torch.rsqrt(h.pow(2).mean(-1, keepdim=True) + self.eps)
        return self.weight * h.to(x.dtype)


def _linear(fan_in: int, fan_out: int, dtype) -> nn.Linear:
    return nn.Linear(fan_in, fan_out, bias=False, dtype=dtype)


class Attention(nn.Module):
    """Multi-head latent attention without q-LoRA."""

    def __init__(self, cfg: DeepseekV2Config, dtype):
        super().__init__()
        H, nh = cfg.hidden_size, cfg.num_attention_heads
        self.cfg = cfg
        self.q_proj = _linear(H, nh * cfg.q_head_dim, dtype)
        self.kv_a_proj_with_mqa = _linear(
            H, cfg.kv_lora_rank + cfg.qk_rope_head_dim, dtype)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps,
                                      dtype)
        self.kv_b_proj = _linear(
            cfg.kv_lora_rank, nh * (cfg.qk_nope_head_dim + cfg.v_head_dim),
            dtype)
        self.o_proj = _linear(nh * cfg.v_head_dim, H, dtype)
        self.softmax_scale = softmax_scale(cfg)

    def forward(self, x, cos, sin, mask_bias):
        cfg = self.cfg
        B, L, _ = x.shape
        nh, dn, dr = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                      cfg.qk_rope_head_dim)
        q = self.q_proj(x).view(B, L, nh, dn + dr).transpose(1, 2)
        q_nope, q_pe = q.split([dn, dr], dim=-1)
        c, k_pe = self.kv_a_proj_with_mqa(x).split(
            [cfg.kv_lora_rank, dr], dim=-1)
        k_pe = k_pe.view(B, L, 1, dr).transpose(1, 2)
        kv = self.kv_b_proj(self.kv_a_layernorm(c)).view(
            B, L, nh, dn + cfg.v_head_dim).transpose(1, 2)
        k_nope, v = kv.split([dn, cfg.v_head_dim], dim=-1)
        q = torch.cat([q_nope, apply_rope(q_pe, cos, sin)], dim=-1)
        k = torch.cat([k_nope, apply_rope(k_pe, cos, sin).expand(
            B, nh, L, dr)], dim=-1)
        scores = torch.matmul(q, k.transpose(-1, -2)).float() \
            * self.softmax_scale + mask_bias
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(
            B, L, nh * cfg.v_head_dim)
        return self.o_proj(out)


class MLP(nn.Module):
    """``down(silu(gate(x)) * up(x))``."""

    def __init__(self, hidden: int, inter: int, dtype):
        super().__init__()
        self.gate_proj = _linear(hidden, inter, dtype)
        self.up_proj = _linear(hidden, inter, dtype)
        self.down_proj = _linear(inter, hidden, dtype)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Experts(nn.Module):
    """The routed experts of one layer, stacked: ``gate_up`` [E, 2I, H]
    (each expert's gate rows, then its up rows), ``down`` [E, H, I]."""

    def __init__(self, n: int, hidden: int, inter: int, dtype):
        super().__init__()
        self.gate_up = nn.Parameter(torch.empty(n, 2 * inter, hidden,
                                                dtype=dtype))
        self.down = nn.Parameter(torch.empty(n, hidden, inter, dtype=dtype))


class MoE(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, dtype):
        super().__init__()
        H, inter = cfg.hidden_size, cfg.moe_intermediate_size
        self.top_k = cfg.num_experts_per_tok
        self.norm_topk_prob = cfg.norm_topk_prob
        self.routed_scaling_factor = cfg.routed_scaling_factor
        self.gate = _linear(H, cfg.n_routed_experts, torch.float32)
        self.experts = Experts(cfg.n_routed_experts, H, inter, dtype)
        self.shared_experts = MLP(H, inter * cfg.n_shared_experts, dtype)

    def forward(self, x):
        shape = x.shape
        flat = x.reshape(-1, shape[-1])
        with span("moe.route"):
            weights, experts = moe.route(
                flat, self.gate.weight, self.top_k, self.norm_topk_prob,
                self.routed_scaling_factor)
            p = moe.plan(experts, self.experts.gate_up.shape[0])
        with span("moe.experts"):
            y = moe.grouped_mlp(flat, p, self.experts.gate_up,
                                self.experts.down)
            shared = self.shared_experts(x)
        with span("moe.combine"):
            return moe.combine(y, p, weights).view(shape) + shared


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, index: int, dtype):
        super().__init__()
        H, eps = cfg.hidden_size, cfg.rms_norm_eps
        self.input_layernorm = RMSNorm(H, eps, dtype)
        self.self_attn = Attention(cfg, dtype)
        self.post_attention_layernorm = RMSNorm(H, eps, dtype)
        self.mlp = (MLP(H, cfg.intermediate_size, dtype)
                    if index < cfg.first_k_dense_replace else MoE(cfg, dtype))

    def forward(self, h, cos, sin, mask_bias):
        h = h + self.self_attn(self.input_layernorm(h), cos, sin, mask_bias)
        return h + self.mlp(self.post_attention_layernorm(h))


class DeepseekV2Tower(nn.Module):
    """The decoder stack with a masked-mean embedding (``predict_emb``).
    Built without a ``generator`` its weights are left as allocated (to
    be loaded); with one, they are drawn from it as the published init
    (normal(0, ``initializer_range``), unit norm scales)."""

    padding_invariant = True

    def __init__(self, config: DeepseekV2Config,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config, self.dtype = config, dtype
        self.embed_tokens = nn.Embedding(config.vocab_size,
                                         config.hidden_size, dtype=dtype)
        self.layers = nn.ModuleList(
            DecoderLayer(config, i, dtype)
            for i in range(config.num_hidden_layers))
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, dtype)
        # (length, dtype, device) -> (cos, sin, causal mask bias)
        self._tables = {}
        if generator is not None:
            self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            else:
                w = torch.empty(p.shape, dtype=torch.float32,
                                device=p.device)
                w.normal_(0.0, self.config.initializer_range,
                          generator=generator)
                p.copy_(w)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """The final norm's output [B, L, H]."""
        h = self.embed_tokens(input_ids.long())
        key = (input_ids.shape[1], h.dtype, h.device)
        if key not in self._tables:
            L = key[0]
            self._tables[key] = rope_cos_sin(self.config, L, h.dtype,
                                             h.device) + (
                torch.full((L, L), torch.finfo(torch.float32).min,
                           device=h.device).triu(1),)
        cos, sin, mask_bias = self._tables[key]
        for layer in self.layers:
            h = layer(h, cos, sin, mask_bias)
        return self.norm(h)

    def predict_emb(self, input_ids, attention_mask=None,
                    token_type_ids=None) -> torch.Tensor:
        """float32 [B, H]: the masked mean of the final norm's output."""
        return masked_mean_pool(self(input_ids), input_ids, attention_mask,
                                torch.float32)
