"""A plain DeepSeek-V2 decoder (V2-Lite's shape) as a text embedder, in
float32, layer by layer over any number of batches, as a function of the
published configuration and of a ``weights(part)`` callable that gives
one part's tensors at a time under the published names (without the
``model.`` prefix): ``"embed"``, each layer index, ``"norm"``.

The equations are those of the published ``modeling_deepseek.py``
(deepseek-ai/DeepSeek-V2-Lite): RMSNorm; multi-head latent attention
without q-LoRA (a latent ``c`` of ``kv_lora_rank`` normalised and
expanded to each head's key and value, one rotary key head shared by all
heads, YaRN rotary frequencies in the published de-interleaved layout,
causal attention scaled by ``q_head_dim^-0.5 * mscale^2``); a dense
SiLU-gated MLP in the first ``first_k_dense_replace`` layers; in the
others a softmax router with greedy top-k (weights renormalised only
with ``norm_topk_prob``, else times ``routed_scaling_factor``), the
routed experts, and the shared experts as one MLP of ``n_shared_experts``
x the expert width; a final RMSNorm.

Departures from the published model, each on purpose:

* the output is an embedding, the mean of the final norm's output over
  each row's real tokens (the output head is never computed; the
  pooling is the one expected of an embedder, not published);
* tokens: a BOS id, then one token a non-space character over the
  catalog's alphabet (``tokenize``), as the published tokenizer's files
  are not in the repository;
* every product in float32 (the caller turns TF32 off), where the
  published model runs bfloat16 products; the router, the attention
  softmax and the norms in float32, as published;
* the experts run in one loop over the experts with boolean masks (the
  published ``moe_infer`` groups the sorted tokens; the sums are the
  same), with no capacity limit;
* weights are random, drawn from a seed one part at a time as bfloat16
  (``draw``) and upcast here one layer at a time, which is exact.

It imports no JAX and nothing of the port. ``quant="fp8"`` rounds the
operands of every product to float8 e4m3 (the comparison's control).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")


def tokenize(texts: Sequence[str], tokens: Sequence[str], bos_id: int,
             max_length: int) -> Tuple[np.ndarray, np.ndarray]:
    """(input_ids, attention_mask) int32 [B, max_length]: ``bos_id``,
    then each non-space character's index in ``tokens`` ([UNK]'s when
    absent), padded with [PAD] on the right."""
    index = {t: i for i, t in enumerate(tokens)}
    ids = np.full((len(texts), max_length), index["[PAD]"], np.int32)
    mask = np.zeros((len(texts), max_length), np.int32)
    for b, text in enumerate(texts):
        chars = [c for c in text if not c.isspace()][:max_length - 1]
        row = [bos_id] + [index.get(c, index["[UNK]"]) for c in chars]
        ids[b, :len(row)] = row
        mask[b, :len(row)] = 1
    return ids, mask


# -- weights ------------------------------------------------------------------

def part_shapes(cfg: dict, part) -> List[Tuple[str, tuple, float]]:
    """(name, shape, standard deviation) of every tensor of one part;
    a norm scale's deviation is around 1. Projections are drawn at
    1/sqrt(fan in), so every product keeps its input's scale, the token
    table at 1."""
    H = cfg["hidden_size"]
    if part == "embed":
        return [("embed_tokens.weight", (cfg["vocab_size"], H), 1.0)]
    if part == "norm":
        return [("norm.weight", (H,), 0.1)]
    nh, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    p = f"layers.{part}."

    def lin(name, fan_in, fan_out):
        return (p + name + ".weight", (fan_out, fan_in), fan_in ** -0.5)

    out = [(p + "input_layernorm.weight", (H,), 0.1),
           lin("self_attn.q_proj", H, nh * (dn + dr)),
           lin("self_attn.kv_a_proj_with_mqa", H, r + dr),
           (p + "self_attn.kv_a_layernorm.weight", (r,), 0.1),
           lin("self_attn.kv_b_proj", r, nh * (dn + dv)),
           lin("self_attn.o_proj", nh * dv, H),
           (p + "post_attention_layernorm.weight", (H,), 0.1)]

    def mlp(name, inter):
        return [lin(f"{name}.gate_proj", H, inter),
                lin(f"{name}.up_proj", H, inter),
                lin(f"{name}.down_proj", inter, H)]

    if part < cfg["first_k_dense_replace"]:
        return out + mlp("mlp", cfg["intermediate_size"])
    inter = cfg["moe_intermediate_size"]
    out.append(lin("mlp.gate", H, cfg["n_routed_experts"]))
    for e in range(cfg["n_routed_experts"]):
        out += mlp(f"mlp.experts.{e}", inter)
    return out + mlp("mlp.shared_experts", inter * cfg["n_shared_experts"])


def parts(cfg: dict) -> list:
    return ["embed"] + list(range(cfg["num_hidden_layers"])) + ["norm"]


def draw(cfg: dict, seed: int, part, device) -> Dict[str, torch.Tensor]:
    """One part's tensors as bfloat16 on ``device``, from a generator of
    the device seeded by (``seed``, part): normal draws times each
    tensor's deviation, a norm scale 1 plus its draw."""
    number = parts(cfg).index(part)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1009 + number) & (2**63 - 1))
    out = {}
    for name, shape, std in part_shapes(cfg, part):
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32).mul_(std)
        if name.endswith("norm.weight"):
            w += 1.0
        out[name] = w.to(torch.bfloat16)
    return out


# -- the forward pass ---------------------------------------------------------

def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale for the whole tensor
    (its largest magnitude to 448), back in float32."""
    scale = x.abs().amax().clamp_min(1e-12) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def yarn(cfg: dict, length: int, device):
    """(cos, sin) [length, d] of the YaRN rotary frequencies, and the
    softmax scale."""
    rs = cfg["rope_scaling"]
    d, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    factor, orig = float(rs["factor"]), rs["original_max_position_embeddings"]

    def corr(rotations):
        return d * math.log(orig / (rotations * 2 * math.pi)) \
            / (2 * math.log(base))

    def mscale(m):
        return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0

    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), d - 1)
    if low == high:
        high += 0.001
    f = 1.0 / base ** (torch.arange(0, d, 2, dtype=torch.float64) / d)
    ramp = ((torch.arange(d // 2, dtype=torch.float64) - low)
            / (high - low)).clamp(0, 1)
    inv_freq = f / factor * ramp + f * (1.0 - ramp)
    freqs = torch.outer(torch.arange(length, dtype=torch.float64), inv_freq)
    emb = torch.cat((freqs, freqs), dim=-1)
    m = mscale(rs["mscale"]) / mscale(rs["mscale_all_dim"])
    scale = (cfg["qk_nope_head_dim"] + d) ** -0.5 \
        * mscale(rs["mscale_all_dim"]) ** 2
    return ((emb.cos() * m).float().to(device),
            (emb.sin() * m).float().to(device), scale)


def rope(x: torch.Tensor, cos, sin) -> torch.Tensor:
    b, h, s, d = x.shape
    x = x.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    rotated = torch.cat((-x[..., d // 2:], x[..., :d // 2]), dim=-1)
    return x * cos + rotated * sin


def attention(w, p, cfg, x, tables, q=_same):
    cos, sin, scale = tables
    B, L, _ = x.shape
    nh, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    eps = cfg["rms_norm_eps"]

    def lin(t, name):
        return F.linear(q(t), q(w[p + name + ".weight"]))

    qh = lin(x, "self_attn.q_proj").view(B, L, nh, dn + dr).transpose(1, 2)
    ckv = lin(x, "self_attn.kv_a_proj_with_mqa")
    c, k_pe = ckv[..., :r], ckv[..., r:]
    kv = lin(rms_norm(c, w[p + "self_attn.kv_a_layernorm.weight"], eps),
             "self_attn.kv_b_proj").view(B, L, nh, dn + dv).transpose(1, 2)
    k_pe = rope(k_pe.reshape(B, L, 1, dr).transpose(1, 2), cos[:L], sin[:L])
    query = torch.cat([qh[..., :dn], rope(qh[..., dn:], cos[:L], sin[:L])],
                      dim=-1)
    key = torch.cat([kv[..., :dn], k_pe.expand(B, nh, L, dr)], dim=-1)
    scores = (q(query) @ q(key).transpose(-1, -2)) * scale
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).triu(1)
    probs = torch.softmax(scores.masked_fill(causal, float("-inf")), dim=-1)
    out = (q(probs) @ q(kv[..., dn:])).transpose(1, 2).reshape(B, L, nh * dv)
    return lin(out, "self_attn.o_proj")


def mlp(w, name, x, q=_same):
    def lin(t, proj):
        return F.linear(q(t), q(w[f"{name}.{proj}.weight"]))

    return lin(F.silu(lin(x, "gate_proj")) * lin(x, "up_proj"), "down_proj")


def moe(w, p, cfg, x, q=_same):
    """The router, the routed experts (a loop with boolean masks) and
    the shared experts, over ``x`` [T, H]."""
    scores = torch.softmax(F.linear(q(x), q(w[p + "mlp.gate.weight"])),
                           dim=-1)
    weights, experts = torch.topk(scores, cfg["num_experts_per_tok"], dim=-1)
    if cfg["num_experts_per_tok"] > 1 and cfg["norm_topk_prob"]:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    else:
        weights = weights * cfg["routed_scaling_factor"]
    y = torch.zeros_like(x)
    for e in range(cfg["n_routed_experts"]):
        hit = experts == e
        rows = hit.any(-1)
        if not bool(rows.any()):
            continue
        we = (weights * hit).sum(-1)[rows]
        y[rows] += we[:, None] * mlp(w, f"{p}mlp.experts.{e}", x[rows], q)
    return y + mlp(w, p + "mlp.shared_experts", x, q)


def layer(w, cfg: dict, i: int, h: torch.Tensor, tables, q=_same):
    p, eps = f"layers.{i}.", cfg["rms_norm_eps"]
    h = h + attention(w, p, cfg, rms_norm(h, w[p + "input_layernorm.weight"],
                                          eps), tables, q)
    x = rms_norm(h, w[p + "post_attention_layernorm.weight"], eps)
    if i < cfg["first_k_dense_replace"]:
        return h + mlp(w, p + "mlp", x, q)
    return h + moe(w, p, cfg, x.reshape(-1, x.shape[-1]), q).view(x.shape)


def embed_batches(weights: Callable, cfg: dict,
                  batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                  quant: str = None) -> List[torch.Tensor]:
    """float32 [B, H] embeddings of each (input_ids, attention_mask)
    batch, computed a layer at a time over all of them: ``weights(part)``
    is called once a part and upcast once."""
    q = fp8 if quant == "fp8" else _same

    def f32(part):
        return {k: v.float() for k, v in weights(part).items()}

    table = f32("embed")["embed_tokens.weight"]
    hs = [table[ids.long()] for ids, _ in batches]
    del table
    longest = max((ids.shape[1] for ids, _ in batches), default=1)
    tables = yarn(cfg, longest, hs[0].device if hs else "cpu")
    for i in range(cfg["num_hidden_layers"]):
        w = f32(i)
        hs = [layer(w, cfg, i, h, tables, q) for h in hs]
        del w
    norm = f32("norm")["norm.weight"]
    out = []
    for h, (_, mask) in zip(hs, batches):
        h = rms_norm(h, norm, cfg["rms_norm_eps"])
        m = mask.to(h.dtype)[:, :, None]
        out.append((h * m).sum(1) / m.sum(1))
    return out


def embed_groups(weights: Callable, cfg: dict,
                 groups: Sequence[Sequence[str]], tokens: Sequence[str],
                 bos_id: int, max_length: int, device, batch: int = 512,
                 quant: str = None) -> List[np.ndarray]:
    """float32 [N, H] embeddings of each list of texts in ``groups``, in
    the order given, all in one pass over the layers: each list in
    batches of titles of about one length, each cut to its longest row
    (padding is causal and masked, so it changes nothing)."""
    plans = []
    for texts in groups:
        order = np.argsort([len(t) for t in texts], kind="stable")
        batches = []
        for s in range(0, len(texts), batch):
            ids, mask = tokenize([texts[i] for i in order[s:s + batch]],
                                 tokens, bos_id, max_length)
            width = int(mask.sum(1).max())
            batches.append((torch.from_numpy(ids[:, :width]).to(device),
                            torch.from_numpy(mask[:, :width]).to(device)))
        plans.append((batches, order))
    with torch.no_grad():
        got = embed_batches(weights, cfg, [b for bs, _ in plans for b in bs],
                            quant)
    out, at = [], 0
    for batches, order in plans:
        emb = torch.cat(got[at:at + len(batches)]).cpu().numpy() \
            if batches else np.zeros((0, cfg["hidden_size"]), np.float32)
        at += len(batches)
        result = np.empty_like(emb)
        result[order] = emb
        out.append(result)
    return out
