"""Operations and bytes of a DeepSeek-V2 decoder's forward pass, from the
published configuration (``config.json``'s keys).

As in ``flops.py``, only products count (two operations a multiply-add)
and padding never does: a title of L tokens costs what L tokens cost.
Attention is causal, so a sequence of L tokens needs L (L + 1) / 2
query-key pairs. No output head: the embedder never computes one."""

from __future__ import annotations

from typing import Iterable


def seq_flops(tokens: int, cfg: dict) -> float:
    """Forward operations of one sequence of ``tokens`` real tokens:
    each layer's latent attention (``q_proj``, ``kv_a_proj_with_mqa``,
    ``kv_b_proj``, ``o_proj``, and the score and value products over the
    causal pairs), then the first ``first_k_dense_replace`` layers' dense
    MLP or the others' router, ``num_experts_per_tok`` routed experts and
    the shared experts."""
    L, H = tokens, cfg["hidden_size"]
    nh, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    attn = 2 * L * (H * nh * (dn + dr) + H * (r + dr) + r * nh * (dn + dv)
                    + nh * dv * H) \
        + 2 * nh * (dn + dr + dv) * L * (L + 1) // 2
    dense = 2 * L * 3 * H * cfg["intermediate_size"]
    inter = cfg["moe_intermediate_size"]
    experts = cfg["num_experts_per_tok"] + cfg["n_shared_experts"]
    sparse = 2 * L * (H * cfg["n_routed_experts"] + experts * 3 * H * inter)
    first = cfg["first_k_dense_replace"]
    layers = cfg["num_hidden_layers"]
    return float(layers * attn + first * dense + (layers - first) * sparse)


def job_flops(token_counts: Iterable[int], cfg: dict) -> float:
    return sum(seq_flops(t, cfg) for t in token_counts)


def expert_flops(rows_routed: int, cfg: dict) -> float:
    """The routed experts' grouped products over ``rows_routed`` rows
    (tokens x top-k): gate, up and down, 2 x 3 H I a row."""
    return 2.0 * 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"] \
        * rows_routed


def expert_bytes(launches: int, rows_routed: int, cfg: dict) -> float:
    """Bytes the grouped products need: each launch pair reads every
    routed expert's bfloat16 weights (3 H I a expert) once, and its rows
    come in and go out once, bfloat16 [rows, H] each way."""
    H, inter = cfg["hidden_size"], cfg["moe_intermediate_size"]
    weights = 2.0 * cfg["n_routed_experts"] * 3 * H * inter
    return launches * weights + 2.0 * 2 * H * rows_routed
