"""A mixture of experts' routed half: route, group, compute, combine.

The equations are DeepSeek-V2's (``modeling_deepseek.py``: ``MoEGate``
and ``DeepseekV2MoE.moe_infer``), without a capacity limit, so no token
is dropped:

* ``route``: softmax scores over the experts in float32, the greedy
  top-k, the weights renormalised with ``norm_topk_prob`` or else scaled
  by ``routed_scaling_factor``;
* ``plan``: the (token, slot) pairs sorted by expert (a stable sort),
  the tokens' rows in that order and each expert's end row, all on the
  device;
* ``grouped_mlp``: one grouped product for gate and up together
  (``gate_up`` is ``[E, 2I, H]``, gate rows first), SiLU(gate) * up, one
  grouped product for down (``down`` is ``[E, H, I]``);
* ``combine``: the rows put back in (token, slot) order, weighted in
  float32, summed over the slots and cast back.

On a card the grouped products are ``torch._grouped_mm`` (CUTLASS's
grouped GEMM for sm90, bfloat16 with float32 accumulation) and nothing
here waits for the device: the sort, the end rows (``searchsorted``) and
the gathers and scatters are stream-ordered, and what the host counts
comes from shapes. A CUDA tensor on a torch without ``_grouped_mm``
raises. A CPU tensor takes the plain loop over the experts.

Counters (``utils/profiling.py``): ``moe.rows_routed``, the rows of each
grouped launch pair (tokens x top-k, pad tokens included), and
``moe.launches``, the grouped launch pairs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from multimodalsimilar_tpu_torch.utils.profiling import count, enabled


class Plan(NamedTuple):
    """Where each routed row goes: ``order`` [T*k] the flat (token, slot)
    index of each row in expert order, ``rows`` [T*k] its token, ``ends``
    [E] int32 each expert's end row (``torch._grouped_mm``'s offsets)."""
    order: torch.Tensor
    rows: torch.Tensor
    ends: torch.Tensor


def route(x: torch.Tensor, gate_weight: torch.Tensor, top_k: int,
          norm_topk_prob: bool = False, scaling: float = 1.0):
    """(weights [T, k] float32, experts [T, k] int64) of the tokens ``x``
    [T, H] under the float32 router ``gate_weight`` [E, H]."""
    logits = F.linear(x.float(), gate_weight.float())
    scores = logits.softmax(dim=-1)
    weights, experts = torch.topk(scores, k=top_k, dim=-1, sorted=False)
    if top_k > 1 and norm_topk_prob:
        return weights / (weights.sum(dim=-1, keepdim=True) + 1e-20), experts
    return weights * scaling, experts


def plan(experts: torch.Tensor, n_experts: int) -> Plan:
    """The rows of a ``[T, k]`` routing grouped by expert."""
    k = experts.shape[1]
    flat = experts.reshape(-1)
    sorted_experts, order = torch.sort(flat, stable=True)
    ends = torch.searchsorted(
        sorted_experts, torch.arange(n_experts, device=flat.device,
                                     dtype=flat.dtype),
        right=True, out_int32=True)
    return Plan(order, torch.div(order, k, rounding_mode="floor"), ends)


def _grouped_plain(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor
                   ) -> torch.Tensor:
    """``x`` [R, K] rows in expert order times each expert's ``w[e]``
    [N, K] transposed: one product an expert that has rows."""
    out = x.new_empty((x.shape[0], w.shape[1]))
    start = 0
    for e, end in enumerate(ends.tolist()):
        if end > start:
            out[start:end] = x[start:end] @ w[e].t()
        start = end
    return out


def grouped_mm(x: torch.Tensor, w: torch.Tensor, ends: torch.Tensor
               ) -> torch.Tensor:
    """Rows ``x`` [R, K] grouped by ``ends`` times ``w`` [E, N, K]
    (``nn.Linear``'s layout a group): [R, N]."""
    if x.device.type != "cuda":
        return _grouped_plain(x, w, ends)
    if not hasattr(torch, "_grouped_mm"):
        raise RuntimeError(
            f"torch {torch.__version__} has no torch._grouped_mm: the "
            f"experts' grouped products need torch 2.8 or later on the card")
    return torch._grouped_mm(x, w.transpose(-2, -1), offs=ends)


def grouped_mlp(x: torch.Tensor, p: Plan, gate_up: torch.Tensor,
                down: torch.Tensor) -> torch.Tensor:
    """Each routed row of ``x`` [T, H] through its expert's SiLU-gated
    MLP: [T*k, H] in ``p``'s (expert) order."""
    inter = down.shape[2]
    xs = x.index_select(0, p.rows)
    h = grouped_mm(xs, gate_up, p.ends)
    a = F.silu(h[:, :inter]) * h[:, inter:]
    if enabled():
        count("moe.rows_routed", xs.shape[0])
        count("moe.launches")
    return grouped_mm(a, down, p.ends)


def combine(y: torch.Tensor, p: Plan, weights: torch.Tensor) -> torch.Tensor:
    """``y`` [T*k, H] in expert order back to the tokens: each token's
    rows weighted by ``weights`` [T, k] in float32 and summed, in
    ``y``'s dtype."""
    T, k = weights.shape
    back = torch.empty_like(y).index_copy_(0, p.order, y)
    mixed = back.view(T, k, -1).float() * weights.unsqueeze(-1)
    return mixed.sum(dim=1).to(y.dtype)
