"""The text job's search and filters, exact: inner products of
L2-normalised rows in float64, the k best of each query in descending
order with ties to the lower index, then the job's rules (drop the query
row and same-key rows, keep scores above the threshold, first occurrence
of a key wins). And the judge of a written neighbour list against them.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch


def normalized64(emb: np.ndarray, device) -> torch.Tensor:
    x = torch.from_numpy(np.asarray(emb, np.float32)).to(device).double()
    return x / torch.clamp_min(x.norm(dim=1, keepdim=True), 1e-12)


def ranked(corpus: torch.Tensor, rows: Sequence[int], k: int):
    """(scores [q, N] f64 on the host, the k best columns of each row,
    ties to the lower index)."""
    s = corpus[torch.as_tensor(list(rows), device=corpus.device)] \
        @ corpus.T
    order = torch.sort(s, dim=1, descending=True, stable=True).indices[:, :k]
    return s.cpu().numpy(), order.cpu().numpy()


def expected_list(scores, order: np.ndarray, row: int,
                  keys: Sequence[str], threshold: float) -> List[int]:
    """The job's rules on one query's k best: rows, not keys."""
    out, seen = [], set()
    for j in order:
        j = int(j)
        if j == row or keys[j] == keys[row] or not scores[j] > threshold \
                or keys[j] in seen:
            continue
        seen.add(keys[j])
        out.append(j)
    return out


def list_gap(scores, order: np.ndarray, row: int,
             written: List[int], keys: Sequence[str], threshold: float
             ) -> float:
    """How far a written list lies from the exact one, in score units
    (``scores``: the query's exact scores, indexed by row).

    Position by position, the gap between the exact score of the written
    neighbour and that of the expected one; an item only one list holds
    (the two lists differ in length) is as far as its score lies from the
    nearer of the two cuts it could have fallen to: the threshold or the
    k-th best score. A written row that is the query itself, or written
    twice, is an infinite gap."""
    want = expected_list(scores, order, row, keys, threshold)
    if row in written or len(set(written)) != len(written) \
            or min(written, default=0) < 0:
        return float("inf")
    cut = float(scores[int(order[-1])])
    gap = 0.0
    for a, b in zip(written, want):
        gap = max(gap, abs(float(scores[a]) - float(scores[b])))
    tail = written[len(want):] + want[len(written):]
    for x in tail:
        s = float(scores[x])
        gap = max(gap, min(abs(s - threshold), abs(s - cut)))
    return gap


def widest_list_gap(corpus: torch.Tensor, written: Sequence[List[int]],
                    keys: Sequence[str], k: int, threshold: float,
                    chunk: int = 1024) -> float:
    """The widest ``list_gap`` over every row of ``corpus`` (L2-normalised
    float64), ``written[i]`` being row i's written list: the exact k best
    of a block of rows at a time, with the scores of what they wrote."""
    n = corpus.shape[0]
    width = max([len(w) for w in written] + [1])
    gap = 0.0
    for s in range(0, n, chunk):
        rows = range(s, min(s + chunk, n))
        scores = corpus[s:s + len(rows)] @ corpus.T
        order = torch.sort(scores, dim=1, descending=True,
                           stable=True).indices[:, :k]
        picked = torch.tensor([[max(j, 0) for j in written[r]]
                               + [0] * (width - len(written[r]))
                               for r in rows], device=corpus.device)
        top = scores.gather(1, order).cpu().numpy()
        got = scores.gather(1, picked).cpu().numpy()
        order = order.cpu().numpy()
        for q, r in enumerate(rows):
            lookup = dict(zip(order[q].tolist(), top[q].tolist()))
            lookup.update(zip(written[r], got[q].tolist()))
            gap = max(gap, list_gap(lookup, order[q], r, written[r], keys,
                                    threshold))
    return gap


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits, to nearest), still
    float32: the operands of a product one precision step below float32
    with TF32 off."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def search_tf32(emb: np.ndarray, k: int, device, chunk: int = 4096):
    """The job's search with TF32 products (the comparison's control):
    rows L2-normalised in float32, the k best of each row over all rows,
    as numpy (scores [N, k] float32, indices [N, k] int32)."""
    x = torch.from_numpy(np.asarray(emb, np.float32)).to(device)
    x = tf32(x / torch.clamp_min(x.norm(dim=1, keepdim=True), 1e-12))
    vals, idx = [], []
    for s in range(0, len(x), chunk):
        v, i = torch.topk(x[s:s + chunk] @ x.T, min(k, len(x)), dim=1)
        vals.append(v.cpu())
        idx.append(i.cpu())
    return (torch.cat(vals).numpy(),
            torch.cat(idx).to(torch.int32).numpy())


def parse_written(value, key_row: Dict[str, int]) -> List[int]:
    """The rows of a written ``a,b,c`` value; -1 for a key that is not in
    the catalog (an infinite gap, since row -1 scores nothing)."""
    if not value:
        return []
    return [key_row.get(k, -1) for k in str(value).split(",")]
