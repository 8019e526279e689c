"""Exact k-NN — the FAISS ``IndexFlat`` replacement, in PyTorch.

Counterpart of ``multimodalsimilar_tpu/retrieval/knn.py`` (``knn_search``,
``l2_normalize_rows``, ``pad_corpus``, ``sharded_knn_search``). The
contract is the same: 'ip' returns inner products sorted descending, 'l2'
squared L2 distances sorted ascending, ties go to the lower index, rows
past ``true_n`` never win, and ``k`` shrinks to ``min(k, true_n)``.

On a CUDA tensor the search is ``csrc/topk.cu`` for k <= 128 and the
large-k route (f32 products, then ``csrc/topk_select.cu``) above; on a CPU
tensor their plain version (``ops/topk.py``). The JAX package's HBM-budget
probe, window-max prefilter and merge-every-M schedule are how XLA reaches
that result on a TPU; the kernels need none of them. Query chunks are
bounded by the card's free memory instead (``plan_query_chunk``, which
counts the large-k route's [Qc, N] product tile and selection scratch).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from multimodalsimilar_tpu_torch.ops.topk import (MAX_K, select_scratch_bytes,
                                                  streaming_topk)


def l2_normalize_rows(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def knn_search(corpus: torch.Tensor, queries: torch.Tensor, k: int,
               metric: str = "ip", true_n: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over the corpus: (scores [Q, k'], indices [Q, k'])
    with k' = min(k, true_n), in FAISS order, on the inputs' device.

    ``true_n`` declares that only the first ``true_n`` corpus rows are
    real (the rest are padding, e.g. from ``pad_corpus``)."""
    n = corpus.shape[0]
    true_n = n if true_n is None else true_n
    q = queries.shape[0]
    k_true = min(k, true_n)
    if q == 0 or true_n == 0:
        dev = queries.device
        return (torch.zeros((q, k_true), dtype=torch.float32, device=dev),
                torch.zeros((q, k_true), dtype=torch.int32, device=dev))
    return streaming_topk(corpus, queries, k_true, metric, true_n)


def next_pow2(x: int, lo: int = 128) -> int:
    p = lo
    while p < x:
        p *= 2
    return p


def corpus_block_rows(n: int) -> int:
    """Row multiple the engine pads its cached device corpus to: appends
    land in the padding tail without reallocating. A power of two from 512
    up to 32768, as the JAX engine's blocks."""
    return min(next_pow2(n, lo=512), 32768)


def query_bytes(n: int, d: int, k: int) -> float:
    """Device bytes one query row of a search over ``n`` rows of width
    ``d`` holds at depth ``k`` (already ``min(k, n)``): its f32 row and
    its [k] scores and indices, plus the route's scratch. ``csrc/topk.cu``
    (k <= ``MAX_K``) keeps up to three more lists per query for its corpus
    splits; the large-k route holds the query's [n] f32 product row and
    the selection's running lists (``select_scratch_bytes``)."""
    if k <= MAX_K:
        return 4.0 * d + 8.0 * k * 4
    return 4.0 * d + 8.0 * k + 4.0 * n + select_scratch_bytes(n, k)


def plan_query_chunk(n: int, d: int, k: int, device: torch.device,
                     cap: int) -> int:
    """Query rows per search call over ``n`` corpus rows at depth ``k``.
    On a card, the most whose ``query_bytes`` fit in half of the free
    device memory (``torch.cuda.mem_get_info``); on the CPU, ``cap``."""
    if torch.device(device).type != "cuda":
        return cap
    free, _ = torch.cuda.mem_get_info(device)
    per_query = query_bytes(n, d, min(k, n))
    return int(max(1, min(cap, 0.5 * free // per_query)))


def pad_corpus(corpus: np.ndarray, multiple: int, metric: str = "ip",
               target_rows: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Pad corpus rows to a multiple of ``multiple`` (at least
    ``target_rows`` when given: bucketed targets let similarly sized
    corpora share one shard shape) with rows that can never win (zeros
    for IP after the index mask, 1e18 rows for L2) and return the true
    length to mask by."""
    n = corpus.shape[0]
    want = max(n, target_rows or 0)
    want += (-want) % multiple
    pad = want - n
    if pad == 0:
        return corpus, n
    fill = np.zeros((pad, corpus.shape[1]), corpus.dtype)
    if metric == "l2":
        fill = fill + 1e18
    return np.concatenate([corpus, fill], axis=0), n


def sharded_knn_search(mesh, corpus_shard: torch.Tensor,
                       queries: torch.Tensor, k: int, metric: str = "ip",
                       true_n: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k with the corpus row-sharded over the mesh's data axis
    (the JAX package's ``sharded_knn_search``): every rank passes its own
    block of ``rows`` rows of the padded corpus (``pad_corpus`` to a
    multiple of the axis, ``MeshRules.corpus_sharded``) and the same
    queries, and every rank gets the same (scores, indices), equal to
    ``knn_search`` over the whole corpus, FAISS order included.

    Each rank searches its block with the kernels (``knn_search``:
    ``csrc/topk.cu``, or the selection kernel where its k exceeds
    ``MAX_K``) at ``local_k = min(k, rows)``, masking past ``true_n -
    rank * rows``, and offsets its indices by ``rank * rows``; slots with
    no real row carry (-inf, n). Only the [Q, local_k] candidates cross
    between ranks (an all-gather); the merge keeps ``k_out = min(k,
    true_n, ranks * local_k)`` by a stable descending sort: candidates
    lie shard-major and each shard's in (score desc, index asc), so among
    equal scores position order is index order."""
    n_dev, i = mesh.data, mesh.data_index
    rows, d = corpus_shard.shape
    n = rows * n_dev
    limit = n if true_n is None else true_n
    local_k = min(k, rows)
    k_out = min(k, limit, n_dev * local_k)
    q = queries.shape[0]
    dev = queries.device
    vals = torch.full((q, local_k), float("-inf"), dtype=torch.float32,
                      device=dev)
    idx = torch.full((q, local_k), n, dtype=torch.int32, device=dev)
    local_n = min(max(limit - i * rows, 0), rows)
    if local_n and q and local_k:
        v, gi = knn_search(corpus_shard, queries, local_k, metric,
                           true_n=local_n)
        vals[:, :v.shape[1]] = -v if metric == "l2" else v
        idx[:, :gi.shape[1]] = gi + i * rows
    v_all = mesh.all_gather(vals)                   # [n_dev, Q, local_k]
    i_all = mesh.all_gather(idx)
    v_flat = v_all.permute(1, 0, 2).reshape(q, n_dev * local_k)
    i_flat = i_all.permute(1, 0, 2).reshape(q, n_dev * local_k)
    top, order = torch.sort(v_flat, dim=1, descending=True, stable=True)
    vals = top[:, :k_out]
    idx = torch.gather(i_flat, 1, order[:, :k_out])
    return (-vals if metric == "l2" else vals), idx
