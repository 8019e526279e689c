"""Business-rule neighbor filtering (vectorized numpy).

The reference post-processes FAISS results with per-row Python loops
(daodian_infer.py:233-246, :305-315; nlp_infer.py:161-169). Same semantics
here, applied to the (scores, indices) matrices the k-NN engine returns:

  * drop self (the query row itself, and any neighbor with the same key),
  * score threshold (``score > th`` — strict, like the reference),
  * same-category constraint (lv1 for text, lv2 for CV),
  * dedup while preserving rank order (first *surviving* occurrence wins,
    matching the reference's ``not in out[spusn]`` check against appended
    neighbors only),
  * cap at ``max_neighbors``,
  * optional date-window rule: neighbor kept only if its ``dt`` equals the
    query's target date (daodian_infer_v2_recent_days.py:242-251).

All rules are evaluated as numpy mask algebra — no per-candidate Python.
At warehouse scale (100k queries x k=100) filtering runs in ~0.5-1 s on one
CPU where the per-candidate loop it replaced took a minute+; only the final
group-by-row dict assembly touches Python objects, and only for survivors.

Deliberate divergence on score TIES: the reference drops rank 0
unconditionally (``I[i][1:]``) on the assumption that rank 0 is the query
itself. When another row carries an IDENTICAL embedding (duplicate
products sharing one cached emb.txt), FAISS's index tie-break can put the
duplicate at rank 0 — the reference then drops the genuinely-similar
duplicate and keeps the query ITSELF as its own neighbor. We instead drop
the query row and same-key neighbors wherever they rank, keeping distinct
duplicate items; on tie-free data the two are provably identical
(differential-tested during review), and on ties ours is the non-buggy
reading of the intent.

Copied from ``multimodalsimilar_tpu/retrieval/filters.py``, with one
change: columns are factorized by ``_factorize`` (a dict, first-seen
order, missing values -1) instead of ``pandas.factorize``, because the
port does not need pandas on its device path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class FilterRules:
    score_threshold: Optional[float] = None   # keep score > threshold
    same_category: bool = True
    max_neighbors: Optional[int] = None
    require_dt: Optional[str] = None          # keep neighbors with this dt


def _missing(v) -> bool:
    """True for every value ``pandas.factorize`` codes -1: None, and any
    value unequal to itself (float and numpy NaN, ``pd.NaT``,
    ``np.datetime64('NaT')``) or whose self-comparison is no bool
    (``pd.NA`` compares to NA, which raises ``TypeError`` in ``bool``).
    pandas itself is not imported."""
    if v is None:
        return True
    try:
        return bool(v != v)
    except (TypeError, ValueError):
        return True


def _factorize(values):
    """(int64 codes, uniques) in first-seen order, like
    ``pandas.factorize``: missing values (``_missing``) get -1; equal
    values (1 == 1.0) share a code."""
    table: Dict[object, int] = {}
    codes = np.empty(len(values), np.int64)
    for i, v in enumerate(values):
        codes[i] = -1 if _missing(v) else table.setdefault(v, len(table))
    return codes, list(table)


def filter_neighbors(
    scores: np.ndarray,            # [Q, k] (IP: higher better)
    indices: np.ndarray,           # [Q, k] corpus row ids
    keys: Sequence,                # corpus row -> external key (spu_sn)
    categories: Optional[Sequence] = None,
    rules: FilterRules = FilterRules(),
    query_rows: Optional[np.ndarray] = None,   # corpus row of each query
    dts: Optional[Sequence] = None,
    return_lists: bool = False,
) -> Dict[object, List[object]]:
    """Return {query_key: [neighbor_keys ranked]} under the rules.

    ``query_rows`` defaults to arange (self-search, the reference's usage).
    ``return_lists=True`` returns the per-QUERY lists positionally instead
    of the keyed dict — callers that stitch partial results (the grouped
    self-search) need row identity, which the dict loses for duplicate
    query keys.
    """
    keys = np.asarray(keys, dtype=object)
    n = len(keys)
    q, k = scores.shape
    if query_rows is None:
        query_rows = np.arange(q)
    query_rows = np.asarray(query_rows)

    # factorize everything once: object comparisons become int compares.
    # A hash table (not np.unique) because warehouse columns mix types —
    # a string category column with NaN holes crashes np.unique's sort.
    # NaN keys get DISTINCT codes (nan != nan, like the comparisons they
    # replace); NaN categories/dts keep the -1 sentinel and never match.
    def factorize(values, distinct_nan=False):
        codes, uniq = _factorize(values)
        if distinct_nan:
            nan_pos = np.nonzero(codes < 0)[0]
            codes[nan_pos] = len(uniq) + np.arange(len(nan_pos))
        return codes, uniq

    key_codes, _ = factorize(keys, distinct_nan=True)

    idx = np.asarray(indices)
    valid = (idx >= 0) & (idx < n)
    idx_safe = np.where(valid, idx, 0)

    # phase 1: gather-free elementwise [Q, k] masks (bounds, self row,
    # score threshold) — these need no table lookups
    mask = valid & (idx != query_rows[:, None])
    if rules.score_threshold is not None:
        mask &= scores > rules.score_threshold

    # table-lookup rules (category, dt window, self-key). Two evaluation
    # strategies with identical results: dense (gathers over the full [Q, k]
    # matrix) wins when the score threshold lets most candidates through;
    # sparse (compact to survivors first, gather per survivor) wins when it
    # doesn't. Random gathers are the dominant cost either way, so pick by
    # survivor density.
    cat_codes = dt_codes = None
    dt_target = -2
    if rules.same_category and categories is not None:
        cat_codes = factorize(categories)[0].astype(np.int32)
    if rules.require_dt is not None and dts is not None:
        dt_codes, dt_uniq = factorize(dts)
        dt_codes = dt_codes.astype(np.int32)
        hit = [i for i, u in enumerate(dt_uniq) if u == rules.require_dt]
        dt_target = hit[0] if hit else -2   # -2: never matches (NaN is -1)
    key_codes = key_codes.astype(np.int32)

    dense = np.count_nonzero(mask) > 0.15 * mask.size
    if dense:
        if cat_codes is not None:
            g = cat_codes[idx_safe]
            # NaN categories (code -1) never match anything, incl. NaN
            mask &= (g == cat_codes[query_rows][:, None]) & (g >= 0)
        if dt_codes is not None:
            mask &= dt_codes[idx_safe] == dt_target
        mask &= key_codes[idx_safe] != key_codes[query_rows][:, None]
    rows, cols = np.nonzero(mask)
    cand = idx_safe[rows, cols]
    qrow = query_rows[rows]
    if not dense:
        sel = np.ones(len(rows), dtype=bool)
        if cat_codes is not None:
            g = cat_codes[cand]
            sel &= (g == cat_codes[qrow]) & (g >= 0)
        if dt_codes is not None:
            sel &= dt_codes[cand] == dt_target
        # self-key rule: drop any candidate sharing the query's key
        sel &= key_codes[cand] != key_codes[qrow]
        rows = rows[sel]
        cand = cand[sel]
    c = key_codes[cand].astype(np.int64)
    # first surviving occurrence of a key per row wins (the reference's
    # 'not in out[spusn]' check only sees appended neighbors)
    combined = rows.astype(np.int64) * (int(key_codes.max(initial=0)) + 1) + c
    keep = np.zeros(len(rows), dtype=bool)
    keep[np.unique(combined, return_index=True)[1]] = True
    if rules.max_neighbors is not None and len(rows):
        kept_cum = np.cumsum(keep)
        row_start = np.searchsorted(rows, rows)          # start idx per entry
        base = np.where(row_start > 0, kept_cum[row_start - 1], 0)
        keep &= (kept_cum - base) <= rules.max_neighbors
    rows = rows[keep]
    neighbor_keys = keys[cand[keep]]

    starts = np.searchsorted(rows, np.arange(q))
    ends = np.searchsorted(rows, np.arange(q), side="right")
    if return_lists:
        return [list(neighbor_keys[starts[qi]:ends[qi]])
                for qi in range(q)]
    out: Dict[object, List[object]] = {}
    for qi in range(q):
        # duplicate query keys: the last row wins, like the loop it replaced
        out[keys[query_rows[qi]]] = list(neighbor_keys[starts[qi]:ends[qi]])
    return out


def merge_neighbor_maps(primary: Dict, secondary: Dict,
                        cap: Optional[int] = None) -> Dict:
    """cv-first-then-nlp merge (daodian_infer.py:368-375): primary's
    neighbors first, then secondary's not already present."""
    out = {}
    for key in set(primary) | set(secondary):
        merged = list(primary.get(key, []))
        have = set(merged)
        for k2 in secondary.get(key, []):
            if k2 not in have:
                merged.append(k2)
                have.add(k2)
        out[key] = merged[:cap] if cap else merged
    return out
