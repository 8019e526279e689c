"""The similarity jobs — batched retrieval + KV writes.

Counterpart of ``multimodalsimilar_tpu/pipelines/similar.py``:

* ``nlp_similar_job`` <- nlp_infer.py:105-172 — text embeddings,
  normalize + inner product, k=13, threshold 0.9, no category filter;
  writes ``dj_similar:{spu_sn}``;
* ``multimodal_similar_job`` <- multimodal_infer.py:103-159 — the fused
  embeddings searched by **un-normalized squared L2**, top-13, no
  threshold; writes ``dj_similar:{spu_sn}``;
* ``daodian_similar_job`` <- daodian_infer.py:329-392 (+ the _v2
  variants) — per area: the fastText text arm (th -0.6, same lv1, cap
  100) and the CV image arm (k 26, th 0.15, same lv2), merged cv-first;
  keys ``{spu_sn}`` (v1) or ``{yyyymmdd}:{spu_sn}`` (v2 date-keyed, TTL
  1.5 days); the v2 "recent days" window keeps only neighbors whose dt
  is the target date. ``build_area_index`` / ``area_merged_map`` are
  the one place both the job and the daemon
  (``pipelines/daodian_serving.py``) build an area's retrieval state.

Tables are pandas DataFrames or ``{column: list}`` mappings (the card
machine has no pandas); the daodian job hands each area to its embedders
as a ``{column: list}`` mapping.

``mesh=`` (``parallel.mesh.Mesh``, every rank calling the job with the
same table) shards the jobs over its data axis: each rank embeds its own
block of rows (``embed_sharded``; the daodian job's fastText arm embeds
every row on every rank), the vectors are all-gathered into the query
set, the engine searches its block of the corpus
(``sharded_knn_search``), and rank 0 alone runs the filters and writes
the sink; every rank returns what rank 0 returns.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from multimodalsimilar_tpu_torch.data.datasets import column
from multimodalsimilar_tpu_torch.pipelines.sinks import KVSink
from multimodalsimilar_tpu_torch.retrieval.engine import SimilarityEngine
from multimodalsimilar_tpu_torch.retrieval.filters import FilterRules
from multimodalsimilar_tpu_torch.utils.profiling import span

WEEK = 7 * 24 * 3600
DAY_AND_HALF = int(1.5 * 24 * 3600)


def write_neighbor_map(sink: KVSink, neighbor_map: Dict[str, List[str]],
                       ttl_seconds: int, key_fn: Callable[[str], str]
                       ) -> int:
    """CSV-string values, empty lists skipped (nlp_infer.py:159-171).
    Keys/neighbors are stringified — integer spu_sn columns must serialize
    like the reference's str keys."""
    with span("similar.write"):
        items = {key_fn(str(k)): ",".join(str(x) for x in v)
                 for k, v in neighbor_map.items() if v}
        sink.set_many(items, ttl_seconds)
    return len(items)


def _sharded(mesh) -> bool:
    return mesh is not None and mesh.data > 1


def row_block(mesh, n: int) -> range:
    """This rank's contiguous block of ``n`` rows on the data axis
    (ceil(n / data) rows a rank, the last block shorter)."""
    per = -(-n // mesh.data)
    return range(min(mesh.data_index * per, n),
                 min((mesh.data_index + 1) * per, n))


def gather_rows(mesh, local, device) -> np.ndarray:
    """The [n_r, D] f32 rows of every rank of the data axis, concatenated
    in rank order. A rank with no rows may pass any empty array (an
    embedder's ``(0, 0)``): the width is agreed first."""
    import torch
    local = np.asarray(local, np.float32)
    width = torch.tensor([local.shape[-1] if len(local) else 0],
                         dtype=torch.int64, device=device)
    width = int(mesh.all_reduce(width, op="max")[0])
    if not len(local):
        local = np.zeros((0, width), np.float32)
    t = torch.from_numpy(np.ascontiguousarray(local)).to(device)
    return mesh.all_gather_rows(t).cpu().numpy()


def embed_sharded(mesh, n: int, embed_rows: Callable[[range], np.ndarray],
                  device) -> np.ndarray:
    """[n, D]: ``embed_rows(block)`` of every rank's ``row_block``,
    all-gathered in row order (each rank embeds only its own rows);
    ``embed_rows(range(n))`` without a sharded ``mesh``."""
    if not _sharded(mesh):
        return embed_rows(range(n))
    return gather_rows(mesh, embed_rows(row_block(mesh, n)), device)


def embed_kept(mesh, n: int, embed_rows: Callable[[range], tuple],
               device) -> tuple:
    """(emb [m, D], kept row indices) of rows 0..n-1, where
    ``embed_rows(rows) -> (emb, kept)`` may drop rows (an image key with
    no readable image): ``kept`` are the positions in ``rows`` that it
    embedded. Sharded, each rank embeds its own ``row_block`` and both
    are all-gathered in row order."""
    if not _sharded(mesh):
        emb, kept = embed_rows(range(n))
        return emb, list(kept)
    import torch
    block = row_block(mesh, n)
    emb, kept = embed_rows(block)
    pos = torch.tensor([block[j] for j in kept], dtype=torch.int64,
                       device=device)
    return (gather_rows(mesh, emb, device),
            mesh.all_gather_rows(pos).cpu().tolist())


def embed_keys_sharded(mesh, keys: Sequence, embed_keys: Callable[
        [List[str]], Dict[str, np.ndarray]], device) -> Dict[str, np.ndarray]:
    """``embed_keys(keys) -> {key: vec}`` (the keys it could embed: an
    image key may have no readable image), each rank embedding its own
    block of ``keys`` under a sharded ``mesh``."""
    keys = list(keys)
    if not _sharded(mesh):
        return embed_keys(keys)

    def block(rows):
        got = embed_keys([keys[i] for i in rows])
        kept = [j for j, i in enumerate(rows) if keys[i] in got]
        vecs = [np.asarray(got[keys[rows[j]]], np.float32).reshape(-1)
                for j in kept]
        return (np.stack(vecs) if vecs else np.zeros((0, 0), np.float32),
                kept)

    emb, kept = embed_kept(mesh, len(keys), block, device)
    return {keys[i]: emb[j] for j, i in enumerate(kept)}


def _search_and_write(engine: SimilarityEngine, mesh, k: int,
                      rules: FilterRules, sink: KVSink, ttl_seconds: int,
                      key_fn: Callable[[str], str]) -> int:
    """The engine's neighbour map written to ``sink``. Sharded, every
    rank runs the search and rank 0 alone filters and writes."""
    if not engine.sharded:
        return write_neighbor_map(sink, engine.similar_map(k, rules),
                                  ttl_seconds, key_fn)
    if mesh.rank == 0:
        n = write_neighbor_map(sink, engine.similar_map(k, rules),
                               ttl_seconds, key_fn)
    else:
        with span("similar.search"):
            engine.search(k)     # this rank's shard of every query's search
        n = None
    return mesh.broadcast_object(n)


def nlp_similar_job(table, embed_texts, sink: KVSink,
                    text_col: str = "spu_name", key_col: str = "spu_sn",
                    k: int = 13, score_th: float = 0.9,
                    ttl_seconds: int = WEEK, device="cuda",
                    mesh=None) -> int:
    """``table`` is a pandas DataFrame or a ``{column: list}`` mapping.

    Divergence kept ON PURPOSE, as in the JAX package: the reference loop
    (nlp_infer.py:161-163) has no self/dedup check beyond skipping rank 0,
    so with duplicate spu_sn rows it can write a key as its own neighbor;
    we always drop same-key neighbors and dedup (see retrieval/filters.py
    docstring)."""
    with span("similar.job"):
        texts = [str(t) for t in column(table, text_col)]
        with span("similar.embed"):
            emb = embed_sharded(mesh, len(texts), lambda rows: embed_texts(
                [texts[i] for i in rows]), device)
        with span("similar.index"):
            engine = SimilarityEngine(emb, column(table, key_col),
                                      metric="ip", normalize=True,
                                      device=device, mesh=mesh)
        return _search_and_write(
            engine, mesh, k, FilterRules(score_threshold=score_th,
                                         same_category=False),
            sink, ttl_seconds, lambda s: f"dj_similar:{s}")


def multimodal_similar_job(table, embeddings, sink: KVSink,
                           key_col: str = "spu_sn", k: int = 13,
                           ttl_seconds: int = WEEK, device="cuda",
                           mesh=None) -> int:
    """L2 metric on raw (un-normalized) fused embeddings, no threshold
    (multimodal_infer.py:140-159). ``table`` is a pandas DataFrame or a
    ``{column: list}`` mapping whose rows ``embeddings`` [N, D] follow
    (all of them on every rank under a mesh)."""
    with span("similar.job"):
        with span("similar.index"):
            engine = SimilarityEngine(embeddings, column(table, key_col),
                                      metric="l2", normalize=False,
                                      device=device, mesh=mesh)
        return _search_and_write(engine, mesh, k,
                                 FilterRules(same_category=False), sink,
                                 ttl_seconds, lambda s: f"dj_similar:{s}")


def norm_dt(v) -> str:
    """'2026-08-16', '20260816', or date objects all compare equal — the
    reference mixes raw SQL dt values with compacted key dates
    (daodian_infer_v2_recent_days.py:242 vs :342); comparing them verbatim
    would silently filter every neighbor out."""
    return "".join(ch for ch in str(v) if ch.isdigit())


def table_columns(table) -> Dict[str, list]:
    """A DataFrame or ``{column: sequence}`` mapping as ``{column:
    list}``, column order kept."""
    names = list(table.columns) if hasattr(table, "columns") \
        else list(table)
    return {c: column(table, c) for c in names}


def take_rows(cols: Dict[str, list], rows: Sequence[int]) -> Dict[str, list]:
    """The ``rows`` of a ``{column: list}`` table, in that order."""
    return {c: [v[i] for i in rows] for c, v in cols.items()}


def n_rows(cols: Dict[str, list]) -> int:
    return len(next(iter(cols.values()))) if cols else 0


@dataclasses.dataclass
class DaodianAreaIndex:
    """One area's hot retrieval state — built identically by the batch job
    (daodian_similar_job) and the online daemon (pipelines/daodian_serving),
    so the two can never drift on engines, depths, or filter rules."""
    area: Dict[str, list]                   # the area's rows
    text_engine: SimilarityEngine           # fastText sentence vectors
    k_text: int
    text_rules: FilterRules
    cv_rows: Dict[str, list]                # rows with a CV embedding
    cv_engine: Optional[SimilarityEngine]   # None when no row has one
    k_cv: int
    cv_rules: Optional[FilterRules]


def build_area_index(
    area,
    embed_titles: Callable[[Sequence[str]], np.ndarray],
    sku_embs: Dict[str, np.ndarray],
    key_col: str = "spu_sn",
    title_col: str = "title",
    lv1_col: str = "first_level_category_id",
    lv2_col: str = "second_level_category_id",
    nlp_score_th: float = -0.6,
    cv_score_th: float = 0.15,
    ann_cnt_nlp: int = 100,
    ann_cnt_cv: int = 26,
    dt_col: Optional[str] = None,
    require_dt: Optional[str] = None,       # already norm_dt'd
    recent_days: int = 7,
    device="cuda",
    mesh=None,
) -> DaodianAreaIndex:
    """Both arms' engines + the reference variant's retrieval depths/rules
    for ONE area (daodian_infer.py:361-375; see daodian_similar_job's
    docstring for the v1/v2 depth semantics). ``area`` is a DataFrame or
    a ``{column: list}`` mapping; ``mesh`` shards both arms' engines."""
    area = table_columns(area)
    n = n_rows(area)
    windowed = bool(require_dt and dt_col)
    text_emb = embed_titles([str(t) for t in area[title_col]])
    rules_kw = dict(require_dt=require_dt) if windowed else {}
    if windowed:
        k_text = max(1, min(n, n // recent_days))
    else:
        k_text = n
    text_engine = SimilarityEngine(
        text_emb, area[key_col], area[lv1_col],
        dts=([norm_dt(v) for v in area[dt_col]] if dt_col else None),
        metric="ip", normalize=True, device=device, mesh=mesh)
    # +1: the reference appends, then breaks once len > ann_cnt
    text_rules = FilterRules(score_threshold=nlp_score_th,
                             same_category=True,
                             max_neighbors=ann_cnt_nlp + 1, **rules_kw)
    cv_rows = take_rows(area, [i for i, k in enumerate(area[key_col])
                               if k in sku_embs])
    cv_engine = cv_rules = None
    k_cv = 0
    n_cv = n_rows(cv_rows)
    if n_cv:
        if windowed:
            k_cv = max(1, min(n_cv, n_cv // recent_days))
            cv_cap = ann_cnt_cv + 1
        else:
            k_cv = min(ann_cnt_cv, n_cv)
            cv_cap = None        # v1 CV loop never breaks
        cv_emb = np.stack([sku_embs[k] for k in cv_rows[key_col]])
        cv_engine = SimilarityEngine(
            cv_emb, cv_rows[key_col], cv_rows[lv2_col],
            dts=([norm_dt(v) for v in cv_rows[dt_col]]
                 if dt_col else None),
            metric="ip", normalize=True, device=device, mesh=mesh)
        cv_rules = FilterRules(score_threshold=cv_score_th,
                               same_category=True, max_neighbors=cv_cap,
                               **rules_kw)
    return DaodianAreaIndex(area=area, text_engine=text_engine,
                            k_text=k_text, text_rules=text_rules,
                            cv_rows=cv_rows, cv_engine=cv_engine,
                            k_cv=k_cv, cv_rules=cv_rules)


def area_merged_map(index: DaodianAreaIndex, mesh=None
                    ) -> Optional[Dict[str, List[str]]]:
    """The area's production answer: cv-first-then-text merged neighbor
    map (daodian_infer.py:368-375). Sharded over ``mesh``, every rank runs
    both arms' searches and rank 0 alone filters and merges; the others
    return None."""
    if _sharded(mesh) and mesh.rank != 0:
        index.text_engine.search(index.k_text)
        if index.cv_engine is not None:
            index.cv_engine.search(index.k_cv)
        return None
    nlp_map = index.text_engine.similar_map(index.k_text, index.text_rules)
    cv_map = (index.cv_engine.similar_map(index.k_cv, index.cv_rules)
              if index.cv_engine is not None else {})
    return SimilarityEngine.merge(cv_map, nlp_map)


def split_areas(table, area_col: str) -> Dict[object, Dict[str, list]]:
    """``{area value: its rows as {column: list}}`` in first-seen order
    (``DataFrame[area_col].unique()``'s)."""
    cols = table_columns(table)
    groups: Dict[object, List[int]] = {}
    for i, a in enumerate(cols[area_col]):
        groups.setdefault(a, []).append(i)
    return {a: take_rows(cols, rows) for a, rows in groups.items()}


def daodian_similar_job(
    table,
    embed_titles: Callable[[Sequence[str]], np.ndarray],   # fastText side
    embed_skus: Callable[[Dict[str, list]], Dict[str, np.ndarray]],  # CV
    sink: KVSink,
    area_col: str = "area_id",
    key_col: str = "spu_sn",
    title_col: str = "title",
    lv1_col: str = "first_level_category_id",
    lv2_col: str = "second_level_category_id",
    nlp_score_th: float = -0.6,       # daodian_infer.py:79-82
    cv_score_th: float = 0.15,
    ann_cnt_nlp: int = 100,
    ann_cnt_cv: int = 26,
    ttl_seconds: Optional[int] = None,   # default: WEEK for v1 keys,
                                         # DAY_AND_HALF when date-keyed
                                         # (daodian_infer_v2_*.py:342)
    date_key: Optional[str] = None,   # 'yyyymmdd' -> v2 date-keyed writes
    dt_col: Optional[str] = None,     # with a target date: v2 history filter
    target_dt: Optional[str] = None,  # dt value neighbors must carry (raw
                                      # --dt, e.g. '2026-08-16'; the KV key
                                      # uses the compacted date_key instead —
                                      # daodian_infer_v2_recent_days.py:242
                                      # vs :342). Defaults to date_key.
    recent_days: int = 7,             # v2 window (daodian_infer_v2_recent_days)
    device="cuda",
    mesh=None,
) -> Dict[str, List[str]]:
    """Per-area fastText + CV retrieval, cv-first merge, KV write.

    ``table`` is a DataFrame or a ``{column: list}`` mapping; each area
    reaches ``embed_skus`` as a ``{column: list}`` mapping. Retrieval
    depths and caps follow the reference variant selected by the date
    arguments:

    * v1 / v2_today (no ``dt_col``): text searches the whole area
      (k=len(arr), daodian_infer.py:230), CV searches ann_cnt_cv=26
      (daodian_infer.py:302); the CV filter loop has no break, the text
      loop breaks only after exceeding ann_cnt_nlp (daodian_infer.py:244-246)
      so its true cap is ann_cnt_nlp+1.
    * v2_recent_days (``dt_col`` set): BOTH sides search
      k = len(arr)//recent_days (daodian_infer_v2_recent_days.py:235,310) —
      the corpus holds ``recent_days`` days of history and only neighbors
      whose dt equals ``date_key`` survive; both loops break after exceeding
      their ann_cnt (:248-250, :323-325), so caps are ann_cnt+1.

    Returns the merged neighbor map (all areas) for inspection/testing.

    ``mesh`` (every rank calling the job with the same table) shards both
    arms' engines over its data axis: every rank runs every area's
    searches, rank 0 alone filters, merges and writes, and every rank
    returns rank 0's map. Sharded engines skip the per-group ranking of
    the v1 text arm: its k = len(area) search runs over the ranks' blocks,
    as in the JAX package.
    """
    merged_all: Dict[str, List[str]] = {}
    key_fn = ((lambda s: f"{date_key}:{s}") if date_key
              else (lambda s: s))
    if ttl_seconds is None:
        ttl_seconds = DAY_AND_HALF if date_key else WEEK
    require_dt = target_dt if target_dt is not None else date_key
    windowed = bool(require_dt and dt_col)
    require_dt = norm_dt(require_dt) if windowed else require_dt
    for area in split_areas(table, area_col).values():
        index = build_area_index(
            area, embed_titles, embed_skus(area), key_col=key_col,
            title_col=title_col, lv1_col=lv1_col, lv2_col=lv2_col,
            nlp_score_th=nlp_score_th, cv_score_th=cv_score_th,
            ann_cnt_nlp=ann_cnt_nlp, ann_cnt_cv=ann_cnt_cv,
            dt_col=dt_col, require_dt=require_dt if windowed else None,
            recent_days=recent_days, device=device, mesh=mesh)
        merged = area_merged_map(index, mesh)
        if merged is not None:
            merged_all.update(merged)
            write_neighbor_map(sink, merged, ttl_seconds, key_fn)
    if _sharded(mesh):
        merged_all = mesh.broadcast_object(merged_all)
    return merged_all
