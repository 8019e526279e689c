"""Bulk, incremental, and rebuild embedding export jobs.

Copied from ``multimodalsimilar_tpu/pipelines/embed.py`` (which imports
pandas and the sinks, not JAX), against the port's
``pipelines/sinks.py``; pandas is imported inside the jobs.

* ``bulk_export``        <- goodssku_emb.py:145-202 — embed every key with
  one or more embedders, outer-merge into one table, overwrite the
  warehouse. The reference bulk job serializes RAW values: unnormalized,
  ','-joined with no brackets (goodssku_emb.py:92-93,114-115,131-133) —
  only the _di incremental variants normalize and bracket.
* ``incremental_export`` <- goodssku_emb_{bert,fasttext}_di.py — daily
  delta: skip keys already in the table (goodssku_emb_bert_di.py:126-129),
  embed the rest, L2-normalize, serialize as '[x,y,...]' strings (:85-87),
  and write in a few large flushes (per-chunk table rewrites would be
  quadratic I/O).
* ``rebuild_export``     <- goodssku_emb_cv_di.py — despite the _di name,
  the CV job is a FULL REBUILD: it re-reads every cached emb.txt for
  today's catalog and INSERT OVERWRITEs the whole table (:83-119), so
  re-embedded SKUs refresh and departed SKUs drop out.

``embed_fn(sub_df) -> {key: vector}`` lets each tower plug in.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from multimodalsimilar_tpu_torch.pipelines.sinks import TableSink

EmbedFn = Callable[[object], Dict[str, np.ndarray]]


def format_embedding(vec: np.ndarray, normalize: bool = True,
                     brackets: bool = True) -> str:
    """'[x,y,...]' (goodssku_emb_bert_di.py:84-87) or the bulk job's raw
    'x,y,...' (goodssku_emb.py:92-93) serialization."""
    v = np.asarray(vec, np.float32)
    if normalize:
        n = float(np.linalg.norm(v))
        if n > 0:
            v = v / n
    body = ",".join(str(float(x)) for x in v)
    return f"[{body}]" if brackets else body


def parse_embedding(s: str) -> np.ndarray:
    return np.asarray([float(x) for x in s.strip("[]").split(",")],
                      np.float32)


def parse_embeddings(strings) -> np.ndarray:
    """[N, D] from many '[x,y,...]' rows in ONE np.loadtxt pass per chunk
    (per-row ``parse_embedding`` is python-float speed). Rows must share
    one dimension (they do within a warehouse table; a ragged table
    raises)."""
    import io
    strings = list(strings)
    if not strings:
        return np.zeros((0, 0), np.float32)

    def load(chunk):
        body = "\n".join(s.strip().strip("[]") for s in chunk)
        got = np.loadtxt(io.StringIO(body), delimiter=",",
                         dtype=np.float32, ndmin=2)
        if got.shape[0] != len(chunk):
            raise ValueError(f"parsed {got.shape[0]} rows from "
                             f"{len(chunk)} embedding strings")
        return got

    # chunked: one giant '\n'.join over a warehouse-scale table would
    # materialize a multi-GB transient string (1M x 768 floats ~ 10 GB)
    step = 50_000
    first = load(strings[:step])
    if len(strings) <= step:
        return first
    out = np.empty((len(strings), first.shape[1]), np.float32)
    out[:step] = first
    for s in range(step, len(strings), step):
        chunk = load(strings[s: s + step])
        if chunk.shape[1] != first.shape[1]:
            raise ValueError(f"ragged embedding table: dim "
                             f"{chunk.shape[1]} at row {s} vs "
                             f"{first.shape[1]}")
        out[s: s + len(chunk)] = chunk
    return out


def incremental_export(
    df,
    embed_fn: EmbedFn,
    sink: TableSink,
    key_col: str = "goods_sku",
    emb_col: str = "embedding",
    dt: Optional[str] = None,
    normalize: bool = True,
    buffer_rows: int = 8192,
    flush_rows: int = 50_000,
) -> int:
    """Embed only keys missing from the sink; returns #rows written.

    Embedding runs in ``buffer_rows`` chunks of the DataFrame ``df``
    (bounded memory); the table is flushed to the sink every
    ``flush_rows`` accumulated rows rather than once at the end — a single
    final write holds every embedding of a first-run backfill in RAM and
    loses the whole run on a late crash. Periodic flushes bound memory AND
    keep the job resumable: a retry's ``existing_keys`` pre-filter skips
    everything already flushed.
    """
    import pandas as pd
    existing = sink.existing_keys(key_col)
    keys = df[key_col].astype(str)
    # in-df duplicate keys must collapse too: existing_keys only guards
    # against the SINK's keys, and a key recurring across two flushes
    # would otherwise append twice
    todo = df[~keys.isin(existing) & ~keys.duplicated()]
    rows, written = [], 0
    for s in range(0, len(todo), buffer_rows):
        chunk = todo.iloc[s: s + buffer_rows]
        for key, vec in embed_fn(chunk).items():
            row = {key_col: str(key),
                   emb_col: format_embedding(vec, normalize)}
            if dt is not None:
                row["dt"] = dt
            rows.append(row)
        if len(rows) >= flush_rows:
            sink.append(pd.DataFrame(rows))
            written += len(rows)
            rows = []
    if rows:
        sink.append(pd.DataFrame(rows))
        written += len(rows)
    # merge any append parts into the single table file on success (sinks
    # that append in place have no compact)
    compact = getattr(sink, "compact", None)
    if compact is not None:
        compact()
    return written


def rebuild_export(
    df,
    embed_fn: EmbedFn,
    sink: TableSink,
    key_col: str = "goods_sku",
    emb_col: str = "embedding",
    dt: Optional[str] = None,
    normalize: bool = True,
    buffer_rows: int = 8192,
) -> int:
    """Embed EVERY key in today's catalog and overwrite the whole table
    (goodssku_emb_cv_di.py semantics): refreshed embeddings replace stale
    rows and keys absent from the catalog are dropped."""
    import pandas as pd
    rows = []
    for s in range(0, len(df), buffer_rows):
        chunk = df.iloc[s: s + buffer_rows]
        for key, vec in embed_fn(chunk).items():
            row = {key_col: str(key),
                   emb_col: format_embedding(vec, normalize)}
            if dt is not None:
                row["dt"] = dt
            rows.append(row)
    sink.overwrite(pd.DataFrame(rows) if rows
                   else pd.DataFrame(columns=[key_col, emb_col]))
    return len(rows)


def bulk_export(
    df,
    embedders: Dict[str, EmbedFn],
    sink: TableSink,
    key_col: str = "goods_sku",
    normalize: bool = False,
    brackets: bool = False,
):
    """Run several embedders over all keys and outer-merge columns
    (goodssku_emb.py builds fasttext/bert/cv columns then outer-merges
    :183-195). Overwrites the sink with the merged DataFrame and returns
    it.

    Defaults serialize the way the reference bulk job does — raw values,
    no normalization, no brackets (:92-93,114-115,131-133); pass
    normalize=True, brackets=True for the _di-style format instead."""
    import pandas as pd
    merged = None
    for name, embed_fn in embedders.items():
        embs = embed_fn(df)
        part = pd.DataFrame(
            {key_col: [str(k) for k in embs],
             f"{name}_emb": [format_embedding(v, normalize, brackets)
                             for v in embs.values()]})
        merged = part if merged is None else merged.merge(
            part, on=key_col, how="outer")
    if merged is None:
        merged = pd.DataFrame(columns=[key_col])
    sink.overwrite(merged)
    return merged
