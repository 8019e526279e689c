"""The similarity jobs — batched retrieval + KV writes.

Counterpart of ``nlp_similar_job``, ``multimodal_similar_job`` and
``write_neighbor_map`` in ``multimodalsimilar_tpu/pipelines/similar.py``:

* ``nlp_similar_job`` <- nlp_infer.py:105-172 — text embeddings,
  normalize + inner product, k=13, threshold 0.9, no category filter;
* ``multimodal_similar_job`` <- multimodal_infer.py:103-159 — the fused
  embeddings searched by **un-normalized squared L2**, top-13, no
  threshold.

Both write ``dj_similar:{spu_sn}`` = comma-joined neighbor spu_sns with a
TTL (default 7 days). The daodian jobs come with a later slice.
"""

from __future__ import annotations

from typing import Callable, Dict, List

from multimodalsimilar_tpu_torch.data.datasets import column
from multimodalsimilar_tpu_torch.pipelines.sinks import KVSink
from multimodalsimilar_tpu_torch.retrieval.engine import SimilarityEngine
from multimodalsimilar_tpu_torch.retrieval.filters import FilterRules

WEEK = 7 * 24 * 3600


def write_neighbor_map(sink: KVSink, neighbor_map: Dict[str, List[str]],
                       ttl_seconds: int, key_fn: Callable[[str], str]
                       ) -> int:
    """CSV-string values, empty lists skipped (nlp_infer.py:159-171).
    Keys/neighbors are stringified — integer spu_sn columns must serialize
    like the reference's str keys."""
    items = {key_fn(str(k)): ",".join(str(x) for x in v)
             for k, v in neighbor_map.items() if v}
    sink.set_many(items, ttl_seconds)
    return len(items)


def nlp_similar_job(table, embed_texts, sink: KVSink,
                    text_col: str = "spu_name", key_col: str = "spu_sn",
                    k: int = 13, score_th: float = 0.9,
                    ttl_seconds: int = WEEK, device="cuda") -> int:
    """``table`` is a pandas DataFrame or a ``{column: list}`` mapping.

    Divergence kept ON PURPOSE, as in the JAX package: the reference loop
    (nlp_infer.py:161-163) has no self/dedup check beyond skipping rank 0,
    so with duplicate spu_sn rows it can write a key as its own neighbor;
    we always drop same-key neighbors and dedup (see retrieval/filters.py
    docstring)."""
    emb = embed_texts([str(t) for t in column(table, text_col)])
    engine = SimilarityEngine(emb, column(table, key_col), metric="ip",
                              normalize=True, device=device)
    nmap = engine.similar_map(k, FilterRules(score_threshold=score_th,
                                             same_category=False))
    return write_neighbor_map(sink, nmap, ttl_seconds,
                              lambda s: f"dj_similar:{s}")


def multimodal_similar_job(table, embeddings, sink: KVSink,
                           key_col: str = "spu_sn", k: int = 13,
                           ttl_seconds: int = WEEK, device="cuda") -> int:
    """L2 metric on raw (un-normalized) fused embeddings, no threshold
    (multimodal_infer.py:140-159). ``table`` is a pandas DataFrame or a
    ``{column: list}`` mapping whose rows ``embeddings`` [N, D] follow."""
    engine = SimilarityEngine(embeddings, column(table, key_col),
                              metric="l2", normalize=False, device=device)
    nmap = engine.similar_map(k, FilterRules(same_category=False))
    return write_neighbor_map(sink, nmap, ttl_seconds,
                              lambda s: f"dj_similar:{s}")
