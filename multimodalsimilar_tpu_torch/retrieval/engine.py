"""SimilarityEngine: embeddings + metadata -> filtered neighbor maps.

Counterpart of ``multimodalsimilar_tpu/retrieval/engine.py``. The corpus is
normalized on the host (eps 1e-12, like ``faiss.normalize_L2``), cached on
the device once, padded to a block multiple, and searched exactly with
``knn_search`` (``csrc/topk.cu`` on a card); only the [Q, k] candidate
lists come back to the host for the business-rule pass.
``fused_search_fn`` chains a tower into that search for the serving
daemon.

There is no backend or approximate-recall option: the device decides
which path runs (the JAX package's approximate search is a TPU path).
With a ``mesh`` whose data axis is above 1 the engine holds only this
rank's block of the padded corpus and searches it with
``sharded_knn_search`` (the JAX engine's sharded dispatch); every rank of
the data axis then makes the same calls with the same queries and gets
the same answers. A full-ranking self-search (k >= n) under a
same-category rule, the daodian text arm's, runs per category group
(``_grouped_self_similar_map``), as in the JAX package, on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from multimodalsimilar_tpu_torch.retrieval.filters import (
    FilterRules, _factorize, filter_neighbors, merge_neighbor_maps)
from multimodalsimilar_tpu_torch.retrieval.knn import (
    corpus_block_rows, knn_search, next_pow2, pad_corpus, plan_query_chunk,
    sharded_knn_search)
from multimodalsimilar_tpu_torch.utils.devices import resolve_device
from multimodalsimilar_tpu_torch.utils.profiling import span


def _normalize_rows(q):
    """L2-normalize rows with the engine's epsilon (faiss.normalize_L2),
    for numpy arrays and torch tensors alike: the corpus, updates and
    external queries all go through here."""
    if isinstance(q, torch.Tensor):
        norms = torch.linalg.norm(q, dim=1, keepdim=True)
        return q / torch.clamp(norms, min=1e-12)
    norms = np.linalg.norm(q, axis=1, keepdims=True)
    return q / np.maximum(norms, 1e-12)


class SimilarityEngine:
    QUERY_CHUNK = 32_768

    def __init__(self, embeddings: np.ndarray, keys: Sequence,
                 categories: Optional[Sequence] = None,
                 dts: Optional[Sequence] = None,
                 metric: str = "ip", normalize: bool = True,
                 device="cuda", mesh=None):
        """``normalize=True`` reproduces faiss.normalize_L2 before indexing
        (cosine similarity); the fused-L2 job passes normalize=False,
        metric='l2'. ``device`` holds the corpus and runs the search;
        ``mesh`` (``parallel.mesh.Mesh``) shards it over its data axis."""
        self.device = resolve_device(device)
        self.mesh = mesh
        self.sharded = mesh is not None and mesh.data > 1
        emb = np.asarray(embeddings, np.float32)
        self.keys = list(keys)
        self.categories = categories
        self.dts = dts
        self.metric = metric
        self.n = emb.shape[0]
        self._normalized = normalize
        if normalize:
            emb = _normalize_rows(emb)
        self._emb = emb
        self._corpus_dev = None       # cached device corpus, true_n, block
        self._key_pos = None          # lazy key -> row map for update()
        self._buf = None              # capacity buffer once update() appends

    @property
    def dim(self) -> int:
        """Width of the corpus rows (and of the queries it takes)."""
        return self._emb.shape[1]

    # -- corpus upsert ------------------------------------------------------

    def update(self, embeddings: np.ndarray, keys: Sequence,
               categories: Optional[Sequence] = None,
               dts: Optional[Sequence] = None) -> Tuple[int, int]:
        """Upsert corpus rows by key; returns (replaced, appended).

        New keys append, known keys get their row replaced; embeddings get
        the corpus's normalization. The cached device corpus is patched in
        place with the delta (appends land in the block-padding tail, which
        grows by whole blocks when full), so an update never re-uploads the
        corpus. Engines built with categories (or dts) require them for
        every update, and engines built without reject them.
        """
        emb = np.asarray(embeddings, np.float32)
        keys = [str(k) for k in keys]
        if emb.ndim != 2 or emb.shape[0] != len(keys):
            raise ValueError(f"embeddings {emb.shape} vs {len(keys)} keys")
        if self._emb.ndim == 2 and self._emb.shape[1] != emb.shape[1]:
            raise ValueError(f"dim mismatch: corpus d={self._emb.shape[1]}, "
                             f"update d={emb.shape[1]}")
        for name, have, got in (("categories", self.categories, categories),
                                ("dts", self.dts, dts)):
            if (have is None) != (got is None):
                raise ValueError(
                    f"engine was built {'with' if have is not None else 'without'} "
                    f"{name} — update must {'supply' if have is not None else 'omit'} them")
            if got is not None and len(got) != len(keys):
                raise ValueError(f"{name} length {len(got)} != {len(keys)}")
        if len(keys) != len(set(keys)):
            raise ValueError("duplicate keys within one update batch — "
                             "last-wins would be silent; dedup first")
        if self._normalized:
            emb = _normalize_rows(emb)

        if self._key_pos is None:   # first update: take ownership of the
            # host mirror (init may alias the caller's array when
            # normalize=False) and make metadata mutable
            self._buf = np.array(self._emb, np.float32, copy=True)
            self._emb = self._buf[:self.n]
            self.keys = list(self.keys)
            if self.categories is not None:
                self.categories = list(self.categories)
            if self.dts is not None:
                self.dts = list(self.dts)
            self._key_pos = {k: i for i, k in enumerate(self.keys)}
        rep_rows, rep_src, app_src = [], [], []
        for j, k in enumerate(keys):
            pos = self._key_pos.get(k)
            if pos is None:
                app_src.append(j)
            else:
                rep_rows.append(pos)
                rep_src.append(j)

        # host mirror first (the device cache is derived from it)
        if rep_rows:
            self._emb[np.asarray(rep_rows)] = emb[np.asarray(rep_src)]
            for meta, new in ((self.categories, categories),
                              (self.dts, dts)):
                if new is not None:
                    for pos, j in zip(rep_rows, rep_src):
                        meta[pos] = new[j]
        if app_src:
            new = emb[np.asarray(app_src)]
            need = self.n + len(new)
            if need > len(self._buf):   # amortized doubling
                cap = max(2 * len(self._buf), need)
                buf = np.empty((cap, emb.shape[1]), np.float32)
                buf[:self.n] = self._emb
                self._buf = buf
            self._buf[self.n:need] = new
            self._emb = self._buf[:need]
            for j in app_src:
                self._key_pos[keys[j]] = len(self.keys)
                self.keys.append(keys[j])
                if categories is not None:
                    self.categories.append(categories[j])
                if dts is not None:
                    self.dts.append(dts[j])
            self.n = need

        self._patch_corpus_dev(rep_rows,
                               emb[np.asarray(rep_src)] if rep_src else None,
                               emb[np.asarray(app_src)] if app_src else None)
        return len(rep_rows), len(app_src)

    def _patch_corpus_dev(self, rep_rows, rep_emb, app_emb):
        """Apply an upsert delta to the cached device corpus, in place (a
        sharded corpus is cut again from the host mirror at the next
        search)."""
        if self.sharded:
            self._corpus_dev = None
        if self._corpus_dev is None:
            return
        corpus_dev, true_n, block = self._corpus_dev
        if app_emb is not None:
            new_n = true_n + len(app_emb)
            if new_n > corpus_dev.shape[0]:
                want = new_n + (-new_n % block)   # next block multiple
                fill = torch.zeros((want - corpus_dev.shape[0],
                                    corpus_dev.shape[1]),
                                   dtype=corpus_dev.dtype, device=self.device)
                if self.metric == "l2":    # pad rows must never win
                    fill += 1e18
                corpus_dev = torch.cat([corpus_dev, fill], dim=0)
            corpus_dev[true_n:new_n] = torch.from_numpy(app_emb).to(
                self.device)
            true_n = new_n
        if rep_rows:
            corpus_dev[torch.as_tensor(rep_rows, device=self.device)] = (
                torch.from_numpy(rep_emb).to(self.device))
        self._corpus_dev = (corpus_dev, true_n, block)

    # -- device search ----------------------------------------------------

    def _ensure_corpus_dev(self):
        """(corpus_dev, true_n, block): the corpus uploaded once per engine,
        pre-padded on the host to a block multiple; sharded, this rank's
        block of the corpus padded to a multiple of the data axis and at
        least ``next_pow2(n, lo=512)`` rows (the JAX engine's bucket)."""
        if self._corpus_dev is None and self.sharded:
            from multimodalsimilar_tpu_torch.parallel.mesh import MeshRules
            corpus, true_n = pad_corpus(self._emb, self.mesh.data,
                                        self.metric,
                                        target_rows=next_pow2(self.n, 512))
            shard = corpus[MeshRules(self.mesh).corpus_sharded(len(corpus))]
            self._corpus_dev = (torch.from_numpy(np.ascontiguousarray(
                shard)).to(self.device), true_n, None)
        if self._corpus_dev is None:
            block = corpus_block_rows(self.n)
            corpus, true_n = pad_corpus(self._emb, block, self.metric)
            self._corpus_dev = (torch.from_numpy(
                np.ascontiguousarray(corpus)).to(self.device), true_n, block)
        return self._corpus_dev

    def _chunk_rows(self, k_eff: int) -> int:
        rows = plan_query_chunk(self.n, self._emb.shape[1], k_eff,
                                self.device, cap=self.QUERY_CHUNK)
        if self.sharded:    # every rank must make the same calls
            t = torch.tensor([rows], dtype=torch.int64, device=self.device)
            rows = int(self.mesh.all_reduce(t, op="min")[0])
        return rows

    def _dispatch_chunk(self, chunk: torch.Tensor, k: int):
        """Search ONE query chunk on the cached device corpus; returns
        device tensors (no readback)."""
        corpus_dev, true_n, _ = self._corpus_dev
        if self.sharded:
            return sharded_knn_search(self.mesh, corpus_dev, chunk, k,
                                      self.metric, true_n=true_n)
        return knn_search(corpus_dev, chunk, k, self.metric, true_n=true_n)

    def search(self, k: int, queries=None):
        """(scores, indices) as numpy for queries (default: self-search over
        the corpus, the reference's pattern). FAISS conventions preserved;
        external queries get the same normalization as the corpus."""
        if queries is None:
            q = self._emb
        elif isinstance(queries, torch.Tensor):
            q = queries.to(self.device, torch.float32)
            if self._normalized:
                q = _normalize_rows(q)
        else:
            q = np.asarray(queries, np.float32)
            if self._normalized:
                q = _normalize_rows(q)
        k_eff = min(k, self.n)
        if len(q) == 0 or self.n == 0:
            return (np.zeros((len(q), k_eff), np.float32),
                    np.zeros((len(q), k_eff), np.int32))
        self._ensure_corpus_dev()
        chunk_rows = self._chunk_rows(k_eff)
        out_v = np.empty((len(q), k_eff), np.float32)
        out_i = np.empty((len(q), k_eff), np.int32)
        for s in range(0, len(q), chunk_rows):
            chunk = q[s: s + chunk_rows]
            if not isinstance(chunk, torch.Tensor):
                chunk = torch.from_numpy(np.ascontiguousarray(chunk))
            v, i = self._dispatch_chunk(
                chunk.to(self.device).contiguous(), k)
            out_v[s: s + len(v)] = v.cpu().numpy()
            out_i[s: s + len(i)] = i.cpu().numpy()
        return out_v, out_i

    def fused_search_fn(self, tower_fn, k: int):
        """The serving hot path as one stream-ordered chain: ``tower_fn``
        -> ``.float()`` -> normalize (when the engine normalizes) -> exact
        top-k over the cached device corpus. Returns
        ``fused(*tower_args) -> (scores, indices)``, device tensors with
        no host sync and no read-back, or None for an empty or sharded
        corpus.

        The JAX package compiles one program for a corpus shape and k, and
        its fused function returns None once an /update outgrows them, so
        that the service rebuilds it. Nothing here is compiled per shape:
        every call reads the current device corpus and ``min(k, n)``, so
        an /update never makes the function stale. The single-chunk bound
        is planned once, here, so a request makes no
        ``torch.cuda.mem_get_info`` call to size it.

        None for a sharded corpus, as in the JAX package: its search is a
        collective that every rank replays, so the service takes the
        two-step ``embed_device`` -> ``search_device`` chain instead.

        The corpus is fetched outside inference mode (``update`` patches
        it in place); the chain runs inside it."""
        if self.n == 0 or self.sharded:
            return None
        self._ensure_corpus_dev()
        limit = self._chunk_rows(min(k, self.n))
        metric, normalized = self.metric, self._normalized

        def fused(*tower_args):
            corpus_dev, true_n, _ = self._ensure_corpus_dev()
            with torch.inference_mode():
                q = tower_fn(*tower_args).float()
                if q.shape[0] > limit:
                    raise ValueError(f"fused search is single-chunk: "
                                     f"{q.shape[0]} queries > {limit}")
                if normalized:
                    q = _normalize_rows(q)
                return knn_search(corpus_dev, q.contiguous(),
                                  min(k, self.n), metric, true_n=true_n)

        return fused

    def search_device(self, k: int, queries):
        """Single-chunk search returning DEVICE (scores, indices) — no
        readback, for the serving path that chains the tower's output
        straight in. ``queries`` may be a tensor or host numpy."""
        if isinstance(queries, torch.Tensor):
            q = queries.to(self.device, torch.float32)
        else:
            q = torch.from_numpy(np.asarray(queries, np.float32)).to(
                self.device)
        if self._normalized:
            q = _normalize_rows(q)
        k_eff = min(k, self.n)
        if q.shape[0] == 0 or self.n == 0:
            return (torch.zeros((q.shape[0], k_eff), dtype=torch.float32,
                                device=self.device),
                    torch.zeros((q.shape[0], k_eff), dtype=torch.int32,
                                device=self.device))
        self._ensure_corpus_dev()
        chunk_rows = self._chunk_rows(k_eff)
        if q.shape[0] > chunk_rows:
            raise ValueError(f"search_device is single-chunk: "
                             f"{q.shape[0]} queries > chunk {chunk_rows} "
                             "— use search()")
        return self._dispatch_chunk(q.contiguous(), k)

    # -- full jobs ---------------------------------------------------------

    def similar_map(self, k: int, rules: FilterRules
                    ) -> Dict[object, List[object]]:
        if (rules.same_category and self.categories is not None
                and self.n > 0 and k >= self.n and not self.sharded):
            return self._grouped_self_similar_map(rules)
        with span("similar.search"):
            scores, idx = self.search(k)
        with span("similar.filter"):
            return filter_neighbors(scores, idx, self.keys, self.categories,
                                    rules, dts=self.dts)

    def _grouped_self_similar_map(self, rules: FilterRules
                                  ) -> Dict[object, List[object]]:
        """FULL-ranking self-search (k >= n) under a same-category rule,
        evaluated per category GROUP — the daodian text arm's operating
        point (k = len(area), daodian_infer.py:230-246).

        Every rule is within-row and the category rule keeps only the
        query's own group, so the global ranking restricted to a group IS
        the group's own ranking (ties break by index, and group-relative
        index order is monotone in global order): the result equals the
        full [n, n] search + filter, row by row, while the search drops
        from n x n to the sum of n_c x n_c. Rows with a missing category
        (``_factorize`` code -1) match nothing. Duplicate-key queries keep
        last-global-row-wins via the positional stitch."""
        codes, _ = _factorize(list(self.categories))
        dts = (np.asarray(self.dts, dtype=object)
               if self.dts is not None else None)
        sub_rules = dataclasses.replace(rules, same_category=False)
        per_row: List[List[object]] = [[] for _ in range(self.n)]
        keys_arr = np.asarray(self.keys, dtype=object)
        for code in np.unique(codes):
            if code < 0:
                continue    # missing categories never match anything
            rows = np.nonzero(codes == code)[0]
            n_c = len(rows)
            sub_dev = torch.from_numpy(np.ascontiguousarray(
                self._emb[rows])).to(self.device)
            chunk = plan_query_chunk(n_c, self.dim, n_c, self.device,
                                     cap=self.QUERY_CHUNK)
            lists: List[List[object]] = []
            for s in range(0, n_c, chunk):
                v, i = knn_search(sub_dev, sub_dev[s: s + chunk], n_c,
                                  self.metric)
                lists.extend(filter_neighbors(
                    v.cpu().numpy(), i.cpu().numpy(), keys_arr[rows],
                    categories=None, rules=sub_rules,
                    query_rows=np.arange(s, s + len(v)),
                    dts=dts[rows] if dts is not None else None,
                    return_lists=True))
            for r, lst in zip(rows, lists):
                per_row[r] = lst
        # dict assembly in global row order: duplicate query keys keep
        # the full path's last-row-wins
        return {keys_arr[r]: per_row[r] for r in range(self.n)}

    @staticmethod
    def merge(primary: Dict, secondary: Dict, cap: Optional[int] = None):
        return merge_neighbor_maps(primary, secondary, cap)
