"""Online merged daodian serving — both retrieval arms hot in one daemon.

Counterpart of ``multimodalsimilar_tpu/pipelines/daodian_serving.py``. The
nightly job publishes, per area, the cv-first-then-fastText merged
neighbor list per spu_sn (daodian_infer.py:361-392). This service holds
BOTH arms hot — the fastText sentence vectors and the CV tower's cached
embeddings — and answers one request with that production-shaped list:

* ``{"key": spu_sn}`` -> exactly what the nightly job would have published
  for that key (same engines, depths, thresholds, category rules and merge,
  via the same code: pipelines/similar.py's ``build_area_index`` /
  ``area_merged_map``).
* ``{"title", "lv1", "lv2", "area_id"[, "image_b64"]}`` -> the merged
  answer for an UNSEEN query under the same rules: the text arm searches
  the whole area (k = len(area), through ``csrc/topk_select.cu`` on a card
  above 128 rows), the CV arm its 26.
* ``POST /update`` upserts corpus rows online; affected areas rebuild.

v1 semantics only: the v2 date-window variants key their OUTPUT by date
for the nightly cron chain, an online daemon answers for the live corpus.

Areas are ``{column: list}`` tables (no pandas on the card). One change
from the JAX package: ``_canon_cat`` tries ``int(v)`` before ``float(v)``,
so integer category ids above 2^53 stay distinct, and missing values
(None, NaN, ``pd.NA``, ``pd.NaT``) never match, as in the batch filters.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from multimodalsimilar_tpu_torch.pipelines.microbatch import MicroBatcher
from multimodalsimilar_tpu_torch.pipelines.similar import (
    DaodianAreaIndex, area_merged_map, build_area_index, n_rows,
    split_areas, table_columns)
from multimodalsimilar_tpu_torch.retrieval.filters import _missing
from multimodalsimilar_tpu_torch.utils.devices import resolve_device


def _canon_cat(v):
    """Canonical comparison form for a category value in the ad-hoc path.

    The batch path (filters.py) factorizes the CORPUS column and compares
    the query row's own code; an ad-hoc request's category arrives from
    JSON and must be canonicalized against the corpus value. Numbers and
    numeric strings compare BY VALUE (a float64 corpus column holding 7.0
    matches a request sending 7 or '7'); integers and integer strings go
    through ``int`` first, so ids above 2^53 keep every digit; missing
    values never match anything."""
    if _missing(v):
        return None
    if not isinstance(v, (float, np.floating)):
        try:
            return str(int(v))
        except (TypeError, ValueError, OverflowError):
            pass
    try:
        f = float(v)
    except (TypeError, ValueError):
        return str(v)
    if np.isnan(f):
        return None
    if np.isfinite(f) and f == int(f):
        return str(int(f))
    return repr(f)


class DaodianService:
    """Per-area hot indexes + lazily cached merged maps.

    ``embed_titles(list[str]) -> [N, 100]`` is the fastText arm;
    ``embed_skus(area) -> {key: vec}`` the CV arm's corpus embedder
    (``area`` a ``{column: list}`` table; may miss keys without images) —
    the contracts daodian_similar_job takes. ``embed_query_images``
    (optional) embeds a list of decoded uint8 images for ad-hoc image
    queries. Engines live on ``device``.

    Thread safety: the embed callables MAY be invoked concurrently — an
    ad-hoc query's embed can overlap another area's rebuild embed, which
    runs outside the state lock by design.
    """

    def __init__(self, table,
                 embed_titles: Callable[[Sequence[str]], np.ndarray],
                 embed_skus: Callable[[Dict[str, list]],
                                      Dict[str, np.ndarray]],
                 embed_query_images: Optional[Callable] = None,
                 area_col: str = "area_id", key_col: str = "spu_sn",
                 title_col: str = "title",
                 lv1_col: str = "first_level_category_id",
                 lv2_col: str = "second_level_category_id",
                 nlp_score_th: float = -0.6, cv_score_th: float = 0.15,
                 ann_cnt_nlp: int = 100, ann_cnt_cv: int = 26,
                 max_batch: int = 16, max_wait_ms: float = 3.0,
                 device="cuda"):
        cols = table_columns(table)
        for col in (area_col, key_col, title_col, lv1_col, lv2_col):
            if col not in cols:
                raise ValueError(f"column {col!r} not in the corpus table "
                                 f"(has: {list(cols)})")
        self._cols = dict(key_col=key_col, title_col=title_col,
                          lv1_col=lv1_col, lv2_col=lv2_col)
        self._area_col = area_col
        self._params = dict(nlp_score_th=nlp_score_th,
                            cv_score_th=cv_score_th,
                            ann_cnt_nlp=ann_cnt_nlp, ann_cnt_cv=ann_cnt_cv)
        self._device = resolve_device(device)
        self._embed_titles = embed_titles
        self._embed_skus = embed_skus
        self._embed_query_images = embed_query_images
        # ad-hoc embeds are micro-batched; the batchers start on the first
        # ad-hoc query (key lookups never start their threads)
        self._max_batch = max_batch
        self._max_wait_ms = max_wait_ms
        self._mbs: Dict[str, MicroBatcher] = {}
        # keys and area ids serve as STRINGS end to end (the KV layer strs
        # them too): two raw values that stringify alike land in one group
        cols[key_col] = [str(k) for k in cols[key_col]]
        cols[area_col] = [str(a) for a in cols[area_col]]
        self._areas: Dict[str, Dict[str, list]] = split_areas(cols, area_col)
        self._index: Dict[str, DaodianAreaIndex] = {}
        self._merged: Dict[str, Dict[str, List[str]]] = {}
        # a key may list in SEVERAL areas: the map holds the set
        self._key_areas: Dict[str, set] = {}
        for a, area in self._areas.items():
            for k in area[key_col]:
                self._key_areas.setdefault(k, set()).add(a)
        self._n = sum(n_rows(a) for a in self._areas.values())
        self._version: Dict[str, int] = {}
        # _lock guards corpus STATE and is never held across an embed or a
        # search: area builds run outside it on a snapshot and re-validate
        # the area's version before caching. _build_locks serialize builds
        # PER AREA, so one slow rebuild never stalls another area's first
        # hit.
        self._lock = threading.RLock()
        self._build_locks: Dict[str, threading.Lock] = {}

    # -- corpus state -------------------------------------------------------

    @property
    def n(self) -> int:
        # lock-free: /healthz must answer while an area rebuilds
        return self._n

    @property
    def areas(self) -> List[str]:
        return sorted(list(self._areas))

    def _get_or_build(self, area_id: str, need_merged: bool = True
                      ) -> tuple:
        """(index, merged map) for the area — cached, or built OUTSIDE
        the state lock from a snapshot, and cached only if the area has
        not changed meanwhile (version check). ``need_merged=False``
        (ad-hoc queries) builds only the engines."""
        def _cached():
            idx = self._index.get(area_id)
            m = self._merged.get(area_id)
            if idx is not None and (m is not None or not need_merged):
                return idx, m
            return None
        with self._lock:
            hit = _cached()
            if hit is not None:
                return hit
            block = self._build_locks.setdefault(area_id,
                                                 threading.Lock())
        with block:
            with self._lock:
                hit = _cached()
                if hit is not None:
                    return hit      # built while we waited
                idx = self._index.get(area_id)   # engines may be hot
                area = self._areas[area_id]
                ver = self._version.get(area_id, 0)
            if idx is None:
                idx = build_area_index(area, self._embed_titles,
                                       self._embed_skus(area),
                                       **self._cols, **self._params,
                                       device=self._device)
            m = area_merged_map(idx) if need_merged else None
            with self._lock:
                if self._version.get(area_id, 0) == ver:
                    self._index[area_id] = idx
                    if m is not None:
                        self._merged[area_id] = m
            return idx, m

    def warm(self) -> None:
        """Build every area's index + merged map before accepting
        traffic."""
        for a in self.areas:
            self._get_or_build(a)

    def warm_query_buckets(self, image_size: Optional[int] = None) -> None:
        """Run the ad-hoc paths before traffic: the text embed at every
        pow2 micro-batch up to max_batch, the CV arm's when
        ``image_size`` is given and loaded, and one batch-1 search per
        cached area engine (the kernels build at their first launch)."""
        sizes, b = [], 1
        while b <= self._max_batch:
            sizes.append(b)
            b *= 2
        for n in sizes:
            self._run_text_batch(["warm"] * n)
        if image_size and self._embed_query_images is not None:
            img = np.zeros((int(image_size), int(image_size), 3), np.uint8)
            for n in sizes:
                self._run_image_batch([img] * n)
        with self._lock:
            indexes = list(self._index.values())
        for idx in indexes:
            for eng, k in ((idx.text_engine, idx.k_text),
                           (idx.cv_engine, idx.k_cv)):
                if eng is not None:
                    eng.search(k, queries=np.zeros((1, eng.dim),
                                                   np.float32))

    # -- ad-hoc embed micro-batching ---------------------------------------

    def _batcher(self, name: str, run_batch) -> MicroBatcher:
        mb = self._mbs.get(name)
        if mb is None:
            with self._lock:
                mb = self._mbs.get(name)
                if mb is None:
                    mb = MicroBatcher(run_batch, self._max_batch,
                                      self._max_wait_ms)
                    self._mbs[name] = mb
        return mb

    def _run_text_batch(self, titles: List[str]) -> List[np.ndarray]:
        return list(np.asarray(self._embed_titles(list(titles)), np.float32))

    def _run_image_batch(self, images: List[np.ndarray]
                         ) -> List[np.ndarray]:
        # batch contract: list of [S, S, 3] uint8 -> [N, D]; group by
        # shape so ragged direct-API callers still batch correctly
        out: List[Optional[np.ndarray]] = [None] * len(images)
        by_shape: Dict[tuple, List[int]] = {}
        for i, im in enumerate(images):
            by_shape.setdefault(np.asarray(im).shape, []).append(i)
        for idxs in by_shape.values():
            vecs = np.asarray(self._embed_query_images(
                [images[i] for i in idxs]), np.float32)
            for j, i in enumerate(idxs):
                out[i] = vecs[j]
        return out                          # type: ignore[return-value]

    def close(self) -> None:
        """Stop the micro-batch worker threads (idempotent)."""
        with self._lock:
            mbs, self._mbs = list(self._mbs.values()), {}
        for mb in mbs:
            mb.close()

    def _area_of_key(self, key: str,
                     area_id: Optional[str]) -> Optional[str]:
        areas = self._key_areas.get(key)
        if not areas:
            return None
        if area_id is not None:
            return str(area_id) if str(area_id) in areas else None
        # no area given and the key lists in several: first sorted area
        return min(areas)

    # -- queries ------------------------------------------------------------

    def similar_key(self, key: str, area_id: Optional[str] = None) -> dict:
        """The production-shaped answer for a corpus key: the merged
        neighbor list the nightly job would publish. Raises KeyError for
        an unknown key."""
        key = str(key)
        with self._lock:
            a = self._area_of_key(key, area_id)
            if a is None:
                raise KeyError(key)
        _, merged = self._get_or_build(a)
        return {"key": key, "area_id": a,
                "neighbors": [str(x) for x in merged.get(key, [])]}

    def _filter_ranked(self, scores, idx, engine, category,
                       score_th, cap) -> List[dict]:
        """The batch filters' semantics for ONE external query: strict
        score > th, same category as the request's value (``_canon_cat``;
        missing on either side never matches), dedup by key, cap."""
        out, seen = [], set()
        keys = engine.keys
        cats = engine.categories
        want = _canon_cat(category)
        for s, i in zip(np.asarray(scores).ravel().tolist(),
                        np.asarray(idx).ravel().tolist()):
            if cap is not None and len(out) >= cap:
                break
            if i < 0 or i >= len(keys):
                continue
            if score_th is not None and not (s > score_th):
                continue
            if cats is not None and (want is None
                                     or _canon_cat(cats[i]) != want):
                continue
            k = str(keys[i])
            if k in seen:
                continue
            seen.add(k)
            out.append({"key": k, "score": float(s)})
        return out

    def similar_query(self, title: str, lv1, lv2, area_id: str,
                      image: Optional[np.ndarray] = None) -> dict:
        """Ad-hoc merged answer for an UNSEEN query under the same rules:
        text arm vs the area's corpus (same-lv1, th, cap), cv arm when an
        image is supplied and the CV arm is hot (same-lv2, th, k=26),
        merged cv-first like the job."""
        area_id = str(area_id)
        with self._lock:
            if area_id not in self._areas:
                raise KeyError(f"unknown area_id {area_id!r} "
                               f"(have: {self.areas})")
        index, _ = self._get_or_build(area_id, need_merged=False)
        p = self._params
        tvec = np.asarray(
            self._batcher("text", self._run_text_batch).submit(str(title)),
            np.float32).reshape(1, -1)
        ts, ti = index.text_engine.search(index.k_text, queries=tvec)
        text_ranked = self._filter_ranked(
            ts, ti, index.text_engine, lv1, p["nlp_score_th"],
            p["ann_cnt_nlp"] + 1)
        cv_ranked: List[dict] = []
        if image is not None:
            if self._embed_query_images is None:
                raise ValueError(
                    "image query but the CV arm is not loaded "
                    "(--text_only or no --cv_checkpoint)")
            if index.cv_engine is not None:
                ivec = np.asarray(
                    self._batcher("image", self._run_image_batch)
                    .submit(image), np.float32).reshape(1, -1)
                cs, ci = index.cv_engine.search(index.k_cv, queries=ivec)
                cv_ranked = self._filter_ranked(
                    cs, ci, index.cv_engine, lv2, p["cv_score_th"], None)
        merged, seen = [], set()
        for item in cv_ranked + text_ranked:    # cv-first merge
            if item["key"] in seen:
                continue
            seen.add(item["key"])
            merged.append(item)
        return {"area_id": area_id, "neighbors": merged,
                "cv_neighbors": len(cv_ranked),
                "text_neighbors": len(text_ranked)}

    # -- updates ------------------------------------------------------------

    def update(self, items: Sequence[dict], rebuild: bool = True) -> dict:
        """Upsert corpus rows: each item carries the corpus columns ({key,
        area_id, title, lv1, lv2}, plus any the table had).

        The upsert unit is the (area, key) ROW: an item replaces the key's
        row in ITS area (moving it to the end) and appends otherwise;
        listings in other areas are untouched. Items apply in order, each
        computed fully before any state is assigned; duplicate (area, key)
        items in one batch: last wins. Columns the area lacks are dropped
        from an item, columns the item lacks are None. Affected areas drop
        their cached index; with ``rebuild`` (the default) this call
        re-indexes them after releasing the state lock, and a failed
        rebuild is reported under ``"rebuild_errors"`` (the upsert is
        already committed; the area rebuilds on its next read)."""
        key_col = self._cols["key_col"]
        need = [key_col, "area_id", self._cols["title_col"],
                self._cols["lv1_col"], self._cols["lv2_col"]]
        parsed = []
        for it in items:
            missing = [c for c in need
                       if c not in it and not (c == "area_id"
                                               and self._area_col in it)]
            if missing:
                raise ValueError(f"update item missing {missing} "
                                 f"(need {need})")
            parsed.append((str(it.get("area_id", it.get(self._area_col))),
                           str(it[key_col]), it))
        with self._lock:
            invalidated = set()
            for a, key, it in parsed:
                row = {(self._area_col if c == "area_id" else c): v
                       for c, v in it.items()}
                row[key_col] = key
                row[self._area_col] = a
                base = self._areas.get(a)
                if base is None:
                    base = {c: [] for c in row}
                keep = [i for i, k in enumerate(base[key_col]) if k != key]
                new = {c: [vals[i] for i in keep] + [row.get(c)]
                       for c, vals in base.items()}
                # all computed — assign
                self._n += len(keep) + 1 - n_rows(base)
                self._areas[a] = new
                self._key_areas.setdefault(key, set()).add(a)
                invalidated.add(a)
            for a in invalidated:
                self._version[a] = self._version.get(a, 0) + 1
                self._index.pop(a, None)
                self._merged.pop(a, None)
            out = {"updated": len(items),
                   "areas_invalidated": sorted(invalidated),
                   "corpus": self.n}
        if rebuild:
            errors = {}
            for a in sorted(invalidated):
                try:
                    self._get_or_build(a)
                except Exception as e:   # noqa: BLE001 — reported, not lost
                    errors[a] = f"{type(e).__name__}: {e}"
            if errors:
                out["rebuild_errors"] = errors
        return out


# -- HTTP ------------------------------------------------------------------


class _DaodianHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # TCP_NODELAY: small keep-alive responses must not wait on Nagle /
    # delayed-ACK interplay
    disable_nagle_algorithm = True
    timeout = 120

    def log_message(self, fmt, *args):
        pass

    def _reply(self, code: int, payload: dict):
        body = json.dumps(payload).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if self.close_connection:
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path != "/healthz":
            return self._reply(404, {"error": f"unknown path {self.path}"})
        svc = self.server.service
        try:   # gather outside _reply: a failed write must not send a
            # second status line on the kept-alive socket
            payload = {"ok": True, "corpus": svc.n, "areas": svc.areas}
        except Exception as e:
            return self._reply(500, {"error": f"{type(e).__name__}: {e}"})
        self._reply(200, payload)

    def _decode_image(self, req):
        if req.get("image_b64") is None and req.get("image_path") is None:
            return None
        from multimodalsimilar_tpu_torch.pipelines.microbatch import (
            ImageQueryParser)
        return ImageQueryParser(self.server.image_size).one(req)

    def do_POST(self):
        if self.headers.get("Transfer-Encoding"):
            self.close_connection = True
            return self._reply(411, {"error": "Content-Length required"})
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
        except Exception as e:
            self.close_connection = True
            return self._reply(400, {"error": f"bad json: {e}"})
        svc = self.server.service
        try:
            if self.path == "/similar":
                if "key" in req:
                    try:
                        return self._reply(200, svc.similar_key(
                            str(req["key"]), req.get("area_id")))
                    except KeyError:
                        return self._reply(404, {
                            "error": f"key {req['key']!r} not in the "
                                     "corpus — ad-hoc queries need "
                                     "title/lv1/lv2/area_id"})
                need = ["title", "lv1", "lv2", "area_id"]
                missing = [c for c in need if req.get(c) is None]
                if missing:
                    return self._reply(400, {
                        "error": f"need 'key' (corpus lookup) or "
                                 f"{need} (ad-hoc query); missing "
                                 f"{missing}"})
                try:
                    img = self._decode_image(req)
                except ValueError as e:
                    return self._reply(400, {"error": str(e)})
                try:
                    return self._reply(200, svc.similar_query(
                        req["title"], req["lv1"], req["lv2"],
                        req["area_id"], image=img))
                except KeyError as e:
                    return self._reply(404, {"error": str(e.args[0])})
                except ValueError as e:
                    return self._reply(400, {"error": str(e)})
            if self.path == "/update":
                items = req.get("items")
                if not isinstance(items, list) or not items:
                    return self._reply(400, {
                        "error": "need 'items': [{key, area_id, title, "
                                 "lv1..., lv2...}, ...]"})
                rb = req.get("rebuild", True)
                if not isinstance(rb, bool):
                    # bool("false") is True: refuse anything but JSON bools
                    return self._reply(400, {
                        "error": "'rebuild' must be JSON true/false, "
                                 f"got {rb!r}"})
                try:
                    return self._reply(200, svc.update(items, rebuild=rb))
                except ValueError as e:
                    return self._reply(400, {"error": str(e)})
            return self._reply(404, {"error": f"unknown path {self.path}"})
        except Exception as e:   # a failed request must not kill the server
            return self._reply(500, {"error": f"{type(e).__name__}: {e}"})


class _DaodianServer(ThreadingHTTPServer):
    request_queue_size = 128


def make_daodian_server(service: DaodianService, host: str = "127.0.0.1",
                        port: int = 0,
                        image_size: int = 512) -> ThreadingHTTPServer:
    httpd = _DaodianServer((host, port), _DaodianHandler)
    httpd.service = service
    httpd.image_size = image_size
    return httpd
