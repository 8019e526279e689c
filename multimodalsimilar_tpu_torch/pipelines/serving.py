"""Online similarity serving daemon (``serve``).

Counterpart of ``multimodalsimilar_tpu/pipelines/serving.py`` (which
imports no JAX): ``SimilarityService``, ``_Handler``, ``_Server`` and
``make_server``, with the same behaviour. The reference has no online
query path: retrieval is precomputed by daily batch jobs and served as
static Redis KV (nlp_infer.py:154-172). This daemon keeps a tower (text,
image or fused) and the corpus hot on the card and answers embed / similar queries over
HTTP, for queries that were not in last night's batch.

Design:

* **Micro-batching.** HTTP handler threads never touch the device: they
  enqueue the request and block on a future; ONE worker drains the queue,
  coalesces up to ``max_batch`` requests that arrived within
  ``max_wait_ms`` of the first, and runs one padded device call (tower ->
  normalize -> exact top-k) for the whole group. Under load, concurrency
  becomes batch size.
* **Pow2 buckets.** Micro-batches pad to 1, 2, 4, ... ``max_batch``
  queries, so the tower and the search see few shapes, each warmed before
  the server binds.
* **One device owner.** All launches happen on the worker thread, on its
  current stream; a similar-only batch's results are copied to pinned host
  memory behind the search and read back while the next batch runs.

Besides /embed and /similar, the daemon accepts **online corpus upserts**
(``POST /update {"items": [{"key": ..., "text": ..., "category"?:
...}]}``) — the online analogue of the nightly incremental ``_di`` jobs:
new keys append, known keys re-embed, and the engine's cached device corpus
is patched in place. Deltas are in-memory by design: the nightly batch
layout stays the authority on restart.

Filtering reproduces the reference's per-job rules for EXTERNAL queries:
strict ``score > th`` (nlp_infer.py:163), optional same-category
constraint against a request-supplied category (daodian_infer.py:237-245
keeps same-lv1 neighbors), key dedup preserving rank, optional self-key
exclusion, cap at k.
"""

from __future__ import annotations

import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from multimodalsimilar_tpu_torch.pipelines.microbatch import (  # noqa: F401
    _CLOSE, DeferredBatch, ImageQueryParser, MicroBatcher,
    MultimodalQueryParser, TextQueryParser)

_UNSET = object()


def _read_back_later(dv: torch.Tensor, di: torch.Tensor, n: int
                     ) -> DeferredBatch:
    """A DeferredBatch over a launched search's device results (first
    ``n`` rows kept). On a card the copies into pinned host buffers are
    queued behind the search on the same stream and an event marks their
    end, so ``finish`` waits for this batch alone: a ``.cpu()`` there
    would also wait for the next batch, launched in the meantime."""
    if dv.device.type == "cuda":
        hv = torch.empty(dv.shape, dtype=dv.dtype, pin_memory=True)
        hi = torch.empty(di.shape, dtype=di.dtype, pin_memory=True)
        hv.copy_(dv, non_blocking=True)
        hi.copy_(di, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dv.device))
    else:
        hv, hi, done = dv, di, None

    def finish():
        if done is not None:
            done.synchronize()
        scores, idx = hv.numpy(), hi.numpy()
        return [(scores[r], idx[r]) for r in range(n)]

    return DeferredBatch(finish)


class SimilarityService:
    """Hot tower + corpus; answers embed / similar queries.

    ``embed_queries(list[payload]) -> [N, D] np.ndarray`` is the batched
    tower call (a TextEmbedder closure over ``list[str]``). ``engine`` is a
    SimilarityEngine whose corpus rows correspond to ``engine.keys`` /
    ``engine.categories``. ``query_parser`` (default TextQueryParser)
    extracts payloads from HTTP request dicts; the service itself is
    payload-agnostic.
    """

    def __init__(self, embed_queries: Callable[[Sequence], np.ndarray],
                 engine, k: int = 13, score_th: Optional[float] = None,
                 max_batch: int = 64, max_wait_ms: float = 5.0,
                 query_parser=None, embed_queries_device=None,
                 fused_similar=None, fused_factory=None,
                 warm_payload="warmup"):
        self.engine = engine
        self._k_req = k
        self.score_th = score_th
        self.parser = query_parser or TextQueryParser()
        self._embed_queries = embed_queries
        # the best path: fused_similar(payloads, pad_to) -> (scores, idx)
        # device tensors, the whole request (tower -> normalize -> top-k)
        # chained on one stream with a single read-back. The JAX package's
        # fused program can go stale when an /update outgrows its compiled
        # corpus shape and returns None then; fused_factory() rebuilds it
        # off-thread. The port's fused function reads the current corpus
        # on every call and never returns None, so that rebuild never
        # fires here; the machinery stays for parity.
        self._fused_similar = fused_similar
        self._fused_factory = fused_factory
        self._warm_payload = warm_payload
        self._refuse_lock = threading.Lock()
        self._refusing = False
        # the two-step fallback: embed_queries_device(payloads[, pad_to])
        # -> device embeddings, then engine.search_device
        self._embed_queries_device = embed_queries_device
        self._dev_accepts_pad = False
        if embed_queries_device is not None:
            import inspect
            try:
                self._dev_accepts_pad = "pad_to" in inspect.signature(
                    embed_queries_device).parameters
            except (TypeError, ValueError):
                pass
        self._cats = (np.asarray(engine.categories, dtype=object)
                      if engine.categories is not None else None)
        self._keys = np.asarray(engine.keys, dtype=object)
        # two batchers would split one burst's device work in two; a
        # single one keeps ALL launches on one thread and lets embed and
        # similar requests share a batch's tower call
        self._max_batch = max_batch
        self._batcher = MicroBatcher(self._run_batch_async,
                                     max_batch=max_batch,
                                     max_wait_ms=max_wait_ms)

    @property
    def k(self):
        # clamped per call, not at init: /update can grow the corpus past
        # the configured k
        n = self.engine.n
        return min(self._k_req, n) if n else self._k_req

    # -- device-worker side -------------------------------------------------

    def _run_batch(self, items: List[dict]) -> List[object]:
        """Synchronous batch execution (tests, warm-up, library use):
        launch + read-back in one call."""
        out = self._run_batch_async(items)
        if isinstance(out, DeferredBatch):
            return out.finish()
        return out

    def _run_batch_async(self, items: List[dict]):
        """The MicroBatcher's entry: a similar-only batch on a device path
        returns a DeferredBatch (launched, read-back deferred) so the
        worker can overlap its read-back with the next micro-batch;
        anything else runs synchronously on the host path."""
        queries = [it["query"] for it in items]
        # embed/update items need the vectors on host; a similar-only
        # batch (the hot path) can keep the whole chain on device
        if all(it["op"] == "similar" for it in items):
            d = self._try_device_batch(queries, len(items))
            if d is not None:
                return d
        emb = self._embed_queries(queries)
        out: List[object] = [None] * len(items)
        ups = [i for i, it in enumerate(items) if it["op"] == "update"]
        if ups:
            # updates apply BEFORE the batch's searches (a similar request
            # coalesced with an update sees the freshest corpus). Within
            # one batch the last update per key wins — earlier duplicates
            # report success exactly as if the two had arrived in order.
            last = {items[i]["key"]: i for i in ups}
            apply = [i for i in ups if last[items[i]["key"]] == i]
            cats = ([items[i]["category"] for i in apply]
                    if self.engine.categories is not None else None)
            self.engine.update(emb[apply],
                               [items[i]["key"] for i in apply],
                               categories=cats)
            self._keys = np.asarray(self.engine.keys, dtype=object)
            if self._cats is not None:
                self._cats = np.asarray(self.engine.categories,
                                        dtype=object)
            for i in ups:
                out[i] = {"key": items[i]["key"]}
        need_knn = [i for i, it in enumerate(items) if it["op"] == "similar"]
        if need_knn:
            scores, idx = self._search_bucketed(emb[need_knn],
                                                len(need_knn))
            for row, i in enumerate(need_knn):
                out[i] = (scores[row], idx[row])
        for i, it in enumerate(items):
            if it["op"] == "embed":
                out[i] = emb[i]
        return out

    def _try_device_batch(self, queries, n: int):
        """DeferredBatch for a similar-only micro-batch on the best
        available device path, or None (caller runs the host path).
        Preference order: the fused chain, then the two-step
        embed_device -> search_device chain."""
        bucket = self._bucket_size(n)
        if bucket > self._max_batch:
            # _bucket_size's oversized-direct-call escape (a library/test
            # call bigger than max_batch, bypassing the batcher): the
            # device paths take at most batch_size rows (wiring guard:
            # max_batch <= batch_size), so serve it on the host path
            # instead of erroring out of the embedder
            return None
        if self._fused_similar is not None:
            out = self._fused_similar(queries, bucket)
            if out is not None:
                return _read_back_later(*out, n)
            # a stale fused function: keep it in place as a probe and
            # (re)schedule the off-thread rebuild
            self._schedule_refuse()
        if self._embed_queries_device is None:
            return None
        if self._dev_accepts_pad:
            # the tower runs AT the bucket: device cost scales with the
            # micro-batch
            emb = self._embed_queries_device(queries, pad_to=bucket)
        else:
            emb = self._embed_queries_device(queries)
        # slice any extra tower padding to the bucket
        q = emb[:bucket] if bucket < emb.shape[0] else emb
        return _read_back_later(*self.engine.search_device(self.k, q), n)

    def _bucket_size(self, n: int) -> int:
        """Query counts quantize to a pow2 ladder capped at max_batch, so
        the device paths see few shapes; ``_warm_serve_service`` warms
        exactly this ladder through the real paths before traffic."""
        bucket = 1 << max(n - 1, 0).bit_length()
        bucket = min(bucket, self._max_batch)
        if bucket < n:
            bucket = n   # direct call larger than max_batch (tests /
            # library use bypassing the batcher): never drop real queries
        return bucket

    def _bucket_ladder(self) -> List[int]:
        """Every bucket _bucket_size can produce for batcher-sized input
        (1, 2, 4, ... capped at max_batch, plus the cap itself)."""
        ladder, m = [], 1
        while m < self._max_batch:
            ladder.append(m)
            m *= 2
        ladder.append(self._max_batch)
        return ladder

    def _schedule_refuse(self) -> None:
        """Rebuild the fused path at the corpus's new shape, off-thread.
        At most one rebuild runs at a time; live traffic keeps flowing
        through the (correct, slower) two-step chain until the fresh fused
        function is built AND warmed per bucket."""
        if self._fused_factory is None:
            return
        with self._refuse_lock:
            if self._refusing:
                return
            self._refusing = True
        threading.Thread(target=self._refuse_worker, daemon=True,
                         name="serve-refuse").start()

    def _refuse_worker(self) -> None:
        """One rebuild attempt. Every failure mode self-corrects because
        the live path keeps PROBING the stale fused function and
        rescheduling."""
        try:
            fused = self._fused_factory()
            if fused is None:      # engine can't fuse anymore
                return
            for b in self._bucket_ladder():
                if fused([self._warm_payload], b) is None:
                    return         # corpus moved again; next probe retries
            self._fused_similar = fused
            print("serve: fused path rebuilt at the grown corpus "
                  f"shape (n={self.engine.n})", file=sys.stderr,
                  flush=True)
        except Exception as e:     # fallback chain keeps serving
            print(f"serve: fused-path rebuild failed ({e!r}); will retry "
                  "on the next request", file=sys.stderr, flush=True)
        finally:
            with self._refuse_lock:
                self._refusing = False

    def _search_bucketed(self, q, n: int):
        """Host-path engine search at the bucketed query count: ``q`` has
        exactly n rows — zero-pad up (inert under ip and l2), slice the
        pad rows' results off."""
        bucket = self._bucket_size(n)
        if bucket > q.shape[0]:
            q = np.pad(q, ((0, bucket - q.shape[0]), (0, 0)))
        scores, idx = self.engine.search(self.k, queries=q)
        return scores[:n], idx[:n]

    # -- request side (any thread) -------------------------------------------

    def embed(self, queries: Sequence) -> np.ndarray:
        # each query is its own queue item so concurrent callers coalesce
        # fairly; ALL futures are enqueued before the first blocking wait,
        # so one caller's list still lands in one batch rather than
        # serializing one-item batches
        if not len(queries):
            return np.zeros((0, 0), np.float32)
        futs = [self._batcher.submit_nowait({"op": "embed", "query": q})
                for q in queries]
        return np.stack([f.result() for f in futs])

    def update(self, payloads: Sequence, keys: Sequence,
               categories: Optional[Sequence] = None) -> int:
        """Upsert corpus rows online: embed ``payloads`` through the same
        micro-batched tower call and engine-upsert them under ``keys`` —
        the online analogue of the nightly incremental ``_di`` jobs
        (goodssku_emb_bert_di.py:126-129 skip-existing appends; a known
        key here means a re-embed instead). Returns the new corpus size.

        In-memory only, by design: the nightly batch layout stays the
        authority — a restart rebuilds the corpus from it.

        Category discipline mirrors ``similar``: servers started with
        --category_col REQUIRE a category per item (a silently missing
        one would exempt the row from the same-category rule), servers
        without reject them.
        """
        payloads = list(payloads)
        keys = [str(k) for k in keys]
        if len(keys) != len(payloads):
            raise ValueError(f"{len(payloads)} payloads vs "
                             f"{len(keys)} keys")
        if self._cats is not None:
            if categories is None or len(categories) != len(keys) \
                    or any(c is None for c in categories):
                raise ValueError(
                    "server has --category_col: every update item needs "
                    "'category' (the same-category rule would silently "
                    "skip rows without one)")
            categories = [str(c) for c in categories]
        elif categories is not None:
            raise ValueError(
                "server started without --category_col — no category "
                "column to store 'category' values in")
        items = [{"op": "update", "query": p, "key": k,
                  "category": categories[i] if categories else None}
                 for i, (p, k) in enumerate(zip(payloads, keys))]
        futs = [self._batcher.submit_nowait(it) for it in items]
        for f in futs:
            f.result()
        return self.engine.n

    def similar(self, query, k: Optional[int] = None,
                score_th=_UNSET,
                category: Optional[str] = None,
                exclude_key: Optional[str] = None) -> List[dict]:
        """Ranked ``[{key, score}, ...]`` under the request's rules.

        ``query`` is whatever ``embed_queries`` accepts one of (a str for
        the text tower). ``k`` caps the answer (never exceeds the service
        k the search ran with); ``score_th`` overrides the service default
        (None disables); ``category`` keeps only same-category corpus
        neighbors; ``exclude_key`` drops that key (the query item itself,
        when it is already in the corpus — the online analogue of the
        batch jobs' self-drop).

        Raises ValueError if ``category`` is supplied but the server holds
        no category column — silently skipping the filter would return
        cross-category neighbors indistinguishable from a correctly
        filtered answer (the exact failure the batch jobs' same-lv1 rule
        exists to prevent, daodian_infer.py:237-245).
        """
        if category is not None and self._cats is None:
            raise ValueError(
                "request passed 'category' but the server was started "
                "without --category_col — no category data to filter on")
        scores, idx = self._batcher.submit({"op": "similar", "query": query})
        # snapshot: a concurrent /update re-assigns these (rows only ever
        # grow, but one consistent view per response is cleaner)
        keys_arr, cats_arr = self._keys, self._cats
        th = self.score_th if score_th is _UNSET else score_th
        k_out = self.k if k is None else max(0, min(k, self.k))
        out: List[dict] = []
        seen = set()
        for s, i in zip(scores.tolist(), idx.tolist()):
            if len(out) >= k_out:
                break
            if i < 0 or i >= len(keys_arr):
                continue
            if th is not None:
                # strict >, like the reference (nlp_infer.py:163); IP
                # metric only — the fused job's L2 path has no threshold
                # (multimodal_infer.py:147-159)
                if self.engine.metric == "ip" and not (s > th):
                    continue
                if self.engine.metric == "l2" and not (s < th):
                    continue
            key = keys_arr[i]
            if key in seen:
                continue
            if exclude_key is not None and str(key) == str(exclude_key):
                continue
            if category is not None and cats_arr is not None \
                    and str(cats_arr[i]) != str(category):
                continue
            seen.add(key)
            out.append({"key": str(key), "score": float(s)})
        return out

    @property
    def stats(self):
        return dict(self._batcher.stats)

    def close(self):
        """Stop the batcher; a sharded engine (``pipelines/
        sharded_serving.py:LockstepEngine``) then stops its followers."""
        self._batcher.close()
        stop = getattr(self.engine, "stop", None)
        if stop is not None:
            stop()


class _Handler(BaseHTTPRequestHandler):
    # the owning server carries the service (set by make_server)

    # keep-alive: HTTP/1.0's connection-per-request costs a TCP setup AND
    # a server thread spawn each (ThreadingHTTPServer is thread-per-
    # connection). _reply always sends Content-Length, which HTTP/1.1
    # requires.
    protocol_version = "HTTP/1.1"
    # TCP_NODELAY: without it, small keep-alive responses sit in Nagle /
    # delayed-ACK interplay (a flat ~40 ms per request)
    disable_nagle_algorithm = True
    # idle keep-alive connections must not pin their server thread
    # forever (a silent or half-open client would leak one thread each);
    # on timeout the stdlib handler closes the connection.
    timeout = 120

    def log_message(self, fmt, *args):  # stderr chatter off the hot path
        pass

    def _reply(self, code: int, payload: dict):
        body = json.dumps(payload).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if self.close_connection:
            # advertise the close (set before _reply on desynced
            # connections) — a keep-alive client would otherwise try to
            # reuse the socket and hit EOF
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            svc = self.server.service
            self._reply(200, {"ok": True, "corpus": svc.engine.n,
                              "k": svc.k, "stats": svc.stats})
        else:
            self._reply(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):
        if self.headers.get("Transfer-Encoding"):
            # a chunked body would stay unread on the kept-alive socket
            # and desync every later request on the connection
            self.close_connection = True
            return self._reply(411, {"error": "Content-Length required "
                                              "(chunked bodies not "
                                              "supported)"})
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length) or b"{}")
        except Exception as e:
            # the request body may be partly unread — a kept-alive socket
            # would misparse the leftover bytes as the next request's
            # start line
            self.close_connection = True
            return self._reply(400, {"error": f"bad json: {e}"})
        svc = self.server.service
        try:
            if self.path == "/embed":
                try:
                    queries = svc.parser.many(req)
                except ValueError as e:
                    return self._reply(400, {"error": str(e)})
                emb = svc.embed(queries)
                return self._reply(200, {"embeddings": emb.tolist()})
            if self.path == "/similar":
                try:
                    query = svc.parser.one(req)
                except ValueError as e:
                    return self._reply(400, {"error": str(e)})
                kwargs = {}
                try:  # malformed client fields are 400s, not 500s
                    if "k" in req:
                        kwargs["k"] = int(req["k"])
                    if "score_th" in req:   # explicit null disables default
                        kwargs["score_th"] = (None if req["score_th"] is None
                                              else float(req["score_th"]))
                except (TypeError, ValueError) as e:
                    return self._reply(400, {"error": f"bad field: {e}"})
                if req.get("category") is not None:
                    kwargs["category"] = str(req["category"])
                if req.get("exclude_key") is not None:
                    kwargs["exclude_key"] = str(req["exclude_key"])
                try:
                    neighbors = svc.similar(query, **kwargs)
                except ValueError as e:  # e.g. category w/o --category_col
                    return self._reply(400, {"error": str(e)})
                return self._reply(200, {"neighbors": neighbors})
            if self.path == "/update":
                items = req.get("items")
                if not isinstance(items, list) or not items:
                    return self._reply(400, {
                        "error": "need 'items': [{'key': ..., <query "
                                 "fields>, 'category'?: ...}, ...]"})
                try:
                    payloads, keys = [], []
                    for it in items:
                        if not isinstance(it, dict) or "key" not in it:
                            raise ValueError(
                                "each item must be an object with 'key' "
                                "plus the tower's query fields")
                        payloads.append(svc.parser.one(it))
                        keys.append(str(it["key"]))
                    cats = None
                    if any(isinstance(it, dict)
                           and it.get("category") is not None
                           for it in items):
                        cats = [it.get("category") for it in items]
                    n = svc.update(payloads, keys, categories=cats)
                except ValueError as e:
                    return self._reply(400, {"error": str(e)})
                return self._reply(200, {"updated": len(items),
                                         "corpus": n, "k": svc.k})
            return self._reply(404, {"error": f"unknown path {self.path}"})
        except Exception as e:  # a failed request must not kill the server
            return self._reply(500, {"error": f"{type(e).__name__}: {e}"})


class _Server(ThreadingHTTPServer):
    # stdlib default request_queue_size=5: at 16 concurrent loopback
    # clients the listen backlog overflows and the kernel resets fresh
    # connections
    request_queue_size = 128


def make_server(service: SimilarityService, host: str = "127.0.0.1",
                port: int = 0) -> ThreadingHTTPServer:
    """Bound, ready-to-serve HTTP server (``port=0`` picks a free port —
    the bound one is at ``server.server_address[1]``). Caller runs
    ``serve_forever()`` (blocking) and ``shutdown()`` + ``service.close()``
    to stop."""
    httpd = _Server((host, port), _Handler)
    httpd.service = service
    return httpd
