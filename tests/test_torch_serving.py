"""The serving daemon in the port: MicroBatcher, SimilarityService, HTTP,
``serve --tower bert`` and its ``--emb_table`` warm start, on the CPU.

The text cases of the JAX package's ``tests/test_serving.py`` run against
the port's modules, and the port's service is held against the JAX
service: the same JAX-initialized tiny tower (weights carried over with
``text_classifier_from_jax``), the same corpus and queries, through the
fused path, the two-step device chain and the host path, and after an
/update. Scores agree within 1e-5 under ``DTypePolicy.full_precision()``
and 2e-2 under ``.inference()`` (bf16), as in ``tests/test_torch_bert.py``;
keys agree wherever the JAX scores around them are further apart than
that. Every batcher, service and server is closed by its test or fixture.
"""

import http.client
import json
import os
import threading
import time
import urllib.error
import urllib.request
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from multimodalsimilar_tpu.cli import build_parser
from multimodalsimilar_tpu.cli import serve as jserve
from multimodalsimilar_tpu.data.tokenizer import TextTokenizer as JTokenizer
from multimodalsimilar_tpu.models.bert import BertConfig as JBertConfig
from multimodalsimilar_tpu.models.classifiers import (
    NlpTextClassifier as JNlpTextClassifier)
from multimodalsimilar_tpu.pipelines.embedders import (
    TextEmbedder as JTextEmbedder)
from multimodalsimilar_tpu.pipelines.serving import (
    SimilarityService as JSimilarityService)
from multimodalsimilar_tpu.retrieval.engine import (
    SimilarityEngine as JSimilarityEngine)
from multimodalsimilar_tpu.utils.dtypes import DTypePolicy as JPolicy
from multimodalsimilar_tpu_torch.cli import serve as cli
from multimodalsimilar_tpu_torch.data.tokenizer import TextTokenizer
from multimodalsimilar_tpu_torch.models.bert import BertConfig
from multimodalsimilar_tpu_torch.models.classifiers import NlpTextClassifier
from multimodalsimilar_tpu_torch.models.convert import text_classifier_from_jax
from multimodalsimilar_tpu_torch.pipelines.embed import format_embedding
from multimodalsimilar_tpu_torch.pipelines.embedders import TextEmbedder
from multimodalsimilar_tpu_torch.pipelines.serving import (
    DeferredBatch, MicroBatcher, SimilarityService, make_server)
from multimodalsimilar_tpu_torch.retrieval.engine import SimilarityEngine
from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy

torch.set_num_threads(1)


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _http_error(url, payload):
    try:
        _post(url, payload)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())["error"]
    raise AssertionError("expected an HTTPError")


class _Served:
    """A service behind a bound server on a thread; ``close`` stops
    both."""

    def __init__(self, service):
        self.service = service
        self.httpd = make_server(service, "127.0.0.1", 0)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.service.close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


# ---------------------------------------------------------------- batcher

def test_microbatcher_coalesces_concurrent_submissions():
    calls = []

    def run_batch(items):
        calls.append(len(items))
        time.sleep(0.01)              # let the queue fill behind us
        return [x * 2 for x in items]

    b = MicroBatcher(run_batch, max_batch=64, max_wait_ms=200.0)
    try:
        results = [None] * 16
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, b.submit(i))) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert results == [i * 2 for i in range(16)]
        assert sum(calls) == 16 and len(calls) < 16
        assert b.stats["max_batch_seen"] > 1
    finally:
        b.close()


def test_microbatcher_respects_max_batch():
    seen = []

    def run_batch(items):
        seen.append(len(items))
        return items

    b = MicroBatcher(run_batch, max_batch=4, max_wait_ms=50.0)
    try:
        threads = [threading.Thread(target=b.submit, args=(i,))
                   for i in range(10)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert max(seen) <= 4 and sum(seen) == 10
    finally:
        b.close()


def test_microbatcher_propagates_errors_and_keeps_serving():
    def run_batch(items):
        if any(x == "boom" for x in items):
            raise ValueError("boom")
        return items

    b = MicroBatcher(run_batch, max_batch=1, max_wait_ms=1.0)
    try:
        with pytest.raises(ValueError, match="boom"):
            b.submit("boom")
        assert b.submit("ok") == "ok"   # the worker survived the failure
    finally:
        b.close()


def test_microbatcher_close_rejects_new_work():
    b = MicroBatcher(lambda items: items, max_batch=2, max_wait_ms=1.0)
    assert b.submit(1) == 1
    b.close()
    with pytest.raises(RuntimeError):
        b.submit(2)
    with pytest.raises(ValueError, match="max_batch"):
        MicroBatcher(lambda items: items, max_batch=0)


def test_microbatcher_submit_vs_close_race_never_strands_a_future():
    """Every submit racing close() either raises RuntimeError or
    resolves: the lock serializes check+enqueue against close."""
    for _ in range(20):                     # hammer the window
        b = MicroBatcher(lambda items: items, max_batch=8, max_wait_ms=0.1)
        outcomes = []

        def submitter():
            try:
                fut = b.submit_nowait(1)
            except RuntimeError:
                outcomes.append("rejected")
                return
            outcomes.append(fut.result(timeout=10))   # must resolve

        threads = [threading.Thread(target=submitter) for _ in range(8)]
        for t in threads:
            t.start()
        b.close()
        for t in threads:
            t.join(timeout=15)
            assert not t.is_alive(), "submitter stranded on a dead queue"
        assert all(o in ("rejected", 1) for o in outcomes)
        assert len(outcomes) == 8


def test_microbatcher_pipelines_deferred_readback():
    """A DeferredBatch's finish() runs AFTER the next batch is launched,
    and every future still resolves with its own result."""
    events = []

    def run_batch(items):
        tag = items[0]
        events.append(("dispatch", tag))

        def finish():
            events.append(("finish", tag))
            return [f"r-{tag}"]

        return DeferredBatch(finish)

    mb = MicroBatcher(run_batch, max_batch=1, max_wait_ms=200)
    try:
        futs = [mb.submit_nowait(i) for i in range(3)]
        assert [f.result(timeout=10) for f in futs] == ["r-0", "r-1", "r-2"]
        assert events.index(("dispatch", 1)) < events.index(("finish", 0))
        assert events.index(("dispatch", 2)) < events.index(("finish", 1))
    finally:
        mb.close()


@pytest.mark.parametrize("max_batch", [8, 1], ids=["partial", "full"])
def test_microbatcher_deferred_empty_queue_resolves_now(max_batch):
    """A deferred batch whose launch leaves the queue empty resolves at
    once, partial or full: deferring it could overlap nothing and would
    add a whole max_wait poll to the request."""
    times = {}

    def run_batch(items):
        times["dispatch"] = time.monotonic()

        def finish():
            times["finish"] = time.monotonic()
            return ["r"] * len(items)

        return DeferredBatch(finish)

    mb = MicroBatcher(run_batch, max_batch=max_batch, max_wait_ms=500)
    try:
        assert mb.submit("x") == "r"
        assert times["finish"] - times["dispatch"] < 0.25
    finally:
        mb.close()


def test_microbatcher_deferred_finish_exception_propagates():
    def run_batch(items):
        if items[0] == "bad":
            return DeferredBatch(lambda: (_ for _ in ()).throw(
                RuntimeError("readback died")))
        return [f"ok-{items[0]}"]

    mb = MicroBatcher(run_batch, max_batch=1, max_wait_ms=5)
    try:
        with pytest.raises(RuntimeError, match="readback died"):
            mb.submit("bad")
        assert mb.submit("fine") == "ok-fine"   # worker survives
    finally:
        mb.close()


def test_microbatcher_close_finishes_pending_deferred():
    mb = MicroBatcher(lambda items: DeferredBatch(lambda: ["done"]),
                      max_batch=1, max_wait_ms=5000)
    fut = mb.submit_nowait("x")
    mb.close()   # must finish the in-flight deferred, not strand it
    assert fut.result(timeout=1) == "done"


# ------------------------------------------------------- service + filters

def _toy_service(**kw):
    """Service over a hand-built engine whose 'embedding' is a lookup of
    4-d vectors, so neighbor order is fully controlled."""
    emb = np.array([[1.0, 0.0, 0.0, 0.0],
                    [0.9, 0.1, 0.0, 0.0],
                    [0.8, 0.0, 0.1, 0.0],
                    [0.0, 1.0, 0.0, 0.0]], np.float32)
    engine = SimilarityEngine(emb, ["a", "b", "c", "d"],
                              categories=["x", "x", "y", "y"], metric="ip",
                              normalize=False, device="cpu")
    table = {"qa": np.array([1.0, 0.0, 0.0, 0.0], np.float32),
             "qd": np.array([0.0, 1.0, 0.0, 0.0], np.float32)}

    def embed_texts(texts):
        return np.stack([table[t] for t in texts])

    return SimilarityService(embed_texts, engine, k=kw.pop("k", 4),
                             max_wait_ms=1.0, **kw)


def test_service_similar_ranking_threshold_category_exclude():
    svc = _toy_service(score_th=None)
    try:
        got = svc.similar("qa")
        assert [g["key"] for g in got] == ["a", "b", "c", "d"]
        assert got[0]["score"] == pytest.approx(1.0)
        # strict > threshold (reference semantics, nlp_infer.py:163)
        got = svc.similar("qa", score_th=0.85)
        assert [g["key"] for g in got] == ["a", "b"]
        assert [g["key"] for g in svc.similar("qa", k=1)] == ["a"]
        got = svc.similar("qa", category="x")
        assert [g["key"] for g in got] == ["a", "b"]
        got = svc.similar("qa", exclude_key="a")
        assert [g["key"] for g in got] == ["b", "c", "d"]
    finally:
        svc.close()


def test_service_category_without_category_data_raises():
    emb = np.eye(3, dtype=np.float32)
    engine = SimilarityEngine(emb, ["a", "b", "c"], metric="ip",
                              normalize=False, device="cpu")
    svc = SimilarityService(lambda ts: emb[: len(ts)], engine, k=3,
                            max_wait_ms=1.0)
    try:
        assert svc.similar("q")
        with pytest.raises(ValueError, match="category_col"):
            svc.similar("q", category="x")
    finally:
        svc.close()


def test_service_default_threshold_and_embed():
    svc = _toy_service(score_th=0.5)
    try:
        assert [g["key"] for g in svc.similar("qd")] == ["d"]
        assert len(svc.similar("qd", score_th=None)) == 4
        emb = svc.embed(["qa", "qd", "qa"])
        assert emb.shape == (3, 4)
        np.testing.assert_allclose(emb[0], emb[2])
        assert svc.stats["items"] >= 4
        assert svc.embed([]).shape == (0, 0)
    finally:
        svc.close()


def _updatable_service(with_cats=False, **kw):
    """Toy service whose 'tower' maps any text deterministically to a 4-d
    unit direction (crc32-seeded), so unseen /update payloads embed
    consistently across calls."""
    def embed(texts):
        out = []
        for t in texts:
            rng = np.random.default_rng(zlib.crc32(str(t).encode()))
            v = rng.normal(size=4).astype(np.float32)
            out.append(v / np.linalg.norm(v))
        return np.stack(out)

    keys = ["a", "b", "c", "d"]
    engine = SimilarityEngine(
        embed(keys), keys,
        categories=["x", "x", "y", "y"] if with_cats else None,
        metric="ip", normalize=True, device="cpu")
    svc = SimilarityService(embed, engine, k=kw.pop("k", 10),
                            max_wait_ms=1.0, **kw)
    return svc, embed


def test_service_update_upsert_and_dynamic_k():
    svc, _ = _updatable_service(score_th=None)
    try:
        assert svc.k == 4                       # clamped to the corpus
        assert svc.update(["fresh-e"], ["e"]) == 5 and svc.k == 5
        got = svc.similar("fresh-e")
        assert got[0]["key"] == "e"
        assert got[0]["score"] == pytest.approx(1.0, abs=1e-5)
        assert svc.update(["moved-a"], ["a"]) == 5   # replace
        assert svc.similar("moved-a")[0]["key"] == "a"
        with pytest.raises(ValueError, match="keys"):
            svc.update(["x", "y"], ["only-one"])
    finally:
        svc.close()


def test_service_update_category_discipline():
    svc, _ = _updatable_service(with_cats=True)
    try:
        with pytest.raises(ValueError, match="category"):
            svc.update(["t"], ["z"])            # has cats: must supply
        assert svc.update(["t"], ["z"], categories=["x"]) == 5
        assert svc.engine.categories[-1] == "x"
        got = svc.similar("t", category="x", score_th=None)
        assert got[0]["key"] == "z"
    finally:
        svc.close()
    svc, _ = _updatable_service(with_cats=False)
    try:
        with pytest.raises(ValueError, match="category"):
            svc.update(["t"], ["z"], categories=["x"])   # no column to fill
    finally:
        svc.close()


def test_service_update_coalesced_with_similar_sees_fresh_corpus():
    svc, _ = _updatable_service(score_th=None)
    try:
        out = svc._run_batch([
            {"op": "update", "query": "newbie", "key": "z",
             "category": None},
            {"op": "similar", "query": "newbie"},
        ])
        scores, idx = out[1]
        assert svc.engine.n == 5
        assert idx[0] == 4                      # the just-upserted row wins
        assert scores[0] == pytest.approx(1.0, abs=1e-5)
    finally:
        svc.close()


def test_service_update_duplicate_key_in_one_batch_last_wins():
    svc, embed = _updatable_service(score_th=None)
    try:
        svc._run_batch([
            {"op": "update", "query": "first", "key": "z", "category": None},
            {"op": "update", "query": "second", "key": "z",
             "category": None},
        ])
        assert svc.engine.n == 5                # one row, not two
        np.testing.assert_allclose(svc.engine._emb[4], embed(["second"])[0],
                                   rtol=1e-6)
    finally:
        svc.close()


def test_http_update_end_to_end():
    svc, _ = _updatable_service(score_th=None)
    srv = _Served(svc)
    try:
        res = _post(srv.base + "/update", {"items": [
            {"key": "e", "text": "fresh-e"},
            {"key": "a", "text": "moved-a"},     # replace
        ]})
        assert res == {"updated": 2, "corpus": 5, "k": 5}
        got = _post(srv.base + "/similar", {"text": "fresh-e"})["neighbors"]
        assert got[0]["key"] == "e"
        with urllib.request.urlopen(srv.base + "/healthz", timeout=30) as r:
            assert json.loads(r.read())["corpus"] == 5
        url = srv.base + "/update"
        assert _http_error(url, {})[0] == 400
        assert _http_error(url, {"items": "x"})[0] == 400
        assert _http_error(url, {"items": [{"text": "t"}]})[0] == 400
        code, msg = _http_error(url, {"items": [{"key": "k", "text": "t",
                                                 "category": "x"}]})
        assert code == 400 and "category" in msg
        code, msg = _http_error(url, {"items": [{"key": "k"}]})
        assert code == 400 and "text" in msg
    finally:
        srv.close()


# ------------------------------------------------ device paths (on the CPU)

def test_service_device_path_matches_host_path():
    """embed_queries_device keeps the tower output as a tensor and chains
    it into engine.search_device; results equal the host path's."""
    rng = np.random.default_rng(9)
    corpus = rng.normal(size=(50, 8)).astype(np.float32)
    keys = [f"k{i}" for i in range(50)]
    table = {f"q{i}": rng.normal(size=8).astype(np.float32)
             for i in range(6)}

    def embed_host(texts):
        return np.stack([table[t] for t in texts])

    def embed_device(texts):
        return torch.from_numpy(embed_host(texts))

    host = SimilarityService(embed_host, SimilarityEngine(
        corpus, keys, device="cpu"), k=7, max_wait_ms=1.0)
    dev = SimilarityService(embed_host, SimilarityEngine(
        corpus, keys, device="cpu"), k=7, max_wait_ms=1.0,
        embed_queries_device=embed_device)
    try:
        for q in table:
            h = host.similar(q, score_th=None)
            d = dev.similar(q, score_th=None)
            assert [g["key"] for g in h] == [g["key"] for g in d]
            np.testing.assert_allclose([g["score"] for g in h],
                                       [g["score"] for g in d], rtol=1e-5)
        items = [{"op": "similar", "query": "q0"},
                 {"op": "similar", "query": "q1"}]
        for (ds, di), (hs, hi) in zip(dev._run_batch(items),
                                      host._run_batch(items)):
            np.testing.assert_array_equal(di, hi)
            np.testing.assert_allclose(ds, hs, rtol=1e-5)
    finally:
        host.close()
        dev.close()


def test_service_device_path_mixed_batch_falls_back_to_host():
    svc, embed = _updatable_service(score_th=None)
    calls = {"device": 0}

    def embed_device(texts):
        calls["device"] += 1
        return torch.from_numpy(embed(texts))

    svc._embed_queries_device = embed_device
    try:
        out = svc._run_batch([
            {"op": "update", "query": "newbie", "key": "z",
             "category": None},
            {"op": "similar", "query": "newbie"},
        ])
        assert calls["device"] == 0          # mixed batch: host path
        assert out[1][1][0] == 4             # update still applied first
        svc._run_batch([{"op": "similar", "query": "newbie"}])
        assert calls["device"] == 1          # similar-only batch: device
    finally:
        svc.close()


def _port_tiny_embedder(texts, batch_size=4):
    tok = TextTokenizer.from_corpus(texts)
    model = NlpTextClassifier(BertConfig.tiny(), num_labels=3)
    return TextEmbedder(model, tok, max_length=8, batch_size=batch_size,
                        device="cpu")


def test_oversized_direct_batch_falls_back_to_host_path():
    """A direct call with n > max_batch (bypassing the batcher) is served
    on the host path: the device paths take at most batch_size rows."""
    texts = [f"{'甲乙丙丁'[i % 4]}商品{i}" for i in range(12)]
    emb = _port_tiny_embedder(texts, batch_size=4)
    eng = SimilarityEngine(emb(texts), [f"k{i}" for i in range(12)],
                           device="cpu")
    fused = emb.fused_similar_fn(eng, k=3)
    svc = SimilarityService(lambda tt: emb(list(tt)), eng, k=3, max_batch=4,
                            max_wait_ms=1.0,
                            embed_queries_device=emb.embed_device,
                            fused_similar=fused)
    try:
        out = svc._run_batch([{"op": "similar", "query": t}
                              for t in texts[:5]])
        assert len(out) == 5
        for row in range(5):
            assert eng.keys[int(out[row][1][0])] == f"k{row}"
    finally:
        svc.close()


def test_engine_search_device_matches_search():
    rng = np.random.default_rng(11)
    corpus = rng.normal(size=(80, 6)).astype(np.float32)
    q = rng.normal(size=(5, 6)).astype(np.float32)
    for metric, norm in (("ip", True), ("l2", False)):
        eng = SimilarityEngine(corpus, list(range(80)), metric=metric,
                               normalize=norm, device="cpu")
        hs, hi = eng.search(9, queries=q)
        for dev_q in (q, torch.from_numpy(q)):
            dv, di = eng.search_device(9, dev_q)
            np.testing.assert_array_equal(hi, di.numpy())
            np.testing.assert_allclose(hs, dv.numpy(), rtol=1e-5,
                                       atol=1e-6)


def test_run_batch_pads_query_count_to_pow2_bucket():
    """The host path pads micro-batches to the pow2 ladder capped at
    max_batch; padded rows' results are sliced off."""
    svc, embed = _updatable_service(score_th=None, max_batch=8)
    seen = []
    true_search = svc.engine.search

    def spy(k, queries=None):
        seen.append(np.asarray(queries).shape[0])
        return true_search(k, queries=queries)

    svc.engine.search = spy
    try:
        for n, bucket in [(1, 1), (2, 2), (3, 4), (5, 8), (7, 8), (8, 8)]:
            out = svc._run_batch([{"op": "similar", "query": f"q{i}"}
                                  for i in range(n)])
            assert seen[-1] == bucket, (n, seen[-1])
            assert len(out) == n
            for i in range(n):
                s1, i1 = true_search(svc.k, queries=embed([f"q{i}"]))
                np.testing.assert_array_equal(out[i][1], i1[0])
                # the same products in another batch shape: f32 rounding
                np.testing.assert_allclose(out[i][0], s1[0], rtol=1e-6,
                                           atol=1e-6)
    finally:
        svc.engine.search = true_search
        svc.close()


def test_run_batch_bucket_cap_is_max_batch_not_pow2():
    svc, _ = _updatable_service(score_th=None, max_batch=6)
    seen = []
    true_search = svc.engine.search
    svc.engine.search = lambda k, queries=None: (
        seen.append(np.asarray(queries).shape[0]) or
        true_search(k, queries=queries))
    try:
        svc._run_batch([{"op": "similar", "query": f"q{i}"}
                        for i in range(5)])
        assert seen[-1] == 6                    # capped, not padded to 8
        assert svc._bucket_ladder() == [1, 2, 4, 6]
    finally:
        svc.engine.search = true_search
        svc.close()


def test_run_batch_device_path_slices_padded_tower_output_to_bucket():
    svc, embed = _updatable_service(score_th=None, max_batch=8)

    def embed_device(texts):
        full = np.zeros((8, 4), np.float32)     # tower batch_size = 8
        full[: len(texts)] = embed(texts)
        return torch.from_numpy(full)

    svc._embed_queries_device = embed_device
    seen = []
    true_search_dev = svc.engine.search_device
    svc.engine.search_device = lambda k, queries: (
        seen.append(queries.shape[0]) or true_search_dev(k, queries))
    try:
        out = svc._run_batch([{"op": "similar", "query": f"q{i}"}
                              for i in range(3)])
        assert seen[-1] == 4                    # bucket, not 3 and not 8
        for i in range(3):
            s1, i1 = svc.engine.search(svc.k, queries=embed([f"q{i}"]))
            np.testing.assert_array_equal(out[i][1], i1[0])
            np.testing.assert_allclose(out[i][0], s1[0], rtol=1e-5)
    finally:
        svc.engine.search_device = true_search_dev
        svc.close()


def test_service_device_path_passes_bucket_pad_to():
    svc, embed = _updatable_service(score_th=None, max_batch=8)
    pads = []

    def embed_device(texts, pad_to=None):
        pads.append(pad_to)
        full = np.zeros((pad_to, 4), np.float32)
        full[: len(texts)] = embed(texts)
        return torch.from_numpy(full)

    svc._embed_queries_device = embed_device
    svc._dev_accepts_pad = True
    try:
        out = svc._run_batch([{"op": "similar", "query": f"q{i}"}
                              for i in range(3)])
        assert pads[-1] == 4                    # the pow2 bucket, not 8
        for i in range(3):
            s1, i1 = svc.engine.search(svc.k, queries=embed([f"q{i}"]))
            np.testing.assert_array_equal(out[i][1], i1[0])
    finally:
        svc.close()


def test_service_constructor_detects_pad_to_support():
    corpus = np.eye(4, dtype=np.float32)

    def with_pad(texts, pad_to=None):
        return torch.zeros((pad_to or 4, 4))

    def without_pad(texts):
        return torch.zeros((len(texts), 4))

    services = [SimilarityService(
        lambda t: np.zeros((len(t), 4), np.float32),
        SimilarityEngine(corpus, list("abcd"), device="cpu"),
        embed_queries_device=fn, max_wait_ms=1)
        for fn in (with_pad, without_pad)]
    try:
        assert services[0]._dev_accepts_pad
        assert not services[1]._dev_accepts_pad
    finally:
        for s in services:
            s.close()


@pytest.mark.parametrize("metric,norm", [("ip", True), ("l2", False)])
def test_fused_similar_matches_unfused(metric, norm):
    texts = [f"{'甲乙丙丁'[i % 4]}商品{i}" for i in range(20)]
    emb = _port_tiny_embedder(texts)
    eng = SimilarityEngine(emb(texts), [f"k{i}" for i in range(20)],
                           metric=metric, normalize=norm, device="cpu")
    fused = emb.fused_similar_fn(eng, k=5)
    queries = texts[3:6]
    want_s, want_i = eng.search(5, queries=emb(queries))
    dv, di = fused(queries, 4)
    assert isinstance(dv, torch.Tensor) and dv.shape == (4, 5)
    np.testing.assert_array_equal(di[:3].numpy(), want_i)
    np.testing.assert_allclose(dv[:3].numpy(), want_s, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="pad_to"):
        fused(texts[:5], 4)


def test_fused_search_fn_none_only_for_an_empty_corpus():
    tower = lambda x: x  # noqa: E731
    empty = SimilarityEngine(np.zeros((0, 4), np.float32), [], device="cpu")
    assert empty.fused_search_fn(tower, 3) is None
    eng = SimilarityEngine(np.eye(4, dtype=np.float32), list("abcd"),
                           device="cpu")
    v, i = eng.fused_search_fn(tower, 3)(torch.eye(4)[:2])
    assert i.tolist() == [[0, 1, 2], [1, 0, 2]]


def test_fused_follows_k_and_growth_past_the_padded_block():
    """The port's fused function reads the device corpus and min(k, n) on
    every call: after /update appends cross the 512-row padded block (the
    engine re-allocates the device corpus) and move the effective k, the
    next fused call sees the new rows. It never returns None, so the
    service never schedules the JAX package's off-thread rebuild."""
    rng = np.random.default_rng(4)
    vecs = {f"t{i}": rng.normal(size=8).astype(np.float32)
            for i in range(700)}

    def embed(texts):
        return np.stack([vecs[t] for t in texts])

    engine = SimilarityEngine(embed([f"t{i}" for i in range(10)]),
                              [f"k{i}" for i in range(10)], device="cpu")
    corpus0 = engine._ensure_corpus_dev()[0]
    assert corpus0.shape[0] == 512
    fused_calls = []
    run = engine.fused_search_fn(lambda q: q, 20)

    def fused_similar(texts, pad_to):
        vec = np.zeros((pad_to, 8), np.float32)
        vec[: len(texts)] = embed(texts)
        fused_calls.append(len(texts))
        return run(torch.from_numpy(vec))

    refuse = []
    svc = SimilarityService(embed, engine, k=20, score_th=None,
                            max_batch=8, max_wait_ms=1.0,
                            fused_similar=fused_similar,
                            fused_factory=lambda: refuse.append(1))
    svc._schedule_refuse = lambda: refuse.append(1)
    try:
        assert len(svc.similar("t0")) == 10      # k_eff = n = 10
        new = [f"t{i}" for i in range(10, 700)]
        assert svc.update(new, [f"k{i}" for i in range(10, 700)]) == 700
        assert engine._ensure_corpus_dev()[0].shape[0] == 1024
        for t in ("t5", "t650", "t699"):
            got = svc.similar(t)
            assert len(got) == 20 and got[0]["key"] == "k" + t[1:]
            assert got[0]["score"] == pytest.approx(1.0, abs=1e-5)
        assert len(fused_calls) == 4 and not refuse
        assert not svc._refusing
        assert not any(t.name == "serve-refuse"
                       for t in threading.enumerate())
    finally:
        svc.close()


# ------------------------------------------------------------ HTTP + CLI

def _serve_args(data, *extra):
    return build_parser().parse_args(
        ["serve", "--data", data, "--max_length", "8", "--batch_size", "8",
         "--max_batch", "8", "--max_wait_ms", "2", *extra])


@pytest.fixture(scope="module")
def serve_cli(tmp_path_factory):
    """The port's CLI path: corpus csv -> _build_serve_service ->
    _warm_serve_service -> HTTP server."""
    tmp = tmp_path_factory.mktemp("serve")
    df = pd.DataFrame({
        "spu_sn": [f"sku{i}" for i in range(32)],
        "spu_name": [f"{'甲乙丙丁'[i % 4] * 3}商品{i}" for i in range(32)],
        "lv1": [str(i % 4) for i in range(32)]})
    data = str(tmp / "corpus.csv")
    df.to_csv(data, index=False)
    args = _serve_args(data, "--category_col", "lv1", "--k", "5",
                       "--score_th", "0.0", "--port", "0")
    service, n = cli._build_serve_service(args, device="cpu")
    assert n == 32
    cli._warm_serve_service(service, args)
    srv = _Served(service)
    yield srv.base, service, df
    srv.close()


def test_http_healthz(serve_cli):
    base, service, df = serve_cli
    with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
        h = json.loads(r.read())
    assert h["ok"] and h["corpus"] == 32 and h["k"] == 5
    assert "batches" in h["stats"]


def test_http_similar_matches_offline_engine(serve_cli):
    base, service, df = serve_cli
    text = df["spu_name"][7]
    got = _post(base + "/similar", {"text": text,
                                    "exclude_key": "sku7"})["neighbors"]
    assert 1 <= len(got) <= 5
    assert all(g["key"] != "sku7" for g in got)
    emb = service.embed([text])
    scores, idx = service.engine.search(5, queries=emb)
    keys = [service.engine.keys[i] for i in idx[0]]
    expect = [k for k, s in zip(keys, scores[0]) if s > 0.0 and k != "sku7"]
    assert [g["key"] for g in got] == list(dict.fromkeys(expect))


def test_http_similar_category_filter(serve_cli):
    base, service, df = serve_cli
    cat = dict(zip(df["spu_sn"], df["lv1"]))
    text = df["spu_name"][4]
    plain = _post(base + "/similar",
                  {"text": text, "score_th": None})["neighbors"]
    want = cat[plain[0]["key"]]
    got = _post(base + "/similar",
                {"text": text, "category": want,
                 "score_th": None})["neighbors"]
    assert got and all(cat[g["key"]] == want for g in got)
    assert {g["key"] for g in got} <= {p["key"] for p in plain
                                       if cat[p["key"]] == want}


def test_http_malformed_fields_are_400_not_500(serve_cli):
    base, service, df = serve_cli
    text = df["spu_name"][0]
    for payload in ({"text": text, "k": None},
                    {"text": text, "k": "abc"},
                    {"text": text, "score_th": "x"}):
        assert _http_error(base + "/similar", payload)[0] == 400
    assert _post(base + "/similar", {"text": text})["neighbors"]


def test_http_embed_and_errors(serve_cli):
    base, service, df = serve_cli
    out = _post(base + "/embed", {"texts": ["甲甲甲", "乙乙乙"]})
    emb = np.asarray(out["embeddings"], np.float32)
    assert emb.shape == (2, 64) and np.isfinite(emb).all()
    for path, payload in [("/similar", {}), ("/embed", {"texts": "x"}),
                          ("/nope", {})]:
        assert _http_error(base + path, payload)[0] in (400, 404)
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(base + "/nope", timeout=30)
    assert e.value.code == 404
    assert _post(base + "/similar",
                 {"text": df["spu_name"][0]})["neighbors"]


def test_http_concurrent_burst_coalesces(serve_cli):
    base, service, df = serve_cli
    before = service.stats["batches"]
    results = [None] * 12

    def hit(i):
        results[i] = _post(base + "/similar",
                           {"text": df["spu_name"][i % 32],
                            "score_th": None})

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert all(r is not None and r["neighbors"] for r in results)
    assert service.stats["batches"] - before < 12
    assert service.stats["max_batch_seen"] > 1


def test_http_chunked_body_is_411_and_closes(serve_cli):
    base, service, df = serve_cli
    host, port = base.replace("http://", "").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.putrequest("POST", "/similar")
        conn.putheader("Transfer-Encoding", "chunked")
        conn.endheaders()
        resp = conn.getresponse()
        body = resp.read()
        assert resp.status == 411
        assert b"Content-Length" in body
        assert resp.will_close
    finally:
        conn.close()


def test_http_keepalive_two_requests_one_connection(serve_cli):
    base, service, df = serve_cli
    host, port = base.replace("http://", "").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        for text in (df["spu_name"][0], df["spu_name"][1]):
            conn.request("POST", "/similar",
                         body=json.dumps({"text": text}),
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = json.loads(resp.read())
            assert resp.status == 200 and data["neighbors"]
            assert not resp.will_close     # kept alive between requests
    finally:
        conn.close()


def test_server_settings_match_the_reference():
    from multimodalsimilar_tpu_torch.pipelines.serving import (_Handler,
                                                               _Server)
    assert _Handler.protocol_version == "HTTP/1.1"
    assert _Handler.disable_nagle_algorithm is True
    assert _Handler.timeout == 120
    assert _Server.request_queue_size == 128


def test_cli_serve_wires_fused_and_device_paths(serve_cli):
    base, service, df = serve_cli
    assert service._fused_similar is not None
    assert service._fused_factory is not None
    assert service._embed_queries_device is not None
    assert service._dev_accepts_pad
    got = service.similar(df["spu_name"][2], score_th=None)
    assert got and got[0]["key"] == "sku2"


def test_service_pipelined_load_matches_serial_results(serve_cli):
    """More clients than max_batch, so the depth-1 pipeline engages:
    every answer equals the synchronous one."""
    base, service, df = serve_cli
    texts = [df["spu_name"][i] for i in range(16)]
    want = {t: [g["key"] for g in service.similar(t, score_th=None)]
            for t in texts}
    errs = []

    def worker(t):
        try:
            for _ in range(8):
                got = [g["key"] for g in service.similar(t, score_th=None)]
                assert got == want[t]
        except Exception as e:
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in texts]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errs


def test_warm_serve_service_ladder_matches_buckets(serve_cli):
    base, service, df = serve_cli
    assert service._bucket_ladder() == [1, 2, 4, 8]
    for n in range(1, 9):
        out = service._run_batch([{"op": "similar", "query": "苹果"}
                                  for _ in range(n)])
        assert len(out) == n


def test_warm_serve_service_drives_every_path(tmp_path):
    """Warm-up runs the fused path, the fallback tower and the host
    search at every bucket, INCLUDING bucket 1."""
    df = pd.DataFrame({"spu_sn": [f"sku{i}" for i in range(8)],
                       "spu_name": [f"商品{i}" for i in range(8)]})
    data = str(tmp_path / "c.csv")
    df.to_csv(data, index=False)
    args = _serve_args(data, "--k", "3")
    service, _ = cli._build_serve_service(args, device="cpu")
    pads, fused_pads, searched = [], [], []
    orig_dev, orig_fused = (service._embed_queries_device,
                            service._fused_similar)
    orig_search = service.engine.search

    def counting(texts, pad_to=None):
        pads.append(pad_to)
        return orig_dev(texts, pad_to=pad_to)

    def fused(texts, pad_to):
        fused_pads.append(pad_to)
        return orig_fused(texts, pad_to)

    def search(k, queries=None):
        searched.append(len(queries))
        return orig_search(k, queries=queries)

    service._embed_queries_device = counting
    service._fused_similar = fused
    service.engine.search = search
    try:
        cli._warm_serve_service(service, args)
        assert sorted(pads) == [1, 2, 4, 8]
        assert sorted(set(fused_pads)) == [1, 2, 4, 8]
        assert searched == [1, 2, 4, 8]
    finally:
        service.close()


def test_serve_score_th_defaults_and_unported_flags(tmp_path, capsys):
    """Unset --score_th resolves to the tower's reference operating point
    (nlp_infer.py:152); an explicit flag wins. ``--pallas_topk`` raises
    instead of being ignored, ``--approx_recall`` serves the exact search
    after a notice (as JAX serves it off a TPU; out of (0, 1] it raises
    as JAX's ``knn_search`` does), ``--int8`` builds the int8 tower; the
    fasttext and daodian towers are ported (tests/test_torch_daodian.py): without a model the fasttext
    tower stops with a one-line error, and daodian has its own
    service."""
    args = build_parser().parse_args(["serve", "--data", "x"])
    assert cli._serve_score_th(args) == 0.9
    args = build_parser().parse_args(["serve", "--data", "x",
                                      "--score_th", "0.5"])
    assert cli._serve_score_th(args) == 0.5
    for tower, want in [("bert", 0.9), ("cv", 0.15),
                        ("fasttext", -0.6), ("multimodal", None)]:
        args = build_parser().parse_args(
            ["serve", "--tower", tower, "--data", "x"])
        assert cli._serve_score_th(args) == want
        assert cli._serve_score_th(args) == jserve._serve_score_th(args)
    table = {"spu_sn": ["a"], "spu_name": ["b"]}
    args = build_parser().parse_args(["serve", "--data", "x",
                                      "--pallas_topk"])
    with pytest.raises(NotImplementedError):
        cli._build_serve_service(args, table=table, device="cpu")
    args = build_parser().parse_args(["serve", "--data", "x",
                                      "--approx_recall", "1.5"])
    with pytest.raises(ValueError, match="approx_recall"):
        cli._build_serve_service(args, table=table, device="cpu")
    args = build_parser().parse_args(["serve", "--data", "x",
                                      "--approx_recall", "0.9",
                                      "--max_length", "8"])
    service, _ = cli._build_serve_service(args, table=table, device="cpu")
    assert "search is exact" in capsys.readouterr().err
    try:
        assert service.similar("b", score_th=None)[0]["key"] == "a"
    finally:
        service.close()
    # --int8 is ported (models/quant.py): the daemon serves the int8 tower
    args = build_parser().parse_args(["serve", "--data", "x", "--int8",
                                      "--max_length", "8"])
    service, _ = cli._build_serve_service(args, table=table, device="cpu")
    assert "int8 PTQ text tower" in capsys.readouterr().err
    try:
        assert service.similar("b", score_th=None)[0]["key"] == "a"
    finally:
        service.close()
    for tower, err in (("fasttext", SystemExit), ("daodian", ValueError)):
        args = build_parser().parse_args(["serve", "--data", "x",
                                          "--tower", tower])
        with pytest.raises(err):
            cli._build_serve_service(args, table=table, device="cpu")


def test_build_text_embedder_refuses_unported_checkpoints(tmp_path):
    """A JAX pipeline-parallel checkpoint (an orbax directory whose
    metadata names the stacked ``pp_layers``) is no port checkpoint: the
    port's "no checkpoint" error, as for an empty directory; so does an
    HF tokenizer that is not on disk (``from_hf`` reads local files only,
    it never downloads)."""
    from multimodalsimilar_tpu_torch.cli.embedders import (
        _build_text_embedder)
    from multimodalsimilar_tpu_torch.data.datasets import InputError
    table = {"spu_sn": ["a"], "spu_name": ["苹果"]}
    meta = tmp_path / "pp" / "100" / "default"
    meta.mkdir(parents=True)
    (meta / "_METADATA").write_bytes(b'{"tree": {"pp_layers": {}}}')
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("[PAD]\n[UNK]\n[CLS]\n[SEP]\n[MASK]\n苹\n果\n",
                     encoding="utf-8")
    args = _serve_args("x", "--tokenizer", str(vocab), "--checkpoint",
                       str(tmp_path / "pp"))
    with pytest.raises(InputError, match="no checkpoint found under "
                       + str(tmp_path / "pp")):
        _build_text_embedder(args, df=table, device="cpu")
    args.checkpoint = str(tmp_path / "empty")
    with pytest.raises(InputError, match="no checkpoint"):
        _build_text_embedder(args, df=table, device="cpu")
    args.checkpoint = None
    with pytest.raises(SystemExit, match="tokenizer"):
        _build_text_embedder(_serve_args("x", "--checkpoint", "c"),
                             df=table, device="cpu")
    args.tokenizer = str(tmp_path / "no_such_tokenizer")
    with pytest.raises((OSError, ValueError)):   # not a directory or a name
        _build_text_embedder(args, df=table, device="cpu")


def test_build_serve_service_guards(tmp_path):
    args = build_parser().parse_args(["serve", "--data", "x"])
    with pytest.raises(SystemExit, match="spu_name"):
        cli._build_serve_service(args, table={"spu_sn": ["a"]},
                                 device="cpu")
    with pytest.raises(SystemExit, match="empty"):
        cli._build_serve_service(args, table={"spu_sn": [],
                                              "spu_name": []}, device="cpu")
    args = build_parser().parse_args(["serve", "--data", "x",
                                      "--category_col", "lv9"])
    with pytest.raises(SystemExit, match="lv9"):
        cli._build_serve_service(args, table={"spu_sn": ["a"],
                                              "spu_name": ["b"]},
                                 device="cpu")


# --------------------------------------------- --emb_table warm-start

def _emb_table_setup(tmp_path, rows=16, key_col="spu_sn", cover=None):
    """(corpus_csv, emb_table_parquet, df, emb): a tiny corpus + a
    precomputed embedding table in the nightly jobs' layout, built from
    the tower a fresh `serve` run with these flags uses (tiny preset,
    vocab from the corpus, seed-0 weights)."""
    df = pd.DataFrame({
        "spu_sn": [f"sku{i}" for i in range(rows)],
        "spu_name": [f"{'甲乙丙丁'[i % 4] * 3}商品{i}" for i in range(rows)]})
    data = str(tmp_path / "corpus.csv")
    df.to_csv(data, index=False)
    svc, _ = cli._build_serve_service(_serve_args(data, "--k", "5"),
                                      device="cpu")
    try:
        emb = np.array(svc.engine._emb[:rows], np.float32)
    finally:
        svc.close()
    cover = range(rows) if cover is None else cover
    table = pd.DataFrame({
        key_col: [f"sku{i}" for i in cover],
        "embedding": [format_embedding(emb[i]) for i in cover],
        "dt": "2026-08-19"})
    path = str(tmp_path / "warehouse.parquet")
    table.to_parquet(path)
    return data, path, df, emb


def _unit(x):
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_serve_emb_table_skips_reembedding(tmp_path, monkeypatch):
    """Full coverage: startup runs no corpus tower pass (one probe row
    for the dim check), and the served corpus equals the table's
    vectors."""
    data, table, df, emb = _emb_table_setup(tmp_path)
    embedded = []
    real_call = TextEmbedder.__call__
    monkeypatch.setattr(TextEmbedder, "__call__", lambda self, texts: (
        embedded.append(len(texts)) or real_call(self, texts)))
    svc, n = cli._build_serve_service(
        _serve_args(data, "--k", "5", "--emb_table", table), device="cpu")
    try:
        assert n == 16 and embedded == [1]
        np.testing.assert_allclose(svc.engine._emb[:16], _unit(emb),
                                   atol=1e-5)
        assert svc.similar(df["spu_name"][3], score_th=None)[0]["key"] \
            == "sku3"
    finally:
        svc.close()


def test_serve_emb_table_embeds_missing_keys_fresh(tmp_path):
    data, table, df, emb = _emb_table_setup(tmp_path, cover=range(12))
    svc, n = cli._build_serve_service(
        _serve_args(data, "--k", "5", "--emb_table", table), device="cpu")
    try:
        assert n == 16
        # rows 12..15 embedded fresh through the SAME tower
        np.testing.assert_allclose(svc.engine._emb[:16], _unit(emb),
                                   atol=1e-5)
    finally:
        svc.close()


def test_serve_emb_table_guards(tmp_path):
    data, table, df, emb = _emb_table_setup(tmp_path)
    t = pd.read_parquet(table)
    t["embedding"] = t["embedding"].str.replace(r"\]$", ",0.5]", regex=True)
    bad = str(tmp_path / "bad.parquet")
    t.to_parquet(bad)
    with pytest.raises(SystemExit, match="dim"):
        cli._build_serve_service(_serve_args(data, "--emb_table", bad),
                                 device="cpu")
    t2 = pd.read_parquet(table)
    t2["spu_sn"] = "other_" + t2["spu_sn"]
    other = str(tmp_path / "other.parquet")
    t2.to_parquet(other)
    with pytest.raises(SystemExit, match="overlap"):
        cli._build_serve_service(_serve_args(data, "--emb_table", other),
                                 device="cpu")
    with pytest.raises(SystemExit, match="emb_col"):
        cli._build_serve_service(_serve_args(data, "--emb_table", table,
                                             "--emb_col", "nope"),
                                 device="cpu")


def test_serve_emb_table_array_typed_column(tmp_path):
    data, table, df, emb = _emb_table_setup(tmp_path)
    t = pd.read_parquet(table)
    t["embedding"] = [np.asarray(v, np.float32) for v in _unit(emb)]
    arr_table = str(tmp_path / "arr.parquet")
    t.to_parquet(arr_table)
    svc, n = cli._build_serve_service(
        _serve_args(data, "--k", "5", "--emb_table", arr_table),
        device="cpu")
    try:
        assert n == 16
        np.testing.assert_allclose(svc.engine._emb[:16], _unit(emb),
                                   atol=1e-6)
    finally:
        svc.close()


def test_serve_emb_table_restart_cache(tmp_path, monkeypatch):
    """--emb_table_cache: the first start parses and mirrors to npy; a
    restart loads the mirror without the parser; a table rewrite (mtime
    change) invalidates the mirror."""
    import multimodalsimilar_tpu_torch.pipelines.embed as embed_mod
    data, table, df, emb = _emb_table_setup(tmp_path)
    cache = str(tmp_path / "restart_cache")
    argv = ["--k", "5", "--emb_table", table, "--emb_table_cache", cache]
    svc, n = cli._build_serve_service(_serve_args(data, *argv),
                                      device="cpu")
    svc.close()
    assert os.path.exists(os.path.join(cache, "meta.json"))

    def boom(*a, **kw):
        raise AssertionError("parse_embeddings ran despite a valid cache")

    monkeypatch.setattr(embed_mod, "parse_embeddings", boom)
    svc2, n2 = cli._build_serve_service(_serve_args(data, *argv),
                                        device="cpu")
    try:
        assert n2 == 16
        np.testing.assert_allclose(svc2.engine._emb[:16], _unit(emb),
                                   atol=1e-5)
    finally:
        svc2.close()
    monkeypatch.undo()
    t = pd.read_parquet(table)
    t.iloc[:12].to_parquet(table)
    os.utime(table, (1, 1))   # force a distinct mtime
    svc3, n3 = cli._build_serve_service(_serve_args(data, *argv),
                                        device="cpu")
    try:
        assert n3 == 16   # 12 from table + 4 embedded fresh
    finally:
        svc3.close()
    with open(os.path.join(cache, "meta.json")) as f:
        assert json.load(f)["shape"][0] == 12   # mirror was rewritten


def test_serve_emb_table_cache_key_col_mismatch_misses(tmp_path):
    data, table, df, emb = _emb_table_setup(tmp_path)
    cache = str(tmp_path / "c")
    args = _serve_args(data, "--emb_table", table, "--emb_table_cache",
                       cache)
    keys = np.asarray([f"sku{i}" for i in range(len(emb))], dtype=object)
    cli._emb_table_cache_store(cache, keys, emb, args)
    assert cli._emb_table_cache_load(cache, args) is not None
    other = _serve_args(data, "--emb_table", table, "--emb_table_cache",
                        cache, "--key_col", "goods_sku")
    assert cli._emb_table_cache_load(cache, other) is None


def test_serve_emb_table_cache_requires_local_file(tmp_path):
    data, table, df, emb = _emb_table_setup(tmp_path)
    args = _serve_args(data, "--emb_table", "hive://db.emb",
                       "--emb_table_cache", str(tmp_path / "c"))
    with pytest.raises(SystemExit, match="local"):
        cli._build_serve_service(args, device="cpu")


def test_serve_emb_table_alternate_key_column(tmp_path):
    data, table, df, emb = _emb_table_setup(tmp_path, key_col="goods_sku")
    svc, n = cli._build_serve_service(
        _serve_args(data, "--k", "5", "--emb_table", table), device="cpu")
    try:
        assert n == 16
        np.testing.assert_allclose(svc.engine._emb[:16], _unit(emb),
                                   atol=1e-5)
    finally:
        svc.close()


# ----------------------------------------- parity with the JAX service

BASE = ["红富士苹果 5斤装", "青苹果 新鲜", "纯牛奶 250ml", "酸奶 原味",
        "可乐 330ml 罐装", "雪碧 柠檬味", "香蕉 进口", "橙汁 100%"]
K = 6
MAX_LEN = 16


def _titles(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = BASE[int(rng.integers(0, len(BASE)))]
        out.append(t + str(int(rng.integers(0, 99))) if i % 3 else t[::-1])
    return out


@pytest.fixture(scope="module")
def pair():
    """One JAX-initialized tiny classifier and its port twin (weights
    carried over), the corpus, and novel queries."""
    corpus = _titles(40, seed=0)
    queries = _titles(12, seed=1) + corpus[:4]
    jtok = JTokenizer.from_corpus(corpus)
    tok = TextTokenizer.from_corpus(corpus)
    jcfg = JBertConfig.tiny(vocab_size=jtok.vocab_size)
    jmodel = JNlpTextClassifier(jcfg, num_labels=3,
                                policy=JPolicy.full_precision())
    variables = jmodel.init({"params": jax.random.key(2)},
                            jnp.zeros((1, MAX_LEN), jnp.int32),
                            label=jnp.zeros(1, jnp.int32))
    sd = text_classifier_from_jax(
        variables["params"], BertConfig.tiny(vocab_size=tok.vocab_size))
    return corpus, queries, jtok, tok, jcfg, variables, sd


def _services(pair, policy, path):
    """(JAX service with the fused path, port service on ``path``)."""
    corpus, _, jtok, tok, jcfg, variables, sd = pair
    jpol = {"full": JPolicy.full_precision(),
            "inference": JPolicy.inference()}[policy]
    pol = {"full": DTypePolicy.full_precision(),
           "inference": DTypePolicy.inference()}[policy]
    jmodel = JNlpTextClassifier(jcfg, num_labels=3, policy=jpol)
    jemb = JTextEmbedder(jmodel, variables, jtok, max_length=MAX_LEN,
                         batch_size=8)
    keys = [f"s{i}" for i in range(len(corpus))]
    jeng = JSimilarityEngine(jemb(corpus), keys)
    jsvc = JSimilarityService(
        lambda tt: jemb(list(tt)), jeng, k=K, score_th=None, max_batch=8,
        max_wait_ms=1.0, embed_queries_device=jemb.embed_device,
        fused_similar=jemb.fused_similar_fn(jeng, K))
    model = NlpTextClassifier(BertConfig.tiny(vocab_size=tok.vocab_size),
                              policy=pol, num_labels=3)
    model.load_state_dict(sd)
    emb = TextEmbedder(model, tok, max_length=MAX_LEN, batch_size=8,
                       device="cpu")
    eng = SimilarityEngine(emb(corpus), keys, device="cpu")
    wiring = {"fused": dict(embed_queries_device=emb.embed_device,
                            fused_similar=emb.fused_similar_fn(eng, K)),
              "device_chain": dict(embed_queries_device=emb.embed_device),
              "host": {}}[path]
    svc = SimilarityService(lambda tt: emb(list(tt)), eng, k=K,
                            score_th=None, max_batch=8, max_wait_ms=1.0,
                            **wiring)
    return jsvc, svc


def _assert_same_answer(got, want, tol):
    """Scores within ``tol``; keys equal wherever the JAX scores on both
    sides are more than ``tol`` apart (closer ones may swap). The last
    entry's lower neighbour is unknown, so it is compared by score only."""
    assert len(got) == len(want)
    ws = np.array([w["score"] for w in want])
    np.testing.assert_allclose([g["score"] for g in got], ws, atol=tol,
                               rtol=0)
    gaps = np.abs(np.diff(ws))
    for i in range(len(want) - 1):
        if (i == 0 or gaps[i - 1] > tol) and gaps[i] > tol:
            assert got[i]["key"] == want[i]["key"], (i, got, want)


TOL = {"full": 1e-5, "inference": 2e-2}


@pytest.mark.parametrize("policy", ["full", "inference"])
@pytest.mark.parametrize("path", ["fused", "device_chain", "host"])
def test_service_matches_jax_service(pair, policy, path):
    corpus, queries = pair[0], pair[1]
    jsvc, svc = _services(pair, policy, path)
    try:
        for q in queries:
            _assert_same_answer(svc.similar(q, score_th=None),
                                jsvc.similar(q, score_th=None),
                                TOL[policy])
        # a coalesced micro-batch of 5 at bucket 8, through the same path
        items = [{"op": "similar", "query": q} for q in queries[:5]]
        for (gs, gi), (ws, wi) in zip(svc._run_batch(items),
                                      jsvc._run_batch(items)):
            np.testing.assert_allclose(gs, np.asarray(ws), atol=TOL[policy])
        np.testing.assert_allclose(svc.embed(queries[:3]),
                                   jsvc.embed(queries[:3]),
                                   atol=TOL[policy] * 10)
        if policy == "full":
            # the strict threshold: a th midway in the widest gap of the
            # JAX scores, so no score sits within the tolerance of it
            ss = np.sort(np.concatenate([
                [w["score"] for w in jsvc.similar(q, score_th=None)]
                for q in queries]))
            mid = ss[len(ss) // 4: 3 * len(ss) // 4]
            j = int(np.argmax(np.diff(mid)))
            th = float(mid[j] + mid[j + 1]) / 2
            assert mid[j + 1] - mid[j] > 10 * TOL[policy]
            for q in queries:
                want = jsvc.similar(q, score_th=th)
                got = svc.similar(q, score_th=th)
                assert all(g["score"] > th for g in got)
                _assert_same_answer(got, want, TOL[policy])
    finally:
        jsvc.close()
        svc.close()


@pytest.mark.parametrize("path", ["fused", "device_chain", "host"])
def test_update_then_similar_matches_jax_service(pair, path):
    """/update (3 new keys, 2 re-embedded, one key twice in one request:
    the last write wins) then /similar, both over HTTP."""
    queries = pair[1]
    jsvc, svc = _services(pair, "full", path)
    jsrv = _Served(jsvc)
    srv = _Served(svc)
    try:
        items = [{"key": "new0", "text": queries[0]},
                 {"key": "new1", "text": queries[1]},
                 {"key": "s3", "text": queries[2]},
                 {"key": "new2", "text": queries[3]},
                 {"key": "s7", "text": queries[4]},
                 {"key": "new1", "text": queries[5]}]
        got = _post(srv.base + "/update", {"items": items})
        assert got == _post(jsrv.base + "/update", {"items": items})
        assert got["corpus"] == 43
        np.testing.assert_allclose(svc.engine._emb, jsvc.engine._emb,
                                   atol=1e-5)
        for q in queries[:8]:
            body = {"text": q, "score_th": None}
            _assert_same_answer(
                _post(srv.base + "/similar", body)["neighbors"],
                _post(jsrv.base + "/similar", body)["neighbors"], 1e-5)
        own = _post(srv.base + "/similar", {"text": queries[5],
                                            "score_th": None})["neighbors"]
        assert {"new1", "s7"} & {g["key"] for g in own[:2]}
    finally:
        srv.close()
        jsrv.close()


def test_cli_build_serve_service_matches_jax_cli(tmp_path, monkeypatch):
    """The two commands end to end on one corpus file and vocab: the JAX
    ``_build_serve_service`` (seed-0 weights, single device) against the
    port's, given a port checkpoint of the same weights; both warmed,
    both under the inference policy, the default 0.9 threshold off."""
    from multimodalsimilar_tpu_torch.data.tokenizer import build_char_vocab
    from multimodalsimilar_tpu_torch.train.checkpoint import (
        CheckpointManager)
    corpus = _titles(24, seed=3)
    df = pd.DataFrame({"spu_sn": [f"sku{i}" for i in range(24)],
                       "spu_name": corpus,
                       "lv1": [str(i % 3) for i in range(24)]})
    data = str(tmp_path / "corpus.csv")
    df.to_csv(data, index=False)
    vocab = str(tmp_path / "vocab.txt")
    build_char_vocab(corpus, out_path=vocab)
    monkeypatch.setattr(jserve, "_knn_backend_mesh",
                        lambda a: ("xla", None, None))
    flags = ["--tokenizer", vocab, "--category_col", "lv1", "--k", "5",
             "--max_length", str(MAX_LEN)]
    jargs = _serve_args(data, *flags)
    jsvc, jn = jserve._build_serve_service(jargs)
    jembedder = jsvc._embed_queries_device.__self__
    sd = text_classifier_from_jax(jembedder._variables["params"],
                                  BertConfig.tiny())
    CheckpointManager(str(tmp_path / "ckpt")).save(0, {"model": sd})
    args = _serve_args(data, *flags, "--checkpoint", str(tmp_path / "ckpt"))
    svc, n = cli._build_serve_service(args, device="cpu")
    try:
        assert n == jn == 24
        jserve._warm_serve_service(jsvc, jargs)
        cli._warm_serve_service(svc, args)
        for q in _titles(6, seed=4) + corpus[:3]:
            _assert_same_answer(svc.similar(q, score_th=None),
                                jsvc.similar(q, score_th=None), 2e-2)
            _assert_same_answer(
                svc.similar(q, score_th=None, category="1"),
                jsvc.similar(q, score_th=None, category="1"), 2e-2)
    finally:
        jsvc.close()
        svc.close()
