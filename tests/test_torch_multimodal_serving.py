"""The fused (text + image) path in the port against the JAX package's, on
the CPU: ``MultimodalEmbedder``, ``multimodal_similar_job`` and ``serve
--tower multimodal``'s ``SimilarityService``.

One JAX-initialized tiny ``MultimodalClassifier`` (the tiny EfficientNet
with jiggled BatchNorm statistics + the tiny BERT, 16 + 64 = 80-d fused
embeddings) and its port twin (``multimodal_classifier_from_jax``), the
same char tokenizer, titles and seeded uint8 images. The search is
UN-normalized squared L2, so scores ascend. Embeddings and distances
agree within 1e-5 in full precision and 2e-2 under bf16; the job writes
the same KV items; the port's service matches the JAX service on its
fused path, the two-step chain and the host path, and over HTTP with
text + ``image_b64`` payloads after an ``/update``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from multimodalsimilar_tpu.data.tokenizer import TextTokenizer as JTokenizer
from multimodalsimilar_tpu.models.bert import BertConfig as JBertConfig
from multimodalsimilar_tpu.models.efficientnet import (
    EfficientNetConfig as JEfficientNetConfig)
from multimodalsimilar_tpu.models.multimodal import (
    MultimodalClassifier as JMultimodalClassifier)
from multimodalsimilar_tpu.pipelines.embedders import (
    MultimodalEmbedder as JMultimodalEmbedder)
from multimodalsimilar_tpu.pipelines.serving import (
    MultimodalQueryParser as JMultimodalQueryParser,
    SimilarityService as JSimilarityService)
from multimodalsimilar_tpu.pipelines.similar import (
    multimodal_similar_job as jmultimodal_similar_job)
from multimodalsimilar_tpu.pipelines.sinks import (
    InMemoryKVSink as JInMemoryKVSink)
from multimodalsimilar_tpu.retrieval.engine import (
    SimilarityEngine as JSimilarityEngine)
from multimodalsimilar_tpu.utils.dtypes import DTypePolicy as JPolicy
from multimodalsimilar_tpu_torch.data.tokenizer import TextTokenizer
from multimodalsimilar_tpu_torch.models.bert import BertConfig
from multimodalsimilar_tpu_torch.models.convert import (
    multimodal_classifier_from_jax)
from multimodalsimilar_tpu_torch.models.efficientnet import EfficientNetConfig
from multimodalsimilar_tpu_torch.models.multimodal import MultimodalClassifier
from multimodalsimilar_tpu_torch.pipelines.embedders import MultimodalEmbedder
from multimodalsimilar_tpu_torch.pipelines.serving import (
    MultimodalQueryParser, SimilarityService)
from multimodalsimilar_tpu_torch.pipelines.similar import (
    multimodal_similar_job)
from multimodalsimilar_tpu_torch.pipelines.sinks import InMemoryKVSink
from multimodalsimilar_tpu_torch.retrieval.engine import SimilarityEngine
from tests.test_torch_image_serving import (_b64, _jiggle, _policies,
                                            _post, _Served, images)

torch.set_num_threads(1)

IMG, B, K, FC, MAX_LEN = 32, 8, 5, 16, 12
DIM = FC + 64
TOL = {"full": 1e-5, "inference": 2e-2}
BASE = ["红富士苹果 5斤装", "青苹果 新鲜", "纯牛奶 250ml", "酸奶 原味",
        "可乐 330ml 罐装", "雪碧 柠檬味", "香蕉 进口", "橙汁 100%"]


def titles(n, seed):
    rng = np.random.default_rng(seed)
    return [BASE[int(rng.integers(0, len(BASE)))] + str(int(rng.integers(
        0, 99))) for _ in range(n)]


CORPUS_T, CORPUS_I = titles(30, 0), images(30, seed=20)
KEYS = [f"spu{i}" for i in range(30)]
QUERIES = list(zip(titles(6, 1), images(6, seed=21))) + list(
    zip(CORPUS_T[:3], CORPUS_I[:3]))


@pytest.fixture(scope="module")
def weights():
    jtok = JTokenizer.from_corpus(CORPUS_T + BASE)
    tok = TextTokenizer.from_corpus(CORPUS_T + BASE)
    jtcfg = JBertConfig.tiny(vocab_size=jtok.vocab_size)
    jmodel = JMultimodalClassifier(jtcfg, JEfficientNetConfig.tiny(),
                                   num_labels=4, fc_dim=FC,
                                   policy=JPolicy.full_precision())
    v = jax.jit(lambda x, i: jmodel.init(
        {"params": jax.random.key(3)}, x, i, label=jnp.zeros(1, jnp.int32)))(
            jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1, MAX_LEN), jnp.int32))
    return jtok, tok, jtcfg, _jiggle(v, 4)


def embedders(weights, policy):
    jtok, tok, jtcfg, v = weights
    jpol, pol = _policies(policy)
    jmodel = JMultimodalClassifier(jtcfg, JEfficientNetConfig.tiny(),
                                   num_labels=4, fc_dim=FC, policy=jpol)
    jemb = JMultimodalEmbedder(jmodel, v, jtok, max_length=MAX_LEN,
                               image_size=IMG, batch_size=B)
    tcfg = BertConfig.tiny(vocab_size=tok.vocab_size)
    model = MultimodalClassifier(tcfg, EfficientNetConfig.tiny(),
                                 num_labels=4, fc_dim=FC, policy=pol)
    model.load_state_dict(multimodal_classifier_from_jax(
        v, tcfg, EfficientNetConfig.tiny()))
    emb = MultimodalEmbedder(model, tok, max_length=MAX_LEN, image_size=IMG,
                             batch_size=B, device="cpu")
    return jemb, emb


@pytest.mark.parametrize("policy", ["full", "inference"])
def test_multimodal_embedder_matches_jax(weights, policy):
    jemb, emb = embedders(weights, policy)
    want = jemb(CORPUS_I[:11], CORPUS_T[:11])   # a full batch + 3 repeated
    got = emb(CORPUS_I[:11], CORPUS_T[:11])
    assert got.shape == want.shape == (11, DIM) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL[policy], rtol=0)
    for half in (got[:, :FC], got[:, FC:]):
        np.testing.assert_allclose(np.linalg.norm(half, axis=1), 1.0,
                                   atol=TOL[policy])
    dev = emb.embed_device(QUERIES[:3], pad_to=4)
    jdev = np.asarray(jemb.embed_device(QUERIES[:3], pad_to=4), np.float32)
    assert isinstance(dev, torch.Tensor) and dev.shape == (4, DIM)
    np.testing.assert_allclose(dev.float().numpy(), jdev, atol=TOL[policy])
    with pytest.raises(ValueError, match="pad_to"):
        emb.embed_device(QUERIES[:3], pad_to=2)


def test_fused_l2_search_matches_jax(weights):
    jemb, emb = embedders(weights, "full")
    jeng = JSimilarityEngine(jemb(CORPUS_I, CORPUS_T), KEYS, metric="l2",
                             normalize=False)
    eng = SimilarityEngine(emb(CORPUS_I, CORPUS_T), KEYS, metric="l2",
                           normalize=False, device="cpu")
    jv, ji = jemb.fused_similar_fn(jeng, K)(QUERIES[:5], 8)
    v, i = emb.fused_similar_fn(eng, K)(QUERIES[:5], 8)
    np.testing.assert_allclose(v[:5].numpy(), np.asarray(jv)[:5], atol=1e-5)
    np.testing.assert_array_equal(i[:5].numpy(), np.asarray(ji)[:5])
    assert (np.diff(v[:5].numpy(), axis=1) >= 0).all()      # ascending


@pytest.mark.parametrize("as_dict", [False, True], ids=["dataframe", "dict"])
def test_multimodal_similar_job_same_kv_items(weights, as_dict):
    """The same fused embeddings through both jobs: un-normalized L2,
    top-13, no threshold, same-key neighbours dropped."""
    _, emb = embedders(weights, "full")
    vecs = emb(CORPUS_I, CORPUS_T)
    keys = list(KEYS)
    keys[7] = keys[3]                     # a duplicate key: never its own
    df = pd.DataFrame({"spu_sn": keys})
    jsink, sink = JInMemoryKVSink(), InMemoryKVSink()
    want = jmultimodal_similar_job(df, vecs, jsink, k=13)
    table = {"spu_sn": keys} if as_dict else df
    got = multimodal_similar_job(table, vecs, sink, k=13, device="cpu")
    assert got == want > 0
    assert {k: v for k, (v, _) in sink.data.items()} == \
        {k: v for k, (v, _) in jsink.data.items()}
    assert "spu3" not in sink.get("dj_similar:spu3").split(",")


def services(weights, policy, path):
    jemb, emb = embedders(weights, policy)
    warm = ("warmup", np.zeros((IMG, IMG, 3), np.uint8))

    def embed_queries(e):
        return lambda pairs: e(np.stack([im for _, im in pairs]),
                               [t for t, _ in pairs])

    jeng = JSimilarityEngine(jemb(CORPUS_I, CORPUS_T), KEYS, metric="l2",
                             normalize=False)
    jsvc = JSimilarityService(
        embed_queries(jemb), jeng, k=K, score_th=None, max_batch=B,
        max_wait_ms=1.0, query_parser=JMultimodalQueryParser(IMG),
        embed_queries_device=jemb.embed_device,
        fused_similar=jemb.fused_similar_fn(jeng, K), warm_payload=warm)
    eng = SimilarityEngine(emb(CORPUS_I, CORPUS_T), KEYS, metric="l2",
                           normalize=False, device="cpu")
    wiring = {"fused": dict(embed_queries_device=emb.embed_device,
                            fused_similar=emb.fused_similar_fn(eng, K)),
              "device_chain": dict(embed_queries_device=emb.embed_device),
              "host": {}}[path]
    svc = SimilarityService(embed_queries(emb), eng, k=K, score_th=None,
                            max_batch=B, max_wait_ms=1.0,
                            query_parser=MultimodalQueryParser(IMG),
                            warm_payload=warm, **wiring)
    return jsvc, svc


def assert_same_answer(got, want, tol):
    assert len(got) == len(want)
    ws = np.array([w["score"] for w in want])
    np.testing.assert_allclose([g["score"] for g in got], ws, atol=tol,
                               rtol=0)
    assert (np.diff([g["score"] for g in got]) >= 0).all()
    gaps = np.abs(np.diff(ws))
    for i in range(len(want) - 1):
        if (i == 0 or gaps[i - 1] > tol) and gaps[i] > tol:
            assert got[i]["key"] == want[i]["key"], (i, got, want)


@pytest.mark.parametrize("policy,path", [
    ("full", "fused"), ("full", "device_chain"), ("full", "host"),
    ("inference", "fused")])
def test_multimodal_service_matches_jax_service(weights, policy, path):
    jsvc, svc = services(weights, policy, path)
    try:
        for q in QUERIES:
            assert_same_answer(svc.similar(q, score_th=None),
                               jsvc.similar(q, score_th=None), TOL[policy])
        top = svc.similar(QUERIES[-1], score_th=None)[0]
        assert top["key"] == "spu2" and top["score"] <= 1e-3
        items = [{"op": "similar", "query": q} for q in QUERIES[:5]]
        for (gs, _), (ws, _) in zip(svc._run_batch(items),
                                    jsvc._run_batch(items)):
            np.testing.assert_allclose(gs, np.asarray(ws), atol=TOL[policy])
        np.testing.assert_allclose(svc.embed(QUERIES[:3]),
                                   jsvc.embed(QUERIES[:3]), atol=TOL[policy])
        if policy == "full":
            # score_th on the l2 tower is a max distance (strict <)
            ws = [w["score"] for w in jsvc.similar(QUERIES[0],
                                                   score_th=None)]
            j = int(np.argmax(np.diff(ws)))
            th = (ws[j] + ws[j + 1]) / 2
            got = svc.similar(QUERIES[0], score_th=th)
            assert len(got) == j + 1 and all(g["score"] < th for g in got)
            assert_same_answer(got, jsvc.similar(QUERIES[0], score_th=th),
                               TOL[policy])
    finally:
        jsvc.close()
        svc.close()


@pytest.mark.parametrize("path", ["fused", "host"])
def test_http_update_then_similar_matches_jax(weights, path):
    """/update (two new pairs and a re-embedded key) then /similar and
    /embed over HTTP, text + image_b64, against the JAX daemon."""
    jsvc, svc = services(weights, "full", path)
    jsrv, srv = _Served(jsvc), _Served(svc)
    try:
        new_t, new_i = titles(3, 5), images(3, seed=22)
        items = [{"key": k, "text": t, "image_b64": _b64(im)}
                 for k, t, im in zip(["new0", "new1", "spu9"], new_t,
                                     new_i)]
        got = _post(srv.base + "/update", {"items": items})
        assert got == _post(jsrv.base + "/update", {"items": items})
        assert got["corpus"] == 32
        np.testing.assert_allclose(svc.engine._emb, jsvc.engine._emb,
                                   atol=1e-5)
        for t, im in list(zip(new_t, new_i)) + QUERIES[:3]:
            body = {"text": t, "image_b64": _b64(im), "score_th": None}
            assert_same_answer(
                _post(srv.base + "/similar", body)["neighbors"],
                _post(jsrv.base + "/similar", body)["neighbors"], 1e-5)
        own = _post(srv.base + "/similar", {"text": new_t[2],
                                            "image_b64": _b64(new_i[2])})
        assert own["neighbors"][0]["key"] == "spu9"
        body = {"texts": new_t[:2], "images_b64": [_b64(im)
                                                  for im in new_i[:2]]}
        np.testing.assert_allclose(
            _post(srv.base + "/embed", body)["embeddings"],
            _post(jsrv.base + "/embed", body)["embeddings"], atol=1e-5)
    finally:
        srv.close()
        jsrv.close()
