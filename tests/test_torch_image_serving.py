"""The image serving path in the port against the JAX package's, on the
CPU: ``ImageEmbedder``, the image query parsers and ``serve --tower cv``'s
``SimilarityService``.

One JAX-initialized tiny ``CvImageClassifier`` (BatchNorm statistics
jiggled from a seed, then folded by the JAX ``fold_cv_classifier``) and
its port twin (``cv_classifier_from_jax``), the same seeded uint8 images.
Embeddings and scores agree within 1e-5 under
``DTypePolicy.full_precision()`` and 2e-2 under ``.inference()`` (bf16);
keys agree wherever the JAX scores around them are further apart than
that. The JAX service takes the fused path; the port's is held to it on
its fused path, the two-step device chain and the host path, after an
``update`` too, and over HTTP with ``image_b64`` payloads (JPEG and PNG
bytes written by OpenCV). Every service and server is closed by its
test or fixture.
"""

import base64
import dataclasses
import json
import os
import threading
import urllib.error
import urllib.request

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalsimilar_tpu.models.efficientnet import (
    EfficientNetConfig as JEfficientNetConfig)
from multimodalsimilar_tpu.models.fold_bn import (
    fold_cv_classifier as jfold_cv_classifier)
from multimodalsimilar_tpu.models.vision import (
    CvImageClassifier as JCvImageClassifier)
from multimodalsimilar_tpu.pipelines.embcache import (
    EmbeddingCache as JEmbeddingCache)
from multimodalsimilar_tpu.pipelines.embedders import (
    ImageEmbedder as JImageEmbedder)
from multimodalsimilar_tpu.pipelines.serving import (
    ImageQueryParser as JImageQueryParser,
    MultimodalQueryParser as JMultimodalQueryParser,
    SimilarityService as JSimilarityService)
from multimodalsimilar_tpu.retrieval.engine import (
    SimilarityEngine as JSimilarityEngine)
from multimodalsimilar_tpu.utils.dtypes import DTypePolicy as JPolicy
from multimodalsimilar_tpu_torch.models.convert import cv_classifier_from_jax
from multimodalsimilar_tpu_torch.models.efficientnet import EfficientNetConfig
from multimodalsimilar_tpu_torch.models.vision import CvImageClassifier
from multimodalsimilar_tpu_torch.pipelines.embcache import EmbeddingCache
from multimodalsimilar_tpu_torch.pipelines.embedders import ImageEmbedder
from multimodalsimilar_tpu_torch.pipelines.serving import (
    ImageQueryParser, MultimodalQueryParser, SimilarityService, make_server)
from multimodalsimilar_tpu_torch.retrieval.engine import SimilarityEngine
from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy

torch.set_num_threads(1)

IMG, B, K, FC = 32, 8, 5, 16
TOL = {"full": 1e-5, "inference": 2e-2}


def images(n, seed, size=IMG):
    """Blocky synthetic uint8 photos, distinct per seed."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 256, (n, 4, 4, 3), dtype=np.uint8)
    cell = -(-size // 4)
    return np.ascontiguousarray(
        np.repeat(np.repeat(g, cell, 1), cell, 2)[:, :size, :size])


def _policies(name):
    return ({"full": JPolicy.full_precision(),
             "inference": JPolicy.inference()}[name],
            {"full": DTypePolicy.full_precision(),
             "inference": DTypePolicy.inference()}[name])


def _jiggle(variables, seed):
    rng = np.random.default_rng(seed)

    def f(path, a):
        a = np.asarray(a, np.float32)
        if path[-1].key == "mean":
            return a + rng.normal(0, 0.1, a.shape).astype(np.float32)
        if path[-1].key == "var":
            return a * rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        return a

    v = jax.device_get(variables)
    return {"params": v["params"],
            "batch_stats": jax.tree_util.tree_map_with_path(
                f, v["batch_stats"])}


@pytest.fixture(scope="module")
def folded():
    """(JAX folded config, JAX folded variables, port folded config)."""
    jcfg = JEfficientNetConfig.tiny()
    jmodel = JCvImageClassifier(jcfg, num_labels=5, fc_dim=FC,
                                policy=JPolicy.full_precision())
    v = jax.jit(lambda x: jmodel.init(
        {"params": jax.random.key(0)}, x, label=jnp.zeros(1, jnp.int32)))(
            jnp.zeros((1, IMG, IMG, 3)))
    jfcfg, jfv = jfold_cv_classifier(_jiggle(v, 1), jcfg)
    return jfcfg, jfv, dataclasses.replace(EfficientNetConfig.tiny(),
                                           folded=True)


def embedders(folded, policy, jkw=None, kw=None):
    jfcfg, jfv, fcfg = folded
    jpol, pol = _policies(policy)
    jmodel = JCvImageClassifier(jfcfg, num_labels=5, fc_dim=FC, policy=jpol)
    jemb = JImageEmbedder(jmodel, jfv, image_size=IMG, batch_size=B,
                          **(jkw or {}))
    model = CvImageClassifier(fcfg, num_labels=5, fc_dim=FC, policy=pol)
    model.load_state_dict(cv_classifier_from_jax(jfv, fcfg))
    emb = ImageEmbedder(model, image_size=IMG, batch_size=B, device="cpu",
                        **(kw or {}))
    return jemb, emb


@pytest.mark.parametrize("policy", ["full", "inference"])
def test_image_embedder_matches_jax(folded, policy):
    jemb, emb = embedders(folded, policy)
    x = images(11, seed=1)                  # a full batch + a pow2-padded 3
    want = jemb.embed_batch(x)
    got = emb.embed_batch(x)
    assert got.shape == want.shape == (11, FC) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL[policy] * np.abs(
        want).max(), rtol=0)
    dev = emb.embed_device(list(x[:3]), pad_to=4)
    assert isinstance(dev, torch.Tensor) and dev.shape == (4, FC)
    np.testing.assert_allclose(dev[:3].float().numpy(), want[:3],
                               atol=TOL[policy] * np.abs(want).max())
    # zero-padded rows embed zero images, as the JAX embedder's
    jdev = np.asarray(jemb.embed_device(list(x[:3]), pad_to=4), np.float32)
    np.testing.assert_allclose(dev[3].float().numpy(), jdev[3],
                               atol=TOL[policy] * np.abs(jdev).max())
    for bad in ([], list(x[:3])):
        with pytest.raises(ValueError, match="pad_to"):
            emb.embed_device(bad, pad_to=2 if bad else 1)
    assert emb.embed_batch(x[:0]).shape == (0, 0)


def test_image_embedder_pads_partial_chunks_to_pow2_bucket(folded,
                                                           monkeypatch):
    """A partial chunk ships at its pow2 bucket (3 -> 4), repeating the
    last image, as the JAX embedder does."""
    _, emb = embedders(folded, "full")
    seen = []
    real = emb._run
    monkeypatch.setattr(emb, "_run", lambda t: seen.append(t.clone())
                        or real(t))
    x = images(11, seed=2)
    emb.embed_batch(x)
    assert [t.shape[0] for t in seen] == [8, 4]
    assert torch.equal(seen[1][3], seen[1][2])


def _key_tree(root, seed=3):
    """The reference layout {root}/{key}/{j}.jpg: k0 three images, k1 one
    (its 2.jpg follows a gap and is not read), k2 none, k3 a valid
    emb.txt, k4 a wrong-dim emb.txt and an image, k5 a broken emb.txt
    and an image."""
    ims = images(8, seed)
    files = {"k0": [0, 1, 2], "k1": [0], "k4": [0], "k5": [0]}
    n = 0
    for key, js in files.items():
        os.makedirs(os.path.join(root, key), exist_ok=True)
        for j in js:
            cv2.imwrite(os.path.join(root, key, f"{j}.jpg"), ims[n])
            n += 1
    cv2.imwrite(os.path.join(root, "k1", "2.jpg"), ims[n])
    os.makedirs(os.path.join(root, "k2"), exist_ok=True)
    os.makedirs(os.path.join(root, "k3"), exist_ok=True)
    np.savetxt(os.path.join(root, "k3", "emb.txt"),
               np.arange(FC, dtype=np.float32) / FC)
    np.savetxt(os.path.join(root, "k4", "emb.txt"), np.ones(FC + 1))
    with open(os.path.join(root, "k5", "emb.txt"), "w") as f:
        f.write("1.0 nope\n")
    return ["k0", "k1", "k2", "k3", "k4", "k5"]


def _paths(root):
    return lambda k: [os.path.join(root, k, f"{j}.jpg") for j in range(8)]


@pytest.mark.parametrize("packed", [False, True], ids=["emb_txt", "packed"])
def test_embed_keys_matches_jax(folded, tmp_path, packed):
    """Multi-image mean up to the first gap, emb.txt read and written (a
    wrong-dim or broken one recomputed), keys without images absent; with
    a packed cache, legacy emb.txt files backfill it."""
    out = {}
    for side in ("jax", "port"):
        root = str(tmp_path / side / "img")
        keys = _key_tree(root)
        kw = dict(cache_path_for_key=lambda k, r=root: os.path.join(
            r, k, "emb.txt"), emb_dim=FC)
        if packed:
            kw["cache"] = (JEmbeddingCache if side == "jax" else
                           EmbeddingCache)(str(tmp_path / side / "c"), FC)
        jemb, emb = embedders(folded, "full", jkw=kw if side == "jax" else
                              None, kw=kw if side == "port" else None)
        e = jemb if side == "jax" else emb
        first = e.embed_keys(keys, _paths(root))
        again = e.embed_keys(keys, _paths(root))     # now all cached
        out[side] = (first, again, root, kw.get("cache"))
    (jfirst, jagain, jroot, jcache), (first, again, root, cache) = \
        out["jax"], out["port"]
    assert first.keys() == jfirst.keys() == {"k0", "k1", "k3", "k4", "k5"}
    for got, want in ((first, jfirst), (again, jagain)):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, rtol=0)
    if packed:
        assert sorted(cache.keys()) == sorted(jcache.keys())
        for k in jcache.keys():
            np.testing.assert_allclose(cache.get(k), jcache.get(k),
                                       atol=1e-5)
        cache.close()
        jcache.close()
    else:
        for k in ("k0", "k1", "k4", "k5"):
            np.testing.assert_allclose(
                np.loadtxt(os.path.join(root, k, "emb.txt")),
                np.loadtxt(os.path.join(jroot, k, "emb.txt")), atol=1e-5)
    # the mean over k0's three images, not image 0 three times
    _, emb = embedders(folded, "full")
    three = emb.embed_paths([os.path.join(root, "k0", f"{j}.jpg")
                             for j in range(3)] + ["/nonexistent.jpg"])
    assert len(three) == 3
    np.testing.assert_allclose(first["k0"], np.mean(list(three.values()),
                                                    axis=0), atol=1e-6)


def _b64(img, ext=".jpg"):
    ok, buf = cv2.imencode(ext, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    assert ok
    return base64.b64encode(buf.tobytes()).decode()


@pytest.fixture(scope="module")
def payloads(tmp_path_factory):
    d = tmp_path_factory.mktemp("q")
    ims = images(3, seed=4, size=50)
    path = str(d / "q.png")
    cv2.imwrite(path, cv2.cvtColor(ims[1], cv2.COLOR_RGB2BGR))
    junk = d / "junk.jpg"
    junk.write_bytes(b"not an image")
    return {
        "b64": {"image_b64": _b64(ims[0])},
        "b64_png": {"image_b64": _b64(ims[2], ".png")},
        "path": {"image_path": path},
        "many_b64": {"images_b64": [_b64(ims[0]), _b64(ims[2], ".png")]},
        "many_paths": {"image_paths": [path, path]},
        "bad_b64": {"image_b64": "@@@"},
        "not_str": {"image_b64": 7},
        "not_image": {"image_b64": base64.b64encode(b"xyz").decode()},
        "missing_path": {"image_path": str(d / "none.jpg")},
        "junk_path": {"image_path": str(junk)},
        "nothing": {},
        "empty_list": {"images_b64": []},
    }


@pytest.mark.parametrize("name", ["b64", "b64_png", "path", "many_b64",
                                  "many_paths", "bad_b64", "not_str",
                                  "not_image", "missing_path", "junk_path",
                                  "nothing", "empty_list"])
def test_image_query_parser_matches_jax(payloads, name):
    req = payloads[name]
    for method in ("one", "many"):
        try:
            want = getattr(JImageQueryParser(IMG), method)(req)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                getattr(ImageQueryParser(IMG), method)(req)
            assert str(got.value) == str(e)
            continue
        got = getattr(ImageQueryParser(IMG), method)(req)
        if method == "one":
            got, want = [got], [want]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == (IMG, IMG, 3) and g.dtype == np.uint8
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("req", [
    {"text": "苹果", "image_b64": None},
    {"image_b64": None},
    {"text": 3, "image_b64": None},
    {"texts": ["苹果", "香蕉"], "images_b64": [None, None]},
    {"texts": ["苹果"], "images_b64": [None, None]},
    {"texts": ["苹果", "香蕉"]},
], ids=["one", "no_text", "text_not_str", "many", "length_mismatch",
        "texts_only"])
def test_multimodal_query_parser_matches_jax(payloads, req):
    b64 = payloads["b64"]["image_b64"]
    req = {k: ([b64] * len(v) if isinstance(v, list) and k == "images_b64"
               else (b64 if v is None else v)) for k, v in req.items()}
    for method in ("one", "many"):
        try:
            want = getattr(JMultimodalQueryParser(IMG), method)(req)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                getattr(MultimodalQueryParser(IMG), method)(req)
            assert str(got.value) == str(e)
            continue
        got = getattr(MultimodalQueryParser(IMG), method)(req)
        if method == "one":
            got, want = [got], [want]
        for (gt, gi), (wt, wi) in zip(got, want):
            assert gt == wt
            np.testing.assert_array_equal(gi, wi)


CORPUS = images(30, seed=10)
KEYS = [f"sku{i}" for i in range(30)]
CATS = [str(i % 3) for i in range(30)]
QUERIES = list(images(6, seed=11)) + list(CORPUS[:3])


def services(folded, policy, path):
    """(JAX service on its fused path, port service on ``path``)."""
    jemb, emb = embedders(folded, policy)
    warm = np.zeros((IMG, IMG, 3), np.uint8)
    jeng = JSimilarityEngine(jemb.embed_batch(CORPUS), KEYS, categories=CATS)
    jsvc = JSimilarityService(
        lambda ims: jemb.embed_batch(np.stack(list(ims))), jeng, k=K,
        score_th=None, max_batch=B, max_wait_ms=1.0,
        query_parser=JImageQueryParser(IMG),
        embed_queries_device=jemb.embed_device,
        fused_similar=jemb.fused_similar_fn(jeng, K), warm_payload=warm)
    eng = SimilarityEngine(emb.embed_batch(CORPUS), KEYS, categories=CATS,
                           device="cpu")
    wiring = {"fused": dict(embed_queries_device=emb.embed_device,
                            fused_similar=emb.fused_similar_fn(eng, K)),
              "device_chain": dict(embed_queries_device=emb.embed_device),
              "host": {}}[path]
    svc = SimilarityService(
        lambda ims: emb.embed_batch(np.stack(list(ims))), eng, k=K,
        score_th=None, max_batch=B, max_wait_ms=1.0,
        query_parser=ImageQueryParser(IMG), warm_payload=warm, **wiring)
    return jsvc, svc


def assert_same_answer(got, want, tol):
    """Scores within ``tol``; keys equal wherever the JAX scores on both
    sides are more than ``tol`` apart (closer ones may swap)."""
    assert len(got) == len(want)
    ws = np.array([w["score"] for w in want])
    np.testing.assert_allclose([g["score"] for g in got], ws, atol=tol,
                               rtol=0)
    gaps = np.abs(np.diff(ws))
    for i in range(len(want) - 1):
        if (i == 0 or gaps[i - 1] > tol) and gaps[i] > tol:
            assert got[i]["key"] == want[i]["key"], (i, got, want)


@pytest.mark.parametrize("policy,path", [
    ("full", "fused"), ("full", "device_chain"), ("full", "host"),
    ("inference", "fused")])
def test_cv_service_matches_jax_service(folded, policy, path):
    jsvc, svc = services(folded, policy, path)
    try:
        for q in QUERIES:
            assert_same_answer(svc.similar(q, score_th=None),
                               jsvc.similar(q, score_th=None), TOL[policy])
            if policy == "full":
                # in bf16 the k-th and (k+1)-th rows may swap, and the
                # category filter then keeps a different count
                assert_same_answer(
                    svc.similar(q, score_th=None, category="1"),
                    jsvc.similar(q, score_th=None, category="1"),
                    TOL[policy])
        assert svc.similar(CORPUS[2], score_th=None)[0]["key"] == "sku2"
        items = [{"op": "similar", "query": q} for q in QUERIES[:5]]
        for (gs, _), (ws, _) in zip(svc._run_batch(items),
                                    jsvc._run_batch(items)):
            np.testing.assert_allclose(gs, np.asarray(ws), atol=TOL[policy])
        np.testing.assert_allclose(svc.embed(QUERIES[:3]),
                                   jsvc.embed(QUERIES[:3]),
                                   atol=TOL[policy])
        if policy == "full":
            # the strict threshold: midway in the widest gap of one
            # answer's JAX scores, so no score sits within the tolerance
            ws = [w["score"] for w in jsvc.similar(QUERIES[0],
                                                   score_th=None)]
            j = int(np.argmax(-np.diff(ws)))
            th = (ws[j] + ws[j + 1]) / 2
            got = svc.similar(QUERIES[0], score_th=th)
            assert len(got) == j + 1 and all(g["score"] > th for g in got)
            assert_same_answer(got, jsvc.similar(QUERIES[0], score_th=th),
                               TOL[policy])
    finally:
        jsvc.close()
        svc.close()


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


class _Served:
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


@pytest.mark.parametrize("path", ["fused", "host"])
def test_http_update_then_similar_with_image_b64_matches_jax(folded, path):
    """/update (new keys and a re-embedded one, as image_b64), then
    /similar and /embed, all over HTTP, against the JAX daemon."""
    jsvc, svc = services(folded, "full", path)
    jsrv, srv = _Served(jsvc), _Served(svc)
    try:
        new = images(4, seed=12)
        items = ([{"key": f"new{i}", "image_b64": _b64(im), "category": "2"}
                  for i, im in enumerate(new[:3])]
                 + [{"key": "sku4", "image_b64": _b64(new[3]),
                     "category": "0"}])
        got = _post(srv.base + "/update", {"items": items})
        assert got == _post(jsrv.base + "/update", {"items": items})
        assert got["corpus"] == 33
        np.testing.assert_allclose(svc.engine._emb, jsvc.engine._emb,
                                   atol=1e-5)
        for im in list(new) + list(CORPUS[5:8]):
            body = {"image_b64": _b64(im), "score_th": None}
            assert_same_answer(_post(srv.base + "/similar", body)["neighbors"],
                               _post(jsrv.base + "/similar", body)[
                                   "neighbors"], 1e-5)
        own = _post(srv.base + "/similar", {"image_b64": _b64(new[3]),
                                            "score_th": None})["neighbors"]
        assert own[0]["key"] == "sku4"
        body = {"images_b64": [_b64(im) for im in new[:2]]}
        np.testing.assert_allclose(
            _post(srv.base + "/embed", body)["embeddings"],
            _post(jsrv.base + "/embed", body)["embeddings"], atol=1e-5)
        for bad in ({"image_b64": "@@@"}, {"text": "苹果"}):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(srv.base + "/similar", bad)
            assert e.value.code == 400
    finally:
        srv.close()
        jsrv.close()


def test_fused_similar_fn_matches_jax_fused(folded):
    jemb, emb = embedders(folded, "full")
    jeng = JSimilarityEngine(jemb.embed_batch(CORPUS), KEYS)
    eng = SimilarityEngine(emb.embed_batch(CORPUS), KEYS, device="cpu")
    q = QUERIES[:5]
    jv, ji = jemb.fused_similar_fn(jeng, K)(q, 8)
    v, i = emb.fused_similar_fn(eng, K)(q, 8)
    assert v.shape == (8, K)
    np.testing.assert_allclose(v[:5].numpy(), np.asarray(jv)[:5],
                               atol=1e-5)
    np.testing.assert_array_equal(i[:5].numpy(), np.asarray(ji)[:5])
    assert emb.fused_similar_fn(SimilarityEngine(
        np.zeros((0, FC), np.float32), [], device="cpu"), K) is None
