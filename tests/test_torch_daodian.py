"""The daodian slice: the port against the JAX package on the CPU.

* C1: the neighbor filters treat ``pd.NA``, ``pd.NaT`` and
  ``np.datetime64('NaT')`` as missing, like ``pandas.factorize``.
* ``_canon_cat`` keeps integer category ids above 2^53 apart (the JAX
  package rounds them through float).
* The grouped full-ranking path (``_grouped_self_similar_map``) equals the
  JAX map and the port's own full search + filter, with the dt rule, and
  is not taken for a partial ranking (the cases of
  ``tests/test_retrieval.py::test_grouped_self_similar_map_*``).
* ``daodian_similar_job`` v1, v2 date-keyed and v2 recent days: merged
  maps, KV keys, values and TTLs equal to JAX's, on the corpus of
  ``tests/test_daodian_v2_semantics.py`` and a fastText-embedded catalog
  like ``tests/test_integration_daodian.py``'s.
* ``DaodianService``: key answers, ad-hoc text and text + image queries,
  updates and HTTP against JAX's service (the cases of
  ``tests/test_daodian_serving.py``).
* The commands: ``serve --tower fasttext|daodian`` and ``embed --kind
  fasttext`` against JAX's on one corpus and one fastText model.
"""

import base64
import copy
import json
import pickle
import threading
import urllib.error
import urllib.request

import numpy as np
import pandas as pd
import pytest
import torch

from multimodalsimilar_tpu.cli import build_parser
from multimodalsimilar_tpu.cli import embed as jembed_cli
from multimodalsimilar_tpu.cli import serve as jserve
from multimodalsimilar_tpu.models import fasttext as JF
from multimodalsimilar_tpu.pipelines import daodian_serving as JD
from multimodalsimilar_tpu.pipelines.similar import (
    daodian_similar_job as jdaodian_similar_job)
from multimodalsimilar_tpu.retrieval.engine import (
    SimilarityEngine as JEngine)
from multimodalsimilar_tpu.retrieval.filters import FilterRules as JRules
from multimodalsimilar_tpu.retrieval.filters import (
    filter_neighbors as jfilter_neighbors)
from multimodalsimilar_tpu_torch.cli import embed as cli_embed
from multimodalsimilar_tpu_torch.cli import serve as cli
from multimodalsimilar_tpu_torch.models.convert import fasttext_from_jax
from multimodalsimilar_tpu_torch.pipelines import daodian_serving as D
from multimodalsimilar_tpu_torch.pipelines.similar import (
    DAY_AND_HALF, WEEK, daodian_similar_job)
from multimodalsimilar_tpu_torch.retrieval.engine import SimilarityEngine
from multimodalsimilar_tpu_torch.retrieval.filters import (FilterRules,
                                                           filter_neighbors)

torch.set_num_threads(1)


class RecordingSink:
    """A KV sink that keeps every (key, value, ttl) written."""

    def __init__(self):
        self.items = {}

    def set_many(self, items, ttl_seconds=None):
        for k, v in items.items():
            self.items[k] = (v, ttl_seconds)


# -- C1 and _canon_cat -------------------------------------------------------


@pytest.mark.parametrize("missing", [pd.NA, pd.NaT, np.datetime64("NaT")],
                         ids=["NA", "NaT", "np_NaT"])
def test_filters_treat_pandas_missing_values_as_missing(missing):
    """ROADMAP C1's table: rows whose category is missing never match
    (JAX: ``pd.factorize`` codes -1), and missing keys stay distinct."""
    scores = np.full((3, 3), 0.9, np.float32)
    idx = np.array([[0, 1, 2], [1, 0, 2], [2, 0, 1]])
    rules = FilterRules(score_threshold=0.5, same_category=True)
    jrules = JRules(score_threshold=0.5, same_category=True)
    cats = [missing, missing, 1]
    got = filter_neighbors(scores, idx, ["a", "b", "c"], cats, rules)
    want = jfilter_neighbors(scores, idx, ["a", "b", "c"], cats, jrules)
    assert got == want == {"a": [], "b": [], "c": []}
    # missing keys: each its own key, so 'a' keeps both neighbors
    keys = ["a", missing, missing]
    free = FilterRules(same_category=False)
    got = filter_neighbors(scores, idx, keys, None, free)
    want = jfilter_neighbors(scores, idx, keys, None,
                             JRules(same_category=False))

    def show(m):
        return {str(k): [str(x) for x in v] for k, v in m.items()}

    assert show(got) == show(want)
    assert len(got["a"]) == 2


def test_canon_cat_keeps_large_integer_ids_apart():
    big = 2**53
    assert D._canon_cat(big) != D._canon_cat(big + 1)
    assert D._canon_cat(str(big + 1)) == D._canon_cat(big + 1)
    assert D._canon_cat(np.int64(big + 1)) == str(big + 1)
    # the JAX package goes through float first: the two ids collide
    assert JD._canon_cat(big) == JD._canon_cat(big + 1)
    # the value rules both packages share
    for a, b in [(7, 7.0), (7, "7"), ("7.0", 7), (np.float32(2.5), 2.5),
                 ("x", "x")]:
        assert D._canon_cat(a) == D._canon_cat(b) == JD._canon_cat(a)
    for v in (None, float("nan"), np.nan, pd.NA, pd.NaT):
        assert D._canon_cat(v) is None
    assert D._canon_cat(2.5) != D._canon_cat(2)


# -- the grouped full-ranking path ------------------------------------------


def _ungrouped(eng, k, rules):
    scores, idx = eng.search(k)
    return filter_neighbors(scores, idx, eng.keys, eng.categories, rules,
                            dts=eng.dts)


@pytest.mark.parametrize("chunk", [32_768, 8])
def test_grouped_map_equals_jax_and_full_search(monkeypatch, chunk):
    """Duplicate keys across categories (last global row wins), duplicate
    embeddings, a NaN and a pd.NA category, a group of one, and query
    chunks inside a group."""
    rng = np.random.default_rng(5)
    n, d = 90, 12
    emb = rng.standard_normal((n, d)).astype(np.float32)
    emb[7] = emb[3]
    cats = [f"c{i % 4}" for i in range(n)]
    cats[10] = float("nan")
    cats[12] = pd.NA
    cats[11] = "solo"
    keys = [f"k{i}" for i in range(n)]
    keys[20] = keys[50] = "dup"
    monkeypatch.setattr(SimilarityEngine, "QUERY_CHUNK", chunk)
    calls = []
    grouped = SimilarityEngine._grouped_self_similar_map
    monkeypatch.setattr(SimilarityEngine, "_grouped_self_similar_map",
                        lambda self, r: calls.append(1) or grouped(self, r))
    for th, cap in ((-0.6, 5), (None, None)):
        eng = SimilarityEngine(emb, keys, categories=cats, device="cpu")
        got = eng.similar_map(n, FilterRules(th, True, cap))
        want = JEngine(emb, keys, categories=cats).similar_map(
            n, JRules(th, True, cap))
        assert got == want == _ungrouped(eng, n, FilterRules(th, True, cap))
    assert len(calls) == 2


def test_grouped_map_with_dt_rule_and_partial_ranking():
    """The v2 dt rule composes with the grouped path; k < n (a partial
    ranking) keeps the full search."""
    rng = np.random.default_rng(6)
    n, d = 60, 8
    emb = rng.standard_normal((n, d)).astype(np.float32)
    cats = [f"c{i % 3}" for i in range(n)]
    keys = [f"k{i}" for i in range(n)]
    dts = ["20260819" if i % 2 else "20260820" for i in range(n)]
    rules = FilterRules(score_threshold=-0.9, same_category=True,
                        max_neighbors=7, require_dt="20260820")
    jrules = JRules(score_threshold=-0.9, same_category=True,
                    max_neighbors=7, require_dt="20260820")
    eng = SimilarityEngine(emb, keys, categories=cats, dts=dts, device="cpu")
    want = JEngine(emb, keys, categories=cats, dts=dts).similar_map(n,
                                                                    jrules)
    assert eng.similar_map(n, rules) == want == _ungrouped(eng, n, rules)
    called = []
    eng._grouped_self_similar_map = lambda r: called.append(1)
    partial = FilterRules(score_threshold=None, same_category=True,
                          max_neighbors=3)
    got = eng.similar_map(5, partial)
    assert called == [] and got == JEngine(
        emb, keys, categories=cats, dts=dts).similar_map(
            5, JRules(None, True, 3))
    assert eng.dim == d


# -- the job ---------------------------------------------------------------

DAYS = [f"2026-08-{d:02d}" for d in range(10, 17)]


@pytest.fixture(scope="module")
def corpus():
    """tests/test_daodian_v2_semantics.py's corpus: 2 areas, 7 days of
    dts, some rows without a CV vector."""
    rng = np.random.default_rng(7)
    n = 140
    df = pd.DataFrame({
        "area_id": np.where(np.arange(n) < 98, 1, 2),
        "spu_sn": [f"s{i}" for i in range(n)],
        "title": [f"t{i}" for i in range(n)],
        "first_level_category_id": rng.integers(0, 4, n),
        "second_level_category_id": rng.integers(0, 3, n),
        "dt": [DAYS[i % 7] for i in range(n)]})
    text_vecs = dict(zip(df["title"], rng.normal(size=(n, 16)).astype(
        np.float32)))
    cv_vecs = {f"s{i}": rng.normal(size=24).astype(np.float32)
               for i in range(n) if i % 5 != 3}

    def embed_titles(titles):
        return np.stack([text_vecs[t] for t in titles])

    def embed_skus(area):
        return {k: cv_vecs[k] for k in area["spu_sn"] if k in cv_vecs}

    return df, embed_titles, embed_skus


@pytest.mark.parametrize("variant", ["v1", "v2_date_keyed",
                                     "v2_recent_days"])
@pytest.mark.parametrize("as_dict", [False, True], ids=["frame", "dict"])
def test_daodian_job_matches_jax(corpus, variant, as_dict):
    df, embed_titles, embed_skus = corpus
    kw = {"v1": {},
          "v2_date_keyed": dict(date_key="20260816"),
          "v2_recent_days": dict(date_key="20260816", dt_col="dt",
                                 target_dt=DAYS[-1], recent_days=7)}[variant]
    table = {c: df[c].tolist() for c in df.columns} if as_dict else df
    js, ps = RecordingSink(), RecordingSink()
    want = jdaodian_similar_job(df, embed_titles, embed_skus, js, **kw)
    got = daodian_similar_job(table, embed_titles, embed_skus, ps,
                              device="cpu", **kw)
    assert got == want
    assert ps.items == js.items and ps.items
    ttl = WEEK if variant == "v1" else DAY_AND_HALF
    assert {t for _, t in ps.items.values()} == {ttl}
    if variant != "v1":
        assert all(k.startswith("20260816:") for k in ps.items)
    if variant == "v2_recent_days":
        dt_of = dict(zip(df["spu_sn"], df["dt"]))
        assert all(dt_of[nb] == DAYS[-1] for v in got.values() for nb in v)


CATS = {10: {101: ("苹果 水果 新鲜", 200), 102: ("香蕉 水果 甜", 160)},
        20: {201: ("牛奶 乳品 醇香", 110), 202: ("酸奶 乳品 发酵", 60)}}


def _catalog(areas=(1, 2, 3), per=4):
    rows, i = [], 0
    for area in areas:
        for lv1, lv2s in CATS.items():
            for lv2, (words, _) in lv2s.items():
                for k in range(per):
                    rows.append({"area_id": area, "spu_sn": f"s{area}_{lv2}_{k}",
                                 "sku": str(1000 + i),
                                 "title": f"{words} 商品{i}号",
                                 "first_level_category_id": lv1,
                                 "second_level_category_id": lv2})
                    i += 1
    return pd.DataFrame(rows)


@pytest.fixture(scope="module")
def fasttext_pair():
    """A JAX fastText model trained on the catalog and its port carry-over
    (the same weights)."""
    df = _catalog()
    jft = JF.train_supervised(df["title"].tolist(),
                              df["second_level_category_id"].tolist(),
                              dim=16, epochs=8, bucket=2000, batch_size=32)
    pft = fasttext_from_jax(
        {k: np.asarray(v) for k, v in jft.params.items()}, jft.vocab.words,
        jft.vocab.bucket, jft.labels, jft.dim, jft.word_ngrams,
        jft.max_tokens, device="cpu")
    return jft, pft


def _cv_by_sku(df, dim=8):
    """One seeded vector per lv2 colour, jittered per sku: same-lv2
    variants are CV neighbours."""
    rng = np.random.default_rng(3)
    base = {lv2: rng.normal(size=dim) for lv2s in CATS.values()
            for lv2 in lv2s}
    return {sku: (base[lv2] + 0.05 * rng.normal(size=dim)).astype(np.float32)
            for sku, lv2 in zip(df["sku"], df["second_level_category_id"])}


def test_daodian_job_on_a_fasttext_catalog_matches_jax(fasttext_pair):
    df = _catalog()
    jft, pft = fasttext_pair
    vecs = _cv_by_sku(df)

    def embed_skus(area):
        return {sp: vecs[str(sk)] for sp, sk in zip(area["spu_sn"],
                                                    area["sku"])}

    js, ps = RecordingSink(), RecordingSink()
    want = jdaodian_similar_job(
        df, lambda t: jft.get_sentence_vector(list(t)), embed_skus, js,
        nlp_score_th=0.5, cv_score_th=0.8, date_key="20260816")
    got = daodian_similar_job(
        df, pft.get_sentence_vector, embed_skus, ps, nlp_score_th=0.5,
        cv_score_th=0.8, date_key="20260816", device="cpu")
    assert got == want and ps.items == js.items
    assert any(n.startswith("s1_101_") for n in got["s1_101_0"])


# -- the daemon ------------------------------------------------------------


def _daemon_corpus():
    """tests/test_daodian_serving.py's corpus."""
    return pd.DataFrame({
        "area_id": [1, 1, 1, 1, 2, 2, 2],
        "spu_sn": ["a1", "a2", "b1", "b2", "c1", "c2", "c3"],
        "sku": ["10", "11", "12", "13", "20", "21", "22"],
        "title": ["苹果 水果", "苹果 鲜果", "牛奶 乳品", "牛奶 盒装",
                  "可乐 饮料", "汽水 饮料", "果汁 饮料"],
        "first_level_category_id": [5, 5, 6, 6, 7, 7, 7],
        "second_level_category_id": [51, 51, 61, 61, 71, 71, 72]})


def _title_embedder(dim=16):
    vocab = {}
    rng = np.random.default_rng(7)

    def embed(titles):
        out = []
        for t in titles:
            toks = str(t).split() or ["_"]
            for x in toks:
                if x not in vocab:
                    vocab[x] = rng.standard_normal(dim).astype(np.float32)
            out.append(np.mean([vocab[x] for x in toks], axis=0))
        return np.stack(out)

    return embed


SKU_VECS = {s: v for s, v in zip(
    ["10", "11", "12", "20", "21", "22", "19"],
    np.random.default_rng(3).standard_normal((7, 8)).astype(np.float32))}
SKU_VECS["11"] = SKU_VECS["10"] + 0.01


def _embed_skus(area):
    return {str(sp): SKU_VECS[str(sk)]
            for sp, sk in zip(area["spu_sn"], area["sku"])
            if str(sk) in SKU_VECS}


def _image_vec(images):
    """The query-image stub: a solid image of sku 10's 'colour' embeds to
    sku 10's vector, anything else to sku 20's."""
    return np.stack([SKU_VECS["10"] if int(np.asarray(im)[0, 0, 0]) > 128
                     else SKU_VECS["20"] for im in images])


def _same_answer(got, want):
    """Equal answers: keys, counts and order exactly, scores within 1e-5
    (f32 sums in another order)."""
    strip = lambda a: {**a, "neighbors": [n["key"] for n in a["neighbors"]]}  # noqa: E731
    assert strip(got) == strip(want)
    np.testing.assert_allclose([n["score"] for n in got["neighbors"]],
                               [n["score"] for n in want["neighbors"]],
                               atol=1e-5)
    return got


def _services(**kw):
    df = _daemon_corpus()
    embed = _title_embedder()
    jsvc = JD.DaodianService(df, embed, _embed_skus,
                             embed_query_image=lambda im: _image_vec([im])[0],
                             **kw)
    psvc = D.DaodianService(df, embed, _embed_skus,
                            embed_query_images=_image_vec, device="cpu",
                            **kw)
    return jsvc, psvc


def test_daemon_answers_match_jax():
    jsvc, psvc = _services()
    try:
        for key in _daemon_corpus()["spu_sn"]:
            assert psvc.similar_key(key) == jsvc.similar_key(key)
        for q in (("苹果 水果", 5, 51, "1"), ("苹果 水果", 6, 61, "1"),
                  ("果汁", 7, 72, "2"), ("牛奶", 6.0, "61", 1)):
            _same_answer(psvc.similar_query(*q), jsvc.similar_query(*q))
        img = np.full((4, 4, 3), 250, np.uint8)
        got = _same_answer(
            psvc.similar_query("苹果 水果", 5, 51, "1", image=img),
            jsvc.similar_query("苹果 水果", 5, 51, "1", image=img))
        assert got["cv_neighbors"] >= 1
        assert [n["key"] for n in got["neighbors"]][:2] == ["a1", "a2"]
        item = {"spu_sn": "a9", "area_id": "1", "sku": "19",
                "title": "苹果 水果", "first_level_category_id": 5,
                "second_level_category_id": 51}
        moved = {"spu_sn": "a1", "area_id": "1", "sku": "10",
                 "title": "牛奶 乳品", "first_level_category_id": 6,
                 "second_level_category_id": 61}
        assert psvc.update([item, moved]) == jsvc.update([item, moved])
        new_area = dict(item, spu_sn="z1", area_id="9")
        assert psvc.update([new_area], rebuild=False) == jsvc.update(
            [new_area], rebuild=False)
        for key in ("a1", "a2", "a9", "b1", "c1", "z1"):
            assert psvc.similar_key(key) == jsvc.similar_key(key)
        assert psvc.n == jsvc.n and psvc.areas == jsvc.areas
        with pytest.raises(KeyError):
            psvc.similar_key("nope")
        with pytest.raises(KeyError):
            psvc.similar_query("x", 5, 51, area_id="99")
        with pytest.raises(ValueError, match="missing"):
            psvc.update([{"spu_sn": "q"}])
    finally:
        jsvc.close()
        psvc.close()


def test_daemon_keeps_large_integer_categories_apart():
    big = 2**53
    df = pd.DataFrame({"area_id": [1, 1, 1], "spu_sn": ["x", "y", "z"],
                       "sku": ["10", "20", "21"],
                       "title": ["苹果 水果", "苹果 水果", "苹果 水果"],
                       "first_level_category_id": [big, big + 1, big + 1],
                       "second_level_category_id": [1, 1, 1]})
    svc = D.DaodianService(df, _title_embedder(), _embed_skus, device="cpu")
    try:
        got = svc.similar_query("苹果 水果", big + 1, 1, "1")
        assert sorted(n["key"] for n in got["neighbors"]) == ["y", "z"]
    finally:
        svc.close()


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_daemon_http_round_trip():
    import cv2
    jsvc, psvc = _services()
    httpd = D.make_daodian_server(psvc, port=0, image_size=8)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {"ok": True, "corpus": 7,
                                            "areas": ["1", "2"]}
        for key in ("a1", "c3"):
            assert _post(f"{base}/similar", {"key": key}) == (
                200, jsvc.similar_key(key))
        ok, buf = cv2.imencode(".png", np.full((8, 8, 3), 250, np.uint8))
        st, got = _post(f"{base}/similar", {
            "title": "苹果 水果", "lv1": 5, "lv2": 51, "area_id": "1",
            "image_b64": base64.b64encode(buf.tobytes()).decode()})
        assert st == 200
        _same_answer(got, jsvc.similar_query(
            "苹果 水果", 5, 51, "1", image=np.full((8, 8, 3), 250, np.uint8)))
        assert got["cv_neighbors"] >= 1
        st, got = _post(f"{base}/update", {"items": [{
            "spu_sn": "z1", "area_id": "2", "sku": "22",
            "title": "果汁 饮料", "first_level_category_id": 7,
            "second_level_category_id": 72}]})
        assert st == 200 and got["corpus"] == 8
        st, got = _post(f"{base}/similar", {"key": "z1"})
        assert st == 200 and "c3" in got["neighbors"]
        assert _post(f"{base}/similar", {"title": "x"})[0] == 400
        assert _post(f"{base}/update", {"items": "nope"})[0] == 400
        assert _post(f"{base}/update", {"items": [{"spu_sn": "q"}],
                                        "rebuild": "false"})[0] == 400
        assert _post(f"{base}/similar", {"key": "missing-key"})[0] == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        jsvc.close()
        psvc.close()


# -- the commands ----------------------------------------------------------


@pytest.fixture(scope="module")
def models(tmp_path_factory, fasttext_pair):
    """The catalog on disk, the JAX model pickled, the port's saved."""
    d = tmp_path_factory.mktemp("ft")
    df = _catalog()
    data = str(d / "skus.csv")
    df.to_csv(data, index=False)
    jft, pft = fasttext_pair
    jpath, ppath = str(d / "ft.pkl"), str(d / "ft.pt")
    with open(jpath, "wb") as f:
        pickle.dump(jft, f)
    pft.save(ppath)
    return d, df, data, jpath, ppath


def _both(args, ppath):
    port = copy.copy(args)
    port.fasttext_model = ppath
    return args, port


def test_serve_fasttext_matches_jax(models):
    d, df, data, jpath, ppath = models
    jargs, pargs = _both(build_parser().parse_args(
        ["serve", "--tower", "fasttext", "--data", data, "--fasttext_model",
         jpath, "--text_col", "title", "--category_col",
         "first_level_category_id", "--k", "100", "--score_th", "-0.6"]),
        ppath)
    jsvc, jn = jserve._build_serve_service(jargs)
    psvc, pn = cli._build_serve_service(pargs, device="cpu")
    try:
        cli._warm_serve_service(psvc, pargs)
        assert pn == jn == len(df)
        for q in ("苹果 水果", "牛奶 乳品 醇香", "没有 这个"):
            want = jsvc.similar(q)
            got = psvc.similar(q)
            assert [g["key"] for g in got] == [w["key"] for w in want]
            np.testing.assert_allclose([g["score"] for g in got],
                                       [w["score"] for w in want],
                                       atol=1e-5)
        got = psvc.similar("苹果 水果 新鲜", category=10)
        assert [g["key"] for g in got] == [
            w["key"] for w in jsvc.similar("苹果 水果 新鲜", category=10)]
        assert got and all(g["key"].split("_")[1] in ("101", "102")
                           for g in got)
    finally:
        jsvc.close()
        psvc.close()
    # no title column: gen_title's layout, as the JAX command does
    gen = pd.DataFrame({"spu_sn": ["a", "b"], "product_name": ["苹果", "牛奶"],
                        "first_level_category_name": ["水果1", "乳品"],
                        "second_level_category_name": ["鲜果", "奶2"],
                        "product_title": ["新鲜 苹果", None]})
    pargs.category_col = None
    psvc, n = cli._build_serve_service(pargs, table=gen, device="cpu")
    psvc.close()
    assert n == 2
    with pytest.raises(SystemExit, match="gen_title"):
        cli._build_serve_service(pargs, table={"spu_sn": ["a"]},
                                 device="cpu")


def test_embed_fasttext_matches_jax(models, tmp_path):
    d, df, data, jpath, ppath = models
    for argv in (["incremental", "--kind", "fasttext"],
                 ["bulk", "--kinds", "fasttext"]):
        out = {}
        for who, path in (("jax", jpath), ("port", ppath)):
            table = str(tmp_path / f"{who}_{argv[0]}.parquet")
            args = build_parser().parse_args(
                ["embed", argv[0], "--data", data, "--table", table,
                 "--key_col", "spu_sn", "--text_col", "title",
                 "--fasttext_model", path, *argv[1:]])
            if who == "jax":
                fn = (jembed_cli.cmd_embed_incremental
                      if argv[0] == "incremental" else
                      jembed_cli.cmd_embed_bulk)
                fn(args)
            else:
                fn = (cli_embed.cmd_embed_incremental
                      if argv[0] == "incremental" else
                      cli_embed.cmd_embed_bulk)
                fn(args, device="cpu")
            out[who] = pd.read_parquet(table)
        j, p = out["jax"], out["port"]
        assert list(p.columns) == list(j.columns)
        assert p["spu_sn"].tolist() == j["spu_sn"].tolist() == df[
            "spu_sn"].tolist()
        col = [c for c in p.columns if "emb" in c][0]
        for a, b in zip(p[col], j[col]):
            np.testing.assert_allclose(
                np.array(a.strip("[]").split(","), np.float32),
                np.array(b.strip("[]").split(","), np.float32), atol=1e-6)


def test_serve_daodian_matches_jax(models):
    d, df, data, jpath, ppath = models
    jargs, pargs = _both(build_parser().parse_args(
        ["serve", "--tower", "daodian", "--data", data, "--fasttext_model",
         jpath, "--text_only"]), ppath)
    jsvc = jserve._build_daodian_service(jargs)
    psvc = cli._build_daodian_service(pargs, device="cpu")
    try:
        psvc.warm()
        psvc.warm_query_buckets()
        for key in df["spu_sn"][::5]:
            assert psvc.similar_key(key) == jsvc.similar_key(key)
        q = ("苹果 水果 新鲜", 10, 101, "2")
        _same_answer(psvc.similar_query(*q), jsvc.similar_query(*q))
    finally:
        jsvc.close()
        psvc.close()
    no_cv = copy.copy(pargs)
    no_cv.text_only = False
    with pytest.raises(SystemExit, match="cv_checkpoint"):
        cli._build_daodian_service(no_cv, device="cpu")
    for flag, value in (("score_th", 0.5), ("k", 20)):
        bad = copy.copy(pargs)
        setattr(bad, flag, value)
        with pytest.raises(SystemExit, match="merged tower"):
            cli.cmd_serve(bad, device="cpu")
    with pytest.raises(ValueError, match="_build_daodian_service"):
        cli._build_serve_service(pargs, device="cpu")


def test_serve_daodian_with_the_cv_arm(models, tmp_path):
    """--cv_checkpoint: the CV arm embeds each area's skus through the
    folded tower ({img_root}/{sku}/0.jpg, emb.txt caches written) and an
    ad-hoc image query through the micro-batched tower."""
    import cv2

    from multimodalsimilar_tpu_torch.models.vision import (CvImageClassifier,
                                                           backbone_config)
    from multimodalsimilar_tpu_torch.train.checkpoint import (
        CheckpointManager)
    d, df, data, jpath, ppath = models
    root = tmp_path / "img"
    for i, sku in enumerate(df["sku"][:24]):
        (root / str(sku)).mkdir(parents=True)
        cv2.imwrite(str(root / str(sku) / "0.jpg"),
                    np.full((20, 20, 3), 40 * (i % 6), np.uint8))
    model = CvImageClassifier(backbone_config("tiny"), 4, fc_dim=8,
                              generator=torch.Generator().manual_seed(0))
    CheckpointManager(str(tmp_path / "ckpt")).save(0, {
        "model": model.state_dict()})
    args = build_parser().parse_args(
        ["serve", "--tower", "daodian", "--data", data, "--fasttext_model",
         ppath, "--cv_checkpoint", str(tmp_path / "ckpt"),
         "--cv_num_labels", "4", "--backbone", "tiny", "--fc_dim", "8",
         "--image_size", "16", "--img_root", str(root)])
    svc = cli._build_daodian_service(args, device="cpu")
    try:
        svc.warm()
        svc.warm_query_buckets(args.image_size)
        assert (root / str(df["sku"][0]) / "emb.txt").exists()
        got = svc.similar_query("苹果 水果", 10, 101, "1",
                                image=np.zeros((16, 16, 3), np.uint8))
        assert got["cv_neighbors"] >= 1
    finally:
        svc.close()
