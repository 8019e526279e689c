"""SimilarityEngine: the port (device='cpu') against the JAX engine.

Same embeddings, keys and calls on both sides: self-search and external
queries, upserts that replace rows and append past the padding tail,
search_device, and similar_map with a threshold and a cap. Indices must be
equal and scores within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalsimilar_tpu.retrieval.engine import (
    SimilarityEngine as JEngine)
from multimodalsimilar_tpu.retrieval.filters import FilterRules as JRules
from multimodalsimilar_tpu_torch.retrieval.engine import SimilarityEngine
from multimodalsimilar_tpu_torch.retrieval.filters import (
    FilterRules, filter_neighbors, merge_neighbor_maps)

torch.set_num_threads(1)


def _pair(emb, keys, **kw):
    return JEngine(emb, keys, **kw), SimilarityEngine(emb, keys,
                                                      device="cpu", **kw)


def _same(got, want):
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric,normalize", [("ip", True), ("l2", False)])
def test_search_self_and_external(metric, normalize):
    rng = np.random.default_rng(11)
    emb = rng.normal(size=(130, 16)).astype(np.float32)
    keys = [f"k{i}" for i in range(130)]
    jeng, teng = _pair(emb, keys, metric=metric, normalize=normalize)
    _same(teng.search(7), jeng.search(7))
    queries = rng.normal(size=(9, 16)).astype(np.float32)
    _same(teng.search(5, queries=queries), jeng.search(5, queries=queries))
    # tensors are normalized on the device, numpy on the host: same answer
    _same(teng.search(5, queries=torch.from_numpy(queries)),
          jeng.search(5, queries=queries))
    # k past the corpus shrinks to n
    assert teng.search(500)[0].shape == (130, 130)


def test_small_corpus_negative_scores_never_return_pad_rows():
    """A 10-row corpus at k=10 has negative cosines in its tail; the cached
    block-padded corpus's zero rows must never displace them."""
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(10, 16)).astype(np.float32)
    jeng, teng = _pair(emb, list(range(10)), metric="ip")
    got = teng.search(10)
    assert got[0].min() < 0 and got[1].max() < 10
    _same(got, jeng.search(10))


def test_search_device_matches_and_stays_on_device():
    rng = np.random.default_rng(4)
    emb = rng.normal(size=(60, 12)).astype(np.float32)
    jeng, teng = _pair(emb, list(range(60)))
    queries = rng.normal(size=(6, 12)).astype(np.float32)
    v, i = teng.search_device(4, queries)
    assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
    _same((v.numpy(), i.numpy()), jeng.search_device(4, jnp.asarray(queries)))


@pytest.mark.parametrize("metric,normalize", [("ip", True), ("l2", False)])
def test_update_replace_and_append_matches_jax(metric, normalize):
    rng = np.random.default_rng(11)
    emb = rng.normal(size=(40, 12)).astype(np.float32)
    keys = [f"k{i}" for i in range(40)]
    jeng, teng = _pair(emb, keys, metric=metric, normalize=normalize)
    queries = rng.normal(size=(7, 12)).astype(np.float32)
    teng.search(5, queries=queries)                 # warm the device cache
    jeng.search(5, queries=queries)
    upd = rng.normal(size=(7, 12)).astype(np.float32)
    upd_keys = ["k3", "k17", "k39"] + [f"n{i}" for i in range(4)]
    assert teng.update(upd, upd_keys) == jeng.update(upd, upd_keys) == (3, 4)
    assert teng.keys == jeng.keys and teng.n == 44
    _same(teng.search(6, queries=queries), jeng.search(6, queries=queries))
    _same(teng.search(4), jeng.search(4))


@pytest.mark.parametrize("metric,normalize", [("ip", True), ("l2", False)])
def test_update_grows_past_device_padding(metric, normalize):
    """512 rows fill the cached block exactly, so the first append grows
    the device corpus by a block (l2 pad rows must still never win)."""
    rng = np.random.default_rng(5)
    n, d = 512, 8
    emb = rng.normal(size=(n, d)).astype(np.float32)
    keys = [f"k{i}" for i in range(n)]
    jeng, teng = _pair(emb, keys, metric=metric, normalize=normalize)
    queries = rng.normal(size=(5, d)).astype(np.float32)
    teng.search(3, queries=queries)
    jeng.search(3, queries=queries)
    assert teng._corpus_dev[0].shape[0] == n
    app = rng.normal(size=(9, d)).astype(np.float32)
    new = [f"n{i}" for i in range(9)]
    assert teng.update(app, new) == jeng.update(app, new) == (0, 9)
    corpus_dev, true_n, block = teng._corpus_dev
    assert corpus_dev.shape[0] % block == 0 and true_n == n + 9
    _same(teng.search(7, queries=queries), jeng.search(7, queries=queries))


def test_update_metadata_and_validation():
    emb = np.eye(6, dtype=np.float32)
    kw = dict(categories=["a", "a", "b", "b", "a", "b"], dts=["d1"] * 6)
    jeng, teng = _pair(emb, [f"k{i}" for i in range(6)], **kw)
    for eng in (jeng, teng):
        eng.update(np.eye(6, dtype=np.float32)[[0, 2]], ["k0", "x"],
                   categories=["b", "a"], dts=["d2", "d1"])
    assert teng.categories == jeng.categories and teng.dts == jeng.dts
    rules = FilterRules(same_category=True)
    assert teng.similar_map(7, rules) == jeng.similar_map(
        7, JRules(same_category=True))
    with pytest.raises(ValueError, match="dim mismatch"):
        teng.update(np.ones((1, 9), np.float32), ["a"],
                    categories=["a"], dts=["d"])
    with pytest.raises(ValueError, match="duplicate keys"):
        teng.update(np.ones((2, 6), np.float32), ["z", "z"],
                    categories=["a", "a"], dts=["d", "d"])
    with pytest.raises(ValueError, match="categories"):
        teng.update(np.ones((1, 6), np.float32), ["z"])


@pytest.mark.parametrize("threshold,cap,same_category", [
    (0.3, None, False), (None, 3, True), (0.1, 2, True)])
def test_similar_map_matches_jax(threshold, cap, same_category):
    rng = np.random.default_rng(9)
    base = rng.normal(size=(3, 16))
    emb = np.concatenate([b + 0.3 * rng.normal(size=(20, 16))
                          for b in base]).astype(np.float32)
    keys = [f"sku{i}" for i in range(60)]
    keys[7] = keys[3]                    # a duplicate key is dropped
    cats = [i // 20 for i in range(60)]
    cats[11] = None                      # a missing category never matches
    jeng, teng = _pair(emb, keys, categories=cats)
    kw = dict(score_threshold=threshold, same_category=same_category,
              max_neighbors=cap)
    got = teng.similar_map(10, FilterRules(**kw))
    want = jeng.similar_map(10, JRules(**kw))
    assert got == want and any(got.values())


def test_filters_without_pandas_match_jax_filters():
    """The port factorizes with a dict instead of pandas.factorize: mixed
    types, NaN and None behave the same."""
    from multimodalsimilar_tpu.retrieval.filters import (
        filter_neighbors as jfilter)
    rng = np.random.default_rng(0)
    keys = ["a", 1, 1.0, "b", float("nan"), float("nan"), None, "c"]
    cats = [1, "x", float("nan"), 1, "x", None, 1, "x"]
    dts = ["d1", "d2", "d1", None, "d1", "d1", "d2", "d1"]
    scores = rng.random((8, 6)).astype(np.float32)
    idx = rng.integers(-1, 9, size=(8, 6))
    for rules in (FilterRules(score_threshold=0.2, same_category=True),
                  FilterRules(same_category=False, max_neighbors=2,
                              require_dt="d1")):
        jr = JRules(**vars(rules))
        got = filter_neighbors(scores, idx, keys, cats, rules, dts=dts,
                               return_lists=True)
        want = jfilter(scores, idx, keys, cats, jr, dts=dts,
                       return_lists=True)
        assert [[str(x) for x in r] for r in got] == \
            [[str(x) for x in r] for r in want]


def test_merge_cv_first_then_nlp():
    got = merge_neighbor_maps({"a": ["x", "y"], "b": []},
                              {"a": ["y", "z"], "b": ["w"]}, cap=3)
    assert got == {"a": ["x", "y", "z"], "b": ["w"]}
    assert SimilarityEngine.merge({"a": ["x"]}, {"a": ["z"]}) == \
        {"a": ["x", "z"]}
