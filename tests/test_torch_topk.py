"""Streaming top-k: the port's plain version against the JAX package.

The plain version (``ops/topk.py:topk_plain``) is what the port runs on
CPU tensors and what ``chip_smoke.py`` holds the CUDA kernel against. Here
it is held against JAX ``knn_search`` and against the Pallas kernel
``pallas_topk`` in interpret mode, as ``tests/test_pallas_topk.py`` runs it:
indices exact, scores within 1e-5. The kernel itself runs only on a card
(``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalsimilar_tpu.ops.topk import pallas_topk
from multimodalsimilar_tpu.retrieval.knn import knn_search as jknn_search
from multimodalsimilar_tpu.retrieval.knn import pad_corpus as jpad_corpus
from multimodalsimilar_tpu_torch.ops import topk as T
from multimodalsimilar_tpu_torch.retrieval.knn import (knn_search,
                                                       l2_normalize_rows,
                                                       pad_corpus)

torch.set_num_threads(1)


def _jax(corpus, queries, k, metric, true_n=None, pallas=False):
    if pallas:
        v, i = pallas_topk(jnp.asarray(corpus), jnp.asarray(queries), k,
                           metric=metric, block_rows=64, tile_b=8,
                           interpret=True, true_n=true_n)
    else:
        v, i = jknn_search(jnp.asarray(corpus), jnp.asarray(queries), k,
                           metric=metric, block_rows=64, true_n=true_n)
    return np.asarray(v), np.asarray(i)


def _plain(corpus, queries, k, metric, true_n=None, block_rows=48):
    v, i = T.topk_plain(torch.from_numpy(corpus), torch.from_numpy(queries),
                        k, metric, true_n, block_rows=block_rows)
    return v.numpy(), i.numpy()


def _same(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pallas", [False, True], ids=["knn", "pallas"])
@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("n,b,k", [(200, 16, 5), (130, 40, 7), (37, 9, 50)])
def test_plain_matches_jax(metric, n, b, k, pallas):
    """Ragged n (not a block multiple) and k > n (k shrinks to n)."""
    rng = np.random.default_rng(0)
    corpus = rng.normal(size=(n, 32)).astype(np.float32)
    queries = rng.normal(size=(b, 32)).astype(np.float32)
    got = _plain(corpus, queries, k, metric)
    assert got[0].shape == (b, min(k, n)) and got[1].dtype == np.int32
    _same(got, _jax(corpus, queries, k, metric, pallas=pallas))


@pytest.mark.parametrize("pallas", [False, True], ids=["knn", "pallas"])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_plain_true_n_padding(metric, pallas):
    """A pre-padded corpus with true_n: pad rows (zeros for ip, 1e18 for
    l2, whose square overflows f32) never come back. ip scores are all
    negative, so an unmasked zero row would win."""
    rng = np.random.default_rng(11)
    corpus = -np.abs(rng.normal(size=(203, 16))).astype(np.float32) - 0.1
    queries = np.abs(rng.normal(size=(9, 16))).astype(np.float32) + 0.1
    padded, true_n = pad_corpus(corpus, 64, metric)
    jpadded, jtrue_n = jpad_corpus(corpus, 64, metric)
    np.testing.assert_array_equal(padded, jpadded)
    assert (padded.shape[0], true_n) == (256, 203) == (256, jtrue_n)
    got = _plain(padded, queries, 9, metric, true_n)
    assert got[1].max() < true_n
    _same(got, _jax(padded, queries, 9, metric, true_n, pallas=pallas))
    # k past the real rows shrinks to true_n, not to the padded length
    v, i = _plain(padded, queries, 250, metric, true_n)
    assert v.shape == (9, 203) and i.max() < 203


@pytest.mark.parametrize("pallas", [False, True], ids=["knn", "pallas"])
@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_plain_ties_go_to_lowest_index(metric, pallas):
    """Small-integer rows, so every score is exact, with duplicate rows
    across block boundaries: equal scores come back in ascending index."""
    rng = np.random.default_rng(3)
    corpus = rng.integers(-2, 3, size=(300, 8)).astype(np.float32)
    corpus[37] = corpus[211]
    corpus[64] = corpus[0]
    corpus[299] = corpus[0]
    queries = np.concatenate([corpus[:4], rng.integers(
        -2, 3, size=(12, 8)).astype(np.float32)])
    got = _plain(corpus, queries, 12, metric)
    _same(got, _jax(corpus, queries, 12, metric, pallas=pallas))
    # the duplicated row 0 comes back as 0, 64, 299 in that order
    if metric == "ip":
        row0 = list(got[1][0])
        assert row0.index(0) < row0.index(64) < row0.index(299)


def test_tie_break_eye_matches_pallas_case():
    corpus = np.tile(np.eye(4, dtype=np.float32), (3, 1))
    queries = np.eye(4, dtype=np.float32)
    _, i = _plain(corpus, queries, 3, "ip", block_rows=4)
    np.testing.assert_array_equal(i[0], [0, 4, 8])


def test_block_size_does_not_change_results():
    rng = np.random.default_rng(5)
    corpus = rng.integers(-2, 3, size=(500, 8)).astype(np.float32)
    queries = rng.integers(-2, 3, size=(20, 8)).astype(np.float32)
    want = _plain(corpus, queries, 17, "ip", block_rows=500)
    for block in (1, 7, 64, 128):
        got = _plain(corpus, queries, 17, "ip", block_rows=block)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])


def test_knn_search_dispatches_cpu_tensors_to_plain():
    rng = np.random.default_rng(1)
    corpus = torch.from_numpy(rng.normal(size=(50, 8)).astype(np.float32))
    before = T.LAUNCHES["topk"]
    v, i = knn_search(l2_normalize_rows(corpus), l2_normalize_rows(corpus), 3)
    assert T.LAUNCHES["topk"] == before          # no kernel on the CPU
    np.testing.assert_array_equal(i[:, 0].numpy(), np.arange(50))
    np.testing.assert_allclose(v[:, 0].numpy(), 1.0, atol=1e-5)
    empty = knn_search(corpus, corpus[:0], 3)
    assert empty[0].shape == (0, 3)


def test_l2_normalize_matches_jax():
    from multimodalsimilar_tpu.retrieval.knn import l2_normalize_rows as jn
    x = np.random.default_rng(2).normal(size=(7, 5)).astype(np.float32)
    x[3] = 0.0
    np.testing.assert_allclose(l2_normalize_rows(torch.from_numpy(x)).numpy(),
                               np.asarray(jn(jnp.asarray(x))), atol=1e-7)


def test_plan_splits_covers_corpus_and_fills_card():
    for q, n in [(4096, 262_144), (50_000, 50_000), (1, 100), (300, 5000),
                 (20_000, 32_668)]:
        splits, rows = T.plan_splits(q, n, 132)
        assert splits >= 1 and rows % T.CHUNK_ROWS == 0
        assert (splits - 1) * rows < n <= splits * rows
    assert T.plan_splits(4096, 262_144, 132)[0] > 1      # small Q: split
    assert T.plan_splits(50_000, 50_000, 132)[0] == 1    # big Q: one pass
    # one block per SM: 32 query tiles x 4 splits fill 132 SMs in one wave
    splits, _ = T.plan_splits(4096, 262_144, 132)
    tiles = -(-4096 // T.QUERY_TILE)
    assert tiles * splits <= 132 < tiles * (splits + 1)
    assert T.plan_splits(32_768, 50_000, 132)[0] == 1    # the job's chunk


@pytest.mark.parametrize("q,want_ms,want_by", [
    (4096, 2 * 4096 * 262_144 * 768 / 165e12 * 1e3, "operations"),
    (64, 4 * (64 + 262_144) * 768 / 3.35e12 * 1e3 + 8 * 64 * 13 / 3.35e9,
     "bytes")], ids=["main", "serving"])
def test_bound_is_operations_at_main_shape(q, want_ms, want_by):
    """The bound is the card's fastest f32-accurate route: 3xTF32 on the
    tensor cores, 495 / 3 = 165 TFLOP/s (10.0 ms at the main shape); a
    64-query search is bound by reading the corpus (0.240 ms)."""
    ms, by = T.bound_ms(q, 262_144, 768, 13)
    assert by == want_by
    assert ms == pytest.approx(want_ms)
    assert round(ms, 1 if q == 4096 else 3) == (10.0 if q == 4096 else 0.240)
    # the older CUDA-core figure stays available under its own rate
    assert T.bound_ms(4096, 262_144, 768, 13, flops_rate=T.H100_F32_FLOPS
                      )[0] == pytest.approx(24.62, abs=0.01)


def test_kernel_rejects_cpu_tensors_and_bad_metric():
    x = torch.zeros((10, 4))
    with pytest.raises(ValueError, match="not a CUDA device"):
        T.topk_cuda(x, x, 3)
    with pytest.raises(ValueError, match="unknown metric"):
        T.streaming_topk(x, x, 3, metric="cos")

