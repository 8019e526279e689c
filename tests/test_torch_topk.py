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



@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("q,n,k,true_n", [
    (150, 150, 150, None),          # k = n: the whole area ranked
    (150, 150, 150 // 7, None),     # k = n // recent_days
    (1, 150, 150, None),            # one ad-hoc query
    (40, 192, 300, 171),            # k past true_n, padded corpus
    (37, 37, 37, None)],            # k = n_c, one category group
    ids=["k_n", "k_n7", "q1", "padded", "group"])
def test_large_k_cpu_route_matches_jax(metric, q, n, k, true_n):
    """The CPU route at the daodian depths (k > 128 or k = n), duplicate
    rows included, against JAX ``knn_search``: indices exact, scores
    within 1e-5."""
    rng = np.random.default_rng(n + k)
    corpus = rng.normal(size=(n, 16)).astype(np.float32)
    corpus[n // 2: n // 2 + 5] = corpus[:5]            # exact ties
    queries = corpus[:q].copy()
    got = knn_search(torch.from_numpy(corpus), torch.from_numpy(queries), k,
                     metric, true_n=true_n)
    want = _jax(corpus, queries, k, metric, true_n=true_n)
    assert got[0].shape == (q, min(k, true_n or n))
    _same((got[0].numpy(), got[1].numpy()), want)


def _ordered(scores: np.ndarray) -> np.ndarray:
    """``csrc/topk_select.cu``'s order-preserving uint32 of each score
    (-0.0 made +0.0, NaN the largest)."""
    s = np.where(scores == 0, np.float32(0), scores).astype(np.float32)
    u = s.view(np.uint32).astype(np.uint64)
    o = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    return np.where(np.isnan(s), 0xFFC00000, o).astype(np.uint64)


def _chunk_top(vals: np.ndarray, cols: np.ndarray, m: int):
    """One chunk in the kernel: where m is at most half the chunk, the
    radix select of the m-th key (8-bit digits from the top) and the
    compaction in column order; then the stable sort, value descending."""
    if 2 * m <= len(vals):
        prefix, mask, need = 0, 0, m
        for shift in (24, 16, 8, 0):
            match = vals[(vals & mask) == prefix]
            hist = np.bincount(((match >> shift) & 255).astype(np.int64),
                               minlength=256)
            run, d = 0, 255
            while run + hist[d] < need:
                run += hist[d]
                d -= 1
            need -= run
            prefix |= d << shift
            mask |= 255 << shift
        eq = vals == prefix
        keep = (vals > prefix) | (eq & (np.cumsum(eq) - eq < need))
        vals, cols = vals[keep], cols[keep]
        assert len(vals) == m
    order = np.argsort(0xFFFFFFFF - vals, kind="stable")[:m]
    return vals[order], cols[order]


def _select_emulated(scores: np.ndarray, k: int, chunk: int) -> np.ndarray:
    """The kernel's algorithm on one row: each chunk's best min(k, len)
    (``_chunk_top``), merged with the running top-k by rank as uint64
    keys (the value above the complemented column), k kept. Returns the
    selected columns."""
    vals = _ordered(scores)
    run = np.zeros(0, np.uint64)
    for base in range(0, len(vals), chunk):
        part_v = vals[base: base + chunk]
        v, c = _chunk_top(part_v, np.arange(base, base + len(part_v)),
                          min(k, len(part_v)))
        part = (v << np.uint64(32)) | (np.uint64(0xFFFFFFFF)
                                       - c.astype(np.uint64))
        out = np.zeros(min(k, len(run) + len(part)), np.uint64)
        for j, x in enumerate(run):       # place = own rank + larger others
            pos = j + int((part > x).sum())
            if pos < len(out):
                out[pos] = x
        for j, y in enumerate(part):
            pos = j + int((run > y).sum())
            if pos < len(out):
                out[pos] = y
        run = out
    return (np.uint64(0xFFFFFFFF) - (run & np.uint64(0xFFFFFFFF))).astype(
        np.int64)


@pytest.mark.parametrize("k,chunk", [(57, 1024), (57, 16), (300, 64),
                                     (300, 7), (20, 64), (5, 1024),
                                     (149, 300)])
def test_selection_algorithm_is_the_stable_descending_sort(k, chunk):
    """The selection kernel's key order, radix select, compaction and
    chunked merge, emulated on the CPU: the same columns as
    ``torch.sort(descending, stable)``, with -0.0 tied to +0.0 by index,
    -inf below every finite score, +inf above and NaN first. Repeated
    specials put ties at the selected threshold."""
    rng = np.random.default_rng(k + chunk)
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.5, -2.0],
                        np.float32)
    row = np.where(rng.random(300) < 0.4, rng.choice(specials, 300),
                   rng.normal(size=300)).astype(np.float32)
    want = torch.sort(torch.from_numpy(row), descending=True,
                      stable=True)[1][:k].numpy()
    np.testing.assert_array_equal(_select_emulated(row, k, chunk), want)


def test_f32_products_are_f32_accurate_with_tf32_on(monkeypatch):
    """``f32_products`` under ``allow_tf32 = True``: the big parts are
    exact in TF32 and big + small gives each operand back exactly; with
    every product operand cut to TF32 as the tensor cores take it, the
    split stays within f32 error of the f64 product where one TF32
    product does not. On the CPU the flag's path runs with exact f32
    products."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.normal(size=(64, 100)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(300, 100)).astype(np.float32))
    want = q.double() @ x.double().T
    qb, xb = T._tf32_big(q), T._tf32_big(x)
    assert int((qb.view(torch.int32) & 8191).abs().sum()) == 0
    assert torch.equal(qb + (q - qb), q) and torch.equal(xb + (x - xb), x)
    cut = T._tf32_big                    # truncation: worse than rounding
    split = (cut(qb) @ cut(x - xb).T + cut(q - qb) @ cut(xb).T
             + cut(qb) @ cut(xb).T)
    scale = float(want.abs().max())
    assert float((split.double() - want).abs().max()) < 1e-6 * scale
    assert float((cut(q) @ cut(x).T - want).abs().max()) > 1e-4 * scale
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    got = T.f32_products(q, x)
    assert float((got.double() - want).abs().max()) < 1e-6 * scale


def test_query_chunk_plan_counts_the_large_k_route(monkeypatch):
    """``plan_query_chunk``'s arithmetic with a stubbed free-memory
    figure: half the free bytes over ``query_bytes``, which for k > 128
    counts the query's [n] f32 product row and, past one selection chunk,
    the two running lists of k uint64 keys."""
    from multimodalsimilar_tpu_torch.retrieval import knn
    free = 8 * 2**30
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev: (free, 0))
    dev = torch.device("cuda")
    assert knn.query_bytes(262_144, 768, 13) == 4 * 768 + 32 * 13
    assert knn.query_bytes(8300, 100, 8300) == 400 + 8 * 8300 + 4 * 8300
    assert knn.query_bytes(30_000, 100, 30_000) == (
        400 + 8 * 30_000 + 4 * 30_000 + 16 * 30_000)
    for n, d, k in [(8300, 100, 8300), (8300, 100, 8300 // 7),
                    (30_000, 100, 30_000), (262_144, 768, 13)]:
        got = knn.plan_query_chunk(n, d, k, dev, cap=32_768)
        assert got == int(min(32_768, free // 2 // knn.query_bytes(n, d, k)))
    # an 8.3k self-search at k = n: 100 KB a query, so ~43k queries fit
    # in 4 GiB and the cap holds; at 80 MB free the plan shrinks to 400
    assert knn.plan_query_chunk(8300, 100, 8300, dev, 32_768) == 32_768
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda dev: (80 * 10**6, 0))
    assert knn.plan_query_chunk(8300, 100, 8300, dev, 32_768) == 400
    assert knn.plan_query_chunk(8300, 100, 8300, "cpu", 32_768) == 32_768
