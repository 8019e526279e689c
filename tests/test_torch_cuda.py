"""Tests that need an NVIDIA GPU: the CUDA kernels against their plain
versions, and the port's entry points on the card.

They skip without a card. This file imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import math

import numpy as np
import pytest
import torch

from multimodalsimilar_tpu_torch.ops import arcface as A
from multimodalsimilar_tpu_torch.ops import topk as T
from multimodalsimilar_tpu_torch.retrieval.engine import SimilarityEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ints(rng, shape, dev):
    return torch.from_numpy(rng.integers(-3, 4, size=shape)
                            .astype(np.float32)).to(dev)


@pytest.mark.parametrize("k", [1, 13, 101, 128])
@pytest.mark.parametrize("d", [96, 100, 37])
@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("q", [1, 300, 20_000], ids=["q1", "q300", "q20k"])
def test_kernel_equals_plain_on_exact_data(dev, metric, q, d, k):
    """Small-integer rows make every score exact (3xTF32 included: the
    small parts are 0), so results must be identical, ties (duplicate
    rows) included. q picks the split and the unsplit launch; d = 100 is
    not a multiple of the 32-deep slice, d = 37 not of the 16-byte copy;
    k = 128 leaves room for one consumer warpgroup only."""
    rng = np.random.default_rng(0)
    corpus = _ints(rng, (5000, d), dev)
    corpus[100:200] = corpus[:100]
    queries = _ints(rng, (q, d), dev)
    queries[:1] = corpus[:1]
    got = T.topk_cuda(corpus, queries, k, metric, true_n=4900)
    want = T.topk_plain(corpus, queries, k, metric, true_n=4900)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert int(got[1].max()) < 4900


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("q,n,d,k", [(1, 70_000, 768, 13),
                                     (300, 20_011, 100, 128),
                                     (1000, 50_000, 768, 101)])
def test_kernel_matches_plain_on_unit_rows(dev, metric, q, n, d, k):
    """Unit rows, as the job searches them. Scores within atol 1e-4, rtol
    1e-5 (3xTF32 is f32-accurate, the sums run in another order); indices
    equal wherever the plain version's neighbouring scores are more than
    1e-5 apart (closer ones may swap)."""
    rng = np.random.default_rng(q + n + d)
    corpus = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32))
    queries = torch.from_numpy(rng.standard_normal((q, d), dtype=np.float32))
    corpus = (corpus / corpus.norm(dim=1, keepdim=True)).to(dev)
    queries = (queries / queries.norm(dim=1, keepdim=True)).to(dev)
    gv, gi = T.topk_cuda(corpus, queries, k, metric)
    pv, pi = T.topk_plain(corpus, queries, k + 1, metric)
    torch.cuda.synchronize()
    assert torch.allclose(gv, pv[:, :k], atol=1e-4, rtol=1e-5)
    gap = (pv[:, 1:] - pv[:, :-1]).abs()
    inf = torch.full((q, 1), float("inf"), device=dev)
    sep = (torch.cat([inf, gap], 1)[:, :k] > 1e-5) & (gap[:, :k] > 1e-5)
    assert not ((gi != pi[:, :k]) & sep).any()


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("q,n,k", [(1, 20_000, 13), (4096, 20_000, 13)],
                         ids=["q1", "q4096"])
def test_kernel_at_the_deepseek_tower_width(dev, metric, q, n, k):
    """D = 2,048, the DeepSeek-V2 tower's embeddings (wider than any
    search before it): small-integer rows exactly, as above, and unit
    rows within the tolerances above."""
    rng = np.random.default_rng(q + n)
    corpus = _ints(rng, (n, 2048), dev)
    corpus[100:200] = corpus[:100]
    queries = _ints(rng, (q, 2048), dev)
    got = T.topk_cuda(corpus, queries, k, metric, true_n=n - 7)
    want = T.topk_plain(corpus, queries, k, metric, true_n=n - 7)
    torch.cuda.synchronize()
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    corpus = corpus / corpus.norm(dim=1, keepdim=True)
    queries = queries / queries.norm(dim=1, keepdim=True)
    gv, gi = T.topk_cuda(corpus, queries, k, metric)
    pv, pi = T.topk_plain(corpus, queries, k + 1, metric)
    torch.cuda.synchronize()
    assert torch.allclose(gv, pv[:, :k], atol=1e-4, rtol=1e-5)
    gap = (pv[:, 1:] - pv[:, :-1]).abs()
    inf = torch.full((q, 1), float("inf"), device=dev)
    sep = (torch.cat([inf, gap], 1)[:, :k] > 1e-5) & (gap[:, :k] > 1e-5)
    assert not ((gi != pi[:, :k]) & sep).any()


def test_grouped_experts_match_the_plain_loop(dev):
    """``ops/moe.py`` on the card (``torch._grouped_mm``) against its CPU
    loop over the experts on the same routing, bfloat16 operands,
    experts 12-15 with no row: within bf16's rounding of the outputs."""
    from multimodalsimilar_tpu_torch.ops import moe
    g = torch.Generator().manual_seed(0)
    T_, H, inter, E, k = 300, 256, 128, 16, 6
    x = torch.randn(T_, H, generator=g).bfloat16()
    x[:, 0] = 1.0
    gate = torch.randn(E, H, generator=g)
    gate[12:, 0] = -1e3
    gate_up = (torch.randn(E, 2 * inter, H, generator=g) / 16).bfloat16()
    down = (torch.randn(E, H, inter, generator=g) / 11).bfloat16()
    w, e = moe.route(x, gate, k)
    assert int(e.max()) < 12
    out = {}
    for d in ("cpu", dev):
        p = moe.plan(e.to(d), E)
        out[str(d)] = (moe.combine(moe.grouped_mlp(
            x.to(d), p, gate_up.to(d), down.to(d)), p, w.to(d)).float().cpu(),
            p.ends.cpu())
    (got, ends), (want, ends_cpu) = out[str(dev)], out["cpu"]
    assert torch.equal(ends, ends_cpu) and int(ends[11]) == int(ends[-1])
    assert torch.allclose(got, want, atol=0.02 * float(want.abs().max()),
                          rtol=0.02)


def test_deepseek_tower_does_not_synchronise(dev):
    """A tiny DeepSeek-V2 tower's call in bfloat16 on the card: no
    stream synchronisation (``torch.cuda.set_sync_debug_mode``) after the
    first call of a length, and two grouped launches a MoE layer."""
    import warnings

    from multimodalsimilar_tpu_torch.models.deepseek_v2 import (
        DeepseekV2Config, DeepseekV2Tower)
    from multimodalsimilar_tpu_torch.utils import profiling
    cfg = DeepseekV2Config.tiny()
    with torch.device(dev):
        tower = DeepseekV2Tower(
            cfg, generator=torch.Generator(device=dev).manual_seed(0))
    ids = torch.randint(0, 400, (8, 19), device=dev)
    mask = torch.ones_like(ids)
    with torch.no_grad():
        tower.predict_emb(ids, mask)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught, \
                    profiling.recording() as rec:
                warnings.simplefilter("always")
                tower.predict_emb(ids, mask)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    assert not syncs, [str(w.message) for w in syncs]
    layers = cfg.num_hidden_layers - cfg.first_k_dense_replace
    assert rec.counters["moe.launches"] == layers


def test_kernel_counts_launches_and_validates(dev):
    x = torch.randn(300, 40, device=dev)
    before = T.LAUNCHES["topk"]
    T.streaming_topk(x, x, 5)
    assert T.LAUNCHES["topk"] == before + 1
    with pytest.raises(ValueError, match="k <= 128"):
        T.topk_cuda(x, x, 129)
    with pytest.raises(ValueError, match="float32"):
        T.topk_cuda(x.half(), x.half(), 5)
    with pytest.raises(ValueError, match="contiguous"):
        T.topk_cuda(x, x.t().contiguous().t(), 5)
    with pytest.raises(ValueError, match="not a CUDA device"):
        T.topk_cuda(x.cpu(), x, 5)


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("q,n,k", [(1, 300, 300), (50, 5000, 129),
                                   (20, 5000, 5000), (3, 16_384, 16_384),
                                   (8, 40_000, 40_000), (8, 40_000, 1000),
                                   (5, 33_000, 200)])
def test_select_route_equals_plain_on_exact_data(dev, metric, q, n, k):
    """The large-k route (products + csrc/topk_select.cu) on small-integer
    rows, where every score is exact: identical to the plain version,
    ties (duplicate rows) in index order, padding rows never returned.
    n = 16,384 is one whole chunk; 33,000 and 40,000 are merged chunks."""
    rng = np.random.default_rng(q + n + k)
    corpus = _ints(rng, (n, 24), dev)
    corpus[n // 2: n // 2 + 100] = corpus[:100]
    true_n = n - 7
    queries = _ints(rng, (q, 24), dev)
    queries[:1] = corpus[:1]
    before = T.LAUNCHES["topk_select"]
    got = T.streaming_topk(corpus, queries, k, metric, true_n=true_n)
    want = T.topk_plain(corpus, queries, k, metric, true_n=true_n)
    torch.cuda.synchronize()
    assert T.LAUNCHES["topk_select"] == before + 1
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    assert int(got[1].max()) < true_n


@pytest.mark.parametrize("n", [37, 5000, 20_000])
def test_select_kernel_orders_zeros_infinities_and_nan(dev, n):
    """-0.0 ties with +0.0 by index, -inf ranks below every finite score,
    +inf above, NaN first (torch.sort's descending order), on scores
    handed to the kernel directly."""
    rng = np.random.default_rng(n)
    vals = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.5, -2.0],
                    np.float32)
    s = torch.from_numpy(rng.choice(vals, size=(4, n))).to(dev)
    got_v, got_i = T.select_cuda(s.contiguous(), n)
    want_v, want_i = torch.sort(s, dim=1, descending=True, stable=True)
    torch.cuda.synchronize()
    assert torch.equal(got_i.long(), want_i)
    same = (got_v == want_v) | (torch.isnan(got_v) & torch.isnan(want_v))
    assert bool(same.all())


def test_select_kernel_validates(dev):
    s = torch.randn(3, 10, device=dev)
    with pytest.raises(ValueError, match="k <= n"):
        T.select_cuda(s, 11)
    with pytest.raises(ValueError, match="contiguous"):
        T.select_cuda(s.t(), 2)
    with pytest.raises(ValueError, match="float32"):
        T.select_cuda(s.double(), 2)


@pytest.mark.parametrize("n,k", [(5000, 700), (20_000, 1000),
                                 (40_000, 129)])
def test_select_kernel_orders_specials_through_the_radix_select(dev, n, k):
    """At k <= n / 2 (per chunk) the kernel selects the k-th key before
    sorting: with many equal specials (-0.0 and +0.0, infinities, NaN)
    the threshold falls among ties, which go by index as in torch.sort."""
    rng = np.random.default_rng(n + k)
    vals = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.5, -2.0],
                    np.float32)
    row = np.where(rng.random((4, n)) < 0.5, rng.choice(vals, (4, n)),
                   rng.normal(size=(4, n))).astype(np.float32)
    s = torch.from_numpy(row).to(dev)
    got_v, got_i = T.select_cuda(s, k)
    want_v, want_i = torch.sort(s, dim=1, descending=True, stable=True)
    torch.cuda.synchronize()
    assert torch.equal(got_i.long(), want_i[:, :k])
    want_v = want_v[:, :k]
    same = (got_v == want_v) | (torch.isnan(got_v) & torch.isnan(want_v))
    assert bool(same.all())


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_select_route_is_f32_accurate_with_tf32_on(dev, metric):
    """A process that turns TF32 on (``set_float32_matmul_precision
    ('high')``) still gets f32-accurate products on the large-k route:
    the same answer as with TF32 off, within phase 1's tolerances."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(3000, 100)).astype(np.float32))
    x = (x / x.norm(dim=1, keepdim=True)).to(dev)
    want = T.topk_select_cuda(x, x[:64], 3000, metric)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = T.topk_select_cuda(x, x[:64], 3000, metric)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.synchronize()
    assert torch.allclose(got[0], want[0], atol=1e-4, rtol=1e-5)
    gap = (want[0][:, 1:] - want[0][:, :-1]).abs()
    sep = torch.ones_like(want[0], dtype=torch.bool)
    sep[:, 1:] &= gap > 1e-5
    sep[:, :-1] &= gap > 1e-5
    assert bool((got[1] == want[1])[sep].all())


def test_engine_on_card_matches_engine_on_cpu(dev):
    rng = np.random.default_rng(1)
    emb = rng.normal(size=(3000, 64)).astype(np.float32)
    keys = [f"k{i}" for i in range(3000)]
    gpu = SimilarityEngine(emb, keys, device=dev)
    cpu = SimilarityEngine(emb, keys, device="cpu")
    gs, gi = gpu.search(13)
    cs, ci = cpu.search(13)
    np.testing.assert_allclose(gs, cs, atol=1e-5)
    assert (gi[:, 0] == np.arange(3000)).all()
    app = rng.normal(size=(600, 64)).astype(np.float32)
    for eng in (gpu, cpu):
        eng.update(app, [f"n{i}" for i in range(600)])
    gs, gi = gpu.search(7, queries=app[:50])
    cs, ci = cpu.search(7, queries=app[:50])
    np.testing.assert_allclose(gs, cs, atol=1e-5)
    v, i = gpu.search_device(7, app[:50])
    assert v.device.type == "cuda"
    np.testing.assert_array_equal(i.cpu().numpy(), gi)


def _arcface_problem(rng, b, c, d, dev):
    x = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32))
    w = torch.from_numpy(0.05 * rng.standard_normal((c, d),
                                                   dtype=np.float32))
    label = torch.from_numpy(rng.integers(-1, c, b).astype(np.int32))
    return x.to(dev), w.to(dev), label.to(dev)


@pytest.mark.parametrize("easy", [False, True], ids=["margin", "easy"])
@pytest.mark.parametrize("b,c,d", [(1, 1, 1), (100, 37, 64), (65, 129, 17),
                                   (128, 10_205, 768), (128, 10_205, 100),
                                   (200, 300, 99)])
def test_arcface_kernel_matches_plain(dev, b, c, d, easy):
    """Ragged B, C and D, label -1 rows, cos = +-1 and zero rows. Ordinary
    logits within atol 2e-4, rtol 1e-5 (f32 sums in another order, times
    s = 64); targets where 1 - cos^2 < 1e-4 within s*(4e-6 + sin(m)*
    sqrt(8e-6)) (sqrt is 1/2-Hoelder where the sine's slope is
    unbounded)."""
    rng = np.random.default_rng(b + c + d)
    x, w, label = _arcface_problem(rng, b, c, d, dev)
    if b > 3 and c > 1:
        label[:3] = torch.tensor([0, 1, 0], dtype=torch.int32)
        x[0] = 2.0 * w[0]
        x[1] = -w[1]
        x[2] = 0.0
    for m in (0.1, 0.4):
        got = A.arcface_logits_cuda(x, w, label, m, 64.0, easy)
        want = A.arcface_logits(x, w, label, m, 64.0, easy)
        cos = A.cosine_logits(x, w)
        torch.cuda.synchronize()
        target = torch.arange(c, device=dev)[None] == label.long()[:, None]
        steep = target & (1.0 - cos * cos < 1e-4)
        allow = torch.where(
            steep, torch.full_like(want, 64.0 * (4e-6 + math.sin(m)
                                                 * math.sqrt(8e-6))),
            2e-4 + 1e-5 * want.abs())
        assert ((got - want).abs() <= allow).all(), float(
            (got - want).abs().max())


def test_arcface_counts_launches_validates_and_differentiates(dev):
    rng = np.random.default_rng(0)
    x, w, label = _arcface_problem(rng, 64, 300, 48, dev)
    before = A.LAUNCHES["arcface"]
    xr = x.clone().requires_grad_(True)
    wr = w.clone().requires_grad_(True)
    out = A.arcface_logits_fused(xr, wr, label.clamp_min(0), 0.4)
    assert A.LAUNCHES["arcface"] == before + 1
    torch.nn.functional.cross_entropy(out, label.clamp_min(0).long()
                                      ).backward()
    xp = x.clone().requires_grad_(True)
    wp = w.clone().requires_grad_(True)
    torch.nn.functional.cross_entropy(
        A.arcface_logits(xp, wp, label.clamp_min(0), 0.4),
        label.clamp_min(0).long()).backward()
    for a, b in ((xr.grad, xp.grad), (wr.grad, wp.grad)):
        assert torch.allclose(a, b, rtol=1e-3,
                              atol=1e-3 * float(b.abs().max()))
    # x in bf16 is cast to f32, as the TPU kernel casts it
    assert A.arcface_logits_cuda(x.bfloat16(), w, label, 0.4).dtype \
        == torch.float32
    with pytest.raises(ValueError, match="float32"):
        A.arcface_logits_cuda(x, w.double(), label, 0.4)
    with pytest.raises(ValueError, match="contiguous"):
        A.arcface_logits_cuda(x, w.t().contiguous().t(), label, 0.4)
    with pytest.raises(ValueError, match="not a CUDA device"):
        A.arcface_logits_cuda(x, w.cpu(), label, 0.4)
    with pytest.raises(ValueError, match="integer"):
        A.arcface_logits_cuda(x, w, label.float(), 0.4)
    with pytest.raises(ValueError, match="shape mismatch"):
        A.arcface_logits_cuda(x, w[:, :10].contiguous(), label, 0.4)


# ------------------------------------------------------- the serving path

def _serving_engine(dev, n=5000, d=96, seed=0):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, d), dtype=np.float32)
    return SimilarityEngine(emb, [f"k{i}" for i in range(n)], device=dev)


def _check_against_plain(engine, q, got, k):
    corpus_dev, true_n, _ = engine._corpus_dev
    qn = q / q.norm(dim=1, keepdim=True).clamp_min(1e-12)
    pv, pi = T.topk_plain(corpus_dev, qn, k + 1, "ip", true_n)
    gv, gi = got
    assert torch.allclose(gv, pv[:, :k], atol=1e-4, rtol=1e-5)
    gap = (pv[:, 1:] - pv[:, :-1]).abs()
    inf = torch.full((q.shape[0], 1), float("inf"), device=q.device)
    sep = (torch.cat([inf, gap], 1)[:, :k] > 1e-5) & (gap[:, :k] > 1e-5)
    assert not ((gi != pi[:, :k]) & sep).any()


@pytest.mark.parametrize("bucket", [1, 2, 4, 8, 16, 32, 64])
def test_fused_search_matches_plain_at_every_bucket(dev, bucket):
    """The fused chain (tower -> float -> normalize -> kernel) at each
    pow2 micro-batch the service sends, one launch per call, against the
    plain top-k on the same device corpus."""
    engine = _serving_engine(dev)
    run = engine.fused_search_fn(lambda x: x.half(), 13)
    q = torch.randn(bucket, 96, device=dev)
    before = T.LAUNCHES["topk"]
    got = run(q)
    assert T.LAUNCHES["topk"] == before + 1
    assert got[0].device.type == "cuda" and got[0].shape == (bucket, 13)
    _check_against_plain(engine, q.half().float(), got, 13)


def test_zero_query_scores_zero_with_ties_in_index_order(dev):
    """A zero query (the host path zero-pads to the bucket) normalizes to
    zero: every score is 0 and the ties come back in index order."""
    from multimodalsimilar_tpu_torch.pipelines.serving import (
        SimilarityService)
    engine = _serving_engine(dev)
    q = torch.randn(4, 96, device=dev)
    q[2] = 0.0
    v, i = engine.fused_search_fn(lambda x: x, 13)(q)
    torch.cuda.synchronize()
    assert torch.equal(v[2], torch.zeros(13, device=dev))
    assert i[2].tolist() == list(range(13))
    svc = SimilarityService(lambda t: np.zeros((len(t), 96), np.float32),
                            engine, k=13, max_wait_ms=1.0)
    try:
        scores, idx = svc._search_bucketed(np.zeros((3, 96), np.float32), 3)
        assert scores.shape == (3, 13) and not scores.any()
        assert (idx == np.arange(13)).all()
    finally:
        svc.close()


def _tiny_serve_args(**kw):
    import argparse
    args = dict(tower="bert", k=5, text_col="spu_name", key_col="spu_sn",
                category_col=None, tokenizer=None, checkpoint=None,
                bert_preset="tiny", num_labels=2, max_length=16,
                batch_size=8, max_batch=8, max_wait_ms=2.0, score_th=None,
                emb_table=None, data="in-memory")
    args.update(kw)
    return argparse.Namespace(**args)


TABLE = {"spu_sn": [f"sku{i}" for i in range(40)],
         "spu_name": [f"{'甲乙丙丁戊'[i % 5] * (1 + i % 3)}商品{i}"
                      for i in range(40)]}


def test_serve_above_max_k_uses_the_selection_route(dev):
    """A --k above the small-k kernel's 128 no longer refuses: the
    service builds and answers through the large-k route
    (csrc/topk_select.cu), the whole corpus ranked."""
    from multimodalsimilar_tpu_torch.cli.serve import _build_serve_service
    table = {"spu_sn": [f"sku{i}" for i in range(300)],
             "spu_name": [f"{'甲乙丙丁戊'[i % 5] * (1 + i % 3)}商品{i}"
                          for i in range(300)]}
    svc, n = _build_serve_service(_tiny_serve_args(k=200), table=table,
                                  device=dev)
    try:
        before = T.LAUNCHES["topk_select"]
        out = svc.similar(table["spu_name"][7], score_th=None)
        assert T.LAUNCHES["topk_select"] > before
        assert len(out) == 200
    finally:
        svc.close()


def test_serve_on_card_one_launch_per_similar_batch(dev):
    """The port's service on the card: warmed, then concurrent similar
    requests; the kernel launches once per micro-batch, and each title
    finds a row at cosine ~1 (its own, or one whose bf16 embedding ties
    with it)."""
    import threading

    from multimodalsimilar_tpu_torch.cli.serve import (_build_serve_service,
                                                       _warm_serve_service)
    args = _tiny_serve_args()
    svc, n = _build_serve_service(args, table=TABLE, device=dev)
    try:
        _warm_serve_service(svc, args)
        T.LAUNCHES["topk"] = 0
        before = svc.stats["batches"]
        out = [None] * 40

        def hit(i):
            out[i] = svc.similar(TABLE["spu_name"][i], score_th=None)

        threads = [threading.Thread(target=hit, args=(i,))
                   for i in range(40)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert T.LAUNCHES["topk"] == svc.stats["batches"] - before
        assert all(len(o) == 5 and o[0]["score"] > 0.99 for o in out)
    finally:
        svc.close()


def test_deferred_readback_does_not_wait_for_the_next_batch(dev):
    """Batch N's results are read back while batch N+1, launched after it
    on the same stream, is still running: finish() waits on an event
    behind batch N's copies, not on the stream."""
    from multimodalsimilar_tpu_torch.pipelines.serving import (
        DeferredBatch, SimilarityService)
    engine = _serving_engine(dev)
    run = engine.fused_search_fn(lambda x: x, 13)
    table = {f"q{i}": np.random.default_rng(i).standard_normal(
        96).astype(np.float32) for i in range(4)}

    def fused(texts, pad_to):
        q = np.zeros((pad_to, 96), np.float32)
        q[: len(texts)] = np.stack([table[t] for t in texts])
        return run(torch.from_numpy(q).to(dev))

    svc = SimilarityService(lambda t: np.stack([table[x] for x in t]),
                            engine, k=13, max_wait_ms=1.0,
                            fused_similar=fused)
    try:
        deferred = svc._run_batch_async([{"op": "similar", "query": "q0"},
                                         {"op": "similar", "query": "q1"}])
        assert isinstance(deferred, DeferredBatch)
        torch.cuda._sleep(2_000_000_000)          # batch N+1: ~1 s of work
        later = torch.cuda.Event()
        later.record()
        results = deferred.finish()
        assert not later.query(), "finish() waited for the later batch"
        torch.cuda.synchronize()
        want = svc._search_bucketed(np.stack([table["q0"], table["q1"]]), 2)
        for r, (s, i) in enumerate(results):
            np.testing.assert_array_equal(i, want[1][r])
            np.testing.assert_allclose(s, want[0][r], atol=1e-4)
    finally:
        svc.close()


# ------------------------------------------------------ the image paths

def _fused_rows(rng, n):
    """Rows shaped like the multimodal tower's output: unit 512-d and
    768-d halves, norm sqrt(2), un-normalized."""
    halves = []
    for d in (512, 768):
        x = rng.standard_normal((n, d), dtype=np.float32)
        halves.append(x / np.linalg.norm(x, axis=1, keepdims=True))
    return np.concatenate(halves, axis=1)


@pytest.mark.parametrize("q,n", [(48, 4096), (4096, 4096), (1, 5000),
                                 (48, 70_000)])
def test_l2_kernel_at_the_fused_width(dev, q, n):
    """Un-normalized squared L2 at d = 1,280 (the multimodal serving and
    job shapes), through the engine: its l2 pad rows (1e18) never win,
    distances ascend, and the kernel matches the plain version within
    atol 1e-4, rtol 1e-5 (indices where the neighbours are > 1e-5
    apart)."""
    rng = np.random.default_rng(q + n)
    emb = _fused_rows(rng, n)
    engine = SimilarityEngine(emb, [f"k{i}" for i in range(n)], metric="l2",
                              normalize=False, device=dev)
    queries = np.concatenate([emb[: q // 2], _fused_rows(rng, q - q // 2)])
    before = T.LAUNCHES["topk"]
    gv, gi = engine.search_device(13, queries)
    assert T.LAUNCHES["topk"] == before + 1
    corpus_dev, true_n, _ = engine._corpus_dev
    pv, pi = T.topk_plain(corpus_dev, torch.from_numpy(queries).to(dev), 14,
                          "l2", true_n)
    torch.cuda.synchronize()
    assert int(gi.max()) < n and (gv[:, 1:] >= gv[:, :-1]).all()
    assert torch.allclose(gv, pv[:, :13], atol=1e-4, rtol=1e-5)
    gap = (pv[:, 1:] - pv[:, :-1]).abs()
    inf = torch.full((q, 1), float("inf"), device=dev)
    sep = (torch.cat([inf, gap], 1)[:, :13] > 1e-5) & (gap[:, :13] > 1e-5)
    assert not ((gi != pi[:, :13]) & sep).any()
    if q > 1:      # a corpus row finds itself first, at distance ~0
        assert (gi[: q // 2, 0].cpu().numpy() == np.arange(q // 2)).all()


def _image_model(policy, dev, seed=0):
    """EfficientNet-B0 with a 64-d neck, seed-``seed`` weights and its
    backbone's BatchNorm statistics as training leaves them: variances
    and scales drawn around 1, means measured on one batch (see
    ``chip_smoke.py:seed_bn_statistics``)."""
    from multimodalsimilar_tpu_torch.models import efficientnet as E
    from multimodalsimilar_tpu_torch.models.vision import (
        CvImageClassifier, backbone_config, device_normalize, to_nchw)
    model = CvImageClassifier(backbone_config("efficientnet_b0"), 10,
                              fc_dim=64, policy=policy,
                              generator=torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_var.uniform_(0.5, 2.0, generator=g)
                m.weight.uniform_(0.8, 1.2, generator=g)
    real = E.batch_norm

    def measuring(x, bn, dtype):
        if isinstance(bn, torch.nn.BatchNorm2d):
            bn.running_mean.copy_(x.float().mean(dim=(0, 2, 3)))
        return real(x, bn, dtype)

    E.batch_norm = measuring
    try:
        with torch.no_grad():
            model.to(dev).predict_emb(to_nchw(device_normalize(
                torch.from_numpy(_blocky(8, 64, seed + 2)).to(dev))))
    finally:
        E.batch_norm = real
    return model.cpu()


def _blocky(n, size, seed):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 256, (n, 8, 8, 3), dtype=np.uint8)
    cell = size // 8
    return np.ascontiguousarray(np.repeat(np.repeat(g, cell, 1), cell, 2))


def test_image_fused_path_matches_unfolded_tower(dev):
    """EfficientNet-B0 at 64 px, full precision, TF32 off: the folded
    tower's fused search (upload, normalize and permute on the card,
    tower, normalize, kernel) against the UNFOLDED tower's embeddings and
    the plain top-k. Folding is exact math: embeddings within 1e-4 of the
    largest, scores within 1e-4."""
    from multimodalsimilar_tpu_torch.models.fold_bn import fold_cv_classifier
    from multimodalsimilar_tpu_torch.models.vision import CvImageClassifier
    from multimodalsimilar_tpu_torch.pipelines.embedders import ImageEmbedder
    from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy
    torch.backends.cudnn.allow_tf32 = False
    pol = DTypePolicy.full_precision()
    plain = _image_model(pol, dev)
    fcfg, fsd = fold_cv_classifier(plain.state_dict(), plain.cfg)
    folded = CvImageClassifier(fcfg, 10, fc_dim=64, policy=pol)
    folded.load_state_dict(fsd)
    corpus, queries = _blocky(200, 64, 0), _blocky(8, 64, 1)
    unf = ImageEmbedder(plain, image_size=64, batch_size=64, device=dev)
    emb = ImageEmbedder(folded, image_size=64, batch_size=64, device=dev)
    want = unf.embed_batch(corpus)
    got = emb.embed_batch(corpus)
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())
    engine = SimilarityEngine(want, [f"k{i}" for i in range(200)],
                              device=dev)
    before = T.LAUNCHES["topk"]
    gv, gi = emb.fused_similar_fn(engine, 13)(list(queries), 8)
    assert T.LAUNCHES["topk"] == before + 1
    q = torch.from_numpy(unf.embed_batch(queries)).to(dev)
    _check_against_plain(engine, q, (gv, gi), 13)
    own = emb.fused_similar_fn(engine, 1)(list(corpus[:4]), 4)[1]
    assert own[:, 0].tolist() == [0, 1, 2, 3]


def test_image_batches_upload_from_pinned_memory(dev, monkeypatch):
    """uint8 batches go up from pinned host memory, without a copy back:
    the device tensor equals the host batch and every upload pinned."""
    from multimodalsimilar_tpu_torch.pipelines import embedders as P
    pinned = []
    real = torch.Tensor.pin_memory

    def spy(self, *a, **k):
        out = real(self, *a, **k)
        pinned.append(out.is_pinned())
        return out

    monkeypatch.setattr(torch.Tensor, "pin_memory", spy)
    batch = _blocky(4, 32, 2)
    (t,) = P._upload([batch], dev)
    assert t.device.type == "cuda" and t.dtype == torch.uint8
    assert torch.equal(t.cpu(), torch.from_numpy(batch)) and pinned == [True]
    from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy
    emb = P.ImageEmbedder(_image_model(DTypePolicy.inference(), dev),
                          image_size=32, batch_size=8, device=dev)
    out = emb.embed_batch(_blocky(11, 32, 3))
    assert out.shape == (11, 64) and np.isfinite(out).all()
    assert len(pinned) == 3 and all(pinned)     # batches of 8 and 4


def test_multimodal_service_on_card_one_launch_per_batch(dev):
    """A tiny fused tower served on the card, l2: concurrent (title,
    image) requests launch the kernel once per micro-batch, and each
    corpus pair finds itself first at distance ~0."""
    import argparse
    import threading

    from multimodalsimilar_tpu_torch.cli.serve import (_service_from_corpus,
                                                       _warm_serve_service)
    from multimodalsimilar_tpu_torch.data.tokenizer import TextTokenizer
    from multimodalsimilar_tpu_torch.models.bert import BertConfig
    from multimodalsimilar_tpu_torch.models.efficientnet import (
        EfficientNetConfig)
    from multimodalsimilar_tpu_torch.models.multimodal import (
        MultimodalClassifier)
    from multimodalsimilar_tpu_torch.pipelines.embedders import (
        MultimodalEmbedder)
    from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy
    titles = TABLE["spu_name"]
    tok = TextTokenizer.from_corpus(titles)
    model = MultimodalClassifier(BertConfig.tiny(vocab_size=tok.vocab_size),
                                 EfficientNetConfig.tiny(), num_labels=5,
                                 fc_dim=16, policy=DTypePolicy.inference())
    emb = MultimodalEmbedder(model, tok, max_length=16, image_size=32,
                             batch_size=8, device=dev)
    imgs = _blocky(40, 32, 4)
    vecs = emb(imgs, titles)
    args = argparse.Namespace(tower="multimodal", k=5, max_batch=8,
                              batch_size=8, max_wait_ms=2.0, score_th=None,
                              image_size=32)
    svc = _service_from_corpus(
        args, vecs, TABLE["spu_sn"], None,
        lambda pairs: emb(np.stack([im for _, im in pairs]),
                          [t for t, _ in pairs]), emb, metric="l2",
        normalize=False, device=dev)
    try:
        _warm_serve_service(svc, args)
        T.LAUNCHES["topk"] = 0
        before = svc.stats["batches"]
        out = [None] * 40

        def hit(i):
            out[i] = svc.similar((titles[i], imgs[i]))

        threads = [threading.Thread(target=hit, args=(i,))
                   for i in range(40)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert T.LAUNCHES["topk"] == svc.stats["batches"] - before
        assert all(o[0]["key"] == TABLE["spu_sn"][i]
                   and o[0]["score"] <= 1e-3 for i, o in enumerate(out))
    finally:
        svc.close()


# ------------------------------------------------- the training recipes

# B x C x D of the recipes' ArcFace heads: cv (train_cv_daodian.yaml),
# multimodal (train_multimodal.yaml) and the multilabel tag, lv2 and lv1
# heads (train_multilabel_v3.yaml)
RECIPE_HEADS = [(24, 4_181, 512), (48, 796, 1_280), (256, 10_205, 768),
                (256, 590, 768), (256, 38, 768)]


@pytest.mark.parametrize("b,c,d", RECIPE_HEADS)
def test_arcface_kernel_at_the_recipe_heads(dev, b, c, d):
    """Forward within the tolerances of test_arcface_kernel_matches_plain;
    the gradients of one CE loss through ``ArcFaceLogits`` (kernel
    forward, plain backward) against plain autograd within rtol 1e-3 and
    1e-3 of the largest gradient (the logits agree to 2e-4)."""
    rng = np.random.default_rng(c)
    x, w, label = _arcface_problem(rng, b, c, d, dev)
    label = label.clamp_min(0)
    m = 0.2
    got = A.arcface_logits_cuda(x, w, label, m, 64.0)
    want = A.arcface_logits(x, w, label, m, 64.0)
    cos = A.cosine_logits(x, w)
    torch.cuda.synchronize()
    target = torch.arange(c, device=dev)[None] == label.long()[:, None]
    steep = target & (1.0 - cos * cos < 1e-4)
    allow = torch.where(
        steep, torch.full_like(want, 64.0 * (4e-6 + math.sin(m)
                                             * math.sqrt(8e-6))),
        2e-4 + 1e-5 * want.abs())
    assert ((got - want).abs() <= allow).all()

    def grads(fn):
        xr = x.clone().requires_grad_(True)
        wr = w.clone().requires_grad_(True)
        torch.nn.functional.cross_entropy(
            fn(xr, wr, label, m, 64.0, False), label.long()).backward()
        return xr.grad, wr.grad

    for a, b_ in zip(grads(A.arcface_logits_fused),
                     grads(A.arcface_logits)):
        assert torch.allclose(a, b_, rtol=1e-3,
                              atol=1e-3 * float(b_.abs().max()))


@pytest.mark.parametrize("tf32", [False, True])
def test_fused_loss_on_card_matches_cpu(dev, tf32):
    """``arcface_ce_loss`` at the tag head's width on the card against its
    CPU result: loss within 1e-5 relative, dx and dW within 1e-4 of their
    largest entries (f32 sums in another order); with TF32 on too, since
    its products are f32-accurate whatever the flag says."""
    from multimodalsimilar_tpu_torch.ops.arcface_loss import (
        arcface_ce_loss, cosine_argmax)
    rng = np.random.default_rng(7)
    x, w, label = _arcface_problem(rng, 64, 10_205, 768, dev)

    def run(device):
        xr = x.to(device).clone().requires_grad_(True)
        wr = w.to(device).clone().requires_grad_(True)
        loss = arcface_ce_loss(xr, wr, label.to(device), 0.1)
        loss.sum().backward()
        return (loss.detach().cpu(), xr.grad.cpu(), wr.grad.cpu(),
                cosine_argmax(xr, wr).cpu())

    want = run("cpu")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        got = run(dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert torch.allclose(got[0], want[0], rtol=1e-5, atol=0)
    for a, b in zip(got[1:3], want[1:3]):
        assert torch.allclose(a, b, rtol=0, atol=1e-4 * float(b.abs().max()))
    assert (got[3] == want[3]).float().mean() > 0.99


def test_cv_train_step_on_card_matches_cpu(dev):
    """One ``cv_arcface_task`` step of the tiny image classifier in full
    precision (cuDNN TF32 off, drop-path and neck dropout at 0) on the
    card against the same step on the CPU: the loss within 1e-5 relative,
    the BN running statistics within 1e-5, every gradient within 1e-3 of
    its largest entry (cuDNN sums in another order; at least 1e-4 of the
    model's largest gradient), and one ArcFace launch. Biases of
    BatchNorms that feed a convolution into another train-mode BatchNorm
    have zero gradients in exact arithmetic: below 1e-5 of the model's
    largest gradient on both devices."""
    import dataclasses

    from multimodalsimilar_tpu_torch.models.efficientnet import (
        EfficientNetConfig)
    from multimodalsimilar_tpu_torch.models.vision import CvImageClassifier
    from multimodalsimilar_tpu_torch.train.tasks import cv_arcface_task
    from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(EfficientNetConfig.tiny(), drop_path_rate=0.0)
    rng = np.random.default_rng(3)
    batch = {"images": torch.from_numpy(rng.integers(
                 0, 256, (8, 32, 32, 3)).astype(np.uint8)),
             "labels": torch.from_numpy(rng.integers(0, 50, 8).astype(
                 np.int32))}
    out = []
    for device in ("cpu", dev):
        model = CvImageClassifier(cfg, 50, fc_dim=16,
                                  policy=DTypePolicy.full_precision())
        model.dropout.p = 0.0
        model = model.to(device, memory_format=torch.channels_last).train()
        before = A.LAUNCHES["arcface"]
        loss, _ = cv_arcface_task(model).train_loss(
            {k: v.to(device) for k, v in batch.items()}, 0.2)
        loss.backward()
        out.append((float(loss.detach()), A.LAUNCHES["arcface"] - before,
                    {n: p.grad.cpu() for n, p in model.named_parameters()},
                    {n: b.cpu() for n, b in model.named_buffers()}))
    (lc, _, gc, bc), (lg, launches, gg, bg) = out
    assert launches == 1 and lg == pytest.approx(lc, rel=1e-5)
    for n, b in bc.items():
        if n.endswith(("running_mean", "running_var")):
            assert torch.allclose(bg[n], b, rtol=0, atol=1e-5), n
    top = max(float(g.abs().max()) for g in gc.values())
    for n, g in gc.items():
        if float(g.abs().max()) <= 1e-5 * top:
            assert float(gg[n].abs().max()) <= 1e-5 * top, n
            continue
        scale = max(float(g.abs().max()), 1e-4 * top)
        assert torch.allclose(gg[n], g, rtol=0, atol=1e-3 * scale), n


def test_cli_similar_nlp_on_card_without_pandas_or_yaml(dev, tmp_path,
                                                        monkeypatch):
    """``main([... "similar", "nlp" ...])`` on its default device, the
    card: the config read without PyYAML, the CSV without pandas (both
    blocked, as on a machine that has neither), the top-k kernel
    launched, and a key written for every row, as on the CPU."""
    import csv
    import sys

    from multimodalsimilar_tpu_torch.cli import main
    from multimodalsimilar_tpu_torch.cli import similar as cli_similar
    from multimodalsimilar_tpu_torch.pipelines.sinks import InMemoryKVSink
    for name in ("pandas", "yaml"):
        monkeypatch.setitem(sys.modules, name, None)
    words = ["苹果", "香蕉", "牛奶", "酸奶", "可乐", "雪碧"]
    rows = [(f"s{i}", f"{words[i % 6]} {words[(i * 7) % 6]} {i % 13}")
            for i in range(300)]
    data = tmp_path / "titles.csv"
    with open(data, "w", newline="", encoding="utf-8") as f:
        csv.writer(f).writerows([("spu_sn", "spu_name"), *rows])
    config = tmp_path / "job.yaml"
    config.write_text("# a similar_nlp.yaml at test size\n"
                      "text_col: spu_name\nkey_col: spu_sn\n"
                      "bert_preset: tiny\nmax_length: 16\n"
                      "batch_size: 64\nk: 13\nscore_th: -1.0\n",
                      encoding="utf-8")
    sinks = []
    monkeypatch.setattr(cli_similar, "_kv_sink",
                        lambda args: sinks.append(InMemoryKVSink())
                        or sinks[-1])
    argv = ["similar", "nlp", "--config", str(config), "--data", str(data)]
    T.LAUNCHES["topk"] = 0
    main(argv)
    torch.cuda.synchronize()
    assert T.LAUNCHES["topk"] >= 1
    launched = T.LAUNCHES["topk"]
    main(argv, device="cpu")
    assert T.LAUNCHES["topk"] == launched           # the CPU: no kernel
    got, want = (set(s.data) for s in sinks)
    assert got == want and len(got) == 300


@pytest.mark.parametrize("m,k,n", [(1, 64, 64), (16, 100, 37), (17, 768, 768),
                                   (64 * 80, 768, 3072),
                                   (256 * 128, 3072, 768)])
def test_int_mm_on_card_is_exact(dev, m, k, n):
    """``int8_matmul`` on the card (``torch._int_mm``, zero-padded to its
    shapes: more than 16 rows, K and N multiples of 8) equals the exact
    product (f64 on the card: every partial sum an integer below 2^53)
    bit for bit, and the CPU route."""
    from multimodalsimilar_tpu_torch.models import quant as Q
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.integers(-127, 128, (m, k)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (n, k)).astype(np.int8))
    got = Q.int8_matmul(x.to(dev), w.to(dev))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    exact = x.to(dev).double() @ w.to(dev).double().t()
    assert torch.equal(got.double(), exact)
    if m <= 64 * 80:
        assert torch.equal(got.cpu(), Q.int8_matmul(x, w))
    big = torch.full((32, 3072), 127, dtype=torch.int8, device=dev)
    assert int(Q.int8_matmul(big, -big[:8]).min()) == -127 * 127 * 3072


@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_int8_tower_on_card_matches_cpu(dev, pool):
    """The int8 text tower on the card against the CPU on one padded
    batch: the int8 products are exact on both, the rest is f32 (softmax
    probabilities in bf16), so the embeddings agree within 1e-4 of the
    largest (a last-bit difference before a rounding to the 1/127 step can
    move one quantized value)."""
    from multimodalsimilar_tpu_torch.models.bert import BertConfig
    from multimodalsimilar_tpu_torch.models.classifiers import (
        NlpTextClassifier)
    from multimodalsimilar_tpu_torch.models.quant import quantize_text_tower
    from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy
    q = quantize_text_tower(NlpTextClassifier(
        BertConfig.tiny(), pool=pool, policy=DTypePolicy.inference()))
    rng = np.random.default_rng(7)
    ids = torch.from_numpy(rng.integers(5, 128, (12, 24)).astype(np.int32))
    mask = torch.ones_like(ids)
    mask[3:, 10:] = 0
    with torch.no_grad():
        want = q.predict_emb(ids, mask).float()
        got = q.to(dev).predict_emb(ids.to(dev), mask.to(dev)).float().cpu()
    assert torch.allclose(got, want, rtol=0,
                          atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("name", ["vit_test", "convnext_test"])
def test_new_backbones_on_card_match_cpu(dev, name):
    """``vit_test`` and ``convnext_test`` features in full precision
    (TF32 off in cuBLAS and cuDNN) on the card against the CPU within
    1e-4, and under the inference policy within 2e-2 of the largest."""
    from multimodalsimilar_tpu_torch.models.vision import (build_backbone,
                                                           backbone_config)
    from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy
    torch.backends.cudnn.allow_tf32 = False
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(4, 3, 32, 32)).astype(np.float32))
    for policy, tol in ((DTypePolicy.full_precision(), 1e-4),
                        (DTypePolicy.inference(), 2e-2)):
        model = build_backbone(backbone_config(name), policy)
        with torch.no_grad():
            want = model.features(x).float()
            model = model.to(dev, memory_format=torch.channels_last)
            got = model.features(x.to(dev).contiguous(
                memory_format=torch.channels_last)).float().cpu()
        scale = 1.0 if tol < 1e-3 else float(want.abs().max())
        assert torch.allclose(got, want, rtol=0, atol=tol * scale), name


# -- the multi-GPU layouts: two ranks on this card over gloo -----------------

def _spawn_on_card(fn, world, *args):
    from multimodalsimilar_tpu_torch.parallel.spawn import spawn
    return spawn(fn, world, args, device="cuda", backend="gloo",
                 timeout=180, threads=None)


def test_class_sharded_head_on_card_matches_one_rank(dev):
    """The 10,206-class head (10,205 padded) in two blocks of 5,103 on two
    ranks: each block's logits are the kernel's (one launch a rank) and
    equal the one-rank kernel's columns exactly (the same products); the
    cross-entropy over the model group and the gradients of x (summed over
    the blocks) and of each block match the one-rank head's (rtol 1e-5:
    the log-sum-exp adds its blocks in another order)."""
    import torch_parallel_workers as W
    from multimodalsimilar_tpu_torch.models.heads import ArcFaceHead
    from multimodalsimilar_tpu_torch.train.tasks import _ce
    b, c, d = 64, 10_206, 768
    ranks = _spawn_on_card(W.card_head, 2, b, c, d, 7)
    x, w, labels = W._card_inputs(b, c, d, 7)
    head = ArcFaceHead(c, d).to(dev)
    with torch.no_grad():
        head.weight.copy_(w.to(dev))
    x = x.to(dev).requires_grad_(True)
    logits = head(x, labels.to(dev), m=0.4)
    loss = _ce(logits, labels.to(dev))
    loss.backward()
    want = logits.detach().cpu().numpy()
    for j, r in enumerate(ranks):
        cols = slice(j * c // 2, (j + 1) * c // 2)
        assert r["launches"] == 1
        np.testing.assert_array_equal(r["logits"], want[:, cols])
        np.testing.assert_allclose(r["loss"], float(loss.detach()),
                                   rtol=1e-5)
        gw = head.weight.grad[cols].cpu().numpy()
        np.testing.assert_allclose(r["grad_w"], gw, rtol=1e-5,
                                   atol=1e-5 * np.abs(gw).max())
        gx = x.grad.cpu().numpy()
        np.testing.assert_allclose(r["grad_x"], gx, rtol=1e-5,
                                   atol=1e-5 * np.abs(gx).max())


@pytest.mark.parametrize("metric", ["ip", "l2"])
@pytest.mark.parametrize("k", [13, 200])
def test_sharded_search_on_card_equals_one_block(dev, metric, k):
    """``sharded_knn_search`` over two ranks on this card (the top-k
    kernel, or the selection kernel at k = 200, on each block) equals
    ``knn_search`` over the whole corpus on one rank exactly, duplicate
    rows across the block boundary included; the corpus (20,001 rows) is
    padded to 20,002."""
    import torch_parallel_workers as W
    rng = np.random.default_rng(k)
    corpus = rng.integers(-3, 4, (20_001, 96)).astype(np.float32)
    corpus[10_001] = corpus[10_000]
    corpus[20_000] = corpus[17]
    queries = np.concatenate([corpus[[10_000, 17]], rng.integers(
        -3, 4, (62, 96)).astype(np.float32)])
    ranks = _spawn_on_card(W.card_search, 2, corpus, queries, k, metric)
    wv, wi = knn_search_on(dev, corpus, queries, k, metric)
    for r in ranks:
        assert r["launches"] == 1
        np.testing.assert_array_equal(r["i"], wi)
        np.testing.assert_array_equal(r["v"], wv)
    assert list(wi[0, :2]) == [10_000, 10_001]


def knn_search_on(dev, corpus, queries, k, metric):
    from multimodalsimilar_tpu_torch.retrieval.knn import knn_search
    v, i = knn_search(torch.from_numpy(corpus).to(dev),
                      torch.from_numpy(queries).to(dev), k, metric)
    return v.cpu().numpy(), i.cpu().numpy()


def test_sequence_collectives_on_card_over_gloo(dev):
    """The model group's reduce-scatter and all-gather along a dimension,
    and the sequence-parallel autograd pair at a length that does not
    divide, on two ranks on this card over gloo: the values
    tests/test_torch_parallel.py holds on the CPU. Whether gloo itself
    runs ``reduce_scatter_tensor``/``all_gather_into_tensor`` on CUDA
    tensors is printed (the wrappers do not rely on it)."""
    import torch_parallel_workers as W
    ranks = _spawn_on_card(W.card_collectives, 2, 2)
    print("gloo on CUDA tensors:", ranks[0]["native"])
    n, S, c = 2, 5, 3
    xs = [np.arange(2 * 4 * 3, dtype=np.float32).reshape(2, 4, 3) + 100 * r
          for r in range(n)]
    ys = [np.pad(np.arange(2 * S * 3, dtype=np.float32).reshape(2, S, 3)
                 + 10 * r, ((0, 0), (0, c * n - S), (0, 0)))
          for r in range(n)]
    blocks = [sum(ys)[:, q * c:(q + 1) * c] for q in range(n)]
    grad = np.broadcast_to((n * (np.arange(S) // c + 1) * np.arange(S)
                            ).astype(np.float32)[None, :, None], (2, S, 3))
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["rs"],
                                      sum(xs)[:, 2 * r:2 * r + 2])
        np.testing.assert_array_equal(got["ag"], np.concatenate(xs, 2))
        np.testing.assert_array_equal(got["block"], blocks[r])
        np.testing.assert_array_equal(got["grad"], grad)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_on_card_equals_no_remat_with_dropout(dev, policy):
    """The base tower with dropout 0.1 in the training policy (bf16
    products) on ``cuda:0``: with ``--remat`` (and ``remat_skip`` 2 for
    ``dots``) the loss and every gradient equal no remat bit for bit (the
    recompute draws the forward's masks from the CUDA generator again)."""
    from multimodalsimilar_tpu_torch.models.bert import (
        BertConfig, set_dropout_generator)
    from multimodalsimilar_tpu_torch.models.classifiers import (
        NlpTextClassifier)
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(remat=True, remat_policy=policy,
              remat_skip=2 if policy == "dots" else 0)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(5, 21_000, (32, 48))).to(dev)
    labels = torch.from_numpy(rng.integers(0, 64, 32)).to(dev)
    out = []
    for cfg in (BertConfig.roberta_wwm_ext(), BertConfig.roberta_wwm_ext(
            **kw)):
        torch.manual_seed(0)
        model = NlpTextClassifier(cfg, num_labels=64,
                                  generator=torch.Generator().manual_seed(
                                      1)).to(dev).train()
        gen = torch.Generator(device=dev).manual_seed(3)
        set_dropout_generator(model, gen)
        loss = torch.nn.functional.cross_entropy(
            model(ids, label=labels, m=0.4), labels)
        loss.backward()
        out.append((float(loss.detach()), {
            k: p.grad.clone() for k, p in model.named_parameters()}))
        del model
    (a, ga), (b, gb) = out
    assert a == b
    for k, g in ga.items():
        assert torch.equal(g, gb[k]), k


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_pipeline_handoff_on_card(dev, backend):
    """Two ranks over gloo on this card (the hand-off staged through the
    host) or, with two cards, over NCCL: ``Mesh.shift`` hands rank 0's
    bf16 tensor to rank 1 (rank 0 receives zeros) and back in reverse,
    ``broadcast_from`` gives both ranks rank 1's tensor and keeps only
    rank 1's gradient, and the GPipe schedule of eight toy layers (two
    microbatches) equals the layers in turn within 1e-6, forward and
    gradients."""
    import torch_parallel_workers as W
    from multimodalsimilar_tpu_torch.parallel.spawn import spawn
    if backend == "nccl" and torch.cuda.device_count() < 2:
        pytest.skip("NCCL ranks need a card each: this machine has one")
    ranks = spawn(W.card_pipeline, 2, (), device="cuda", backend=backend,
                  timeout=180, threads=None)
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    zero = np.zeros_like(x)
    assert [r["rank"] for r in ranks] == [0, 1]
    np.testing.assert_array_equal(ranks[0]["next"], zero)
    np.testing.assert_array_equal(ranks[1]["next"], x)
    np.testing.assert_array_equal(ranks[0]["prev"], x + 1)
    np.testing.assert_array_equal(ranks[1]["prev"], zero)
    for r in ranks:
        np.testing.assert_array_equal(r["bcast"], np.arange(4) + 10.0)
        sched = r["schedule"]
        assert sched["applied"] == 1
        assert max(sched[k] for k in ("out", "grad_x", "grad_w",
                                      "grad_b")) <= 1e-6
    np.testing.assert_array_equal(ranks[0]["grad"], np.zeros(4))
    np.testing.assert_array_equal(ranks[1]["grad"], np.full(4, 2.0))
