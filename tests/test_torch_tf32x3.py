"""The 3xTF32 arithmetic of ``csrc/tf32x3.cuh``, emulated on the CPU.

Both kernels take their f32 products on the tensor cores as three TF32
products: each f32 operand a splits into big = cvt.rna.tf32.f32(a) and
small = cvt.rna.tf32.f32(a - big), and a.b is small_a.big_b +
big_a.small_b + big_a.big_b, accumulated in f32. Here the split is
emulated bit for bit in torch (cvt.rna rounds the magnitude bits half
away from zero: ``(bits + 0x1000) & 0xFFFFE000`` on the int32 view) and
the products are summed in the kernel's order: 8 K values (one wgmma)
at a time into a partial for each 32-deep slice, the partials added in
f32. Inputs are made from a seed with numpy. The tolerances
are ``chip_smoke.py``'s, which the kernels are held to on the card.
"""

import math

import numpy as np
import pytest
import torch

from multimodalsimilar_tpu_torch.ops import arcface as A
from multimodalsimilar_tpu_torch.ops import topk as T

torch.set_num_threads(1)

# chip_smoke.py: top-k scores within ATOL/RTOL of the plain f32 version,
# indices equal wherever neighbouring plain scores are more than GAP apart
ATOL, RTOL, GAP = 1e-4, 1e-5, 1e-5
# chip_smoke.py phase 3: ordinary logits within AF_ATOL + AF_RTOL |want|;
# targets where 1 - cos^2 < 1e-4 within the Hoelder bound of sqrt for a
# cosine difference of AF_DCOS
AF_ATOL, AF_RTOL, AF_DCOS = 2e-4, 1e-5, 4e-6


def tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: keep 10 mantissa bits, ties away from zero."""
    bits = a.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (bits + 0x1000) & 0xFFFFE000
    r = torch.where(r >= 2**31, r - 2**32, r)
    return r.to(torch.int32).view(torch.float32)


def split(a: torch.Tensor):
    big = tf32_rna(a)
    return big, tf32_rna(a - big)


def product_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, d] . b [N, d]^T as the kernels take it: each 32-deep slice
    into a fresh f32 partial, 8 deep at a time with small.big and
    big.small first and big.big last; the partials then summed in f32."""
    ab, as_ = split(a)
    bb, bs = split(b)
    acc = torch.zeros(a.shape[0], b.shape[0], dtype=torch.float32)
    for k0 in range(0, a.shape[1], 32):
        part = torch.zeros_like(acc)
        for k8 in range(k0, min(k0 + 32, a.shape[1]), 8):
            s = slice(k8, k8 + 8)
            part = part + as_[:, s] @ bb[:, s].T
            part = part + ab[:, s] @ bs[:, s].T
            part = part + ab[:, s] @ bb[:, s].T
        acc = acc + part
    return acc


def topk_from_scores(scores: torch.Tensor, k: int, metric: str):
    """FAISS order over a full score matrix: (value desc, index asc)."""
    v, i = torch.sort(scores, dim=1, descending=True, stable=True)
    v, i = v[:, :k], i[:, :k].to(torch.int32)
    return (-v if metric == "l2" else v), i


def emulated_topk(corpus, queries, k, metric):
    s = product_3xtf32(queries, corpus)
    if metric == "l2":
        qn = (queries * queries).sum(1, keepdim=True)
        xn = (corpus * corpus).sum(1)[None, :]
        s = -(qn - 2.0 * s + xn)
    return topk_from_scores(s, k, metric)


def unit_rows(rng, n, d):
    x = rng.standard_normal((n, d), dtype=np.float32)
    return torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True))


@pytest.mark.parametrize("value,want", [
    (1.0 + 2.0**-11, 1.0 + 2.0**-10),        # a tie goes away from zero
    (-(1.0 + 2.0**-11), -(1.0 + 2.0**-10)),
    (1.0 + 2.0**-12, 1.0),                    # below half an ulp: down
    (1.0 + 3 * 2.0**-12, 1.0 + 2.0**-10),     # above half an ulp: up
    (3.0, 3.0)])
def test_rna_rounding(value, want):
    got = tf32_rna(torch.tensor([value], dtype=torch.float32))
    assert float(got) == want
    assert int(got.view(torch.int32)) & 0x1FFF == 0


def test_split_keeps_22_bits():
    """big + small equals a to 2^-22 of |a|: small's own rounding is all
    that the split loses (a - big is exact)."""
    a = torch.from_numpy(np.random.default_rng(0).standard_normal(
        100_000, dtype=np.float32) * 10.0)
    big, small = split(a)
    assert ((a - big) - small).abs().le(2.0**-22 * a.abs()).all()


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_unit_rows_agree_with_plain(metric):
    """(i) The main path's distribution: unit rows, d = 768. Scores within
    ATOL/RTOL of the plain f32 top-k and of the f64 product (3xTF32 is
    f32-accurate: about 1e-8 here); indices equal wherever neighbouring
    plain scores are more than GAP apart."""
    rng = np.random.default_rng(1)
    corpus, queries = unit_rows(rng, 3000, 768), unit_rows(rng, 300, 768)
    emu = product_3xtf32(queries, corpus)
    exact = queries.double() @ corpus.double().T
    assert float((emu.double() - exact).abs().max()) < 1e-6
    k = 13
    gv, gi = emulated_topk(corpus, queries, k, metric)
    pv, pi = T.topk_plain(corpus, queries, k + 1, metric)
    assert torch.allclose(gv, pv[:, :k], atol=ATOL, rtol=RTOL)
    gap = (pv[:, 1:] - pv[:, :-1]).abs()
    inf = torch.full((pv.shape[0], 1), float("inf"))
    sep = (torch.cat([inf, gap], 1)[:, :k] > GAP) & (gap[:, :k] > GAP)
    assert sep.float().mean() > 0.5          # the check has teeth
    assert not ((gi != pi[:, :k]) & sep).any()


def test_one_tf32_product_would_not_do():
    """The reason for three products: a single TF32 product of the same
    unit rows misses the f32 result by far more than ATOL allows for."""
    rng = np.random.default_rng(1)
    corpus, queries = unit_rows(rng, 3000, 768), unit_rows(rng, 300, 768)
    one = tf32_rna(queries) @ tf32_rna(corpus).T
    exact = queries.double() @ corpus.double().T
    assert float((one.double() - exact).abs().max()) > 10 * 1e-6


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_integer_data_is_exact(metric):
    """(ii) Small integers in -3..3 with duplicate rows: the small parts
    are 0 and every partial sum is an integer below 2^24, so scores and
    indices (ties to the lowest index) equal the plain version's
    exactly."""
    rng = np.random.default_rng(2)
    corpus = torch.from_numpy(rng.integers(-3, 4, (2000, 96)).astype(
        np.float32))
    corpus[1000:1200] = corpus[:200]
    queries = torch.cat([corpus[:8], torch.from_numpy(
        rng.integers(-3, 4, (56, 96)).astype(np.float32))])
    for t in (corpus, queries):
        assert torch.equal(split(t)[1], torch.zeros_like(t))
    assert torch.equal(product_3xtf32(queries, corpus), queries @ corpus.T)
    for k in (13, 101):
        gv, gi = emulated_topk(corpus, queries, k, metric)
        pv, pi = T.topk_plain(corpus, queries, k, metric)
        assert torch.equal(gi, pi) and torch.equal(gv, pv)


@pytest.mark.parametrize("m,easy", [(0.4, False), (0.1, False),
                                    (0.4, True)])
def test_arcface_from_emulated_cosines(m, easy):
    """(iii) ArcFace logits from 3xTF32 cosines, with the kernel's inverse
    norms, meet phase 3's tolerances against ``arcface_logits``: the
    slice's D = 768, ragged class count, rows equal to +-W rows (the
    sine's steep edge), a zero row and label -1 rows."""
    rng = np.random.default_rng(3)
    b, c, d, s = 64, 1000, 768, 64.0
    x = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32))
    w = torch.from_numpy(0.02 * rng.standard_normal((c, d),
                                                   dtype=np.float32))
    label = torch.from_numpy(rng.integers(0, c, b).astype(np.int32))
    x[0] = 3.0 * w[label[0]]
    x[1] = -w[label[1]]
    x[2] = 0.0
    label[5::7] = -1
    inv_x = torch.rsqrt(torch.clamp_min((x * x).sum(1), 1e-24))
    inv_w = torch.rsqrt(torch.clamp_min((w * w).sum(1), 1e-24))
    cos = product_3xtf32(x, w) * inv_x[:, None] * inv_w[None, :]
    got = A._apply_margin(cos, label, m, s, easy)
    want = A.arcface_logits(x, w, label, m, s, easy)
    plain_cos = A.cosine_logits(x, w)
    target = torch.arange(c)[None, :] == label.long()[:, None]
    steep = target & (1.0 - plain_cos * plain_cos < 1e-4)
    assert int(steep.sum()) >= 2
    edge = s * (AF_DCOS + math.sin(m) * math.sqrt(2.0 * AF_DCOS))
    allow = torch.where(steep, torch.full_like(want, edge),
                        AF_ATOL + AF_RTOL * want.abs())
    err = (got - want).abs()
    assert (err <= allow).all(), float(err.max())
