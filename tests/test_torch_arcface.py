"""ArcFace parity: the port's ``ops/arcface.py`` against the JAX package's.

Both sides run on the CPU in f32 on the same numpy inputs: the port's
plain ``arcface_logits`` (the CPU path of ``arcface_logits_fused``)
against JAX ``arcface_logits`` and against the JAX Pallas kernel run in
interpret mode (``tile_b=16``, ``tile_c=128``, as ``tests/test_arcface.py``
runs it). C = 300 is not a multiple of the tile, some rows have no target
(label -1), and three rows sit on the edges: equal to their class's
weight row (cos = +1), equal to its negation (cos = -1), and all zero
(the eps).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalsimilar_tpu.ops import arcface as J
from multimodalsimilar_tpu_torch.ops import arcface as A

torch.set_num_threads(1)

B, C, D = 24, 300, 32
S = 64.0
# Ordinary logits: both sides normalize in f32 and sum 32 products in
# another order, a cos difference of a few 1e-7, times s = 64.
ATOL, RTOL = 5e-5, 1e-5
# Target logits where 1 - cos^2 < 1e-4: the sine's slope is unbounded
# there, but sqrt is 1/2-Hoelder, so |d sine| <= sqrt(2 |d cos|); with
# |d cos| <= DCOS the logit may move by s * (DCOS + sin(m) sqrt(2 DCOS)).
DCOS = 1e-6


def _problem(seed=0, edges=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, D)).astype(np.float32)
    w = (0.05 * rng.standard_normal((C, D))).astype(np.float32)
    label = rng.integers(0, C, B).astype(np.int32)
    if edges:
        x[0] = 2.0 * w[label[0]]
        x[1] = -w[label[1]]
        x[2] = 0.0
        label[[3, 7, 11]] = -1
    return x, w, label


def _check(got, want, x, w, label, m):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape == (x.shape[0], w.shape[0])
    cos = np.asarray(J.cosine_logits(jnp.asarray(x), jnp.asarray(w)))
    target = np.arange(w.shape[0])[None, :] == label[:, None]
    steep = target & (1.0 - cos * cos < 1e-4)
    allow = np.where(steep, S * (DCOS + math.sin(m) * math.sqrt(2 * DCOS)),
                     ATOL + RTOL * np.abs(want))
    bad = np.abs(got - want) > allow
    assert not bad.any(), (np.argwhere(bad)[:5], np.abs(got - want).max())


def _port(x, w, label, m, easy):
    return A.arcface_logits(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(label), m, S, easy).numpy()


@pytest.mark.parametrize("m", [0.1, 0.4, 0.5])
@pytest.mark.parametrize("easy", [False, True], ids=["margin", "easy"])
def test_plain_matches_jax_pure_and_pallas(m, easy):
    x, w, label = _problem()
    jx, jw, jl = jnp.asarray(x), jnp.asarray(w), jnp.asarray(label)
    got = _port(x, w, label, m, easy)
    _check(got, J.arcface_logits(jx, jw, jl, m, S, easy), x, w, label, m)
    pallas = J.arcface_logits_fused(jx, jw, jl, m, S, easy, 16, 128, True)
    _check(got, pallas, x, w, label, m)
    # the zero row: cos = 0 off its target, s * phi(0) = -s sin(m) on it
    # unless easy_margin keeps cos there
    assert np.isfinite(got).all()
    off = np.arange(C) != label[2]
    np.testing.assert_array_equal(got[2, off], 0.0)
    assert got[2, label[2]] == pytest.approx(0.0 if easy
                                             else -S * math.sin(m))


def test_fused_cpu_path_is_the_plain_version():
    x, w, label = _problem(seed=1)
    tx, tw, tl = map(torch.from_numpy, (x, w, label))
    before = A.LAUNCHES["arcface"]
    got = A.arcface_logits_fused(tx, tw, tl, 0.4)
    assert torch.equal(got, A.arcface_logits(tx, tw, tl, 0.4))
    assert A.LAUNCHES["arcface"] == before      # no kernel on the CPU
    with pytest.raises(ValueError, match="not a CUDA device"):
        A.arcface_logits_cuda(tx, tw, tl, 0.4)


def test_cosine_logits_matches_jax():
    x, w, _ = _problem(seed=2)
    got = A.cosine_logits(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    want = np.asarray(J.cosine_logits(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        A.l2_normalize(torch.from_numpy(x)).numpy(),
        np.asarray(J.l2_normalize(jnp.asarray(x))), rtol=0, atol=1e-7)


@pytest.mark.parametrize("m,delta,want", [
    (0.96, 0.04, 1.0), (0.97, 0.04, 0.97), (1.0, 0.0, 1.0),
    (0.05, -0.05, 0.05), (0.05, -0.05 + 1e-6, 1e-6), (1e-6, 0.0, 1e-6),
    (0.4, 0.04, 0.44)])
def test_update_m_window_matches_jax(m, delta, want):
    """The new margin applies only inside [1e-6, 1.0], both ends
    included."""
    got = A.ArcFaceParams(m=m).update_m(delta)
    assert got.m == J.ArcFaceParams(m=m).update_m(delta).m
    assert got.m == pytest.approx(want)
    assert (got.s, got.easy_margin) == (64.0, False)


@pytest.mark.parametrize("easy", [False, True], ids=["margin", "easy"])
def test_gradients_match_jax_fused(easy):
    """CE over ``ArcFaceLogits`` (its CPU path: plain forward, plain
    backward) against ``jax.grad`` of the same loss over the Pallas kernel
    in interpret mode, at the tolerances of tests/test_arcface.py."""
    x, w, label = _problem(seed=3, edges=False)
    jl = jnp.asarray(label)

    def jloss(x_, w_):
        logits = J.arcface_logits_fused(x_, w_, jl, 0.4, S, easy, 16, 128,
                                        True)
        return jnp.mean(jax.nn.logsumexp(logits, -1) - jnp.take_along_axis(
            logits, jl[:, None], 1)[:, 0])

    gx0, gw0 = jax.grad(jloss, (0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    logits = A.ArcFaceLogits.apply(tx, tw, torch.from_numpy(label), 0.4, S,
                                   easy)
    torch.nn.functional.cross_entropy(logits, torch.from_numpy(
        label).long()).backward()
    np.testing.assert_allclose(tx.grad.numpy(), gx0, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), gw0, rtol=1e-4, atol=1e-5)


def test_backward_only_for_inputs_that_need_it():
    x, w, label = _problem(seed=4, edges=False)
    tw = torch.from_numpy(w).requires_grad_(True)
    A.arcface_logits_fused(torch.from_numpy(x), tw, torch.from_numpy(label),
                           0.4).sum().backward()
    assert tw.grad is not None and torch.isfinite(tw.grad).all()


def test_bound_at_the_slice_shape():
    """3xTF32 on the tensor cores, 165 TFLOP/s: 0.0122 ms, just above the
    0.0110 ms that the bytes take."""
    ms, by = A.bound_ms(128, 10_205, 768)
    assert by == "operations"
    assert ms == pytest.approx(2 * 128 * 10_205 * 768 / 165e12 * 1e3)
    assert round(ms, 4) == 0.0122
    assert A.bound_ms(128, 10_205, 768, flops_rate=A.H100_F32_FLOPS)[0] \
        == pytest.approx(0.0299, abs=1e-4)
