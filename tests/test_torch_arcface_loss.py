"""The port's blockwise ArcFace + cross-entropy (``ops/arcface_loss.py``)
against the JAX package's and against the plain margin logits, on the
CPU.

Same seeded numpy inputs for both packages. The per-example loss, dx and
dW agree within 1e-5 of each tensor's largest entry (f32 sums over tiles
in another order), at tile 3 and 1,024 with C not a multiple of the tile,
with and without easy_margin, with a label -1 row (no target: the loss is
the log-sum-exp alone). ``cosine_argmax`` is exact. Where an x row is a
multiple of its target's W row (cos = 1), sqrt(1 - cos^2) has no
derivative: JAX's gradients are NaN there, the port takes the sine's
slope as 0 and stays finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multimodalsimilar_tpu.ops.arcface_loss import (
    arcface_ce_loss as j_arcface_ce_loss)
from multimodalsimilar_tpu.ops.arcface_loss import (
    cosine_argmax as j_cosine_argmax)
from multimodalsimilar_tpu_torch.models.bert import BertConfig
from multimodalsimilar_tpu_torch.models.classifiers import NlpTextClassifier
from multimodalsimilar_tpu_torch.ops.arcface import arcface_logits
from multimodalsimilar_tpu_torch.ops.arcface_loss import (arcface_ce_loss,
                                                          cosine_argmax)
from multimodalsimilar_tpu_torch.train.tasks import text_arcface_task
from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy

torch.set_num_threads(1)

B, C, D = 12, 37, 16


def _problem(seed=0, c=C):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, D)).astype(np.float32)
    w = rng.normal(size=(c, D)).astype(np.float32)
    label = rng.integers(0, c, B).astype(np.int32)
    label[5] = -1
    g = rng.uniform(0.5, 1.5, B).astype(np.float32)
    return x, w, label, g


def _port(x, w, label, g, m, easy, tile):
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    loss = arcface_ce_loss(xt, wt, torch.tensor(label), m, 64.0, easy, tile)
    (loss * torch.tensor(g)).sum().backward()
    return loss.detach().numpy(), xt.grad.numpy(), wt.grad.numpy()


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("tile", [3, 1024])
@pytest.mark.parametrize("easy", [False, True])
@pytest.mark.parametrize("m", [0.4, 0.1])
def test_loss_and_grads_match_jax(tile, easy, m):
    x, w, label, g = _problem()
    lab = jnp.asarray(label)

    def weighted(xj, wj):
        return jnp.sum(j_arcface_ce_loss(xj, wj, lab, m, 64.0, easy, tile)
                       * jnp.asarray(g))

    want = np.asarray(j_arcface_ce_loss(jnp.asarray(x), jnp.asarray(w), lab,
                                        m, 64.0, easy, tile))
    jdx, jdw = jax.grad(weighted, argnums=(0, 1))(jnp.asarray(x),
                                                  jnp.asarray(w))
    loss, dx, dw = _port(x, w, label, g, m, easy, tile)
    _close(loss, want, "loss")
    _close(dx, np.asarray(jdx), "dx")
    _close(dw, np.asarray(jdw), "dW")


@pytest.mark.parametrize("tile", [3, 1024])
@pytest.mark.parametrize("easy", [False, True])
def test_matches_cross_entropy_of_the_margin_logits(tile, easy):
    """CE(arcface_logits(...)) per example, through the port's plain
    logits and autograd: the same function without tiles."""
    x, w, label, g = _problem(seed=1, c=50)
    loss, dx, dw = _port(x, w, label, g, 0.3, easy, tile)
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    lab = torch.tensor(label)
    logits = arcface_logits(xt, wt, lab, 0.3, 64.0, easy)
    want = F.cross_entropy(logits, lab.long().clamp_min(0),
                           reduction="none")
    # label -1: no target column, so the loss is the log-sum-exp alone
    want = torch.where(lab >= 0, want, torch.logsumexp(logits, 1))
    (want * torch.tensor(g)).sum().backward()
    _close(loss, want.detach().numpy(), "loss")
    _close(dx, xt.grad.numpy(), "dx")
    _close(dw, wt.grad.numpy(), "dW")


def test_target_at_cos_one_keeps_finite_gradients():
    """x rows equal to (a multiple of) their target's W row: the loss
    equals JAX's, whose gradients there are NaN; the port's are finite,
    and the other rows' dx agree with JAX within 1e-5."""
    x, w, label, g = _problem(seed=5)
    x[2] = 2.0 * w[label[2]]
    x[3] = w[label[3]]
    lab = jnp.asarray(label)
    want = np.asarray(j_arcface_ce_loss(jnp.asarray(x), jnp.asarray(w), lab,
                                        0.4, 64.0, False, 1024))
    jdx = np.asarray(jax.grad(lambda xj: jnp.sum(j_arcface_ce_loss(
        xj, jnp.asarray(w), lab, 0.4, 64.0, False, 1024) * jnp.asarray(g)))(
            jnp.asarray(x)))
    loss, dx, dw = _port(x, w, label, g, 0.4, False, 1024)
    _close(loss, want, "loss")
    assert np.isfinite(dx).all() and np.isfinite(dw).all()
    assert not np.isfinite(jdx[2:4]).all()
    rows = [i for i in range(B) if i not in (2, 3)]
    _close(dx[rows], jdx[rows], "dx")


@pytest.mark.parametrize("tile", [3, 8, 1024])
def test_cosine_argmax_matches_jax_exactly(tile):
    x, w, _, _ = _problem(seed=2)
    w[7] = w[30]                                  # a tie: the lower class
    got = cosine_argmax(torch.tensor(x), torch.tensor(w), tile)
    want = np.asarray(j_cosine_argmax(jnp.asarray(x), jnp.asarray(w), tile))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int64


def test_bf16_input_and_shape_checks():
    x, w, label, _ = _problem(seed=3)
    xt = torch.tensor(x).bfloat16().requires_grad_(True)
    loss = arcface_ce_loss(xt, torch.tensor(w), torch.tensor(label), 0.4)
    loss.sum().backward()
    assert loss.dtype == torch.float32 and xt.grad.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="must be"):
        arcface_ce_loss(xt, torch.tensor(w[:, :5]), torch.tensor(label), 0.4)


def test_fused_text_task_equals_the_plain_one():
    """``text_arcface_task(fused_loss=True)``: the same loss and gradients
    as the margin-logit path within 1e-5 (of each tensor's largest
    gradient, at least 1e-4 of the model's: the attention key biases have
    zero gradients in exact arithmetic and carry only rounding noise), and
    accuracy from ``cosine_argmax``."""
    torch.manual_seed(0)
    model = NlpTextClassifier(
        BertConfig.tiny(hidden_dropout=0.0, attention_dropout=0.0),
        num_labels=C, policy=DTypePolicy.full_precision())
    model.train()
    rng = np.random.default_rng(4)
    batch = {"input_ids": torch.tensor(rng.integers(5, 100, (B, 10))),
             "labels": torch.tensor(rng.integers(0, C, B), dtype=torch.int32)}
    out = []
    for fused in (False, True):
        model.zero_grad()
        task = text_arcface_task(model, fused_loss=fused, loss_tile_c=8)
        loss, metrics = task.train_loss(batch, 0.3)
        loss.backward()
        out.append((float(loss), float(metrics["acc"]),
                    [p.grad.clone() for p in model.parameters()]))
    (lp, ap, gp), (lf, af, gf) = out
    assert lf == pytest.approx(lp, rel=1e-5) and af == ap
    top = max(float(b.abs().max()) for b in gp)
    for a, b in zip(gf, gp):
        scale = max(float(b.abs().max()), 1e-4 * top)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-5 * scale)
