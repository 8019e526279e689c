"""The port's AdamP and cosine schedules against the JAX package's, on the
CPU.

Schedules are compared value by value over a grid of steps (both compute
in float32). AdamP runs three steps on the same parameters and gradients
as JAX ``adamp``; a Flax kernel is the torch weight transposed (conv
[kh, kw, in, out] against [out, in, kh, kw], Dense [in, out] against
[out, in]), and the ArcFace head weight is [C, D] in both packages.
Gradients are made orthogonal to the weights in JAX's channel view (the
last axis) for some tensors, so the scale-invariant projection fires
there: a [C, D] head weight is then projected per D column, which the
port does only through ``adamp_views``.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodalsimilar_tpu.models.bert import BertConfig as JBertConfig
from multimodalsimilar_tpu.models.classifiers import (
    NlpTextClassifier as JClassifier)
from multimodalsimilar_tpu.train.optim import adamp as j_adamp
from multimodalsimilar_tpu.train.optim import (
    cosine_warm_restarts as j_cosine_warm_restarts)
from multimodalsimilar_tpu.train.optim import dual_group as j_dual_group
from multimodalsimilar_tpu.train.optim import (
    timm_cosine_schedule as j_timm_cosine)
from multimodalsimilar_tpu.utils.dtypes import DTypePolicy as JPolicy
from multimodalsimilar_tpu_torch.cli.train import _trainer
from multimodalsimilar_tpu_torch.models.bert import BertConfig
from multimodalsimilar_tpu_torch.models.classifiers import NlpTextClassifier
from multimodalsimilar_tpu_torch.models.convert import text_classifier_from_jax
from multimodalsimilar_tpu_torch.train.optim import (
    AdamP, adamp_views, cosine_warm_restarts, dual_group,
    timm_cosine_schedule)
from multimodalsimilar_tpu_torch.train.tasks import text_arcface_task
from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy

torch.set_num_threads(1)


# -- schedules ---------------------------------------------------------------

@pytest.mark.parametrize("t_mult", [1, 2])
@pytest.mark.parametrize("eta_min", [0.0, 1e-5])
def test_cosine_warm_restarts_matches_jax(t_mult, eta_min):
    """Every step of four restart periods (t_mult 2: periods 7, 14, 28 x 5
    steps), restarts included, within 1e-7."""
    ours = cosine_warm_restarts(1e-4, 7, 5, t_mult=t_mult, eta_min=eta_min)
    want = j_cosine_warm_restarts(1e-4, 7, 5, t_mult=t_mult,
                                  eta_min=eta_min)
    for step in range(0, 7 * 5 * 15 + 3):
        assert ours(step) == pytest.approx(float(want(step)), abs=1e-7,
                                           rel=0), step
    assert ours(35 if t_mult == 1 else 105) == pytest.approx(1e-4)  # restart


@pytest.mark.parametrize("warmup_t,t_initial", [(5, 300), (3, 6), (0, 4)])
def test_timm_cosine_matches_jax(warmup_t, t_initial):
    """Per-epoch LR through the warmup, the cosine and the cooldown at
    lr_min, within 1e-7."""
    kw = dict(warmup_t=warmup_t, warmup_lr_init=1e-3, lr_min=1e-6)
    ours = timm_cosine_schedule(1e-4, t_initial, 4, **kw)
    want = j_timm_cosine(1e-4, t_initial, 4, **kw)
    for step in list(range(0, 4 * (t_initial + 3))) + [4 * t_initial - 1]:
        assert ours(step) == pytest.approx(float(want(step)), abs=1e-7,
                                           rel=0), step
    assert ours(4 * (t_initial + 2)) == pytest.approx(1e-6)


# -- AdamP -------------------------------------------------------------------

# name -> (torch shape, torch -> Flax layout)
SHAPES = {"conv": ((6, 4, 3, 3), lambda a: a.transpose(2, 3, 1, 0)),
          "linear": ((5, 7), lambda a: a.T),
          "bias": ((5,), lambda a: a),
          "head": ((9, 4), lambda a: a)}


def _orthogonal(g, p):
    """g with its component along p removed in each of JAX's channel rows
    (the last axis), so |cos(w, g)| ~ 0 there."""
    if p.ndim <= 1:
        return g
    rows = np.moveaxis(g, -1, 0).reshape(p.shape[-1], -1)
    prow = np.moveaxis(p, -1, 0).reshape(p.shape[-1], -1)
    norm2 = (prow * prow).sum(1)
    along = np.where(norm2 > 0, (rows * prow).sum(1) / np.maximum(norm2,
                                                                   1e-30), 0)
    rows = rows - prow * along[:, None]
    return np.moveaxis(rows.reshape((p.shape[-1],) + p.shape[:-1]), 0,
                       -1).astype(np.float32)


def _adamp_run(nesterov, weight_decay, views, steps=3):
    """(port parameters in Flax layout, JAX parameters) after ``steps``
    AdamP updates; even steps take channel-orthogonal gradients."""
    rng = np.random.default_rng(0)
    init = {k: rng.normal(size=s).astype(np.float32)
            for k, (s, _) in SHAPES.items()}
    params = {k: jnp.asarray(SHAPES[k][1](v)) for k, v in init.items()}
    tx = j_adamp(1e-2, weight_decay=weight_decay, nesterov=nesterov)
    state = tx.init(params)
    port = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
            for k, v in init.items()}
    opt = AdamP(list(port.values()), lr=1e-2, weight_decay=weight_decay,
                nesterov=nesterov,
                views={port["head"]: (SHAPES["head"][0], 1)} if views
                else None)
    for step in range(steps):
        grads = {k: rng.normal(size=np.shape(v)).astype(np.float32)
                 for k, v in params.items()}
        if step % 2 == 0:
            grads = {k: _orthogonal(g, np.asarray(params[k]))
                     for k, g in grads.items()}
        updates, state = tx.update(
            {k: jnp.asarray(g) for k, g in grads.items()}, state, params)
        params = optax.apply_updates(params, updates)
        for k, p in port.items():
            flax_to_torch = {"conv": lambda a: a.transpose(3, 2, 0, 1),
                             "linear": lambda a: a.T}.get(k, lambda a: a)
            p.grad = torch.from_numpy(np.ascontiguousarray(
                flax_to_torch(grads[k])))
        opt.step()
    got = {k: SHAPES[k][1](p.detach().numpy()) for k, p in port.items()}
    return got, {k: np.asarray(v) for k, v in params.items()}


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_adamp_matches_jax(nesterov, weight_decay):
    """Three steps on a conv kernel, a Linear weight, a 1-D bias and a
    [C, D] head weight: equal to JAX within 1e-6."""
    got, want = _adamp_run(nesterov, weight_decay, views=True)
    for k in SHAPES:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6,
                                   err_msg=k)


def test_adamp_head_weight_needs_the_jax_channel_view():
    """JAX projects a [C, D] head weight per D column. Taking timm's
    class rows instead (no view) leaves the projection out on the head,
    and the head's update differs from JAX's by far more than 1e-6; the
    other tensors are unaffected."""
    got, want = _adamp_run(False, 1e-2, views=False)
    assert np.abs(got["head"] - want["head"]).max() > 1e-4
    for k in ("conv", "linear", "bias"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6)


def test_dual_adamp_on_a_text_classifier_matches_jax():
    """Two dual-group AdamP steps on every parameter of a tiny text
    classifier (embeddings [V, H], BERT query/key/value Flax kernels [in,
    heads, head_dim] and biases [heads, head_dim], Dense kernels, layer
    norms, the head) with channel-orthogonal gradients: ``adamp_views``
    picks JAX's channel rows for each, so the parameters agree within
    1e-6."""
    rng = np.random.default_rng(1)
    jcfg = JBertConfig.tiny(hidden_dropout=0.0, attention_dropout=0.0)
    jmodel = JClassifier(jcfg, num_labels=6,
                         policy=JPolicy.full_precision())
    ids = jnp.asarray(rng.integers(5, 100, (2, 8)), jnp.int32)
    params = jax.device_get(jmodel.init(jax.random.key(0), ids)["params"])
    cfg = BertConfig.tiny(hidden_dropout=0.0, attention_dropout=0.0)
    model = NlpTextClassifier(cfg, num_labels=6,
                              policy=DTypePolicy.full_precision())
    model.load_state_dict(text_classifier_from_jax(params, cfg))
    const = lambda lr: (lambda step: lr)  # noqa: E731
    tx = j_dual_group(j_adamp(const(1e-2), weight_decay=1e-2),
                      j_adamp(const(5e-2)))
    state = tx.init(params)
    update = jax.jit(tx.update)
    opt, _ = dual_group(model, AdamP, const(1e-2), const(5e-2),
                        weight_decay=1e-2, head_weight_decay=0.0,
                        views=adamp_views(model))
    names = dict(model.named_parameters())
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda p: _orthogonal(rng.normal(size=np.shape(p)).astype(
                np.float32), np.asarray(p)), params)
        updates, state = update(grads, state, params)
        params = jax.device_get(optax.apply_updates(params, updates))
        for name, g in text_classifier_from_jax(grads, cfg).items():
            names[name].grad = g
        opt.step()
    want = text_classifier_from_jax(params, cfg)
    assert all(np.isfinite(v.numpy()).all() for v in want.values())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_trainer_builds_adamp_and_cosine_schedules_in_optimizer_steps(
        tmp_path):
    """``_trainer`` under ``--grad_accum 2``: schedules built over
    optimizer steps (10 micro-steps per epoch -> 5), AdamP with the
    model's channel views for ``--optimizer adamp``, AdamW otherwise."""
    model = NlpTextClassifier(BertConfig.tiny(), num_labels=5)
    base = dict(tower_lr=1e-4, head_lr=2e-4, head_warmup_frac=0.0,
                weight_decay=1e-5, head_weight_decay=0.0, eval_every=10,
                save_every=10, log_every=10, margin=0.2,
                margin_delta_per_epoch=0.0, output=str(tmp_path), seed=0,
                epochs=12, grad_accum=2, cooldown_epochs=2,
                warmup_epochs=3, warmup_lr_init=1e-3, lr_min=1e-6,
                t0_epochs=4)
    args = argparse.Namespace(**base, optimizer="adamp",
                              scheduler="timm_cosine")
    trainer = _trainer(text_arcface_task(model), args, 10, device="cpu")
    assert isinstance(trainer.optimizer, AdamP)
    assert trainer.optimizer.views == adamp_views(trainer.model)
    assert trainer.config.grad_accum == 2
    tower, head = trainer.schedules.schedules
    want = j_timm_cosine(1e-4, 10, 5, 3, 1e-3, 1e-6)
    for step in range(0, 70, 3):
        assert tower(step) == pytest.approx(float(want(step)), abs=1e-7)
    args = argparse.Namespace(**base, optimizer="adamw",
                              scheduler="cosine_warm_restarts")
    trainer = _trainer(text_arcface_task(model), args, 10, device="cpu")
    assert isinstance(trainer.optimizer, torch.optim.AdamW)
    want = j_cosine_warm_restarts(2e-4, 4, 5)
    head = trainer.schedules.schedules[1]
    for step in range(0, 70, 3):
        assert head(step) == pytest.approx(float(want(step)), abs=1e-7)
