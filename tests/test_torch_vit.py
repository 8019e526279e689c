"""The port's ViT against the JAX package's, on the CPU.

Same seeded numpy images through the JAX ``ViT`` and the port's, the JAX
weights (drawn, then jiggled from a seed so the CLS token, LayerNorms
and biases are not at their init) carried over by ``vit_from_jax``:

* ``features`` of ``vit_test`` in full precision within 1e-5, under the
  bf16 inference policy within 2e-2 of the largest feature; in train
  mode with dropout on, both packages drawing the same seeded masks
  (``jax.random.bernoulli`` and ``torch.Tensor.bernoulli_`` replaced by
  one queue of masks) within 1e-5;
* a ViT built at another image size than its preset (48 px: 37
  positions), as the JAX module sizes its table from the image;
* the port's weights through ``hf_import.vit_params_from_timm`` into
  the JAX model (and back by ``vit_from_jax``, equal); the port's
  ``vit_small`` state_dict keys and shapes equal timm's manifest;
* ``resize_bicubic`` against ``jax.image.resize(..., "bicubic")``
  growing and shrinking (within 1e-5), and ``vit_state_from_timm`` at
  another grid against the JAX importer, through both models (1e-5);
* ``CvImageClassifier`` and ``ImageTower`` over ``vit_test`` (1e-5);
* one ``train_cv_timm.yaml`` step (the cv ArcFace task, then AdamP
  with ``adamp_views``) against JAX's task and ``adamp``: the updated
  weights within 1e-6 of each tensor's largest entry, with gradients
  made scale-invariant on the tensors whose channel view differs
  (``cls_token``, ``pos_embed``, ``attn.qkv``) so the projection fires
  there, and a dim-0 view shown to miss.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodalsimilar_tpu.models import vit as JV
from multimodalsimilar_tpu.models.hf_import import vit_params_from_timm
from multimodalsimilar_tpu.models.vision import (
    CvImageClassifier as JCvImageClassifier, ImageTower as JImageTower)
from multimodalsimilar_tpu.train import optim as JO
from multimodalsimilar_tpu.train import tasks as JT
from multimodalsimilar_tpu.utils.dtypes import DTypePolicy as JPolicy
from multimodalsimilar_tpu_torch.models import vit as V
from multimodalsimilar_tpu_torch.models.convert import (
    cv_classifier_from_jax, image_tower_from_jax, vit_from_jax)
from multimodalsimilar_tpu_torch.models.hf_import import (
    interpolate_pos_embed, resize_bicubic, vit_state_from_timm)
from multimodalsimilar_tpu_torch.models.vision import (
    CvImageClassifier, ImageTower, backbone_config)
from multimodalsimilar_tpu_torch.train.optim import AdamP, adamp_views
from multimodalsimilar_tpu_torch.train.tasks import cv_arcface_task
from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
FULL, JFULL = DTypePolicy.full_precision(), JPolicy.full_precision()


def _images(n=2, size=32, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n, size, size, 3)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2)


def _jiggle(tree, seed, std=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a, np.float32)
                   + rng.normal(0, std, np.shape(a)).astype(np.float32)),
        jax.device_get(tree))


def _jax_vit(cfg, policy, size=32, seed=0):
    model = JV.ViT(cfg, policy)
    params = model.init({"params": jax.random.key(seed)},
                        jnp.zeros((1, size, size, 3)))["params"]
    return model, _jiggle(params, seed + 1)


def _jax_features(model, params, x, train=False):
    return np.asarray(jax.jit(lambda p, x: model.apply(
        {"params": p}, x, train=train, rngs={"dropout": jax.random.key(9)},
        method=model.features))(params, jnp.asarray(x)), np.float32)


@pytest.mark.parametrize("name", ["vit_test"] + sorted(JV._VARIANTS))
def test_config_matches_jax(name):
    cfg, jcfg = V.ViTConfig.variant(name), JV.ViTConfig.variant(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.num_features == jcfg.num_features
    assert backbone_config(name) == cfg
    grid = 384 // cfg.patch_size
    assert backbone_config(name, image_size=384).num_tokens == grid ** 2 + 1


@pytest.mark.parametrize("policy", ["full", "inference"])
def test_features_match_jax(policy):
    jpol, pol, tol = {"full": (JFULL, FULL, 1e-5),
                      "inference": (JPolicy.inference(),
                                    DTypePolicy.inference(), 2e-2)}[policy]
    cfg = V.ViTConfig.variant("vit_test")
    jmodel, params = _jax_vit(JV.ViTConfig.variant("vit_test"), jpol)
    x = _images(seed=3)
    want = _jax_features(jmodel, params, x)
    model = V.ViT(cfg, pol)
    model.load_state_dict(vit_from_jax(params, cfg))
    model = model.to(memory_format=torch.channels_last)
    with torch.no_grad():
        got = model.features(_nchw(x))
        tokens = model(_nchw(x))
    assert got.dtype == pol.reduce_dtype and got.shape == (2, 32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())
    if policy == "full":
        jtok = np.asarray(jax.jit(lambda p, x: jmodel.apply(
            {"params": p}, x))(params, jnp.asarray(x)))
        assert tokens.shape == jtok.shape == (2, 17, 32)
        np.testing.assert_allclose(tokens.numpy(), jtok, rtol=0, atol=1e-5)


class _MaskQueue:
    """One seeded queue of dropout masks for both packages: the JAX side
    records each mask it draws (by shape), the port replays them in the
    same order."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.masks = []

    def jax_bernoulli(self, key, p=0.5, shape=None):
        del key
        m = self.rng.random(tuple(shape)) < float(p)
        self.masks.append(m)
        return jnp.asarray(m)

    def torch_bernoulli_(self, t, p=0.5, generator=None):
        del p, generator
        m = self.masks.pop(0)
        assert tuple(t.shape) == m.shape
        return t.copy_(torch.from_numpy(m.astype(np.float32)))


def test_train_mode_dropout_matches_jax_with_shared_masks(monkeypatch):
    """cfg.dropout = 0.25: the JAX module's four sites (after the
    embeddings, the attention projection and each MLP dense) draw the
    same masks in the same order as the port's."""
    jcfg = JV.ViTConfig.variant("vit_test", dropout=0.25)
    cfg = V.ViTConfig.variant("vit_test", dropout=0.25)
    jmodel, params = _jax_vit(jcfg, JFULL)
    x = _images(seed=4)
    q = _MaskQueue(5)
    monkeypatch.setattr(jax.random, "bernoulli", q.jax_bernoulli)
    want = _jax_features(jmodel, params, x, train=True)
    assert len(q.masks) == 1 + 3 * cfg.num_layers
    model = V.ViT(cfg, FULL)
    model.load_state_dict(vit_from_jax(params, cfg))
    from multimodalsimilar_tpu_torch.models.bert import set_dropout_generator
    set_dropout_generator(model, torch.Generator().manual_seed(0))
    monkeypatch.setattr(torch.Tensor, "bernoulli_",
                        lambda t, p=0.5, generator=None:
                        q.torch_bernoulli_(t, p, generator))
    model.train()
    with torch.no_grad():
        got = model.features(_nchw(x)).numpy()
    assert not q.masks
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # eval() turns it off: the JAX module's deterministic forward
    model.eval()
    with torch.no_grad():
        off = model.features(_nchw(x)).numpy()
    np.testing.assert_allclose(off, _jax_features(jmodel, params, x),
                               rtol=0, atol=1e-5)
    assert np.abs(off - got).max() > 1e-3


def test_position_table_follows_the_image_size():
    """The JAX ViT sizes its table from the image at init (48 px of 8 px
    patches: 36 + 1 positions), whatever its config's resolution; the
    port takes the size from ``backbone_config(image_size=)``."""
    jcfg = JV.ViTConfig.variant("vit_test")
    jmodel, params = _jax_vit(jcfg, JFULL, size=48)
    assert params["pos_embed"].shape == (1, 37, 32)
    cfg = backbone_config("vit_test", image_size=48)
    assert cfg.num_tokens == 37
    model = V.ViT(cfg, FULL)
    model.load_state_dict(vit_from_jax(params, cfg))
    x = _images(size=48, seed=6)
    with torch.no_grad():
        got = model.features(_nchw(x)).numpy()
    np.testing.assert_allclose(got, _jax_features(jmodel, params, x),
                               rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="position table"):
        model.features(_nchw(_images(size=32)))


def test_port_weights_load_into_jax_through_timm_importer():
    cfg = V.ViTConfig.variant("vit_test")
    model = V.ViT(cfg, FULL, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():     # a non-zero CLS token and biases
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator()
                               .manual_seed(p.numel())) * 0.05)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    jcfg = JV.ViTConfig.variant("vit_test")
    params = vit_params_from_timm(sd, jcfg)
    x = _images(seed=8)
    jmodel = JV.ViT(jcfg, JFULL)
    with torch.no_grad():
        got = model.features(_nchw(x)).numpy()
    np.testing.assert_allclose(got, _jax_features(jmodel, params, x),
                               rtol=0, atol=1e-5)
    back = vit_from_jax(params, cfg)
    assert back.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)


def test_state_dict_matches_timm_manifest():
    with open(os.path.join(DATA,
                           "timm_manifest_vit_small_patch16_224.json")) as f:
        manifest = json.load(f)
    model = V.ViT(V.ViTConfig.variant("vit_small"))
    got = {k: list(v.shape) for k, v in model.state_dict().items()}
    assert got == manifest


@pytest.mark.parametrize("grid", [(14, 24), (14, 7), (4, 9), (9, 4)],
                         ids=["grow_14_24", "shrink_14_7", "grow_4_9",
                              "shrink_9_4"])
def test_resize_bicubic_matches_jax_image_resize(grid):
    """jax.image.resize's bicubic: Keys a = -0.5, half-pixel centres,
    antialiased and renormalized when shrinking. F.interpolate's bicubic
    differs by far more than the tolerance."""
    g_in, g_out = grid
    x = np.random.default_rng(g_in * g_out).normal(
        size=(g_in, g_in, 8)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (g_out, g_out, 8),
                                       "bicubic"))
    got = resize_bicubic(x, g_out, g_out)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    plain = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(2, 0, 1)[None], size=(g_out, g_out),
        mode="bicubic", align_corners=False)[0].permute(1, 2, 0).numpy()
    assert np.abs(plain - want).max() > 1e-2


@pytest.mark.parametrize("size", [48, 16], ids=["grow", "shrink"])
def test_vit_state_from_timm_resizes_as_the_jax_importer(size):
    """A 32 px (4 x 4 grid) timm-named state_dict with a classifier, into
    a ViT at ``size``: the port's importer and the JAX one give the same
    position table and the same features."""
    base = V.ViT(V.ViTConfig.variant("vit_test"), FULL,
                 generator=torch.Generator().manual_seed(11))
    sd = {k: v.numpy() for k, v in base.state_dict().items()}
    sd["head.weight"] = np.zeros((5, 32), np.float32)
    sd["head.bias"] = np.zeros(5, np.float32)
    cfg = backbone_config("vit_test", image_size=size)
    jcfg = JV.ViTConfig.variant("vit_test", resolution=size)
    state = vit_state_from_timm(sd, cfg)
    params = vit_params_from_timm(sd, jcfg)
    assert "head.weight" not in state
    np.testing.assert_allclose(state["pos_embed"].numpy(),
                               np.asarray(params["pos_embed"]), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(
        interpolate_pos_embed(sd["pos_embed"], 17), sd["pos_embed"])
    model = V.ViT(cfg, FULL)
    model.load_state_dict(state)
    x = _images(size=size, seed=12)
    with torch.no_grad():
        got = model.features(_nchw(x)).numpy()
    np.testing.assert_allclose(
        got, _jax_features(JV.ViT(jcfg, JFULL), params, x), rtol=0,
        atol=1e-5)


def test_cv_classifier_and_image_tower_match_jax():
    cfg = backbone_config("vit_test")
    jcfg = JV.ViTConfig.variant("vit_test")
    x = _images(n=3, seed=13)
    jcv = JCvImageClassifier(jcfg, num_labels=5, fc_dim=12, policy=JFULL)
    v = jcv.init({"params": jax.random.key(1)}, jnp.asarray(x),
                 label=jnp.zeros(3, jnp.int32))
    v = {"params": _jiggle(v["params"], 2),
         "batch_stats": _jiggle(v["batch_stats"], 3)}
    v["batch_stats"]["bn"]["var"] = np.abs(v["batch_stats"]["bn"]["var"])
    want = np.asarray(jcv.apply(v, jnp.asarray(x), method=jcv.predict_emb))
    model = CvImageClassifier(cfg, 5, fc_dim=12, policy=FULL)
    model.load_state_dict(cv_classifier_from_jax(v, cfg))
    with torch.no_grad():
        got = model.predict_emb(_nchw(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    jtower = JImageTower(jcfg, use_bn=True, policy=JFULL)
    tv = jtower.init({"params": jax.random.key(4)}, jnp.asarray(x))
    tv = {"params": _jiggle(tv["params"], 5),
          "batch_stats": _jiggle(tv["batch_stats"], 6)}
    tv["batch_stats"]["bn_layer"]["var"] = np.abs(
        tv["batch_stats"]["bn_layer"]["var"])
    tower = ImageTower(cfg, use_bn=True, policy=FULL)
    tower.load_state_dict(image_tower_from_jax(tv, cfg))
    with torch.no_grad():
        got = tower(_nchw(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jtower.apply(
        tv, jnp.asarray(x))), rtol=0, atol=1e-5)


def _orthogonal(g, p):
    """g with its component along p removed per channel row of the JAX
    view (``moveaxis(x, -1, 0)``): a scale-invariant weight's gradient."""
    g, p = np.asarray(g, np.float32), np.asarray(p, np.float32)
    gm = np.moveaxis(g, -1, 0).reshape(g.shape[-1], -1)
    pm = np.moveaxis(p, -1, 0).reshape(p.shape[-1], -1)
    gm = gm - pm * ((gm * pm).sum(1, keepdims=True)
                    / (pm * pm).sum(1, keepdims=True))
    return np.moveaxis(gm.reshape((g.shape[-1],) + g.shape[:-1]), 0,
                       -1).astype(np.float32)


class _NoDropCv(JCvImageClassifier):
    """The JAX image classifier with the neck's dropout off."""

    def predict_emb(self, images, train=False, deterministic=None):
        return super().predict_emb(images, train=train, deterministic=True)


@pytest.fixture(scope="module")
def timm_step():
    """The JAX side of one cv task step of ``vit_test`` + neck + head
    (gradients made scale-invariant on cls_token, pos_embed and qkv),
    then two ``adamp`` updates with weight decay: (variables, the batch,
    the gradients as a port state_dict, the updated weights as one)."""
    cfg, jcfg = backbone_config("vit_test"), JV.ViTConfig.variant("vit_test")
    jmodel = _NoDropCv(jcfg, num_labels=7, fc_dim=12, policy=JFULL)
    labels = np.array([1, 3, 6, 0], np.int32)
    images = np.random.default_rng(14).integers(
        0, 256, (4, 32, 32, 3)).astype(np.uint8)
    batch = {"images": images, "labels": labels}
    v = jmodel.init({"params": jax.random.key(0)},
                    jnp.asarray(images, jnp.float32),
                    label=jnp.asarray(labels))
    v = {"params": _jiggle(v["params"], 15),
         "batch_stats": jax.device_get(v["batch_stats"])}

    def loss_fn(p):
        return JT.cv_arcface_task(jmodel).train_loss(
            p, v["batch_stats"], batch, jax.random.key(0), 0.2)

    (_, (_, stats)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(v["params"])
    grads = jax.device_get(grads)
    bb, pb = grads["backbone"], v["params"]["backbone"]
    for name in ("cls_token", "pos_embed"):
        bb[name] = _orthogonal(bb[name], pb[name])
    for i in range(jcfg.num_layers):
        q, qp = bb[f"block_{i}"]["qkv"], pb[f"block_{i}"]["qkv"]
        for part in ("kernel", "bias"):
            q[part] = _orthogonal(q[part], qp[part])
    opt = JO.adamp(1e-2, weight_decay=1e-2)
    state, params = opt.init(v["params"]), v["params"]
    update = jax.jit(opt.update)
    for _ in range(2):
        upd, state = update(grads, state, params)
        params = optax.apply_updates(params, upd)
    want = cv_classifier_from_jax({"params": jax.device_get(params),
                                   "batch_stats": stats}, cfg)
    port_grads = cv_classifier_from_jax({"params": grads,
                                         "batch_stats": stats}, cfg)
    return v, batch, port_grads, want


def _port_timm_step(timm_step, views):
    """The port's step on the same batch (its gradients held to JAX's
    where they were not replaced), then two AdamP updates with
    ``views(model)`` on JAX's gradients. Returns the updated weights."""
    v, batch, port_grads, _ = timm_step
    cfg = backbone_config("vit_test")
    model = CvImageClassifier(cfg, 7, fc_dim=12, policy=FULL)
    model.load_state_dict(cv_classifier_from_jax(v, cfg))
    model.dropout.p = 0.0
    model.train()
    loss, _ = cv_arcface_task(model).train_loss(
        {k: torch.from_numpy(a) for k, a in batch.items()}, 0.2)
    loss.backward()
    top = max(float(g.abs().max()) for g in port_grads.values())
    for name, p in model.named_parameters():
        want = port_grads[name]
        if not name.endswith(("cls_token", "pos_embed", "qkv.weight",
                              "qkv.bias")):
            # zero in exact arithmetic (the final LN's shift, which the
            # neck's train-mode BN removes): tiny on both sides
            if float(want.abs().max()) <= 1e-6 * top:
                assert float(p.grad.abs().max()) <= 1e-6 * top, name
            else:
                scale = max(float(want.abs().max()), 1e-4 * top)
                np.testing.assert_allclose(p.grad.numpy(), want.numpy(),
                                           rtol=0, atol=1e-4 * scale,
                                           err_msg=name)
        p.grad = want.clone()
    opt = AdamP(model.parameters(), lr=1e-2, weight_decay=1e-2,
                views=views(model))
    for _ in range(2):
        opt.step()
    return {n: p.detach().numpy() for n, p in model.named_parameters()}


def test_adamp_views_give_the_jax_update_on_a_vit_step(timm_step):
    want = timm_step[3]
    got = _port_timm_step(timm_step, adamp_views)
    for name, p in got.items():
        w = want[name].numpy()
        np.testing.assert_allclose(
            p, w, rtol=0, atol=1e-6 * max(float(np.abs(w).max()), 1.0),
            err_msg=name)
    # the dim-0 default view misses on the tensors whose layout differs
    miss = _port_timm_step(timm_step, lambda model: {})
    bad = [n for n in ("backbone.cls_token", "backbone.pos_embed",
                       "backbone.blocks.0.attn.qkv.weight",
                       "backbone.blocks.0.attn.qkv.bias")
           if np.abs(miss[n] - want[n].numpy()).max() > 1e-5]
    assert len(bad) >= 3, bad
