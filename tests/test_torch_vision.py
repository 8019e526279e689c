"""The port's image tower, image classifier and fused classifier against
the JAX package's, on the CPU.

JAX-initialized tiny models (BatchNorm statistics jiggled from a seed),
weights carried over by ``image_tower_from_jax``,
``cv_classifier_from_jax`` and ``multimodal_classifier_from_jax``; the
same seeded numpy images (NHWC for JAX, the same array permuted to NCHW
for the port) and token ids. Embeddings agree within 1e-4 in full
precision and 2e-2 under the bf16 inference policy; cosine logits
likewise, and margin logits (s = 64) within 64 x those. The fused
embedding is ``fc_dim + hidden`` wide with unit-norm halves: 12 + 64 at
the tiny sizes, 512 + 768 = 1,280 at EfficientNet-B4 + the base tower.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalsimilar_tpu.models.bert import BertConfig as JBertConfig
from multimodalsimilar_tpu.models.efficientnet import (
    EfficientNetConfig as JEfficientNetConfig)
from multimodalsimilar_tpu.models.multimodal import (
    MultimodalClassifier as JMultimodalClassifier)
from multimodalsimilar_tpu.models.vision import (
    CvImageClassifier as JCvImageClassifier, ImageTower as JImageTower)
from multimodalsimilar_tpu.utils.dtypes import DTypePolicy as JPolicy
from multimodalsimilar_tpu_torch.models.bert import BertConfig
from multimodalsimilar_tpu_torch.models.convert import (
    cv_classifier_from_jax, image_tower_from_jax,
    multimodal_classifier_from_jax)
from multimodalsimilar_tpu_torch.models.efficientnet import EfficientNetConfig
from multimodalsimilar_tpu_torch.models.multimodal import MultimodalClassifier
from multimodalsimilar_tpu_torch.models.vision import (
    CvImageClassifier, ImageTower, backbone_config)
from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy

torch.set_num_threads(1)

TOL = {"full": 1e-4, "inference": 2e-2}


def _policies(name):
    return ({"full": JPolicy.full_precision(),
             "inference": JPolicy.inference()}[name],
            {"full": DTypePolicy.full_precision(),
             "inference": DTypePolicy.inference()}[name])


def _jiggle(variables, seed):
    rng = np.random.default_rng(seed)

    def f(path, a):
        a = np.asarray(a, np.float32)
        if path[-1].key == "mean":
            return a + rng.normal(0, 0.1, a.shape).astype(np.float32)
        if path[-1].key == "var":
            return a * rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        return a

    v = jax.device_get(variables)
    return {"params": v["params"],
            "batch_stats": jax.tree_util.tree_map_with_path(
                f, v["batch_stats"])}


def _images(n=3, size=16, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n, size, size, 3)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _jit_apply(model, **kw):
    return jax.jit(lambda v, *a: model.apply(v, *a, **kw))


@pytest.mark.parametrize("policy", ["full", "inference"])
def test_cv_classifier_matches_jax(policy):
    jpol, pol = _policies(policy)
    x, label = _images(), np.array([1, 3, 6], np.int32)
    jmodel = JCvImageClassifier(JEfficientNetConfig.tiny(), num_labels=7,
                                fc_dim=12, policy=jpol)
    v = _jiggle(jax.jit(lambda x: jmodel.init(
        {"params": jax.random.key(0)}, x, label=jnp.zeros(3, jnp.int32)))(
            jnp.asarray(x)), 1)
    want = np.asarray(_jit_apply(jmodel, method=jmodel.predict_emb)(
        v, jnp.asarray(x)), np.float32)
    want_cos = np.asarray(_jit_apply(jmodel, is_test=True)(v, jnp.asarray(x)))
    want_margin = np.asarray(jax.jit(lambda v, x, y: jmodel.apply(
        v, x, label=y))(v, jnp.asarray(x), jnp.asarray(label)))

    cfg = EfficientNetConfig.tiny()
    model = CvImageClassifier(cfg, num_labels=7, fc_dim=12, policy=pol)
    model.load_state_dict(cv_classifier_from_jax(v, cfg))
    model = model.to(memory_format=torch.channels_last)
    with torch.no_grad():
        got = model.predict_emb(_nchw(x))
        cos = model(_nchw(x), is_test=True)
        margin = model(_nchw(x), label=torch.from_numpy(label))
    assert got.shape == (3, 12) and got.dtype == pol.reduce_dtype
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=TOL[policy] * np.abs(want).max(), rtol=0)
    np.testing.assert_allclose(cos.numpy(), want_cos, atol=TOL[policy],
                               rtol=0)
    np.testing.assert_allclose(margin.numpy(), want_margin,
                               atol=64 * TOL[policy], rtol=0)


@pytest.mark.parametrize("use_bn", [False, True])
def test_image_tower_matches_jax(use_bn):
    x = _images(seed=1)
    jtower = JImageTower(JEfficientNetConfig.tiny(), use_bn=use_bn,
                         policy=JPolicy.full_precision())
    v = _jiggle(jax.jit(lambda x: jtower.init(jax.random.key(2), x))(
        jnp.asarray(x)), 2)
    want = np.asarray(_jit_apply(jtower)(v, jnp.asarray(x)))
    cfg = EfficientNetConfig.tiny()
    tower = ImageTower(cfg, use_bn=use_bn,
                       policy=DTypePolicy.full_precision())
    tower.load_state_dict(image_tower_from_jax(v, cfg))
    with torch.no_grad():
        got = tower(_nchw(x)).numpy()
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("policy", ["full", "inference"])
def test_multimodal_classifier_matches_jax(policy):
    jpol, pol = _policies(policy)
    x = _images(seed=2)
    ids = np.random.default_rng(3).integers(
        5, 128, size=(3, 10)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 6:] = 0
    types = np.zeros_like(ids)
    jmodel = JMultimodalClassifier(JBertConfig.tiny(),
                                   JEfficientNetConfig.tiny(), num_labels=9,
                                   fc_dim=12, policy=jpol)
    v = _jiggle(jax.jit(lambda x, i: jmodel.init(
        {"params": jax.random.key(4)}, x, i, label=jnp.zeros(3, jnp.int32)))(
            jnp.asarray(x), jnp.asarray(ids)), 3)
    args = [jnp.asarray(a) for a in (x, ids, mask, types)]
    want = np.asarray(_jit_apply(jmodel, method=jmodel.predict_emb)(
        v, *args), np.float32)
    want_cos = np.asarray(_jit_apply(jmodel, is_test=True)(v, *args))

    tcfg, icfg = BertConfig.tiny(), EfficientNetConfig.tiny()
    model = MultimodalClassifier(tcfg, icfg, num_labels=9, fc_dim=12,
                                 policy=pol)
    model.load_state_dict(multimodal_classifier_from_jax(v, tcfg, icfg))
    targs = [torch.from_numpy(a) for a in (ids, mask, types)]
    with torch.no_grad():
        got = model.predict_emb(_nchw(x), *targs)
        cos = model(_nchw(x), *targs, is_test=True)
    assert got.shape == (3, 12 + tcfg.hidden_size)
    assert got.dtype == pol.reduce_dtype
    halves = got[:, :12].float(), got[:, 12:].float()
    for h in halves:
        np.testing.assert_allclose(h.norm(dim=1).numpy(), 1.0,
                                   atol=TOL[policy])
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[policy],
                               rtol=0)
    np.testing.assert_allclose(cos.numpy(), want_cos, atol=TOL[policy],
                               rtol=0)


def test_fused_width_at_production_widths():
    """EfficientNet-B4's 512-d neck ++ the base text tower's 768: 1,280,
    not the 2,560 some JAX docstrings state."""
    model = MultimodalClassifier(BertConfig.roberta_wwm_ext(),
                                 backbone_config("efficientnet_b4"),
                                 num_labels=796,
                                 policy=DTypePolicy.inference())
    ids = torch.tensor([[101, 2000, 2001, 2002, 102, 0, 0, 0]])
    with torch.no_grad():
        emb = model.predict_emb(_nchw(_images(1, 32, seed=4)), ids,
                                (ids > 0).int())
    assert emb.shape == (1, 512 + 768) and torch.isfinite(emb).all()
    assert model.head.weight.shape == (796, 1280)
    assert model.cv.backbone.cfg.num_features == 1792
