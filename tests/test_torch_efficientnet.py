"""The port's EfficientNet and BN folding against the JAX package's.

Same seeded numpy inputs through the JAX ``EfficientNet.features`` and the
port's, with the JAX weights carried over by ``efficientnet_from_jax``
(BatchNorm statistics jiggled from a seed, so eval-mode BN is not the
identity): the ``tiny`` config and ``efficientnet_b0`` at 64 px (all
seven stages, 5x5 kernels, stride-2 padding). Full precision within 1e-4;
the bf16 inference policy within 2e-2. The other direction too: the
port's state_dict through ``efficientnet_params_from_timm`` into the JAX
model. Folding: the port's folded tower against its unfolded one, and
``fold_cv_classifier`` against the JAX one. The port's B4 state_dict
keys and shapes equal timm's manifest.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalsimilar_tpu.models import efficientnet as JE
from multimodalsimilar_tpu.models.fold_bn import (
    fold_cv_classifier as jfold_cv_classifier)
from multimodalsimilar_tpu.models.hf_import import (
    efficientnet_params_from_timm)
from multimodalsimilar_tpu.models.vision import (
    CvImageClassifier as JCvImageClassifier)
from multimodalsimilar_tpu.utils.dtypes import DTypePolicy as JPolicy
from multimodalsimilar_tpu_torch.models import efficientnet as E
from multimodalsimilar_tpu_torch.models.convert import (
    cv_classifier_from_jax, efficientnet_from_jax)
from multimodalsimilar_tpu_torch.models.fold_bn import (
    fold_cv_classifier, fold_efficientnet_bn)
from multimodalsimilar_tpu_torch.models.vision import (
    CvImageClassifier, backbone_config, build_backbone)
from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
TOL = {"full": 1e-4, "inference": 2e-2}
SIZES = {"tiny": 16, "efficientnet_b0": 64}
# tests/test_fold_bn.py's config: three stages, a 5x5 one among them
FOLD_CFG = dict(stages=((1, 8, 1, 1, 3), (6, 16, 2, 2, 3), (6, 24, 2, 2, 5)),
                stem_channels=8, head_channels=64, drop_path_rate=0.0)


def _policies(name):
    return ({"full": JPolicy.full_precision(),
             "inference": JPolicy.inference()}[name],
            {"full": DTypePolicy.full_precision(),
             "inference": DTypePolicy.inference()}[name])


def _jiggle(tree, seed):
    """BN statistics as training leaves them: means shifted, variances
    scaled, from a seed."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        a = np.asarray(a, np.float32)
        if path[-1].key == "mean":
            return a + rng.normal(0, 0.1, a.shape).astype(np.float32)
        if path[-1].key == "var":
            return a * rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(f, tree)


def _images(size, n=2, seed=0):
    return np.random.default_rng(seed).normal(
        size=(n, size, size, 3)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.fixture(scope="module")
def jax_nets():
    """name -> (params, batch_stats) of a JAX-initialized EfficientNet."""
    out = {}
    for name, size in SIZES.items():
        model = JE.EfficientNet(JE.EfficientNetConfig.variant(name),
                                JPolicy.full_precision())
        v = jax.jit(model.init)({"params": jax.random.key(0)},
                                jnp.asarray(_images(size)))
        out[name] = (jax.device_get(v["params"]),
                     _jiggle(jax.device_get(v["batch_stats"]), 1))
    return out


@pytest.mark.parametrize("name", ["tiny"] + sorted(JE._VARIANTS))
def test_config_and_block_plan_match_jax(name):
    jcfg = JE.EfficientNetConfig.variant(name)
    cfg = E.EfficientNetConfig.variant(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.block_plan() == jcfg.block_plan()
    assert cfg.num_features == jcfg.num_features
    for c in (3, 12.5, 24 * 1.4, 1280 * 1.8):
        assert E.round_channels(c) == JE.round_channels(c)


@pytest.mark.parametrize("policy", ["full", "inference"])
@pytest.mark.parametrize("name", sorted(SIZES))
def test_features_match_jax(jax_nets, name, policy):
    params, stats = jax_nets[name]
    jpol, pol = _policies(policy)
    x = _images(SIZES[name], seed=3)
    jmodel = JE.EfficientNet(JE.EfficientNetConfig.variant(name), jpol)
    variables = {"params": params, "batch_stats": stats}
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(
        v, x, method=jmodel.features))(variables, jnp.asarray(x)),
        np.float32)
    cfg = E.EfficientNetConfig.variant(name)
    model = E.EfficientNet(cfg, pol)
    model.load_state_dict(efficientnet_from_jax(params, stats, cfg))
    model = model.to(memory_format=torch.channels_last)
    with torch.no_grad():
        got = model.features(_nchw(x))
        fmap = model(_nchw(x))
    assert got.dtype == pol.reduce_dtype
    assert got.shape == want.shape == (2, cfg.num_features)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[policy],
                               rtol=0)
    if policy == "full":
        # the pre-pool map, NCHW against NHWC
        jmap = np.asarray(jax.jit(jmodel.apply)(variables, jnp.asarray(x)))
        np.testing.assert_allclose(fmap.permute(0, 2, 3, 1).numpy(), jmap,
                                   atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", sorted(SIZES))
def test_port_weights_load_into_jax_through_timm_importer(name):
    """The other direction: the port's seed-0 weights (BN statistics
    jiggled) as a timm state_dict -> ``efficientnet_params_from_timm`` ->
    the JAX model gives the port's features."""
    cfg = E.EfficientNetConfig.variant(name)
    model = E.EfficientNet(cfg, DTypePolicy.full_precision(),
                           generator=torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    jcfg = JE.EfficientNetConfig.variant(name)
    params, stats = efficientnet_params_from_timm(sd, jcfg)
    x = _images(SIZES[name], seed=4)
    jmodel = JE.EfficientNet(jcfg, JPolicy.full_precision())
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(
        v, x, method=jmodel.features))({"params": params,
                                        "batch_stats": stats},
                                       jnp.asarray(x)))
    with torch.no_grad():
        got = model.features(_nchw(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # and back: the JAX tree carries over to the same state_dict
    back = efficientnet_from_jax(params, stats, cfg)
    assert back.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy())


@pytest.mark.parametrize("name", sorted(SIZES))
def test_folded_backbone_matches_unfolded(jax_nets, name):
    params, stats = jax_nets[name]
    cfg = E.EfficientNetConfig.variant(name)
    pol = DTypePolicy.full_precision()
    model = E.EfficientNet(cfg, pol)
    model.load_state_dict(efficientnet_from_jax(params, stats, cfg))
    folded = E.EfficientNet(dataclasses.replace(cfg, folded=True), pol)
    folded.load_state_dict(fold_efficientnet_bn(model.state_dict(), cfg))
    assert not any(isinstance(m, torch.nn.BatchNorm2d)
                   for m in folded.modules())
    x = _nchw(_images(SIZES[name], seed=5))
    with torch.no_grad():
        want, got = model.features(x), folded.features(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("policy", ["full", "inference"])
def test_fold_cv_classifier_matches_jax(policy):
    """JAX ``fold_cv_classifier`` and the port's give the same folded
    weights, and the folded classifiers the same embeddings and logits;
    the folded JAX tree carries over through ``cv_classifier_from_jax``."""
    jpol, pol = _policies(policy)
    jcfg = JE.EfficientNetConfig(**FOLD_CFG)
    jmodel = JCvImageClassifier(jcfg, num_labels=5, fc_dim=12, policy=jpol)
    x = _images(32, seed=6)
    v = jax.jit(lambda x: jmodel.init({"params": jax.random.key(1)}, x,
                                      label=jnp.zeros(2, jnp.int32)))(
        jnp.asarray(x))
    v = {"params": jax.device_get(v["params"]),
         "batch_stats": _jiggle(jax.device_get(v["batch_stats"]), 2)}
    jfcfg, jfv = jfold_cv_classifier(v, jcfg)
    jfolded = JCvImageClassifier(jfcfg, num_labels=5, fc_dim=12, policy=jpol)
    want = np.asarray(jax.jit(lambda v, x: jfolded.apply(
        v, x, method=jfolded.predict_emb))(jfv, jnp.asarray(x)), np.float32)
    want_logits = np.asarray(jax.jit(lambda v, x: jfolded.apply(
        v, x, is_test=True))(jfv, jnp.asarray(x)))

    cfg = E.EfficientNetConfig(**FOLD_CFG)
    fcfg, fsd = fold_cv_classifier(cv_classifier_from_jax(v, cfg), cfg)
    assert fcfg.folded and dataclasses.asdict(fcfg) == \
        dataclasses.asdict(jfcfg)
    carried = cv_classifier_from_jax(jfv, fcfg)
    assert carried.keys() == fsd.keys()
    for k in fsd:
        np.testing.assert_allclose(fsd[k].numpy(), carried[k].numpy(),
                                   atol=1e-6, rtol=1e-6)
    model = CvImageClassifier(fcfg, num_labels=5, fc_dim=12, policy=pol)
    model.load_state_dict(fsd)
    model = model.to(memory_format=torch.channels_last)
    with torch.no_grad():
        got = model.predict_emb(_nchw(x)).float().numpy()
        logits = model(_nchw(x), is_test=True).numpy()
    np.testing.assert_allclose(got, want, atol=TOL[policy] * np.abs(
        want).max(), rtol=0)
    np.testing.assert_allclose(logits, want_logits, atol=TOL[policy] * 5,
                               rtol=0)


def test_b4_state_dict_matches_timm_manifest():
    with open(os.path.join(DATA, "timm_manifest_efficientnet_b4.json")) as f:
        manifest = json.load(f)
    model = E.EfficientNet(backbone_config("efficientnet_b4"))
    got = {k: list(v.shape) for k, v in model.state_dict().items()}
    assert got == manifest
    assert model.cfg.num_features == 1792


def test_eval_only_and_unported_backbones():
    model = E.EfficientNet(E.EfficientNetConfig.tiny())
    assert not model.training
    model.train()      # trains, with drop-path masks from a generator
    with pytest.raises(RuntimeError, match="generator"):
        model(torch.zeros(2, 3, 16, 16))
    # the ViT and ConvNeXt backbones are ported (tests/test_torch_vit.py,
    # tests/test_torch_convnext.py); an unknown config type is refused
    assert type(backbone_config("vit_base")).__name__ == "ViTConfig"
    assert backbone_config("vit_base", image_size=384).resolution == 384
    assert type(backbone_config("convnext_tiny")).__name__ == \
        "ConvNeXtConfig"
    with pytest.raises(TypeError, match="backbone config"):
        build_backbone(object(), DTypePolicy())
    # weights are a function of the generator's seed
    a = E.EfficientNet(E.EfficientNetConfig.tiny()).state_dict()
    b = E.EfficientNet(E.EfficientNetConfig.tiny(),
                       generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.items())
