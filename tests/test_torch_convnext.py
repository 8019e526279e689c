"""The port's ConvNeXt against the JAX package's, on the CPU.

Same seeded numpy images through the JAX ``ConvNeXt`` and the port's, the
JAX weights (drawn, then jiggled from a seed so gamma, the LayerNorms and
biases are not at their init) carried over by ``convnext_from_jax``:

* ``features`` and the pre-pool map of ``convnext_test`` in full
  precision within 1e-5; under the bf16 inference policy ``features``
  within 2e-2 of the largest feature (two bf16 steps at its size);
* train mode with drop-path on (``drop_path_rate`` 0.4), both packages
  dropping the same samples (one seeded queue of masks in place of
  ``jax.random.bernoulli`` and ``torch.Tensor.bernoulli_``), within 1e-5;
* the port's weights through ``hf_import.convnext_params_from_timm``
  into the JAX model (and back, equal); ``convnext_state_from_timm`` on
  timm's names and on the FB repo's, against the JAX importer; the
  port's ``convnext_tiny`` keys and shapes equal timm's manifest;
* ``CvImageClassifier`` over ``convnext_test`` (1e-5).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalsimilar_tpu.models import convnext as JC
from multimodalsimilar_tpu.models.hf_import import convnext_params_from_timm
from multimodalsimilar_tpu.models.vision import (
    CvImageClassifier as JCvImageClassifier)
from multimodalsimilar_tpu.utils.dtypes import DTypePolicy as JPolicy
from multimodalsimilar_tpu_torch.models import convnext as C
from multimodalsimilar_tpu_torch.models.bert import set_dropout_generator
from multimodalsimilar_tpu_torch.models.convert import (
    convnext_from_jax, cv_classifier_from_jax)
from multimodalsimilar_tpu_torch.models.hf_import import (
    convnext_state_from_timm)
from multimodalsimilar_tpu_torch.models.vision import (CvImageClassifier,
                                                       backbone_config)
from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy
from tests.test_torch_vit import _MaskQueue, _images, _jiggle, _nchw

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
FULL, JFULL = DTypePolicy.full_precision(), JPolicy.full_precision()


def _jax_convnext(cfg, policy, seed=0):
    model = JC.ConvNeXt(cfg, policy)
    params = model.init({"params": jax.random.key(seed)},
                        jnp.zeros((1, 32, 32, 3)),
                        method=model.features)["params"]
    return model, _jiggle(params, seed + 1)


def _jax_features(model, params, x, train=False):
    return np.asarray(jax.jit(lambda p, x: model.apply(
        {"params": p}, x, train=train, rngs={"dropout": jax.random.key(9)},
        method=model.features))(params, jnp.asarray(x)), np.float32)


def _port(cfg, params, policy=FULL):
    model = C.ConvNeXt(cfg, policy)
    model.load_state_dict(convnext_from_jax(params, cfg))
    return model.to(memory_format=torch.channels_last)


@pytest.mark.parametrize("name", ["convnext_test"] + sorted(JC._VARIANTS))
def test_config_matches_jax(name):
    cfg, jcfg = C.ConvNeXtConfig.variant(name), JC.ConvNeXtConfig.variant(
        name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.num_features == jcfg.num_features
    rate = dataclasses.replace(cfg, drop_path_rate=0.3)
    assert rate.block_drop_paths() == dataclasses.replace(
        jcfg, drop_path_rate=0.3).block_drop_paths()
    assert backbone_config(name) == cfg
    assert backbone_config(name, image_size=384) == cfg


@pytest.mark.parametrize("policy", ["full", "inference"])
def test_features_match_jax(policy):
    jpol, pol, tol = {"full": (JFULL, FULL, 1e-5),
                      "inference": (JPolicy.inference(),
                                    DTypePolicy.inference(), 2e-2)}[policy]
    cfg = C.ConvNeXtConfig.variant("convnext_test")
    jmodel, params = _jax_convnext(JC.ConvNeXtConfig.variant(
        "convnext_test"), jpol)
    x = _images(seed=3)
    want = _jax_features(jmodel, params, x)
    model = _port(cfg, params, pol)
    with torch.no_grad():
        got = model.features(_nchw(x))
        fmap = model(_nchw(x))
    assert got.dtype == pol.reduce_dtype and got.shape == (2, 64)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())
    if policy == "full":
        jmap = np.asarray(jax.jit(lambda p, x: jmodel.apply(
            {"params": p}, x))(params, jnp.asarray(x)))
        assert jmap.shape == (2, 1, 1, 64)
        np.testing.assert_allclose(fmap.permute(0, 2, 3, 1).numpy(), jmap,
                                   rtol=0, atol=1e-5)


def test_train_mode_drop_path_matches_jax_with_shared_masks(monkeypatch):
    jcfg = JC.ConvNeXtConfig.variant("convnext_test", drop_path_rate=0.4)
    cfg = C.ConvNeXtConfig.variant("convnext_test", drop_path_rate=0.4)
    jmodel, params = _jax_convnext(jcfg, JFULL)
    x = _images(n=6, seed=4)
    q = _MaskQueue(5)
    monkeypatch.setattr(jax.random, "bernoulli", q.jax_bernoulli)
    want = _jax_features(jmodel, params, x, train=True)
    # the first block's rate is 0 (timm's schedule): no draw there
    assert len(q.masks) == sum(cfg.depths) - 1
    model = _port(cfg, params)
    set_dropout_generator(model, torch.Generator().manual_seed(0))
    monkeypatch.setattr(torch.Tensor, "bernoulli_",
                        lambda t, p=0.5, generator=None:
                        q.torch_bernoulli_(t, p, generator))
    model.train()
    with torch.no_grad():
        got = model.features(_nchw(x)).numpy()
    assert not q.masks
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    model.eval()
    with torch.no_grad():
        off = model.features(_nchw(x)).numpy()
    np.testing.assert_allclose(off, _jax_features(jmodel, params, x),
                               rtol=0, atol=1e-5)
    assert np.abs(off - got).max() > 1e-3


def test_port_weights_load_into_jax_through_timm_importer():
    cfg = C.ConvNeXtConfig.variant("convnext_test")
    model = C.ConvNeXt(cfg, FULL, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():     # gamma, LayerNorms and biases off their init
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator()
                               .manual_seed(p.numel())) * 0.1)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    jcfg = JC.ConvNeXtConfig.variant("convnext_test")
    params = convnext_params_from_timm(sd, jcfg)
    x = _images(seed=8)
    with torch.no_grad():
        got = model.features(_nchw(x)).numpy()
    np.testing.assert_allclose(
        got, _jax_features(JC.ConvNeXt(jcfg, JFULL), params, x), rtol=0,
        atol=1e-5)
    back = convnext_from_jax(params, cfg)
    assert back.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)


def _fb_names(sd):
    """timm names -> the original FB repo's."""
    out = {}
    for k, v in sd.items():
        k = (k.replace("stem.", "downsample_layers.0.")
             .replace("head.norm.", "norm."))
        for s in range(1, 4):
            k = k.replace(f"stages.{s}.downsample.",
                          f"downsample_layers.{s}.")
        k = (k.replace(".blocks.", ".").replace("conv_dw", "dwconv")
             .replace("mlp.fc1", "pwconv1").replace("mlp.fc2", "pwconv2"))
        out[k] = v
    return out


@pytest.mark.parametrize("names", ["timm", "fb"])
def test_convnext_state_from_timm_matches_the_jax_importer(names):
    cfg = C.ConvNeXtConfig.variant("convnext_test")
    src = C.ConvNeXt(cfg, FULL, generator=torch.Generator().manual_seed(12))
    sd = {k: v.numpy() for k, v in src.state_dict().items()}
    sd["head.fc.weight"] = np.zeros((5, 64), np.float32)
    sd["head.fc.bias"] = np.zeros(5, np.float32)
    if names == "fb":
        sd = _fb_names(sd)
        assert "downsample_layers.2.1.weight" in sd and \
            "stages.2.1.pwconv2.weight" in sd
    state = convnext_state_from_timm(sd, cfg)
    assert state.keys() == src.state_dict().keys()
    model = C.ConvNeXt(cfg, FULL)
    model.load_state_dict(state)
    jcfg = JC.ConvNeXtConfig.variant("convnext_test")
    params = convnext_params_from_timm(sd, jcfg)
    x = _images(seed=13)
    with torch.no_grad():
        got = model.features(_nchw(x)).numpy()
    np.testing.assert_allclose(
        got, _jax_features(JC.ConvNeXt(jcfg, JFULL), params, x), rtol=0,
        atol=1e-5)


def test_state_dict_matches_timm_manifest():
    with open(os.path.join(DATA, "timm_manifest_convnext_tiny.json")) as f:
        manifest = json.load(f)
    model = C.ConvNeXt(C.ConvNeXtConfig.variant("convnext_tiny"))
    got = {k: list(v.shape) for k, v in model.state_dict().items()}
    assert got == manifest


def test_cv_classifier_matches_jax():
    cfg = backbone_config("convnext_test")
    jcfg = JC.ConvNeXtConfig.variant("convnext_test")
    x = _images(n=3, seed=14)
    jcv = JCvImageClassifier(jcfg, num_labels=5, fc_dim=12, policy=JFULL)
    v = jcv.init({"params": jax.random.key(1)}, jnp.asarray(x),
                 label=jnp.zeros(3, jnp.int32))
    v = {"params": _jiggle(v["params"], 2),
         "batch_stats": _jiggle(v["batch_stats"], 3)}
    v["batch_stats"]["bn"]["var"] = np.abs(v["batch_stats"]["bn"]["var"])
    want = np.asarray(jcv.apply(v, jnp.asarray(x), method=jcv.predict_emb))
    model = CvImageClassifier(cfg, 5, fc_dim=12, policy=FULL)
    model.load_state_dict(cv_classifier_from_jax(v, cfg))
    model = model.to(memory_format=torch.channels_last)
    with torch.no_grad():
        got = model.predict_emb(_nchw(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
