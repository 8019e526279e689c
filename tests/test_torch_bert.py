"""Text tower parity: JAX ``NlpTextClassifier.predict_emb`` vs the port.

Both sides run on the CPU at a tiny config (2 layers, width 64) on the
same token ids, with padded masks. Weights go JAX -> port through
``text_classifier_from_jax`` and port -> JAX through the JAX package's own
``bert_params_from_torch``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalsimilar_tpu.models.bert import BertConfig as JBertConfig
from multimodalsimilar_tpu.models.classifiers import (
    NlpTextClassifier as JNlpTextClassifier)
from multimodalsimilar_tpu.models.hf_import import bert_params_from_torch
from multimodalsimilar_tpu.utils.dtypes import DTypePolicy as JPolicy
from multimodalsimilar_tpu_torch.models.bert import BertConfig
from multimodalsimilar_tpu_torch.models.classifiers import NlpTextClassifier
from multimodalsimilar_tpu_torch.models.convert import text_classifier_from_jax
from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy

torch.set_num_threads(1)

POLICIES = {"full": (JPolicy.full_precision(), DTypePolicy.full_precision()),
            "inference": (JPolicy.inference(), DTypePolicy.inference())}


def _inputs(seed=0, B=6, S=16, vocab=128):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, vocab, size=(B, S)).astype(np.int32)
    lens = rng.integers(3, S + 1, size=B)
    lens[0] = S                                   # one unpadded row
    mask = (np.arange(S)[None, :] < lens[:, None]).astype(np.int32)
    ids = np.where(mask > 0, ids, 0).astype(np.int32)
    return ids, mask, np.zeros_like(ids)


def _jax_model(pool, jpol):
    model = JNlpTextClassifier(JBertConfig.tiny(), num_labels=3, pool=pool,
                               policy=jpol)
    ids, mask, types = _inputs()
    variables = model.init({"params": jax.random.key(1)}, jnp.asarray(ids),
                           label=jnp.zeros(ids.shape[0], jnp.int32))
    return model, variables


def _jax_emb(model, variables, ids, mask, types):
    out = model.apply(variables, jnp.asarray(ids), jnp.asarray(mask),
                      jnp.asarray(types), method=model.predict_emb)
    return np.asarray(out, np.float32)


def _port_emb(model, ids, mask, types):
    with torch.inference_mode():
        out = model.predict_emb(torch.from_numpy(ids), torch.from_numpy(mask),
                                torch.from_numpy(types))
    return out.float().numpy()


def _check(got, want, policy):
    assert got.shape == want.shape and np.isfinite(got).all()
    if policy == "full":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        # bf16 rounds at other points in each framework: per-row cosine
        cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1)
                                     * np.linalg.norm(want, axis=1))
        assert cos.min() >= 0.999, cos


@pytest.mark.parametrize("policy", ["full", "inference"])
@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_predict_emb_matches_jax(pool, policy):
    jpol, tpol = POLICIES[policy]
    jmodel, variables = _jax_model(pool, jpol)
    port = NlpTextClassifier(BertConfig.tiny(), pool=pool, policy=tpol,
                             num_labels=3)
    port.load_state_dict(text_classifier_from_jax(variables["params"],
                                                  BertConfig.tiny()))
    ids, mask, types = _inputs(seed=3)
    _check(_port_emb(port, ids, mask, types),
           _jax_emb(jmodel, variables, ids, mask, types), policy)


@pytest.mark.parametrize("policy", ["full", "inference"])
@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_port_weights_load_into_jax(pool, policy):
    """Reverse direction: the port's own random init, exported through the
    JAX package's HF importer, gives the JAX model the same function."""
    jpol, tpol = POLICIES[policy]
    port = NlpTextClassifier(BertConfig.tiny(), pool=pool, policy=tpol,
                             generator=torch.Generator().manual_seed(7))
    jmodel, variables = _jax_model(pool, jpol)
    enc_sd = {k.removeprefix("tower.encoder."): v
              for k, v in port.state_dict().items()}
    params = dict(variables["params"])
    params["tower"] = {"encoder": bert_params_from_torch(
        enc_sd, JBertConfig.tiny())}
    ids, mask, types = _inputs(seed=4)
    _check(_port_emb(port, ids, mask, types),
           _jax_emb(jmodel, {"params": params}, ids, mask, types), policy)


def test_padding_invariance():
    """Pad tokens past the mask do not change a row's embedding."""
    port = NlpTextClassifier(BertConfig.tiny(), policy=POLICIES["full"][1])
    ids, mask, types = _inputs(seed=5, S=12)
    wide = np.zeros((ids.shape[0], 20), np.int32)
    wmask = np.zeros_like(wide)
    wide[:, :12], wmask[:, :12] = ids, mask
    np.testing.assert_allclose(
        _port_emb(port, wide, wmask, np.zeros_like(wide)),
        _port_emb(port, ids, mask, types), rtol=0, atol=1e-5)
