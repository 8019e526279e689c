"""Remat of the port's BERT encoder (``BertConfig.remat``,
``remat_policy``, ``remat_skip``) against no remat and against the JAX
encoder.

The variants are the JAX package's own (tests/test_bert.py
``_REMAT_VARIANTS``): per-layer full remat, the ``dots`` policy, and
``remat_skip`` 2 and 3. The loss is the JAX test's, the sum of the
squared pooler output, on a tiny 4-layer encoder in f32.

* With dropout off every variant's loss and gradients equal the port's
  no-remat encoder bit for bit (eager PyTorch recomputes the same ops),
  and the JAX encoder's under ``disable_jit`` (the same variant, weights
  carried over by ``bert_params_from_torch``) within 1e-5 of each
  tensor's largest entry, floored at 1e-4 of the model's largest
  gradient (two implementations' f32 sums in another order; a key bias's
  gradient is zero in exact arithmetic).
* With dropout on, the two packages draw their masks from different
  generators, so remat is held within the port: each variant equals no
  remat bit for bit (the recompute draws the forward's masks again), and
  the dropout generator ends where it would without remat.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalsimilar_tpu.cli.common import _bert_config as j_bert_config
from multimodalsimilar_tpu.models.bert import BertConfig as JBertConfig
from multimodalsimilar_tpu.models.bert import (
    BertEncoderModel as JBertEncoderModel)
from multimodalsimilar_tpu.models.hf_import import bert_params_from_torch
from multimodalsimilar_tpu.utils.dtypes import DTypePolicy as JPolicy
from multimodalsimilar_tpu_torch.cli.common import _bert_config
from multimodalsimilar_tpu_torch.models.bert import (BertConfig,
                                                     BertEncoderModel,
                                                     init_bert_weights,
                                                     set_dropout_generator)
from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy

torch.set_num_threads(1)

VARIANTS = (dict(remat=True),
            dict(remat=True, remat_policy="dots"),
            dict(remat=True, remat_skip=2),
            dict(remat=True, remat_skip=3, remat_policy="dots"))
IDS = np.random.default_rng(0).integers(0, 100, size=(4, 16)).astype(
    np.int32)
MASK = (np.arange(16)[None] < np.array([[16], [9], [12], [5]])).astype(
    np.int32)


def _encoder(dropout: float = 0.0, **kw) -> BertEncoderModel:
    cfg = BertConfig.tiny(num_layers=4, hidden_dropout=dropout,
                          attention_dropout=dropout, **kw)
    model = BertEncoderModel(cfg, DTypePolicy.full_precision())
    init_bert_weights(model, torch.Generator().manual_seed(0))
    return model


def _port(model: BertEncoderModel, seed: int = 7):
    """(loss, {name: gradient}, the dropout generator's final state)."""
    gen = torch.Generator().manual_seed(seed)
    set_dropout_generator(model, gen)
    model.train()
    out = model(torch.from_numpy(IDS), torch.from_numpy(MASK))
    loss = (out["pooler_output"] ** 2).sum()
    loss.backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    return float(loss.detach()), grads, gen.get_state()


def _jax(kw, state_dict):
    """The JAX encoder of the same variant on the port's weights, its loss
    and gradients interpreted (``disable_jit``), the gradients in the
    port's names."""
    cfg = JBertConfig.tiny(num_layers=4, **kw)
    params = bert_params_from_torch(
        {k: v.numpy() for k, v in state_dict.items()}, cfg)
    model = JBertEncoderModel(cfg, JPolicy.full_precision())

    def loss_fn(p):
        out = model.apply({"params": p}, jnp.asarray(IDS),
                          jnp.asarray(MASK), deterministic=True)
        return jnp.sum(out["pooler_output"] ** 2)

    with jax.disable_jit():
        loss, grads = jax.value_and_grad(loss_fn)(params)
    from multimodalsimilar_tpu_torch.models.convert import (
        text_classifier_from_jax)
    sd = text_classifier_from_jax(
        {"tower": {"encoder": jax.device_get(grads)}},
        BertConfig.tiny(num_layers=4))
    return float(loss), {k[len("tower.encoder."):]: v
                         for k, v in sd.items()}


@pytest.mark.parametrize("kw", VARIANTS, ids=str)
def test_remat_matches_no_remat_and_jax(kw):
    base = _encoder()
    sd = {k: v.clone() for k, v in base.state_dict().items()}
    want_loss, want, _ = _port(base)
    model = _encoder(**kw)
    model.load_state_dict(sd)
    loss, grads, _ = _port(model)
    assert loss == want_loss
    for k, g in grads.items():
        assert torch.equal(g, want[k]), k
    j_loss, j_grads = _jax(kw, sd)
    np.testing.assert_allclose(loss, j_loss, rtol=1e-6)
    top = max(float(v.abs().max()) for v in j_grads.values())
    for k, g in grads.items():
        w = j_grads[k].numpy()
        scale = max(float(np.abs(w).max()), 1e-4 * top)
        assert np.abs(g.numpy() - w).max() <= 1e-5 * scale, k


@pytest.mark.parametrize("kw", VARIANTS, ids=str)
def test_remat_with_dropout_equals_no_remat_bit_for_bit(kw):
    base = _encoder(dropout=0.1)
    sd = {k: v.clone() for k, v in base.state_dict().items()}
    want_loss, want, want_state = _port(base)
    model = _encoder(dropout=0.1, **kw)
    model.load_state_dict(sd)
    loss, grads, state = _port(model)
    assert loss == want_loss
    for k, g in grads.items():
        assert torch.equal(g, want[k]), k
    # the recompute put the generator back: it ends where the forward left
    # it, as without remat
    assert torch.equal(state, want_state)


def test_remat_is_off_without_gradients():
    """In ``eval()`` under ``no_grad`` (the embedders) a remat encoder is
    the plain one."""
    base, model = _encoder(), _encoder(remat=True, remat_policy="dots")
    model.load_state_dict(base.state_dict())
    with torch.no_grad():
        a = base(torch.from_numpy(IDS), torch.from_numpy(MASK))
        b = model(torch.from_numpy(IDS), torch.from_numpy(MASK))
    assert torch.equal(a["pooler_output"], b["pooler_output"])


def test_remat_refusals_match_jax():
    """An unknown ``remat_policy`` (JAX ``_remat_policy``'s ValueError)
    and ``--remat_policy``/``--remat_skip`` without ``--remat`` (JAX
    ``cli/common.py:_bert_config``'s SystemExit), word for word."""
    with pytest.raises(ValueError) as got:
        _encoder(remat=True, remat_policy="some")
    jcfg = JBertConfig.tiny(remat=True, remat_policy="some")
    with pytest.raises(ValueError) as want:
        JBertEncoderModel(jcfg, JPolicy()).init(
            {"params": jax.random.key(0)}, jnp.zeros((1, 4), jnp.int32))
    assert str(got.value) == str(want.value)
    for kw in (dict(remat_policy="dots"), dict(remat_skip=2)):
        with pytest.raises(SystemExit) as got:
            _bert_config("tiny", **kw)
        with pytest.raises(SystemExit) as want:
            j_bert_config("tiny", **kw)
        assert str(got.value) == str(want.value)
    cfg = _bert_config("large", remat=True, sequence_parallel=True,
                       remat_policy="dots", remat_skip=3)
    assert (cfg.hidden_size, cfg.num_layers, cfg.remat, cfg.remat_policy,
            cfg.remat_skip, cfg.sequence_parallel) == (1024, 24, True,
                                                       "dots", 3, True)
