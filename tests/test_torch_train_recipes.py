"""The training recipes of the port against the JAX package's, on the CPU
at tiny sizes (``EfficientNetConfig.tiny()`` at 16 px, ``BertConfig.tiny``,
full precision).

Weights go JAX -> port through ``models/convert.py``; inputs come from
numpy seeds and both packages get the same arrays. Dropout and drop-path
are 0 (or, for the cv neck, off through JAX ``predict_emb(train=True,
deterministic=True)``): the two frameworks' random bits never match.
Tolerances: features 1e-4 of their largest entry; BatchNorm running
statistics 1e-5; losses 1e-5 relative; gradients 1e-4 of each tensor's
largest entry (at least 1e-4 of the model's largest gradient). Some
tensors have zero gradients in exact arithmetic and carry rounding noise
only: the attention key biases (softmax ignores a per-query constant) and
the biases of BatchNorms whose output reaches the loss only through a
convolution into another train-mode BatchNorm (which subtracts any
per-channel constant). Where JAX's largest entry is below 1e-6 of the
model's largest gradient, both sides must stay below that.
"""

import argparse
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

from multimodalsimilar_tpu.cli.parser import build_parser
from multimodalsimilar_tpu.data import datasets as JD
from multimodalsimilar_tpu.data.sampling import PairSampler as JPairSampler
from multimodalsimilar_tpu.data.tokenizer import TextTokenizer as JTokenizer
from multimodalsimilar_tpu.models import efficientnet as JE
from multimodalsimilar_tpu.models import multimodal as JM
from multimodalsimilar_tpu.models.bert import BertConfig as JBertConfig
from multimodalsimilar_tpu.models.classifiers import (
    NlpMultilabelClassifier as JMultilabel)
from multimodalsimilar_tpu.models.classifiers import (
    NlpTextClassifier as JTextClassifier)
from multimodalsimilar_tpu.models.classifiers import (
    SiamesePairModel as JSiamese)
from multimodalsimilar_tpu.models.vision import (
    CvImageClassifier as JCvImageClassifier)
from multimodalsimilar_tpu.parallel.mesh import create_mesh
from multimodalsimilar_tpu.train import tasks as JT
from multimodalsimilar_tpu.train.optim import dual_group as j_dual_group
from multimodalsimilar_tpu.train.optim import (
    linear_schedule_with_warmup as j_linear)
from multimodalsimilar_tpu.train.trainer import Trainer as JTrainer
from multimodalsimilar_tpu.train.trainer import (
    TrainerConfig as JTrainerConfig)
from multimodalsimilar_tpu.utils.dtypes import DTypePolicy as JPolicy
from multimodalsimilar_tpu_torch.cli import train as CT
from multimodalsimilar_tpu_torch.data.datasets import (
    ImageClassificationSource, MultimodalSource, PairTextSource,
    TextClassificationSource)
from multimodalsimilar_tpu_torch.data.sampling import (PairSampler,
                                                       WeightedSampler,
                                                       class_balance_weights)
from multimodalsimilar_tpu_torch.data.tokenizer import TextTokenizer
from multimodalsimilar_tpu_torch.models import efficientnet as E
from multimodalsimilar_tpu_torch.models.bert import (BertConfig,
                                                     set_dropout_generator)
from multimodalsimilar_tpu_torch.models.classifiers import (
    NlpMultilabelClassifier, NlpTextClassifier, SiamesePairModel)
from multimodalsimilar_tpu_torch.models.convert import (
    cv_classifier_from_jax, efficientnet_from_jax,
    multilabel_classifier_from_jax, multimodal_classifier_from_jax,
    siamese_pair_from_jax, text_classifier_from_jax)
from multimodalsimilar_tpu_torch.models.multimodal import MultimodalClassifier
from multimodalsimilar_tpu_torch.models.vision import CvImageClassifier
from multimodalsimilar_tpu_torch.train.optim import (
    dual_group, dual_group_adamw, linear_schedule_with_warmup)
from multimodalsimilar_tpu_torch.train.tasks import (
    cv_arcface_task, multilabel_arcface_task, multimodal_arcface_task,
    pair_task, text_arcface_task)
from multimodalsimilar_tpu_torch.train.trainer import Trainer, TrainerConfig
from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy

torch.set_num_threads(1)

FULL, JFULL = DTypePolicy.full_precision(), JPolicy.full_precision()
NO_DROPOUT = dict(hidden_dropout=0.0, attention_dropout=0.0)
SIZE = 16


def _tiny_cfgs():
    """The tiny backbone without drop-path, in both packages."""
    return (dataclasses.replace(JE.EfficientNetConfig.tiny(),
                                drop_path_rate=0.0),
            dataclasses.replace(E.EfficientNetConfig.tiny(),
                                drop_path_rate=0.0))


def _jiggle(stats, seed):
    """BN statistics as training leaves them (means shifted, variances
    scaled), so batch statistics differ from the running ones."""
    rng = np.random.default_rng(seed)

    def f(path, a):
        a = np.asarray(a, np.float32)
        if path[-1].key == "mean":
            return a + rng.normal(0, 0.1, a.shape).astype(np.float32)
        return a * rng.uniform(0.5, 2.0, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, jax.device_get(stats))


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _assert_grads(got: dict, want: dict, names=None):
    """Every gradient within 1e-4 of its tensor's largest entry (floored
    at 1e-4 of the model's largest gradient); zero-in-exact-arithmetic
    ones below 1e-6 of it on both sides."""
    names = names or list(want)
    top = max(float(want[n].abs().max()) for n in names)
    for n in names:
        w = want[n].numpy()
        if np.abs(w).max() <= 1e-6 * top:
            assert float(got[n].abs().max()) <= 1e-6 * top, n
            continue
        scale = max(float(np.abs(w).max()), 1e-4 * top)
        np.testing.assert_allclose(got[n].numpy(), w, rtol=0,
                                   atol=1e-4 * scale, err_msg=n)


def _port_grads(model):
    return {n: p.grad for n, p in model.named_parameters()}


# -- EfficientNet in train mode ----------------------------------------------

def test_efficientnet_train_mode_matches_jax():
    """Features, updated running statistics and the gradients of a scalar
    loss against JAX ``apply(..., train=True, mutable=["batch_stats"])``.
    The running variance moves with the BIASED batch variance, as Flax's
    does: the unbiased one (``F.batch_norm``'s) is n/(n-1) larger and
    misses the 1e-5 tolerance."""
    jcfg, cfg = _tiny_cfgs()
    jmodel = JE.EfficientNet(jcfg, JFULL)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, SIZE, SIZE, 3)).astype(np.float32)
    r = rng.normal(size=(4, cfg.num_features)).astype(np.float32)
    v = jax.jit(jmodel.init)({"params": jax.random.key(0)}, jnp.asarray(x))
    params, stats = jax.device_get(v["params"]), _jiggle(v["batch_stats"], 1)

    def loss(p):
        feats, mutated = jmodel.apply(
            {"params": p, "batch_stats": stats}, jnp.asarray(x), train=True,
            mutable=["batch_stats"], method=jmodel.features)
        return jnp.sum(feats * jnp.asarray(r)), (feats, mutated)

    (_, (want, mutated)), jgrads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    model = E.EfficientNet(cfg, FULL)
    model.load_state_dict(efficientnet_from_jax(params, stats, cfg))
    model = model.to(memory_format=torch.channels_last).train()
    feats = model.features(_nchw(x))
    (feats * torch.from_numpy(r)).sum().backward()
    want = np.asarray(want)
    np.testing.assert_allclose(feats.detach().numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    new = efficientnet_from_jax(params, mutated["batch_stats"], cfg)
    buffers = dict(model.named_buffers())
    for name, t in new.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buffers[name].numpy(), t.numpy(),
                                       rtol=0, atol=1e-5, err_msg=name)
    # the unbiased update would miss: the head BN sees 4 x 4 x 4 values
    n = 4 * (SIZE // 4) ** 2
    old = efficientnet_from_jax(params, stats, cfg)["bn2.running_var"]
    biased = (new["bn2.running_var"] - 0.9 * old) / 0.1
    assert float((0.1 * biased * (n / (n - 1) - 1)).abs().max()) > 1e-5
    _assert_grads(_port_grads(model), efficientnet_from_jax(
        jax.device_get(jgrads), stats, cfg),
        [n for n, _ in model.named_parameters()])


def test_drop_path_and_neck_dropout_use_the_generator():
    """DropPath drops whole samples, scales survivors by 1/keep, draws
    from the generator that set_dropout_generator hands out (the global
    RNG is unused), and is off in eval(); the cv neck's dropout(0.5) is
    on in train() only."""
    dp = E.DropPath(0.25).train()
    x = torch.ones(256, 3, 2, 2)
    with pytest.raises(RuntimeError, match="generator"):
        dp(x)
    gen = torch.Generator()
    set_dropout_generator(dp, gen)
    gen.manual_seed(3)
    a = dp(x)
    per_sample = a.flatten(1)
    assert ((per_sample == 0).all(1) | (per_sample == 1 / 0.75).all(1)).all()
    assert 0.1 < float((per_sample[:, 0] == 0).float().mean()) < 0.4
    torch.manual_seed(0)
    gen.manual_seed(3)
    assert torch.equal(dp(x), a)
    assert torch.equal(dp.eval()(x), x)

    _, cfg = _tiny_cfgs()
    model = CvImageClassifier(cfg, num_labels=5, fc_dim=8, policy=FULL)
    set_dropout_generator(model, gen)
    images = torch.randn(4, 3, SIZE, SIZE,
                         generator=torch.Generator().manual_seed(1))
    assert model.dropout.generator is gen and model.dropout.p == 0.5
    paths = [m for m in model.modules() if isinstance(m, E.DropPath)]
    assert paths and all(m.generator is gen for m in paths)
    model.train()
    gen.manual_seed(5)
    first = model.predict_emb(images)
    gen.manual_seed(6)
    assert not torch.allclose(model.predict_emb(images), first)
    model.eval()
    assert torch.equal(model.predict_emb(images), model.predict_emb(images))


# -- one task step per task ------------------------------------------------

class _NoDropCv(JCvImageClassifier):
    """The JAX image classifier with the neck's dropout off in train
    mode (``predict_emb(train=True, deterministic=True)``)."""

    def predict_emb(self, images, train=False, deterministic=None):
        return super().predict_emb(images, train=train, deterministic=True)


def _images(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (n, SIZE, SIZE, 3)).astype(np.uint8)


def _jax_step(task, variables, batch, margin):
    """(loss, new batch_stats, grads) of one JAX task step."""
    def loss_fn(p):
        return task.train_loss(p, variables.get("batch_stats", {}), batch,
                               jax.random.key(0), margin)

    (loss, (_, stats)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    return float(loss), jax.device_get(stats), jax.device_get(grads)


def _port_step(task, batch, margin):
    task.model.train()
    loss, metrics = task.train_loss(_tensors(batch), margin)
    loss.backward()
    return float(loss), metrics


def test_cv_task_step_matches_jax():
    jcfg, cfg = _tiny_cfgs()
    jmodel = _NoDropCv(jcfg, num_labels=7, fc_dim=12, policy=JFULL)
    labels = np.array([1, 3, 6, 0], np.int32)
    batch = {"images": _images(4, 2), "labels": labels}
    v = jax.jit(lambda x: jmodel.init({"params": jax.random.key(0)}, x,
                                      label=jnp.asarray(labels)))(
        jnp.asarray(batch["images"], jnp.float32))
    v = {"params": jax.device_get(v["params"]),
         "batch_stats": _jiggle(v["batch_stats"], 2)}
    jloss, jstats, jgrads = _jax_step(JT.cv_arcface_task(jmodel), v, batch,
                                      0.3)
    model = CvImageClassifier(cfg, num_labels=7, fc_dim=12, policy=FULL)
    model.load_state_dict(cv_classifier_from_jax(v, cfg))
    model.dropout.p = 0.0
    loss, metrics = _port_step(cv_arcface_task(model), batch, 0.3)
    assert loss == pytest.approx(jloss, rel=1e-5)
    new = cv_classifier_from_jax({"params": v["params"],
                                  "batch_stats": jstats}, cfg)
    for name, t in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), new[name].numpy(),
                                       rtol=0, atol=1e-5, err_msg=name)
    _assert_grads(_port_grads(model), cv_classifier_from_jax(
        {"params": jgrads, "batch_stats": jstats}, cfg),
        [n for n, _ in model.named_parameters()])


def test_multimodal_task_step_matches_jax(monkeypatch):
    monkeypatch.setattr(JM, "CvImageClassifier", _NoDropCv)
    jcfg, cfg = _tiny_cfgs()
    jtcfg = JBertConfig.tiny(**NO_DROPOUT)
    tcfg = BertConfig.tiny(**NO_DROPOUT)
    jmodel = JM.MultimodalClassifier(jtcfg, jcfg, num_labels=9, fc_dim=12,
                                     policy=JFULL)
    rng = np.random.default_rng(3)
    ids = rng.integers(5, 100, (4, 10)).astype(np.int32)
    mask = (np.arange(10)[None] < rng.integers(3, 11, (4, 1))).astype(
        np.int32)
    batch = {"images": _images(4, 4), "input_ids": ids * mask,
             "attention_mask": mask, "token_type_ids": np.zeros_like(ids),
             "labels": np.array([8, 0, 3, 3], np.int32)}
    v = jax.jit(lambda x, i: jmodel.init({"params": jax.random.key(0)}, x,
                                         i, label=jnp.zeros(4, jnp.int32)))(
        jnp.asarray(batch["images"], jnp.float32),
        jnp.asarray(batch["input_ids"]))
    v = {"params": jax.device_get(v["params"]),
         "batch_stats": _jiggle(v["batch_stats"], 3)}
    jloss, jstats, jgrads = _jax_step(JT.multimodal_arcface_task(jmodel), v,
                                      batch, 0.5)
    model = MultimodalClassifier(tcfg, cfg, num_labels=9, fc_dim=12,
                                 policy=FULL)
    model.load_state_dict(multimodal_classifier_from_jax(v, tcfg, cfg))
    model.cv.dropout.p = 0.0
    loss, _ = _port_step(multimodal_arcface_task(model), batch, 0.5)
    assert loss == pytest.approx(jloss, rel=1e-5)
    new = multimodal_classifier_from_jax(
        {"params": v["params"], "batch_stats": jstats}, tcfg, cfg)
    for name, t in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), new[name].numpy(),
                                       rtol=0, atol=1e-5, err_msg=name)
    _assert_grads(_port_grads(model), multimodal_classifier_from_jax(
        {"params": jgrads, "batch_stats": jstats}, tcfg, cfg),
        [n for n, _ in model.named_parameters()])


def _text_batch(rng, n=8, length=12):
    ids = rng.integers(5, 100, (n, length)).astype(np.int32)
    mask = (np.arange(length)[None] < rng.integers(3, length + 1, (n, 1))
            ).astype(np.int32)
    return {"input_ids": ids * mask, "attention_mask": mask,
            "token_type_ids": np.zeros_like(ids)}


@pytest.mark.parametrize("fused", [False, True])
def test_multilabel_task_step_matches_jax(fused):
    rng = np.random.default_rng(4)
    batch = _text_batch(rng)
    batch.update(lv1_label=rng.integers(0, 3, 8).astype(np.int32),
                 lv2_label=rng.integers(0, 7, 8).astype(np.int32),
                 tag_label=rng.integers(0, 19, 8).astype(np.int32))
    jmodel = JMultilabel(JBertConfig.tiny(**NO_DROPOUT), 3, 7, 19,
                         policy=JFULL)
    params = jax.device_get(jax.jit(lambda i: jmodel.init(
        {"params": jax.random.key(1)}, i))(jnp.asarray(batch["input_ids"])
                                          )["params"])
    jloss, _, jgrads = _jax_step(
        JT.multilabel_arcface_task(jmodel, fused_loss=fused,
                                   loss_tile_c=5),
        {"params": params}, batch, 0.0)
    cfg = BertConfig.tiny(**NO_DROPOUT)
    model = NlpMultilabelClassifier(cfg, 3, 7, 19, policy=FULL)
    model.load_state_dict(multilabel_classifier_from_jax(params, cfg))
    task = multilabel_arcface_task(model, fused_loss=fused, loss_tile_c=5)
    assert not task.dynamic_margin
    loss, _ = _port_step(task, batch, 0.0)
    assert loss == pytest.approx(jloss, rel=1e-5)
    _assert_grads(_port_grads(model),
                  multilabel_classifier_from_jax(jgrads, cfg))


def test_pair_task_step_matches_jax():
    rng = np.random.default_rng(5)
    q, t = _text_batch(rng), _text_batch(rng)
    batch = {f"query_{k}": v for k, v in q.items()}
    batch.update({f"title_{k}": v for k, v in t.items()})
    batch["labels"] = rng.integers(0, 2, 8).astype(np.int32)
    jmodel = JSiamese(JBertConfig.tiny(**NO_DROPOUT), policy=JFULL)
    params = jax.device_get(jax.jit(lambda a, b: jmodel.init(
        {"params": jax.random.key(2)}, a, b))(
            jnp.asarray(q["input_ids"]), jnp.asarray(t["input_ids"])
    )["params"])
    jloss, _, jgrads = _jax_step(JT.pair_task(jmodel), {"params": params},
                                 batch, 0.0)
    cfg = BertConfig.tiny(**NO_DROPOUT)
    model = SiamesePairModel(cfg, policy=FULL)
    model.load_state_dict(siamese_pair_from_jax(params, cfg))
    loss, _ = _port_step(pair_task(model), batch, 0.0)
    assert loss == pytest.approx(jloss, rel=1e-5)
    _assert_grads(_port_grads(model), siamese_pair_from_jax(jgrads, cfg))


# -- the Trainer -------------------------------------------------------------

def _text_table(n, seed=0, n_cls=5):
    rng = np.random.default_rng(seed)
    markers = "甲乙丙丁戊己庚"
    pool = list("水果蔬菜饮料零食牛奶面包")
    lv1 = rng.integers(0, 3, n)
    lv2 = lv1 * 2 + rng.integers(0, 2, n)
    tag = np.minimum(rng.geometric(0.4, n) - 1, n_cls - 1)
    titles = [markers[k] * 3 + "".join(rng.choice(pool, rng.integers(1, 8)))
              for k in tag]
    return pd.DataFrame({"spu_name": titles, "lv1_category_id": lv1,
                         "lv2_category_id": lv2, "tag_new_id": tag,
                         "labels": tag})


def _lines(path):
    return [json.loads(ln) for ln in open(path)]


def test_multilabel_fit_matches_jax_step_by_step(tmp_path):
    """The JAX Trainer.fit and the port's on the same table, from the same
    weights: dual-group AdamW, class-balanced sampling by lv2, log every
    step, eval every 3 steps. Per-step losses within 1e-4 relative (Adam
    turns rounding-level gradient differences into lr-sized steps on
    near-zero coordinates), eval accuracies equal."""
    df, held = _text_table(64), _text_table(24, seed=1)
    cols = ["lv1_category_id", "lv2_category_id", "tag_new_id"]
    jtok = JTokenizer.from_corpus(pd.concat([df, held])["spu_name"])
    tok = TextTokenizer.from_corpus(pd.concat([df, held])["spu_name"])
    jsrc, jev = (CT._Renamed(JD.TextClassificationSource(
        t, jtok, "spu_name", cols, 12, clean=False), cols)
        for t in (df, held))
    src, ev = (CT._Renamed(TextClassificationSource(
        t, tok, "spu_name", cols, 12, clean=False), cols)
        for t in (df, held))
    cfg = dict(eval_every=3, save_every=10**9, log_every=1)
    total, bs = 2 * (64 // 16), 16
    args = argparse.Namespace(weighted_sampling=True, seed=0)
    jmodel = JMultilabel(JBertConfig.tiny(vocab_size=tok.vocab_size,
                                          **NO_DROPOUT), 3, 6, 5,
                         policy=JFULL)
    tx = j_dual_group(optax.adamw(j_linear(1e-3, 0, total), weight_decay=0.01),
                      optax.adamw(j_linear(1e-2, 0, total),
                                  weight_decay=0.01))
    jtrainer = JTrainer(JT.multilabel_arcface_task(jmodel), tx,
                        create_mesh(), JTrainerConfig(
                            metrics_path=str(tmp_path / "j.jsonl"), **cfg))
    state0 = jtrainer.init_state(next(jsrc.batches(bs, shuffle=False)))
    jtrainer.fit(jsrc, 2, bs, jev, initial_state=state0,
                 sampler_fn=CT._sampler_fn(args, df, "lv2_category_id"))

    tcfg = BertConfig.tiny(vocab_size=tok.vocab_size, **NO_DROPOUT)
    model = NlpMultilabelClassifier(tcfg, 3, 6, 5, policy=FULL)
    model.load_state_dict(multilabel_classifier_from_jax(
        jax.device_get(state0.params), tcfg))
    trainer = Trainer(
        multilabel_arcface_task(model),
        lambda m: dual_group_adamw(
            m, linear_schedule_with_warmup(1e-3, 0, total),
            linear_schedule_with_warmup(1e-2, 0, total), 0.01),
        TrainerConfig(metrics_path=str(tmp_path / "t.jsonl"), **cfg),
        device="cpu")
    trainer.fit(src, 2, bs, ev,
                sampler_fn=CT._sampler_fn(args, df, "lv2_category_id"))
    jl, tl = _lines(tmp_path / "j.jsonl"), _lines(tmp_path / "t.jsonl")

    def pick(lines, k):
        return [(ln["step"], ln[k]) for ln in lines if k in ln]

    jloss, tloss = pick(jl, "train/loss"), pick(tl, "train/loss")
    assert [s for s, _ in tloss] == [s for s, _ in jloss] == list(
        range(1, total + 1))
    np.testing.assert_allclose([v for _, v in tloss], [v for _, v in jloss],
                               rtol=1e-4)
    for k in ("eval/acc", "eval/lv1_acc", "eval/lv2_acc"):
        got, want = pick(tl, k), pick(jl, k)
        assert [s for s, _ in got] == [s for s, _ in want] == [3, 6], k
        np.testing.assert_allclose([v for _, v in got],
                                   [v for _, v in want], rtol=0, atol=1e-6)


def test_grad_accum_matches_jax_multisteps(tmp_path):
    """``grad_accum=2`` on a BN-free model (the text classifier) against
    JAX ``optax.MultiSteps(every_k_schedule=2)``: SGD keeps the comparison
    linear in the gradients, so after 3 optimizer steps (6 micro-steps)
    every parameter agrees within 1e-5; logs fire on boundaries only, at
    micro-step keys with the optimizer step beside them."""
    df = _text_table(48, seed=2)
    jtok = JTokenizer.from_corpus(df["spu_name"])
    tok = TextTokenizer.from_corpus(df["spu_name"])
    jsrc = JD.TextClassificationSource(df, jtok, max_length=12, clean=False)
    src = TextClassificationSource(df, tok, max_length=12, clean=False)
    jmodel = JTextClassifier(JBertConfig.tiny(vocab_size=tok.vocab_size,
                                              **NO_DROPOUT), 5,
                             policy=JFULL)
    tx = optax.MultiSteps(j_dual_group(optax.sgd(1e-2), optax.sgd(1e-1)),
                          every_k_schedule=2)
    cfg = dict(log_every=1, eval_every=10**9, save_every=10**9)
    jtrainer = JTrainer(JT.text_arcface_task(jmodel), tx, create_mesh(),
                        JTrainerConfig(metrics_path=str(tmp_path / "j.jsonl"),
                                       grad_accum=2, **cfg))
    state0 = jtrainer.init_state(next(jsrc.batches(8, shuffle=False)))
    params0 = jax.device_get(state0.params)
    state = jtrainer.fit(jsrc, 1, 8, initial_state=state0)

    tcfg = BertConfig.tiny(vocab_size=tok.vocab_size, **NO_DROPOUT)
    model = NlpTextClassifier(tcfg, num_labels=5, policy=FULL)
    model.load_state_dict(text_classifier_from_jax(params0, tcfg))
    const = lambda lr: (lambda step: lr)  # noqa: E731
    trainer = Trainer(text_arcface_task(model),
                      lambda m: dual_group(m, torch.optim.SGD, const(1e-2),
                                           const(1e-1)),
                      TrainerConfig(metrics_path=str(tmp_path / "t.jsonl"),
                                    grad_accum=2, **cfg), device="cpu")
    trainer.fit(src, 1, 8)
    assert trainer.step == 6 and trainer.schedules.count == 3
    want = text_classifier_from_jax(jax.device_get(state.params), tcfg)
    assert not torch.equal(model.head.weight.detach(),
                           text_classifier_from_jax(params0, tcfg)[
                               "head.weight"])
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
    jl, tl = _lines(tmp_path / "j.jsonl"), _lines(tmp_path / "t.jsonl")
    assert [(ln["step"], ln["train/opt_step"]) for ln in tl] == [
        (ln["step"], ln["train/opt_step"]) for ln in jl] == [
        (2, 1.0), (4, 2.0), (6, 3.0)]
    np.testing.assert_allclose([ln["train/loss"] for ln in tl],
                               [ln["train/loss"] for ln in jl], rtol=1e-5)


def _write_images(root, keys, size=20, seed=0, skip=()):
    import cv2
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for k in keys:
        img = rng.integers(0, 256, (size, size, 3)).astype(np.uint8)
        if k not in skip:
            cv2.imwrite(os.path.join(root, f"{k}.jpg"), img)


def _cv_trainer(tmp_path, table, **cfg):
    _, ecfg = _tiny_cfgs()
    model = CvImageClassifier(dataclasses.replace(ecfg, drop_path_rate=0.2),
                              num_labels=4, fc_dim=8, policy=FULL,
                              generator=torch.Generator().manual_seed(7))
    sched = linear_schedule_with_warmup(1e-2, 0, 10)
    trainer = Trainer(cv_arcface_task(model),
                      lambda m: dual_group_adamw(m, sched, sched, 0.01),
                      TrainerConfig(checkpoint_dir=str(tmp_path / "ckpt"),
                                    save_every=10**9, log_every=1,
                                    eval_every=10**9, grad_accum=2,
                                    margin_delta_per_epoch=0.04, **cfg),
                      device="cpu")
    src = ImageClassificationSource(table, str(tmp_path / "img"), "key",
                                    "label", SIZE, train_aug=True)
    return trainer, src


def test_resume_restores_batch_norm_statistics(tmp_path):
    """A cv run with drop-path, neck dropout and grad_accum 2 over 3
    micro-steps per epoch, so the end-of-epoch checkpoint falls between
    accumulation boundaries. It holds the BN running statistics and the
    pending gradient; a second trainer from other weights resumes from it
    to the same state, bit for bit, as the first trainer's continuation."""
    keys = [str(i) for i in range(12)]
    table = {"key": keys, "label": [i % 4 for i in range(12)]}
    _write_images(str(tmp_path / "img"), keys)
    t1, src = _cv_trainer(tmp_path, table)
    t1.fit(src, 1, 4)
    assert t1.step == 3 and t1.ckpt.latest_step() == 3
    saved = t1.ckpt.restore()
    assert set(saved["accum_grads"]) == {n for n, _ in
                                         t1.model.named_parameters()}
    stats = {k: v for k, v in saved["model"].items() if "running" in k}
    assert stats and all(torch.equal(v, t1.model.state_dict()[k])
                         for k, v in stats.items())
    moved = E.EfficientNet(t1.model.cfg).state_dict()["bn1.running_var"]
    assert not torch.equal(stats["backbone.bn1.running_var"], moved)
    t1.fit(src, 1, 4, resume=True)

    t2, _ = _cv_trainer(tmp_path, table)
    with torch.no_grad():
        for t in list(t2.model.parameters()) + list(t2.model.buffers()):
            if t.is_floating_point():
                t.add_(0.5)
    for step in t2.ckpt.all_steps():
        if step > 3:
            os.unlink(t2.ckpt._path(step))
    t2.load_state(t2.ckpt.restore())
    for k, v in stats.items():
        assert torch.equal(t2.model.state_dict()[k], v), k
    t2.fit(src, 1, 4, resume=True)
    assert t1.step == t2.step == 6 and t1.margin == t2.margin
    for (k, a), b in zip(t1.model.state_dict().items(),
                         t2.model.state_dict().values()):
        assert torch.equal(a, b), k


# -- sources and the pair sampler ---------------------------------------------

def _pair_table(n=40, seed=0):
    """Titles over a tag/lv2/lv1 hierarchy with missing tag and lv2 ids
    (NaN, as pandas reads an empty cell), duplicated titles and shared
    sku names."""
    rng = np.random.default_rng(seed)
    lv1 = rng.integers(0, 3, n)
    lv2 = (lv1 * 3 + rng.integers(0, 3, n)).astype(float)
    tag = (lv2 * 4 + rng.integers(0, 3, n)).astype(float)
    tag[rng.choice(n, 6, replace=False)] = np.nan
    lv2[rng.choice(n, 3, replace=False)] = np.nan
    titles = [f"标题{rng.integers(0, n // 2)}号" for _ in range(n)]
    return pd.DataFrame({"title": titles,
                         "sku_sn_name": [f"s{i // 2}" for i in range(n)],
                         "tag_id": tag, "lv2_category_id": lv2,
                         "lv1_category_id": lv1})


@pytest.mark.parametrize("with_sku", [True, False])
def test_pair_sampler_draws_the_jax_pairs(with_sku):
    df = _pair_table()
    if not with_sku:
        df = df.drop(columns="sku_sn_name")
    table = {c: df[c].tolist() for c in df.columns}
    jsampler, sampler = JPairSampler(df, seed=3), PairSampler(table, seed=3)
    for rep in range(3):
        for i in range(len(df)):
            assert sampler.sample_pair(i) == jsampler.sample_pair(i), (rep, i)
    rng_a, rng_b = np.random.default_rng(9), np.random.default_rng(9)
    got = [sampler.sample_pair(i, rng=rng_a) for i in range(len(df))]
    assert got == [jsampler.sample_pair(i, rng=rng_b) for i in range(len(df))]
    assert {p[2] for p in got} == {0, 1}
    # missing ids form no group, as pandas groupby drops NaN keys
    assert all(not np.isnan(k) for k in sampler._by_tag)
    assert {k: v.tolist() for k, v in sampler._by_lv2.items()} == {
        k: v.tolist() for k, v in jsampler._by_lv2.items()}


def test_pair_text_source_matches_jax():
    df = _pair_table(48, seed=1)
    table = {c: df[c].tolist() for c in df.columns}
    jtok = JTokenizer.from_corpus(df["title"])
    tok = TextTokenizer.from_corpus(df["title"])
    jsrc = JD.PairTextSource(df, jtok, 16, seed=2, seq_buckets=(8, 12))
    src = PairTextSource(table, tok, 16, seed=2, seq_buckets=(8, 12))
    w = class_balance_weights(CT.column(src.table, "tag_id"))
    np.testing.assert_array_equal(
        w, class_balance_weights(jsrc.df["tag_id"].values))
    runs = [dict(shuffle=True, seed=2, epoch=1), dict(shuffle=False),
            dict(shuffle=False, drop_remainder=False)]
    for kw in runs + ["sampler"]:
        if kw == "sampler":
            got = list(src.batches(8, sampler=WeightedSampler(w, seed=4)))
            want = list(jsrc.batches(8, sampler=WeightedSampler(w, seed=4)))
        else:
            got, want = list(src.batches(8, **kw)), list(jsrc.batches(8,
                                                                      **kw))
        assert len(got) == len(want) > 0
        for g, j in zip(got, want):
            assert list(g) == list(j)
            for k in g:
                np.testing.assert_array_equal(g[k], j[k], err_msg=k)
                assert g[k].dtype == j[k].dtype


def test_image_and_multimodal_sources_match_jax(tmp_path):
    """uint8 batches with augmentations on, shuffled and weighted, a key
    without an image skipped and replaced in both; the eval pass without
    augmentations; the ImageFolder layout."""
    n = 22
    keys = [f"k{i}" for i in range(n)]
    df = pd.DataFrame({"key": keys, "label": [i % 3 for i in range(n)],
                       "spu_name": [f"商品{i}号" for i in range(n)]})
    table = {c: df[c].tolist() for c in df.columns}
    root = str(tmp_path / "img")
    _write_images(root, keys, skip={"k5"})
    cases = [dict(shuffle=True, seed=1, epoch=2),
             dict(shuffle=False, drop_remainder=False),
             dict(sampler="w")]
    w = class_balance_weights(df["label"].values)

    def run(src, kw):
        kw = dict(kw)
        if kw.get("sampler") == "w":
            kw["sampler"] = WeightedSampler(w, seed=3)
        return list(src.batches(4, **kw))

    for aug in (True, False):
        jsrc = JD.ImageClassificationSource(df, root, "key", "label", SIZE,
                                            train_aug=aug, emit="uint8",
                                            num_workers=2)
        src = ImageClassificationSource(table, root, "key", "label", SIZE,
                                        train_aug=aug, num_workers=2)
        for kw in cases:
            got, want = run(src, kw), run(jsrc, kw)
            assert len(got) == len(want) > 0
            for g, j in zip(got, want):
                assert g["images"].dtype == np.uint8
                np.testing.assert_array_equal(g["images"], j["images"])
                np.testing.assert_array_equal(g["labels"], j["labels"])
    jtok = JTokenizer.from_corpus(df["spu_name"])
    tok = TextTokenizer.from_corpus(df["spu_name"])
    jmm = JD.MultimodalSource(df, jtok, root, "spu_name", "key", "label", 10,
                              SIZE, train_aug=True, emit="uint8",
                              seq_buckets=(6,))
    mm = MultimodalSource(table, tok, root, "spu_name", "key", "label", 10,
                          SIZE, train_aug=True, seq_buckets=(6,))
    for kw in cases:
        got, want = run(mm, kw), run(jmm, kw)
        assert len(got) == len(want) > 0
        for g, j in zip(got, want):
            assert sorted(g) == sorted(j)
            for k in g:
                np.testing.assert_array_equal(g[k], j[k], err_msg=k)
    folder = tmp_path / "folder"
    for c in ("b", "a"):
        _write_images(str(folder / c), ["x", "y"], seed=ord(c))
    jf = JD.ImageClassificationSource.from_image_folder(str(folder), SIZE)
    f = ImageClassificationSource.from_image_folder(str(folder), SIZE)
    jb, b = next(jf.batches(4, shuffle=False)), next(f.batches(4,
                                                               shuffle=False))
    np.testing.assert_array_equal(b["labels"], jb["labels"])
    np.testing.assert_array_equal(b["images"], np.clip(np.round(
        jb["images"] * np.array(JD.I.IMAGENET_STD) * 255
        + np.array(JD.I.IMAGENET_MEAN) * 255), 0, 255).astype(np.uint8))
    broken = ImageClassificationSource(table, str(tmp_path / "none"), "key",
                                       "label", SIZE)
    with pytest.raises(RuntimeError, match="failed to decode"):
        list(broken.batches(4))


# -- the commands ------------------------------------------------------------

def _cmd_args(argv, out):
    return build_parser().parse_args(argv + ["--output", str(out),
                                             "--epochs", "2"])


def _check_outputs(out, trainer, steps):
    assert trainer.step == steps
    assert trainer.ckpt.latest_step() == steps
    lines = _lines(os.path.join(out, "metrics.jsonl"))
    losses = [ln["train/loss"] for ln in lines if "train/loss" in ln]
    assert losses and all(np.isfinite(losses))
    return lines


def test_train_commands_run_two_epochs(tmp_path):
    """Every ``cmd_train_*`` on a tiny table: two epochs, a checkpoint,
    ``metrics.jsonl`` and, for the text recipes, ``vocab.txt``; the cv
    margin curriculum reaches 0.24; ``--profile`` writes a trace."""
    df = _text_table(32, seed=3)
    path = str(tmp_path / "t.csv")
    df.to_csv(path, index=False)
    common = ["--batch_size", "8", "--max_length", "10", "--log_every", "1",
              "--save_every", "1000", "--eval_every", "1000",
              "--bert_preset", "tiny"]
    out = tmp_path / "nlp"
    tr = CT.cmd_train_nlp(_cmd_args(
        ["train", "nlp", "--data", path] + common
        + ["--fused_loss", "--no_clean", "--eval_data", path,
           "--eval_every", "4", "--optimizer", "adamp", "--scheduler",
           "timm_cosine"], out), device="cpu")
    lines = _check_outputs(out, tr, 8)
    assert any("eval/acc" in ln for ln in lines)
    assert os.path.exists(out / "vocab.txt")
    out = tmp_path / "ml"
    tr = CT.cmd_train_multilabel(_cmd_args(
        ["train", "multilabel", "--data", path, "--grad_accum", "2",
         "--weighted_sampling", "--profile", str(tmp_path / "trace")]
        + common, out), device="cpu")
    lines = _check_outputs(out, tr, 8)
    assert [ln["train/opt_step"] for ln in lines if "train/loss" in ln] == [
        1.0, 2.0, 3.0, 4.0]
    assert [f for f in os.listdir(tmp_path / "trace")
            if f.endswith(".pt.trace.json")]

    pairs = _pair_table(32, seed=4)
    ppath = str(tmp_path / "p.csv")
    pairs.to_csv(ppath, index=False)
    out = tmp_path / "pair"
    tr = CT.cmd_train_pair(_cmd_args(
        ["train", "pair", "--data", ppath, "--weighted_sampling"] + common,
        out), device="cpu")
    _check_outputs(out, tr, 8)
    assert os.path.exists(out / "vocab.txt")

    keys = [str(i) for i in range(16)]
    img = pd.DataFrame({"goods_sku": keys, "tag_new_id": [i % 3 for i in
                                                          range(16)],
                        "spu_sn": keys,
                        "spu_name": [f"商品{i}" for i in range(16)]})
    ipath = str(tmp_path / "i.csv")
    img.to_csv(ipath, index=False)
    root = str(tmp_path / "img")
    _write_images(root, keys)
    image = ["--img_root", root, "--backbone", "tiny", "--image_size",
             str(SIZE), "--fc_dim", "8", "--batch_size", "8",
             "--log_every", "1"]
    out = tmp_path / "cv"
    tr = CT.cmd_train_cv(_cmd_args(
        ["train", "cv", "--data", ipath, "--scheduler",
         "cosine_warm_restarts", "--t0_epochs", "1", "--weighted_sampling"]
        + image, out), device="cpu")
    lines = _check_outputs(out, tr, 4)
    assert [ln["train/margin"] for ln in lines if "train/margin" in ln][
        -1] == pytest.approx(0.24)
    assert tr.margin == pytest.approx(0.28)
    out = tmp_path / "mm"
    tr = CT.cmd_train_multimodal(_cmd_args(
        ["train", "multimodal", "--data", ipath, "--label_col", "tag_new_id",
         "--max_length", "8", "--bert_preset", "tiny"] + image, out),
        device="cpu")
    _check_outputs(out, tr, 4)
    assert os.path.exists(out / "vocab.txt")


def test_train_commands_refuse_what_jax_refuses(tmp_path):
    """The JAX commands' refusals (SystemExit) of flags that do not apply,
    ``--remat_policy``/``--remat_skip`` without ``--remat`` (JAX
    ``_bert_config``'s SystemExit), the JAX Trainer's ValueErrors of
    layouts that need a model axis or do not compose (pipeline
    parallelism included: it needs ``--model_parallel`` > 1, and runs
    over ranks in tests/test_torch_pp.py), before any training. ``--remat`` builds; ``--model_parallel``,
    ``--tensor_parallel``, ``--sequence_parallel`` and ``--bf16_grads``
    run over ranks (tests/test_torch_parallel.py)."""
    argv = ["--data", "unused.csv", "--img_root", "unused"]
    for cmd, fn, flag in (("cv", CT.cmd_train_cv, ["--fused_loss"]),
                          ("cv", CT.cmd_train_cv, ["--remat"]),
                          ("cv", CT.cmd_train_cv, ["--tensor_parallel"]),
                          ("pair", CT.cmd_train_pair, ["--fused_loss"]),
                          ("multimodal", CT.cmd_train_multimodal,
                           ["--fused_loss"])):
        extra = argv if cmd != "pair" else argv[:2]
        with pytest.raises(SystemExit, match=f"train {cmd}"):
            fn(_cmd_args(["train", cmd] + extra + flag, tmp_path),
               device="cpu")
    table = {"spu_name": ["a"], "labels": [0], "title": ["a"],
             "tag_id": [0], "lv2_category_id": [0], "lv1_category_id": [0],
             "tag_new_id": [0]}
    for cmd, fn in (("nlp", CT.cmd_train_nlp),
                    ("multilabel", CT.cmd_train_multilabel),
                    ("pair", CT.cmd_train_pair)):
        for flag, error, match in (
                (["--pipeline_parallel", "2"], ValueError,
                 "pipeline_parallel needs a mesh model axis > 1"),
                (["--pipeline_parallel", "2", "--tensor_parallel"],
                 ValueError, "incompatible layouts"),
                (["--tensor_parallel"], ValueError, "model axis > 1"),
                (["--tensor_parallel", "--sequence_parallel"], ValueError,
                 "model axis > 1"),
                (["--sequence_parallel"], ValueError,
                 "requires tensor_parallel"),
                (["--remat_policy", "dots"], SystemExit,
                 "pass --remat too"),
                (["--remat_skip", "2"], SystemExit, "pass --remat too")):
            with pytest.raises(error, match=match):
                fn(_cmd_args(["train", cmd, "--data", str(tmp_path / "x")]
                             + flag, tmp_path / cmd), table=table,
                   device="cpu")
        trainer = fn(_cmd_args(["train", cmd, "--data", str(tmp_path / "x"),
                                "--remat", "--remat_policy", "dots",
                                "--remat_skip", "2", "--overwrite"],
                               tmp_path / cmd), table=table, device="cpu")
        cfg = trainer.model.tower.encoder.config
        assert (cfg.remat, cfg.remat_policy, cfg.remat_skip) == (
            True, "dots", 2)
