"""Training-slice parity: the port's text ArcFace training against the JAX
package's, on the CPU at a tiny size (2 layers, hidden 64).

Inputs come from numpy with fixed seeds and both packages get the same
arrays; weights go JAX -> port through ``text_classifier_from_jax`` (the
head included). Dropout is 0.0 in both ``BertConfig``s wherever the two
are compared: Flax ``Dropout(0.0)`` is the identity and the two
frameworks' random bits never match.
"""

import argparse
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch

from multimodalsimilar_tpu.cli.train import _opt_step_units as j_units
from multimodalsimilar_tpu.cli.train import _sampler_fn as j_sampler_fn
from multimodalsimilar_tpu.data.datasets import (
    TextClassificationSource as JSource)
from multimodalsimilar_tpu.data.sampling import (
    WeightedSampler as JWeightedSampler)
from multimodalsimilar_tpu.data.sampling import (
    class_balance_weights as j_weights)
from multimodalsimilar_tpu.data.tokenizer import TextTokenizer as JTokenizer
from multimodalsimilar_tpu.models.bert import BertConfig as JBertConfig
from multimodalsimilar_tpu.models.classifiers import (
    NlpTextClassifier as JClassifier)
from multimodalsimilar_tpu.parallel.mesh import create_mesh, shard_batch
from multimodalsimilar_tpu.train.optim import dual_group
from multimodalsimilar_tpu.train.optim import (
    linear_schedule_with_warmup as j_linear)
from multimodalsimilar_tpu.train.tasks import (
    text_arcface_task as j_text_task)
from multimodalsimilar_tpu.train.trainer import Trainer as JTrainer
from multimodalsimilar_tpu.train.trainer import (
    TrainerConfig as JTrainerConfig)
from multimodalsimilar_tpu.utils.dtypes import DTypePolicy as JPolicy
from multimodalsimilar_tpu_torch.cli.train import (_opt_step_units,
                                                   _sampler_fn, _trainer)
from multimodalsimilar_tpu_torch.data.datasets import TextClassificationSource
from multimodalsimilar_tpu_torch.data.prefetch import prefetch_to_device
from multimodalsimilar_tpu_torch.data.sampling import (
    WeightedSampler, class_balance_weights)
from multimodalsimilar_tpu_torch.data.tokenizer import TextTokenizer
from multimodalsimilar_tpu_torch.models.bert import (BertConfig,
                                                     BertEncoderModel,
                                                     set_dropout_generator)
from multimodalsimilar_tpu_torch.models.classifiers import NlpTextClassifier
from multimodalsimilar_tpu_torch.models.convert import text_classifier_from_jax
from multimodalsimilar_tpu_torch.ops.arcface import ArcFaceParams
from multimodalsimilar_tpu_torch.train import checkpoint as ckpt_mod
from multimodalsimilar_tpu_torch.train.checkpoint import CheckpointManager
from multimodalsimilar_tpu_torch.train.optim import (
    dual_group_adamw, linear_schedule_with_warmup)
from multimodalsimilar_tpu_torch.train.tasks import text_arcface_task
from multimodalsimilar_tpu_torch.train.trainer import Trainer, TrainerConfig
from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy

torch.set_num_threads(1)

POLICIES = {"full": (JPolicy.full_precision(), DTypePolicy.full_precision()),
            "default": (JPolicy(), DTypePolicy())}
N_CLS = 37
NO_DROPOUT = dict(hidden_dropout=0.0, attention_dropout=0.0)


def _table(n=96, n_cls=7, seed=0):
    """Label-correlated titles (class k repeats marker k) of varied
    length, with skewed class frequencies."""
    rng = np.random.default_rng(seed)
    markers = "甲乙丙丁戊己庚辛壬癸"
    pool = list("水果蔬菜饮料零食牛奶面包")
    labels = np.minimum(rng.geometric(0.35, size=n) - 1, n_cls - 1)
    titles = [markers[k] * 3 + "".join(rng.choice(pool, rng.integers(1, 9)))
              for k in labels]
    return pd.DataFrame({"spu_name": titles, "labels": labels})


def _tokenizers(df):
    jtok = JTokenizer.from_corpus(df["spu_name"])
    tok = TextTokenizer.from_corpus(df["spu_name"])
    assert tok.vocab_size == jtok.vocab_size
    return jtok, tok


def _jax_classifier(jcfg, jpol, batch):
    model = JClassifier(jcfg, num_labels=N_CLS, policy=jpol)
    variables = model.init({"params": jax.random.key(1)},
                           jnp.asarray(batch["input_ids"]),
                           label=jnp.asarray(batch["labels"]))
    return model, variables["params"]


def _port_classifier(params, tcfg, tpol):
    model = NlpTextClassifier(tcfg, policy=tpol, num_labels=N_CLS)
    model.load_state_dict(text_classifier_from_jax(params, tcfg))
    return model


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


# -- model -------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["full", "default"])
def test_classifier_margin_logits_match_jax(policy):
    """Full precision: logits are s * cos, and cos agrees to a few 1e-7
    (f32 sums in another order), so atol 1e-4. Default policy: the tower
    computes in bf16, which both frameworks round at other points; the
    cosines then agree to about 1e-2 (measured 3e-3), so atol
    64 * 1.5e-2 on the logits."""
    jpol, tpol = POLICIES[policy]
    rng = np.random.default_rng(5)
    ids = rng.integers(5, 128, size=(8, 16)).astype(np.int32)
    lens = rng.integers(3, 17, size=8)
    mask = (np.arange(16)[None] < lens[:, None]).astype(np.int32)
    ids = np.where(mask > 0, ids, 0).astype(np.int32)
    label = rng.integers(0, N_CLS, 8).astype(np.int32)
    label[3] = -1
    batch = {"input_ids": ids, "attention_mask": mask,
             "token_type_ids": np.zeros_like(ids), "labels": label}
    jmodel, params = _jax_classifier(JBertConfig.tiny(), jpol, batch)
    port = _port_classifier(params, BertConfig.tiny(), tpol)
    atol = 1e-4 if policy == "full" else 64 * 1.5e-2
    t = _tensors(batch)
    for kw in (dict(label=label, m=0.3), dict(is_test=True)):
        want = np.asarray(jmodel.apply(
            {"params": params}, jnp.asarray(ids), jnp.asarray(mask),
            jnp.asarray(batch["token_type_ids"]),
            **{k: (jnp.asarray(v) if k == "label" else v)
               for k, v in kw.items()}))
        with torch.no_grad():
            got = port(t["input_ids"], t["attention_mask"],
                       t["token_type_ids"],
                       **{k: (t["labels"] if k == "label" else v)
                          for k, v in kw.items()}).numpy()
        scale = 1.0 if "label" in kw else 64.0      # cosine logits
        np.testing.assert_allclose(got * scale, want * scale, rtol=0,
                                   atol=atol)


def test_dropout_uses_the_generator_and_only_in_train_mode():
    cfg = BertConfig.tiny(hidden_dropout=0.2, attention_dropout=0.2)
    enc = BertEncoderModel(cfg, DTypePolicy.full_precision())
    ids = torch.randint(5, 128, (4, 10), generator=torch.Generator()
                        .manual_seed(0))
    assert not enc.training                       # built in eval mode
    ref = enc(ids)["pooler_output"]
    enc.train()
    with pytest.raises(RuntimeError, match="generator"):
        enc(ids)
    gen = torch.Generator()
    set_dropout_generator(enc, gen)
    gen.manual_seed(3)
    a = enc(ids)["pooler_output"]
    gen.manual_seed(3)
    b = enc(ids)["pooler_output"]
    assert torch.equal(a, b) and not torch.allclose(a, ref)
    torch.manual_seed(0)                          # the global RNG is unused
    gen.manual_seed(3)
    assert torch.equal(enc(ids)["pooler_output"], a)
    enc.eval()
    assert torch.equal(enc(ids)["pooler_output"], ref)


# -- optimizer and schedule --------------------------------------------------

@pytest.mark.parametrize("warmup,total", [(5, 20), (3.5, 12), (0, 10)])
def test_linear_schedule_matches_jax_and_hf(warmup, total):
    """Equal to the JAX schedule's float32 value at every step; equal to
    HF's get_linear_schedule_with_warmup (float64) within 1e-6 relative."""
    from transformers import get_linear_schedule_with_warmup
    ours = linear_schedule_with_warmup(1e-2, warmup, total)
    want = j_linear(1e-2, warmup, total)
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=1e-2)
    hf = get_linear_schedule_with_warmup(opt, int(warmup), total)
    for step in range(total + 3):
        assert ours(step) == float(want(step)), step
        assert ours(step) == pytest.approx(opt.param_groups[0]["lr"],
                                           rel=1e-6, abs=1e-12)
        opt.step()
        hf.step()


class _TwoGroups(torch.nn.Module):
    def __init__(self, w_tower, b_tower, w_head):
        super().__init__()
        self.tower = torch.nn.Linear(3, 4)
        self.head = torch.nn.Module()
        self.head.weight = torch.nn.Parameter(torch.from_numpy(w_head))
        with torch.no_grad():
            self.tower.weight.copy_(torch.from_numpy(w_tower))
            self.tower.bias.copy_(torch.from_numpy(b_tower))


def test_dual_group_adamw_matches_optax():
    """Five updates on the same gradients: the port's one AdamW with two
    groups against optax.multi_transform of two optax.adamw, each group
    with its own schedule and weight decay. Same arithmetic in another
    order (torch decays p before the Adam step and divides by
    sqrt(v)/sqrt(bc2) + eps): atol 2e-6 on parameters of size 1 after five
    updates of size lr (1e-2 and 5e-2)."""
    rng = np.random.default_rng(0)
    init = {"tower": {"weight": rng.normal(size=(4, 3)).astype(np.float32),
                      "bias": rng.normal(size=4).astype(np.float32)},
            "head": {"weight": rng.normal(size=(5, 3)).astype(np.float32)}}
    grads = [jax.tree_util.tree_map(
        lambda p: rng.normal(size=p.shape).astype(np.float32), init)
        for _ in range(5)]
    t_sched = linear_schedule_with_warmup(1e-2, 2, 5)
    h_sched = linear_schedule_with_warmup(5e-2, 0, 5)
    tx = dual_group(
        optax.adamw(j_linear(1e-2, 2, 5), weight_decay=0.01),
        optax.adamw(j_linear(5e-2, 0, 5), weight_decay=0.1))
    params = jax.tree_util.tree_map(jnp.asarray, init)
    state = tx.init(params)
    model = _TwoGroups(init["tower"]["weight"], init["tower"]["bias"],
                       init["head"]["weight"])
    opt, sched = dual_group_adamw(model, t_sched, h_sched,
                                  weight_decay=0.01, head_weight_decay=0.1)
    assert [len(g["params"]) for g in opt.param_groups] == [2, 1]
    for g in grads:
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                   state, params)
        params = optax.apply_updates(params, updates)
        model.tower.weight.grad = torch.from_numpy(g["tower"]["weight"])
        model.tower.bias.grad = torch.from_numpy(g["tower"]["bias"])
        model.head.weight.grad = torch.from_numpy(g["head"]["weight"])
        opt.step()
        sched.step()
    for got, want in ((model.tower.weight, params["tower"]["weight"]),
                      (model.tower.bias, params["tower"]["bias"]),
                      (model.head.weight, params["head"]["weight"])):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=2e-6)
    assert [g["lr"] for g in opt.param_groups] == [t_sched(5),
                                                    h_sched(5)]


# -- data --------------------------------------------------------------------

@pytest.mark.parametrize("as_dict", [True, False], ids=["dict", "frame"])
def test_source_and_sampler_match_jax(as_dict):
    df = _table(n=50)
    jtok, tok = _tokenizers(df)
    table = ({c: df[c].tolist() for c in df.columns} if as_dict else df)
    jsrc = JSource(df, jtok, max_length=16, seq_buckets=(9, 12),
                   clean=False)
    src = TextClassificationSource(table, tok, max_length=16,
                                   seq_buckets=(9, 12), clean=False)
    w = class_balance_weights(df["labels"].values)
    np.testing.assert_array_equal(w, j_weights(df["labels"].values))
    assert list(WeightedSampler(w, seed=4)) == list(
        JWeightedSampler(w, seed=4))
    runs = [dict(shuffle=True, seed=3, epoch=1),
            dict(shuffle=False, drop_remainder=False),
            dict(sampler=None, seed=0, epoch=0)]
    widths = set()
    for kw in runs + ["sampler"]:
        if kw == "sampler":
            got = list(src.batches(4, sampler=WeightedSampler(w, seed=2)))
            want = list(jsrc.batches(4, sampler=JWeightedSampler(w, seed=2)))
        else:
            got, want = list(src.batches(4, **kw)), list(jsrc.batches(4, **kw))
        assert len(got) == len(want) > 0
        for g, j in zip(got, want):
            assert g.keys() == j.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], j[k])
                assert g[k].dtype == j[k].dtype
            widths.add(g["input_ids"].shape[1])
    assert len(widths) > 1                        # buckets did trim


def test_sampler_fn_and_step_units_match_jax():
    df = _table(n=40)
    args = argparse.Namespace(weighted_sampling=True, seed=7, epochs=3,
                              grad_accum=1)
    for epoch in (0, 1):
        assert list(_sampler_fn(args, df, "labels")(epoch)) == list(
            j_sampler_fn(args, df, "labels")(epoch))
    assert _opt_step_units(args, 10) == j_units(args, 10)
    args.weighted_sampling = False
    assert _sampler_fn(args, df, "labels") is None


def test_prefetch_yields_tensors_and_surfaces_errors():
    batches = [{"a": np.full((2, 3), i, np.int32)} for i in range(5)]
    got = list(prefetch_to_device(iter(batches), "cpu"))
    assert [int(b["a"][0, 0]) for b in got] == list(range(5))
    assert got[0]["a"].dtype == torch.int32

    def broken():
        yield batches[0]
        raise OSError("bad shard")

    with pytest.raises(OSError, match="bad shard"):
        list(prefetch_to_device(broken(), "cpu"))
    before = threading.active_count()
    for b in prefetch_to_device(iter(batches * 50), "cpu", buffer_size=1):
        break                                     # abandoned early
    for t in threading.enumerate():
        if t.name == "prefetch":
            t.join(timeout=5)
    assert threading.active_count() <= before


# -- the slice as a whole ----------------------------------------------------

BS, EPOCHS, LR, WD = 16, 2, 1e-3, 0.01


def _fit_pair(policy, tmp_path):
    """The JAX Trainer.fit (started through initial_state from the JAX
    init) and the port's (started from the same weights, carried over) on
    the same table: 2 epochs of class-balanced sampling, log_every=1, a
    margin curriculum of 0.04 per epoch, eval every 4 steps on a held-out
    split. Returns both metrics.jsonl line lists."""
    jpol, tpol = POLICIES[policy]
    df = _table(n=96)
    held = _table(n=32, seed=1)
    jtok, tok = _tokenizers(pd.concat([df, held]))
    jsrc, jeval = (JSource(t, jtok, max_length=12, clean=False)
                   for t in (df, held))
    src, evsrc = (TextClassificationSource(t, tok, max_length=12,
                                           clean=False) for t in (df, held))
    total = EPOCHS * (len(df) // BS)
    cfg = dict(eval_every=4, save_every=10**9, log_every=1,
               margin_init=0.4, margin_delta_per_epoch=0.04)
    args = argparse.Namespace(weighted_sampling=True, seed=0)

    jcfg = JBertConfig.tiny(vocab_size=tok.vocab_size, **NO_DROPOUT)
    jmodel = JClassifier(jcfg, num_labels=N_CLS, policy=jpol)
    tx = dual_group(optax.adamw(j_linear(LR, 0, total), weight_decay=WD),
                    optax.adamw(j_linear(LR, 0, total), weight_decay=WD))
    jtrainer = JTrainer(j_text_task(jmodel), tx, create_mesh(),
                        JTrainerConfig(metrics_path=str(tmp_path / "j.jsonl"),
                                       **cfg))
    state0 = jtrainer.init_state(next(jsrc.batches(BS, shuffle=False)))
    jtrainer.fit(jsrc, EPOCHS, BS, jeval, initial_state=state0,
                 sampler_fn=j_sampler_fn(args, df, "labels"))

    tcfg = BertConfig.tiny(vocab_size=tok.vocab_size, **NO_DROPOUT)
    port = _port_classifier(state0.params, tcfg, tpol)
    sched = linear_schedule_with_warmup(LR, 0, total)
    trainer = Trainer(
        text_arcface_task(port),
        lambda m: dual_group_adamw(m, sched, sched, weight_decay=WD),
        TrainerConfig(metrics_path=str(tmp_path / "t.jsonl"), **cfg),
        device="cpu")
    trainer.fit(src, EPOCHS, BS, evsrc,
                sampler_fn=_sampler_fn(args, df, "labels"))

    def lines(name):
        return [json.loads(ln) for ln in open(tmp_path / name)]
    return lines("j.jsonl"), lines("t.jsonl")


@pytest.mark.parametrize("policy", ["full", "default"])
def test_fit_matches_jax_step_by_step(policy, tmp_path):
    """Per-step train losses and every eval accuracy of the two fits.
    Adam turns tiny gradient differences into updates of size lr, so the
    parameters are compared through the losses, not leaf by leaf. Full
    precision: rtol 1e-4. Default policy (bf16 compute, rounded at other
    points in each framework): measured within 2e-3 relative over the 12
    steps, so rtol 1e-2; eval accuracies within one example of 32."""
    jlines, tlines = _fit_pair(policy, tmp_path)
    pick = lambda ls, k: [(ln["step"], ln[k]) for ln in ls if k in ln]  # noqa
    jl, tl = pick(jlines, "train/loss"), pick(tlines, "train/loss")
    assert [s for s, _ in tl] == [s for s, _ in jl] == list(range(1, 13))
    rtol = 1e-4 if policy == "full" else 1e-2
    np.testing.assert_allclose([v for _, v in tl], [v for _, v in jl],
                               rtol=rtol)
    assert pick(tlines, "train/margin") == pick(jlines, "train/margin")
    je, te = pick(jlines, "eval/acc"), pick(tlines, "eval/acc")
    assert [s for s, _ in te] == [s for s, _ in je] == [4, 8, 12]
    np.testing.assert_allclose([v for _, v in te], [v for _, v in je],
                               atol=0 if policy == "full" else 1.5 / 32)
    assert tl[-1][1] < tl[0][1]                   # it learns


@pytest.mark.parametrize("policy", ["full", "default"])
def test_first_step_gradients_match_jax(policy):
    """Gradients of the training loss at the init, every parameter. The
    JAX tree maps onto the port's names through the same converter as the
    weights. Full precision: rtol 1e-4 and atol 1e-6 of the tensor's
    largest entry. Default policy: bf16 compute, rounded at other points
    in each framework (JAX returns the gradients of bf16 Dense layers in
    bf16, one ulp = 2^-8 of a value); measured up to 3.1e-2 of a tensor's
    largest entry (an attention-output bias), so 6e-2. The
    attention key bias has a zero gradient in exact arithmetic (softmax
    ignores a per-query constant), so both sides give rounding noise
    there: held only to 1e-4 of the largest gradient of the model."""
    jpol, tpol = POLICIES[policy]
    df = _table(n=32)
    jtok, tok = _tokenizers(df)
    jbatch = next(JSource(df, jtok, max_length=12, clean=False).batches(16))
    jcfg = JBertConfig.tiny(vocab_size=tok.vocab_size, **NO_DROPOUT)
    tcfg = BertConfig.tiny(vocab_size=tok.vocab_size, **NO_DROPOUT)
    jmodel, params = _jax_classifier(jcfg, jpol, jbatch)
    jtask = j_text_task(jmodel)
    dev_batch = shard_batch(create_mesh(), jbatch)
    jgrads = jax.jit(jax.grad(lambda p: jtask.train_loss(
        p, {}, dev_batch, jax.random.key(0), 0.4)[0]))(params)
    want = text_classifier_from_jax(jgrads, tcfg)

    port = _port_classifier(params, tcfg, tpol)
    task = text_arcface_task(port)
    port.train()
    loss, _ = task.train_loss(_tensors(jbatch), 0.4)
    loss.backward()
    top = max(float(np.abs(v.numpy()).max()) for v in want.values())
    for name, p in port.named_parameters():
        w = want[name].numpy()
        if name.endswith("attention.self.key.bias"):
            assert np.abs(p.grad.numpy()).max() <= 1e-4 * top, name
            assert np.abs(w).max() <= 1e-4 * top, name
        elif policy == "full":
            np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                       atol=1e-6 * np.abs(w).max(),
                                       err_msg=name)
        else:
            err = np.abs(p.grad.numpy() - w).max()
            assert err <= 6e-2 * np.abs(w).max(), (name, err)


# -- checkpoints, resume and refusals ----------------------------------------

def _small_trainer(tmp_path, name, **cfg):
    df = _table(n=48)
    tok = TextTokenizer.from_corpus(df["spu_name"])
    src = TextClassificationSource(df, tok, max_length=12, clean=False)
    model = NlpTextClassifier(BertConfig.tiny(vocab_size=tok.vocab_size),
                              policy=DTypePolicy.full_precision(),
                              num_labels=N_CLS,
                              generator=torch.Generator().manual_seed(1))
    sched = linear_schedule_with_warmup(1e-3, 0, 12)
    config = TrainerConfig(
        eval_every=10**9, save_every=2, log_every=1,
        margin_delta_per_epoch=0.04,
        checkpoint_dir=str(tmp_path / "ckpt"),
        metrics_path=str(tmp_path / f"{name}.jsonl"), **cfg)
    trainer = Trainer(text_arcface_task(model),
                      lambda m: dual_group_adamw(m, sched, sched, 0.01),
                      config, device="cpu")
    return trainer, src


def test_resume_continues_the_run(tmp_path):
    """Dropout 0.1 on (masks from the trainer's generator). A first trainer
    trains one epoch and saves; it and a second trainer built from other
    weights both resume from that checkpoint for one more epoch and must
    produce the same losses, step, margin and parameters: weights,
    optimizer moments, schedule count, margin and the per-step dropout
    seeds all come back."""
    t1, src = _small_trainer(tmp_path, "a")
    state = t1.fit(src, 1, 16)
    assert state["step"] == 3 and t1.ckpt.latest_step() == 3
    assert state["margin"] == pytest.approx(0.44)
    saved = t1.ckpt.restore()
    for k, v in t1.model.state_dict().items():
        assert torch.equal(saved["model"][k], v)
    t1.fit(src, 1, 16, resume=True)
    t2, _ = _small_trainer(tmp_path, "b")
    with torch.no_grad():
        for p in t2.model.parameters():
            p.add_(1.0)
    # t1's second fit overwrote the checkpoint dir's latest step (6); go
    # back to step 3 for t2
    for step in t2.ckpt.all_steps():
        if step > 3:
            os.unlink(t2.ckpt._path(step))
    t2.fit(src, 1, 16, resume=True)
    assert t1.step == t2.step == 6
    assert t1.margin == t2.margin == pytest.approx(0.48)
    for (k, a), b in zip(t1.model.state_dict().items(),
                         t2.model.state_dict().values()):
        assert torch.equal(a, b), k

    def losses(name):
        return [(ln["step"], ln["train/loss"]) for ln in map(
            json.loads, open(tmp_path / name)) if "train/loss" in ln]
    assert losses("a.jsonl")[3:] == losses("b.jsonl")
    resumed = [json.loads(ln) for ln in open(tmp_path / "b.jsonl")][0]
    assert resumed == {"step": 3, "resumed": 1.0}


def test_fresh_fit_into_populated_dir_needs_overwrite(tmp_path):
    t1, src = _small_trainer(tmp_path, "a")
    t1.fit(src, 1, 16)
    t2, _ = _small_trainer(tmp_path, "b")
    with pytest.raises(ValueError, match="already holds checkpoints"):
        t2.fit(src, 1, 16)
    t3, _ = _small_trainer(tmp_path, "c", overwrite=True)
    t3.fit(src, 1, 16)
    assert t3.step == 3 and t3.ckpt.all_steps() == [2, 3]


def _recorded_trainer(root, log_every=2):
    """``_small_trainer``'s run with dropout off, logging every
    ``log_every`` steps and saving every 2, into ``root``."""
    os.makedirs(root, exist_ok=True)
    df = _table(n=48)
    tok = TextTokenizer.from_corpus(df["spu_name"])
    src = TextClassificationSource(df, tok, max_length=12, clean=False)
    model = NlpTextClassifier(
        BertConfig.tiny(vocab_size=tok.vocab_size, **NO_DROPOUT),
        policy=DTypePolicy.full_precision(), num_labels=N_CLS,
        generator=torch.Generator().manual_seed(1))
    sched = linear_schedule_with_warmup(1e-3, 0, 12)
    config = TrainerConfig(
        eval_every=10**9, save_every=2, log_every=log_every,
        checkpoint_dir=os.path.join(root, "ckpt"),
        metrics_path=os.path.join(root, "m.jsonl"))
    trainer = Trainer(text_arcface_task(model),
                      lambda m: dual_group_adamw(m, sched, sched, 0.01),
                      config, device="cpu")
    return trainer, src


def test_recorded_fit_has_every_stage_and_the_same_state(tmp_path):
    """Under ``recording()`` a fit of 2 epochs of 3 steps holds, for each
    step, ``train.step`` with its forward, backward and optimizer and one
    ``prefetch.wait`` (one more an epoch, for its end), ``train.sync``
    from the second step, ``train.log`` and ``train.save`` on every
    second, the producer's spans on its own thread and no counter; its
    final state is an unrecorded run's, bit for bit."""
    from multimodalsimilar_tpu_torch.utils.profiling import recording
    plain, src = _recorded_trainer(str(tmp_path / "plain"))
    want = plain.fit(src, 2, 16)
    traced, src = _recorded_trainer(str(tmp_path / "traced"))
    with recording() as rec:
        got = traced.fit(src, 2, 16)
    assert traced.step == plain.step == 6
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    main = threading.get_ident()
    names = [s[0] for s in rec.spans if s[2] == main]
    steps = [s for s in rec.spans if s[0] == "train.step"]
    assert len(steps) == 6 and all(s[1] is None for s in steps)
    for child in ("train.forward", "train.backward", "train.optimizer"):
        kids = [s for s in rec.spans if s[0] == child]
        assert len(kids) == 6 and all(s[1] == "train.step" for s in kids)
        assert all(a[3] <= b[3] <= b[4] <= a[4]
                   for a, b in zip(steps, kids))
    assert names.count("prefetch.wait") == 6 + 2
    assert names.count("train.sync") == 5
    assert names.count("train.log") == names.count("train.save") == 3
    assert names.index("train.sync") > names.index("train.step")
    producer = [s for s in rec.spans if s[0].startswith("prefetch.")
                and s[0] != "prefetch.wait"]
    assert {s[0] for s in producer} == {"prefetch.build", "prefetch.upload"}
    assert all(s[2] != main for s in producer)
    assert not rec.counters


def test_logged_rate_is_examples_over_the_wall_since_the_last_log(
        tmp_path, monkeypatch):
    """``examples_per_sec`` is the examples since the previous log step
    over the wall time since then (here a clock that moves 10 s between
    the Trainer's readings of it), not the batch over the median step;
    the first interval starts after the warm-up steps that ``StepTimer``
    skips (the first 3 of 6, logging every 2: step 4's rate counts step 4
    alone); ``step_ms_p50`` stays."""
    import types
    from multimodalsimilar_tpu_torch.train import trainer as trainer_mod
    ticks = iter(range(0, 1000, 10))
    monkeypatch.setattr(trainer_mod, "time", types.SimpleNamespace(
        perf_counter=lambda: float(next(ticks))))
    trainer, src = _recorded_trainer(str(tmp_path), log_every=2)
    trainer.fit(src, 2, 16)
    lines = [json.loads(ln) for ln in open(tmp_path / "m.jsonl")]
    rated = [ln for ln in lines if "train/examples_per_sec" in ln]
    assert [ln["step"] for ln in rated] == [4, 6]
    assert [ln["train/examples_per_sec"] for ln in rated] == [
        1 * 16 / 10, 2 * 16 / 10]
    assert all(ln["train/step_ms_p50"] > 0 for ln in rated)


def test_async_failure_reraises_and_a_retry_writes(tmp_path, monkeypatch):
    """A failed background write re-raises on wait(); the step does not
    count as saved, so saving it again (without force) writes it."""
    mgr = CheckpointManager(str(tmp_path / "ckpt"), async_save=True,
                            max_to_keep=2)
    state = {"step": 5, "model": {"w": torch.arange(4.0)}, "margin": 0.4}
    real_save = torch.save

    def failing(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod.torch, "save", failing)
    mgr.save(5, state)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert mgr.latest_step() is None
    monkeypatch.setattr(ckpt_mod.torch, "save", real_save)
    mgr.save(5, state)
    mgr.wait()
    assert mgr.latest_step() == 5
    # the host copy was taken at save(): later in-place updates miss it
    state["model"]["w"].add_(1.0)
    mgr.save(5, state)                            # already saved: no-op
    assert torch.equal(mgr.restore()["model"]["w"], torch.arange(4.0))
    mgr.save(5, state, force=True)                # force rewrites
    assert torch.equal(mgr.restore()["model"]["w"], torch.arange(4.0) + 1)
    for step in (6, 7):
        mgr.save(step, state)
    mgr.wait()
    assert mgr.all_steps() == [6, 7]              # max_to_keep
    mgr.clear()
    assert mgr.latest_step() is None and mgr.restore() is None


def test_unported_options_raise(tmp_path):
    """Pipeline parallelism, as its TrainerConfig field and as its command
    flag, refuses a mesh without a model axis, and with tensor or sequence
    parallelism it is the JAX Trainer's refusal (it runs over ranks in
    tests/test_torch_pp.py). Tensor and sequence parallelism refuse a
    mesh without a model axis (the JAX messages: tests/test_torch_parallel.py
    and tests/test_torch_pp.py hold them word for word). Accumulation, profiling, AdamP, the cosine schedules, the fused
    loss, remat, class-sharded heads and the bf16 gradient all-reduce
    build (the layouts over ranks run in tests/test_torch_parallel.py).
    ``--model_parallel 2`` on one process fails as the JAX package's
    ``create_mesh`` does on one device."""
    model = NlpTextClassifier(BertConfig.tiny(), num_labels=3)
    opt = lambda m: dual_group_adamw(m, lambda s: 0.0,  # noqa: E731
                                     lambda s: 0.0)
    with pytest.raises(ValueError,
                       match="pipeline_parallel needs a mesh model axis > 1"):
        Trainer(text_arcface_task(model), opt,
                TrainerConfig(pipeline_parallel=True), device="cpu")
    for cfg, match in ((dict(pipeline_parallel=True, tensor_parallel=True),
                        "incompatible layouts"),
                       (dict(tensor_parallel=True), "model axis > 1"),
                       (dict(sequence_parallel=True),
                        "requires tensor_parallel"),
                       (dict(tensor_parallel=True, sequence_parallel=True),
                        "model axis > 1"),
                       (dict(bf16_grad_allreduce=True, tensor_parallel=True),
                        "pure-DP path")):
        with pytest.raises(ValueError, match=match):
            Trainer(text_arcface_task(model), opt, TrainerConfig(**cfg),
                    device="cpu")
    for field in ("model_parallel_heads", "bf16_grad_allreduce",
                  "tensor_parallel", "sequence_parallel"):
        assert getattr(TrainerConfig(**{field: True}), field)
    assert TrainerConfig(grad_accum=2, profile_dir="/nowhere").grad_accum == 2
    with pytest.raises(ValueError, match="grad_accum"):
        TrainerConfig(grad_accum=0)
    text_arcface_task(model, fused_loss=True)
    base = dict(tower_lr=1e-3, head_lr=1e-3, head_warmup_frac=0.0,
                weight_decay=0.0, head_weight_decay=0.0, eval_every=1,
                save_every=1, log_every=1, margin=0.4,
                margin_delta_per_epoch=0.0, output="unused", seed=0,
                epochs=1)
    args = argparse.Namespace(**base, pipeline_parallel=2)
    with pytest.raises(ValueError,
                       match="pipeline_parallel needs a mesh model axis > 1"):
        _trainer(text_arcface_task(model), args, 4, device="cpu")
    args = argparse.Namespace(**base, pipeline_parallel=2,
                              tensor_parallel=True)
    with pytest.raises(ValueError, match="incompatible layouts"):
        _trainer(text_arcface_task(model), args, 4, device="cpu")
    for flag in ("tensor_parallel", "sequence_parallel"):
        args = argparse.Namespace(**{**base, "output": str(tmp_path)},
                                  **{flag: True})
        with pytest.raises(ValueError, match="tensor_parallel"):
            _trainer(text_arcface_task(model), args, 4, device="cpu")
    args = argparse.Namespace(**base, model_parallel=2)
    with pytest.raises(ValueError, match="not divisible by model=2"):
        _trainer(text_arcface_task(model), args, 4, device="cpu")
    args = argparse.Namespace(**{**base, "output": str(tmp_path)},
                              bf16_grads=True)
    trainer = _trainer(text_arcface_task(model), args, 4, device="cpu")
    assert trainer.config.bf16_grad_allreduce
    remat = NlpTextClassifier(BertConfig.tiny(remat=True,
                                              remat_policy="dots"),
                              num_labels=3)
    trainer = _trainer(text_arcface_task(remat), argparse.Namespace(
        **{**base, "output": str(tmp_path / "remat")}), 4, device="cpu")
    assert trainer.model.tower.encoder.config.remat


def test_cli_trainer_builds_the_v2_recipe(tmp_path):
    """``_trainer`` from the train_nlp_v2 values: two groups (tower and
    head) at lr 1e-3 with weight decay 0.01, a linear schedule over
    epochs x steps, and checkpoints and metrics under --output."""
    model = NlpTextClassifier(BertConfig.tiny(), num_labels=5,
                              arcface=ArcFaceParams(m=0.4))
    args = argparse.Namespace(
        tower_lr=1e-3, head_lr=1e-3, head_warmup_frac=0.0,
        weight_decay=0.01, head_weight_decay=0.01, eval_every=1000,
        save_every=1000, log_every=20, margin=0.4,
        margin_delta_per_epoch=0.0, output=str(tmp_path / "out"), seed=0,
        epochs=30, optimizer="adamw", scheduler="linear")
    trainer = _trainer(text_arcface_task(model), args, 10, device="cpu")
    groups = trainer.optimizer.param_groups
    assert [len(g["params"]) for g in groups] == [
        len(list(model.tower.parameters())), 1]
    assert groups[1]["params"][0] is model.head.weight
    assert [g["weight_decay"] for g in groups] == [0.01, 0.01]
    assert [g["lr"] for g in groups] == [pytest.approx(1e-3)] * 2
    assert trainer.schedules.schedules[0](300) == 0.0
    assert trainer.ckpt.directory == str(tmp_path / "out" / "ckpt")
    assert trainer.margin == pytest.approx(0.4)
