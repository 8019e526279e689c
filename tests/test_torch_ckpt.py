"""``eval``, ``import-checkpoint`` and ``export-checkpoint`` of the port
against the JAX package's, on the CPU.

* ``eval``: ``main(argv, device="cpu")`` against the JAX CLI's ``main`` on
  one checkpoint's weights (the JAX side's restore replaced by the JAX
  tree, the port's checkpoint written by ``text_classifier_from_jax``),
  both towers in full precision: the metrics within 1e-5, a padded head
  masked by ``--num_labels``, and the three refusals word for word.
* The reference key maps: a reference-layout state_dict (the port's export
  of a seeded model of each kind) goes through the JAX importer and
  ``models/convert.py`` to the port's state_dict exactly as through the
  port's importer, the JAX exporter gives the same reference state_dict
  back, and a reference-structured module (HF ``BertModel``, the timm
  EfficientNet stand-in of ``tests/test_efficientnet.py``) embeds as the
  imported port model does.
* The commands round-trip every kind through a checkpoint directory and
  keep the JAX commands' refusals.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import torch.nn as nn_t
import torch.nn.functional as F

import multimodalsimilar_tpu.cli as jcli
from multimodalsimilar_tpu.cli import ckpt as jckpt
from multimodalsimilar_tpu.models import classifiers as jclassifiers
from multimodalsimilar_tpu.models import reference_export as jre
from multimodalsimilar_tpu.models import reference_import as jri
from multimodalsimilar_tpu.models.bert import BertConfig as JBertConfig
from multimodalsimilar_tpu.models.efficientnet import (
    EfficientNetConfig as JEfficientNetConfig)
from multimodalsimilar_tpu.utils.dtypes import DTypePolicy as JPolicy
from multimodalsimilar_tpu_torch import cli
from multimodalsimilar_tpu_torch.models import classifiers as pclassifiers
from multimodalsimilar_tpu_torch.models import convert
from multimodalsimilar_tpu_torch.models import reference_export as pre
from multimodalsimilar_tpu_torch.models import reference_import as pri
from multimodalsimilar_tpu_torch.models.bert import BertConfig
from multimodalsimilar_tpu_torch.models.classifiers import (
    NlpMultilabelClassifier, NlpTextClassifier, SiamesePairModel)
from multimodalsimilar_tpu_torch.models.efficientnet import EfficientNetConfig
from multimodalsimilar_tpu_torch.models.multimodal import MultimodalClassifier
from multimodalsimilar_tpu_torch.models.vision import CvImageClassifier
from multimodalsimilar_tpu_torch.train.checkpoint import CheckpointManager
from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy

torch.set_num_threads(1)

FP32 = DTypePolicy.full_precision()


# -- eval ---------------------------------------------------------------------

TITLES = ["红富士苹果 5斤装", "青苹果 新鲜", "纯牛奶 250ml", "酸奶 原味",
          "可乐 330ml 罐装", "雪碧 柠檬味", "香蕉 进口", "橙汁 100%"]


@pytest.fixture(scope="module")
def eval_setup(tmp_path_factory):
    """48 labeled titles (labels 0..2) on disk, their vocab, and two JAX
    trees, heads of 5 and of 2 classes, each with the port checkpoint of
    its weights."""
    from multimodalsimilar_tpu_torch.data.tokenizer import build_char_vocab
    d = tmp_path_factory.mktemp("eval")
    titles = [TITLES[i % 8] + str(i % 7) for i in range(48)]
    pd.DataFrame({"spu_name": titles,
                  "labels": [i % 3 for i in range(48)]}).to_csv(
        d / "e.csv", index=False)
    vocab = str(d / "vocab.txt")
    build_char_vocab(titles, out_path=vocab)
    trees = {}
    for classes in (5, 2):
        jmodel = jclassifiers.NlpTextClassifier(
            JBertConfig.tiny(), num_labels=classes,
            policy=JPolicy.full_precision())
        params = jax.device_get(jmodel.init(
            {"params": jax.random.key(classes)},
            jnp.zeros((1, 16), jnp.int32),
            label=jnp.zeros(1, jnp.int32)))["params"]
        CheckpointManager(str(d / f"ckpt{classes}")).save(0, {
            "model": convert.text_classifier_from_jax(params,
                                                      BertConfig.tiny())})
        trees[classes] = params
    return d, vocab, trees


def _eval_both(monkeypatch, capsys, d, vocab, params, classes, extra):
    monkeypatch.setattr(jckpt, "_restore_required",
                        lambda c, template=None: {"params": params})
    monkeypatch.setattr(jclassifiers, "NlpTextClassifier", functools.partial(
        jclassifiers.NlpTextClassifier, policy=JPolicy.full_precision()))
    monkeypatch.setattr(pclassifiers, "NlpTextClassifier", functools.partial(
        pclassifiers.NlpTextClassifier, policy=FP32))
    argv = ["eval", "--data", str(d / "e.csv"), "--tokenizer", vocab,
            "--checkpoint", str(d / f"ckpt{classes}"), "--max_length", "16",
            "--batch_size", "16", *extra]
    out = []
    for main in (jcli.main, lambda a: cli.main(a, device="cpu")):
        try:
            main(argv)
            out.append(json.loads(capsys.readouterr().out.splitlines()[-1]))
        except SystemExit as e:
            out.append(("SystemExit", str(e)))
    return out


@pytest.mark.parametrize("classes,extra", [
    (5, ["--num_labels", "5"]), (5, ["--num_labels", "4"]),
    (5, ["--num_labels", "3", "--seq_buckets", "8,12"])],
    ids=["full_head", "one_pad_class", "two_pad_classes_buckets"])
def test_eval_matches_jax_cli(eval_setup, monkeypatch, capsys, classes,
                              extra):
    d, vocab, trees = eval_setup
    want, got = _eval_both(monkeypatch, capsys, d, vocab, trees[classes],
                           classes, extra)
    assert set(got) == set(want) == {"acc", "loss"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5)
    assert np.isfinite(got["loss"])


@pytest.mark.parametrize("classes,extra", [
    (5, []), (5, ["--num_labels", "2"]), (5, ["--num_labels", "6"]),
    (2, [])], ids=["wider_head_without_num_labels", "num_labels_below_data",
                   "num_labels_above_head", "narrow_head"])
def test_eval_refusals_match_jax_cli(eval_setup, monkeypatch, capsys,
                                     classes, extra):
    d, vocab, trees = eval_setup
    want, got = _eval_both(monkeypatch, capsys, d, vocab, trees[classes],
                           classes, extra)
    assert want[0] == "SystemExit" and got == want


# -- the reference key maps ---------------------------------------------------

CFG = BertConfig.tiny()
ECFG = EfficientNetConfig.tiny()


def _port_model(kind):
    """A seeded port model of ``kind``, statistics drawn so BatchNorm is
    not the identity."""
    g = torch.Generator().manual_seed(1)
    model = {"nlp": lambda: NlpTextClassifier(CFG, num_labels=7,
                                              generator=g),
             "multilabel": lambda: NlpMultilabelClassifier(CFG, 3, 5, 7,
                                                           generator=g),
             "siamese": lambda: SiamesePairModel(CFG, generator=g),
             "cv": lambda: CvImageClassifier(ECFG, 6, fc_dim=12,
                                             generator=g),
             "multimodal": lambda: MultimodalClassifier(
                 CFG, ECFG, 6, fc_dim=12, generator=g)}[kind]()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn_t.modules.batchnorm._BatchNorm):
                m.running_mean.normal_(0, 0.3, generator=g)
                m.running_var.uniform_(0.5, 2.0, generator=g)
    return model


def _to_reference(kind, sd):
    return {"nlp": lambda: pre.nlp_classifier_to_reference(sd, CFG),
            "multilabel": lambda: pre.multilabel_classifier_to_reference(
                sd, CFG),
            "siamese": lambda: pre.siamese_to_reference(sd, CFG),
            "cv": lambda: pre.cv_classifier_to_reference(sd, ECFG),
            "multimodal": lambda: pre.multimodal_to_reference(
                sd, CFG, ECFG)}[kind]()


def _from_reference(kind, sd):
    return {"nlp": lambda: pri.nlp_classifier_from_reference(sd, CFG),
            "multilabel": lambda: pri.multilabel_classifier_from_reference(
                sd, CFG),
            "siamese": lambda: pri.siamese_from_reference(sd, CFG),
            "cv": lambda: pri.cv_classifier_from_reference(sd, ECFG),
            "multimodal": lambda: pri.multimodal_from_reference(
                sd, CFG, ECFG)}[kind]()


def _jax_round_trip(kind, ref):
    """(the port state_dict through the JAX importer and convert.py, the
    JAX exporter's reference state_dict of the same JAX tree)."""
    jcfg, jecfg = JBertConfig.tiny(), JEfficientNetConfig.tiny()
    if kind in ("nlp", "multilabel", "siamese"):
        imp = getattr(jri, {"nlp": "nlp_classifier_from_reference",
                            "multilabel":
                                "multilabel_classifier_from_reference",
                            "siamese": "siamese_from_reference"}[kind])
        params = imp(ref, jcfg)
        port = {"nlp": convert.text_classifier_from_jax,
                "multilabel": convert.multilabel_classifier_from_jax,
                "siamese": convert.siamese_pair_from_jax}[kind](params, CFG)
        exp = getattr(jre, {"nlp": "nlp_classifier_to_reference",
                            "multilabel": "multilabel_classifier_to_reference",
                            "siamese": "siamese_to_reference"}[kind])
        return port, exp(params, jcfg)
    if kind == "cv":
        params, stats = jri.cv_classifier_from_reference(ref, jecfg)
        port = convert.cv_classifier_from_jax(
            {"params": params, "batch_stats": stats}, ECFG)
        return port, jre.cv_classifier_to_reference(params, stats, jecfg)
    params, stats = jri.multimodal_from_reference(ref, jcfg, jecfg)
    port = convert.multimodal_classifier_from_jax(
        {"params": params, "batch_stats": stats}, CFG, ECFG)
    # the fused model's sub-heads are dead weights the port's module lacks
    port = {k: v for k, v in port.items()
            if k not in ("cv.head.weight", "nlp.head.weight")}
    return port, jre.multimodal_to_reference(params, stats, jcfg, jecfg)


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        w = torch.as_tensor(np.asarray(want[k]))
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
        assert torch.equal(got[k], w), k


KINDS = ["nlp", "multilabel", "siamese", "cv", "multimodal"]


@pytest.mark.parametrize("kind", KINDS)
def test_key_maps_match_the_jax_importer_and_exporter(kind):
    sd = _port_model(kind).state_dict()
    ref = _to_reference(kind, sd)
    if kind != "cv":
        assert torch.equal(ref["ptm.pooler.dense.weight"]
                           if "ptm.pooler.dense.weight" in ref else
                           ref["nlp.ptm.pooler.dense.weight"],
                           ref["emb_layer.ptm.pooler.dense.weight"]
                           if "ptm.pooler.dense.weight" in ref else
                           ref["nlp.emb_layer.ptm.pooler.dense.weight"])
    port_via_jax, jax_ref = _jax_round_trip(kind, ref)
    got = _from_reference(kind, ref)
    _assert_same(got, {k: v for k, v in sd.items()})
    _assert_same(got, port_via_jax)
    _assert_same(ref, jax_ref)
    wrapped = {f"module.{k}": v for k, v in ref.items()}   # DataParallel
    _assert_same(_from_reference(kind, wrapped), got)


def test_import_embeds_as_the_reference_modules():
    """An HF BertModel text classifier and a timm-named cv classifier,
    imported: the port's models embed as the reference modules do."""
    from transformers import BertConfig as HFBertConfig, BertModel
    from tests.test_efficientnet import TorchEffNet
    hf = HFBertConfig(vocab_size=CFG.vocab_size, hidden_size=CFG.hidden_size,
                      num_hidden_layers=CFG.num_layers,
                      num_attention_heads=CFG.num_heads,
                      intermediate_size=CFG.intermediate_size,
                      max_position_embeddings=CFG.max_position_embeddings,
                      hidden_act="gelu", attn_implementation="eager")

    class TorchNlp(nn_t.Module):
        def __init__(self):
            super().__init__()
            self.ptm = BertModel(hf)
            self.classifier = nn_t.Module()
            self.classifier.weight = nn_t.Parameter(torch.randn(10, 64))

    torch.manual_seed(0)
    ref = TorchNlp().eval()
    model = NlpTextClassifier(CFG, num_labels=10, policy=FP32).eval()
    model.load_state_dict(pri.nlp_classifier_from_reference(
        ref.state_dict(), CFG))
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, CFG.vocab_size, (3, 10)))
    mask = torch.ones_like(ids)
    mask[1, 6:] = 0
    with torch.no_grad():
        want = ref.ptm(ids, attention_mask=mask).pooler_output
        np.testing.assert_allclose(model.predict_emb(ids, mask).numpy(),
                                   want.numpy(), atol=1e-5)
        np.testing.assert_allclose(
            model(ids, mask, is_test=True).numpy(),
            F.linear(F.normalize(want),
                     F.normalize(ref.classifier.weight)).numpy(), atol=1e-5)

    jecfg = JEfficientNetConfig.tiny()

    class TorchCv(nn_t.Module):
        def __init__(self):
            super().__init__()
            self.backbone = TorchEffNet(jecfg)
            self.fc = nn_t.Linear(jecfg.num_features, 12)
            self.bn = nn_t.BatchNorm1d(12)
            self.classifier = nn_t.Module()
            self.classifier.weight = nn_t.Parameter(torch.randn(5, 12))

    cv_ref = TorchCv().eval()
    with torch.no_grad():
        for m in cv_ref.modules():
            if isinstance(m, nn_t.modules.batchnorm._BatchNorm):
                m.running_mean.normal_(0, 0.3)
                m.running_var.uniform_(0.5, 2.0)
    cv = CvImageClassifier(ECFG, 5, fc_dim=12, policy=FP32).eval()
    cv.load_state_dict(pri.cv_classifier_from_reference(
        cv_ref.state_dict(), ECFG))
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 3, 24, 24)).astype(np.float32))
    with torch.no_grad():
        want = cv_ref.bn(cv_ref.fc(cv_ref.backbone(x).mean((2, 3))))
        np.testing.assert_allclose(cv.predict_emb(x).numpy(), want.numpy(),
                                   atol=1e-5)


# -- the commands -------------------------------------------------------------

def _flags(kind):
    return ["--kind", kind, "--bert_preset", "tiny", "--backbone", "tiny"]


@pytest.mark.parametrize("kind", KINDS)
def test_import_export_commands_round_trip(kind, tmp_path, capsys):
    ref = _to_reference(kind, _port_model(kind).state_dict())
    torch.save(ref, tmp_path / "ref.pt")
    cli.main(["import-checkpoint", *_flags(kind), "--state_dict",
              str(tmp_path / "ref.pt"), "--out", str(tmp_path / "ckpt")],
             device="cpu")
    state = CheckpointManager(str(tmp_path / "ckpt")).restore()
    assert state["step"] == 0
    _assert_same(state["model"], _from_reference(kind, ref))
    cli.main(["export-checkpoint", *_flags(kind), "--checkpoint",
              str(tmp_path / "ckpt"), "--out", str(tmp_path / "out.pt")],
             device="cpu")
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines == [{"imported": kind, "out": str(tmp_path / "ckpt")},
                     {"exported": kind, "out": str(tmp_path / "out.pt"),
                      "tensors": len(ref)}]
    _assert_same(torch.load(tmp_path / "out.pt", weights_only=True), ref)


def test_import_refusals(tmp_path):
    ref = _to_reference("nlp", _port_model("nlp").state_dict())
    torch.save(ref, tmp_path / "ref.pt")
    base = ["import-checkpoint", "--state_dict", str(tmp_path / "ref.pt"),
            "--out", str(tmp_path / "ckpt")]
    cli.main(base + _flags("nlp"), device="cpu")
    with pytest.raises(SystemExit, match="already holds checkpoints"):
        cli.main(base + _flags("nlp"), device="cpu")
    cli.main(base + _flags("nlp") + ["--overwrite"], device="cpu")
    assert CheckpointManager(str(tmp_path / "ckpt")).all_steps() == [0]
    with pytest.raises(SystemExit, match="efficientnet"):
        cli.main(base + ["--kind", "cv", "--backbone", "vit_b16"],
                 device="cpu")
    with pytest.raises(SystemExit, match="no text tower"):
        cli.main(base + _flags("cv") + ["--pipeline_parallel", "2"],
                 device="cpu")
    # --pipeline_parallel is accepted for a text kind: the one-card layout
    plain = CheckpointManager(str(tmp_path / "ckpt")).restore()["model"]
    cli.main(base + _flags("nlp") + ["--pipeline_parallel", "2",
                                      "--overwrite"], device="cpu")
    staged = CheckpointManager(str(tmp_path / "ckpt")).restore()["model"]
    assert list(staged) == list(plain)
    assert all(torch.equal(staged[k], v) for k, v in plain.items())
    with pytest.raises(KeyError):               # base preset: 12 layers
        cli.main(base + ["--kind", "nlp", "--bert_preset", "base",
                         "--overwrite"], device="cpu")
    with pytest.raises(SystemExit, match="only EfficientNet checkpoints"):
        cli.main(["export-checkpoint", "--kind", "multimodal", "--backbone",
                  "convnext_tiny", "--checkpoint", str(tmp_path / "ckpt"),
                  "--out", str(tmp_path / "x.pt")], device="cpu")
    with pytest.raises(SystemExit, match="no checkpoint"):
        cli.main(["export-checkpoint", *_flags("nlp"), "--checkpoint",
                  str(tmp_path / "empty"), "--out", str(tmp_path / "x.pt")],
                 device="cpu")
