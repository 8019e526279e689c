"""The ViT and ConvNeXt backbones through the port's commands, against the
JAX commands, on the CPU.

The JAX commands get their towers from JAX-initialized ``vit_test`` /
``convnext_test`` models (their ``_load_cv_tower`` and
``_multimodal_embedder`` replaced, since their checkpoints are orbax
directories); the port's read a port checkpoint of the same weights
through their own loaders, which fold no BatchNorm for these backbones
(only the neck's remains, as in JAX). Both towers run in full precision
here, so answers agree within 1e-4 and keys wherever the JAX scores
around them are further apart:

* ``serve --tower cv`` and ``embed incremental --kind cv`` with each
  backbone, ``similar multimodal --checkpoint`` with a ViT image tower,
  ``similar daodian`` with a ViT cv arm;
* ``train cv`` with ``convnext_test`` at the ``train_cv_daodian.yaml``
  recipe and ``vit_test`` at 48 px (its position table from
  ``--image_size``) at ``train_cv_timm.yaml``'s (AdamP, ``timm_cosine``),
  and ``train multimodal`` with ``vit_test``, two tiny epochs each; each
  checkpoint loads through the serving loaders;
* ``import-``/``export-checkpoint`` refuse both backbones with the JAX
  commands' messages.
"""

import json
import os
import shutil

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import multimodalsimilar_tpu.cli as jcli
from multimodalsimilar_tpu.cli import build_parser
from multimodalsimilar_tpu.cli import embed as jembed_cli
from multimodalsimilar_tpu.cli import embedders as jembedders
from multimodalsimilar_tpu.cli import serve as jserve
from multimodalsimilar_tpu.cli import similar as jsimilar
from multimodalsimilar_tpu.data.tokenizer import TextTokenizer as JTokenizer
from multimodalsimilar_tpu.models.bert import BertConfig as JBertConfig
from multimodalsimilar_tpu.models.multimodal import (
    MultimodalClassifier as JMultimodalClassifier)
from multimodalsimilar_tpu.models.vision import (
    CvImageClassifier as JCvImageClassifier)
from multimodalsimilar_tpu.models.vision import (
    backbone_config as jbackbone_config)
from multimodalsimilar_tpu.pipelines.embedders import (
    MultimodalEmbedder as JMultimodalEmbedder)
from multimodalsimilar_tpu.utils.dtypes import DTypePolicy as JPolicy
from multimodalsimilar_tpu_torch import cli as pcli
from multimodalsimilar_tpu_torch.cli import embed as cli_embed
from multimodalsimilar_tpu_torch.cli import embedders as cli_embedders
from multimodalsimilar_tpu_torch.cli import serve as cli
from multimodalsimilar_tpu_torch.cli import train as CT
from multimodalsimilar_tpu_torch.data.tokenizer import build_char_vocab
from multimodalsimilar_tpu_torch.models.bert import BertConfig
from multimodalsimilar_tpu_torch.models.convert import (
    cv_classifier_from_jax, multimodal_classifier_from_jax)
from multimodalsimilar_tpu_torch.models.vision import backbone_config
from multimodalsimilar_tpu_torch.pipelines.embed import parse_embeddings
from multimodalsimilar_tpu_torch.train.checkpoint import CheckpointManager
from tests.test_torch_cli import (BASE, _full_precision, _items, _last_json,
                                  _sinks, daodian_setup)  # noqa: F401
from tests.test_torch_image_cli import assert_same_answer
from tests.test_torch_image_serving import _jiggle, images

torch.set_num_threads(1)

IMG, FC, N = 32, 16, 12
TOL = 1e-4
BACKBONES = ["vit_test", "convnext_test"]
FULL = JPolicy.full_precision()


def _flags(backbone, *extra):
    return ["--backbone", backbone, "--image_size", str(IMG), "--fc_dim",
            str(FC), "--num_labels", "5", "--batch_size", "8", *extra]


def _jax_cv(backbone, seed):
    """A JAX image classifier of ``backbone`` (weights and neck
    statistics jiggled) and the port checkpoint's state_dict of it."""
    jmodel = JCvImageClassifier(jbackbone_config(backbone), num_labels=5,
                                fc_dim=FC, policy=FULL)
    v = _jiggle(jax.jit(lambda x: jmodel.init(
        {"params": jax.random.key(seed)}, x, label=jnp.zeros(1, jnp.int32)))(
            jnp.zeros((1, IMG, IMG, 3))), seed + 1)
    return (jmodel, v), cv_classifier_from_jax(v, backbone_config(backbone))


@pytest.fixture(scope="module")
def cv_setup(tmp_path_factory):
    """{img_root}/{key}/{j}.jpg for N keys (the last with none), a port
    checkpoint and the JAX tower of each backbone."""
    d = tmp_path_factory.mktemp("bb")
    keys = [f"sku{i}" for i in range(N)]
    ims = images(2 * N, seed=50)
    for i, k in enumerate(keys[:-1]):
        os.makedirs(d / "img" / k)
        for j in range(1 + i % 2):
            cv2.imwrite(str(d / "img" / k / f"{j}.jpg"), ims[2 * i + j])
    os.makedirs(d / "img" / keys[-1])
    pd.DataFrame({"spu_sn": keys, "goods_sku": keys,
                  "lv1": [str(i % 3) for i in range(N)]}).to_csv(
        d / "corpus.csv", index=False)
    towers = {}
    for seed, name in enumerate(BACKBONES):
        towers[name], sd = _jax_cv(name, 3 * seed + 1)
        CheckpointManager(str(d / name)).save(0, {"model": sd})
    return d, keys, towers


def _jax_cv_tower(monkeypatch, tower):
    for mod in (jserve, jembedders, jsimilar):
        if hasattr(mod, "_load_cv_tower"):
            monkeypatch.setattr(mod, "_load_cv_tower", lambda *a: tower)
    monkeypatch.setattr(jserve, "_knn_backend_mesh",
                        lambda a: ("xla", None, None))


@pytest.mark.parametrize("backbone", BACKBONES)
def test_serve_cv_matches_jax_cli(cv_setup, monkeypatch, tmp_path, backbone):
    d, keys, towers = cv_setup
    _full_precision(monkeypatch)
    _jax_cv_tower(monkeypatch, towers[backbone])
    services = {}
    for side in ("jax", "port"):
        root = tmp_path / side
        shutil.copytree(d / "img", root)
        args = build_parser().parse_args(
            ["serve", "--tower", "cv", "--data", str(d / "corpus.csv"),
             "--img_root", str(root), "--category_col", "lv1", "--k", "4",
             "--max_batch", "8", "--checkpoint", str(d / backbone),
             *_flags(backbone)])
        build = jserve._build_serve_service if side == "jax" else (
            lambda a: cli._build_serve_service(a, device="cpu"))
        svc, n = build(args)
        (jserve if side == "jax" else cli)._warm_serve_service(svc, args)
        services[side] = svc
        assert n == N - 1
    jsvc, svc = services["jax"], services["port"]
    try:
        assert svc.engine.keys == jsvc.engine.keys
        for q in images(4, seed=51):
            assert_same_answer(svc.similar(q, score_th=None),
                               jsvc.similar(q, score_th=None), tol=TOL)
        own = cv2.cvtColor(cv2.imread(str(d / "img" / "sku4" / "0.jpg")),
                           cv2.COLOR_BGR2RGB)
        assert svc.similar(own, score_th=None)[0]["key"] == "sku4"
    finally:
        jsvc.close()
        svc.close()


@pytest.mark.parametrize("backbone", BACKBONES)
def test_embed_incremental_cv_matches_jax_cli(cv_setup, monkeypatch,
                                              tmp_path, capsys, backbone):
    d, keys, towers = cv_setup
    _full_precision(monkeypatch)
    _jax_cv_tower(monkeypatch, towers[backbone])
    tables = {}
    for side, cmd in (("jax", jembed_cli.cmd_embed_incremental),
                      ("port", lambda a: cli_embed.cmd_embed_incremental(
                          a, device="cpu"))):
        root = tmp_path / side
        shutil.copytree(d / "img", root)
        table = str(tmp_path / f"{side}.parquet")
        cmd(build_parser().parse_args(
            ["embed", "incremental", "--kind", "cv", "--data",
             str(d / "corpus.csv"), "--table", table, "--img_root",
             str(root), "--dt", "2026-08-16", "--checkpoint",
             str(d / backbone), *_flags(backbone)]))
        tables[side] = pd.read_parquet(table)
    outs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert outs[1] == {**outs[0], "table": outs[1]["table"]}
    assert outs[1]["written"] == N - 1
    got, want = tables["port"], tables["jax"]
    assert list(got["goods_sku"]) == list(want["goods_sku"])
    np.testing.assert_allclose(parse_embeddings(got["embedding"]),
                               parse_embeddings(want["embedding"]),
                               rtol=0, atol=TOL)


def test_load_cv_tower_folds_only_efficientnet(cv_setup):
    """ViT and ConvNeXt keep their (BN-free) backbone and the neck's BN
    as they are; the ViT's table follows --image_size."""
    d, _, _ = cv_setup
    for name in BACKBONES:
        args = build_parser().parse_args(
            ["serve", "--tower", "cv", "--data", "x", *_flags(name)])
        model = cli_embedders._load_cv_tower(args, str(d / name), 5)
        assert model.bn is not None and not any(
            isinstance(m, torch.nn.BatchNorm2d) for m in model.modules())
        state = CheckpointManager(str(d / name)).restore()["model"]
        for k, v in model.state_dict().items():
            if k != "head.weight":
                assert torch.equal(v, state[k]), k
    args = build_parser().parse_args(
        ["serve", "--tower", "cv", "--data", "x", *_flags("vit_test"),
         "--image_size", "48"])
    model = cli_embedders._load_cv_tower(args, None, 5)
    assert model.backbone.pos_embed.shape == (1, 37, 32)
    args = build_parser().parse_args(
        ["serve", "--tower", "cv", "--data", "x", *_flags("tiny")])
    assert model.cfg.resolution == 48
    folded = cli_embedders._load_cv_tower(args, None, 5)
    assert folded.cfg.folded


@pytest.fixture(scope="module")
def mm_setup(tmp_path_factory):
    """Pairs on disk ({img_root}/{key}.jpg), their vocab, a port
    checkpoint of a ViT + tiny-BERT fused classifier and the JAX embedder
    of the same weights."""
    d = tmp_path_factory.mktemp("mmv")
    keys = [f"spu{i}" for i in range(N)]
    titles = [BASE[i % len(BASE)] + str(i) for i in range(N)]
    os.makedirs(d / "img")
    for k, im in zip(keys, images(N, seed=52, size=IMG)):
        cv2.imwrite(str(d / "img" / f"{k}.jpg"), im)
    pd.DataFrame({"spu_sn": keys, "spu_name": titles}).to_csv(
        d / "pairs.csv", index=False)
    vocab = str(d / "vocab.txt")
    build_char_vocab(titles, out_path=vocab)
    jmodel = JMultimodalClassifier(JBertConfig.tiny(),
                                   jbackbone_config("vit_test"), num_labels=5,
                                   fc_dim=FC, policy=FULL)
    v = _jiggle(jax.jit(lambda x, i: jmodel.init(
        {"params": jax.random.key(9)}, x, i, label=jnp.zeros(1, jnp.int32)))(
            jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1, 12), jnp.int32)), 10)
    CheckpointManager(str(d / "ckpt")).save(0, {
        "model": multimodal_classifier_from_jax(
            v, BertConfig.tiny(), backbone_config("vit_test"))})
    jemb = JMultimodalEmbedder(jmodel, v, JTokenizer.from_vocab_file(vocab),
                               max_length=12, image_size=IMG, batch_size=8)
    return d, vocab, jemb


def test_similar_multimodal_vit_matches_jax_cli(mm_setup, monkeypatch,
                                                capsys):
    d, vocab, jemb = mm_setup
    _full_precision(monkeypatch)
    js, ps = _sinks(monkeypatch)
    monkeypatch.setattr(jembedders, "_multimodal_embedder",
                        lambda a, df: jemb)
    argv = ["similar", "multimodal", "--data", str(d / "pairs.csv"),
            "--k", "4", "--checkpoint", str(d / "ckpt"), "--tokenizer",
            vocab, "--img_root", str(d / "img"), "--bert_preset", "tiny",
            "--max_length", "12", *_flags("vit_test")]
    jcli.main(argv)
    want = capsys.readouterr().out
    pcli.main(argv, device="cpu")
    assert capsys.readouterr().out == want
    assert json.loads(want)["written"] == N
    assert _items(ps) == _items(js)


def test_similar_daodian_with_a_vit_cv_arm_matches_jax_cli(
        daodian_setup, cv_setup, monkeypatch, capsys, tmp_path):
    """The v1 job with both arms: the cv arm embeds {img_root}/{sku}/0.jpg
    through the ViT tower of the same weights in both commands."""
    dd = daodian_setup
    d, _, towers = cv_setup
    _full_precision(monkeypatch)
    js, ps = _sinks(monkeypatch)
    _jax_cv_tower(monkeypatch, towers["vit_test"])
    skus = pd.read_csv(dd / "skus.csv")["sku"].astype(str).tolist()
    ims = images(len(skus), seed=53)
    argv_of = {}
    for side in ("jax", "port"):
        root = tmp_path / side
        for i, sku in enumerate(skus):
            (root / sku).mkdir(parents=True)
            cv2.imwrite(str(root / sku / "0.jpg"), ims[i % 24])
        argv_of[side] = [
            "similar", "daodian", "--config",
            os.path.join(os.path.dirname(__file__), "..", "configs",
                         "similar_daodian_v1.yaml"),
            "--data", str(dd / "skus.csv"), "--img_root", str(root),
            "--cv_checkpoint", str(d / "vit_test"), "--cv_num_labels", "5",
            *_flags("vit_test")[:6]]
    jcli.main(argv_of["jax"] + ["--fasttext_model", str(dd / "ft.pkl")])
    want = _last_json(capsys)
    pcli.main(argv_of["port"] + ["--fasttext_model", str(dd / "ft.pt")],
              device="cpu")
    assert _last_json(capsys) == want == {"skus": 72}
    assert _items(ps) == _items(js) and _items(ps)


def _train_table(tmp_path):
    keys = [str(i) for i in range(16)]
    pd.DataFrame({"goods_sku": keys, "spu_sn": keys,
                  "tag_new_id": [i % 3 for i in range(16)],
                  "spu_name": [f"商品{i}" for i in range(16)]}).to_csv(
        tmp_path / "i.csv", index=False)
    root = tmp_path / "img"
    os.makedirs(root)
    rng = np.random.default_rng(0)
    for k in keys:
        cv2.imwrite(str(root / f"{k}.jpg"),
                    rng.integers(0, 256, (20, 20, 3)).astype(np.uint8))
    return str(tmp_path / "i.csv"), str(root)


def _train_args(argv, out):
    return build_parser().parse_args(
        argv + ["--output", str(out), "--epochs", "2", "--log_every", "1",
                "--batch_size", "8", "--fc_dim", "8"])


def _losses(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        lines = [json.loads(ln) for ln in f if ln.strip()]
    return [ln["train/loss"] for ln in lines if "train/loss" in ln]


def test_train_cv_with_the_new_backbones(tmp_path):
    data, root = _train_table(tmp_path)
    common = ["train", "cv", "--data", data, "--img_root", root]
    runs = {
        "convnext_test": (["--config", os.path.join(
            os.path.dirname(__file__), "..", "configs",
            "train_cv_daodian.yaml"), "--backbone", "convnext_test",
            "--image_size", "32", "--t0_epochs", "1"], 32),
        "vit_test": (["--config", os.path.join(
            os.path.dirname(__file__), "..", "configs",
            "train_cv_timm.yaml"), "--backbone", "vit_test",
            "--image_size", "48", "--cooldown_epochs", "0"], 48)}
    for name, (extra, size) in runs.items():
        out = tmp_path / name
        args = _train_args(common + extra, out)
        tr = CT.cmd_train_cv(args, device="cpu")
        assert tr.step == 4 and tr.ckpt.latest_step() == 4
        losses = _losses(out)
        assert len(losses) == 4 and all(np.isfinite(losses))
        # the checkpoint serves through the loader, at the trained size
        sargs = build_parser().parse_args(
            ["serve", "--tower", "cv", "--data", "x", "--backbone", name,
             "--image_size", str(size), "--fc_dim", "8"])
        model = cli_embedders._load_cv_tower(sargs, str(out / "ckpt"), 5)
        state = tr.ckpt.restore()["model"]
        for k, v in model.state_dict().items():
            if k != "head.weight":
                assert torch.equal(v, state[k].cpu()), k
        with torch.no_grad():
            emb = model.predict_emb(torch.zeros(2, 3, size, size))
        assert emb.shape == (2, 8) and torch.isfinite(emb).all()
    assert tr.model.backbone.pos_embed.shape == (1, 37, 32)


def test_train_multimodal_with_a_vit_then_similar(tmp_path, capsys):
    data, root = _train_table(tmp_path)
    out = tmp_path / "mm"
    img_root = tmp_path / "pairs"
    os.makedirs(img_root)
    for f in os.listdir(root):
        shutil.copy(os.path.join(root, f), img_root / f)
    tr = CT.cmd_train_multimodal(_train_args(
        ["train", "multimodal", "--data", data, "--img_root", str(root),
         "--label_col", "tag_new_id", "--max_length", "8", "--bert_preset",
         "tiny", "--backbone", "vit_test", "--image_size", "32"], out),
        device="cpu")
    assert tr.step == 4 and all(np.isfinite(_losses(out)))
    capsys.readouterr()
    pcli.main(["similar", "multimodal", "--data", data, "--key_col",
               "spu_sn", "--k", "4", "--checkpoint", str(out / "ckpt"),
               "--tokenizer", str(out / "vocab.txt"), "--img_root",
               str(img_root), "--bert_preset", "tiny", "--max_length", "8",
               "--backbone", "vit_test", "--image_size", "32", "--fc_dim",
               "8", "--num_labels", "3"], device="cpu")
    assert json.loads(capsys.readouterr().out)["written"] == 16


@pytest.mark.parametrize("command", ["import-checkpoint",
                                     "export-checkpoint"])
@pytest.mark.parametrize("backbone", ["vit_base", "convnext_tiny"])
def test_checkpoint_commands_refuse_the_new_backbones_as_jax(
        tmp_path, command, backbone):
    ref = tmp_path / "ref.pt"
    torch.save({"w": torch.zeros(1)}, ref)
    CheckpointManager(str(tmp_path / "ckpt")).save(0, {"model": {}})
    argv = [command, "--kind", "cv", "--backbone", backbone, "--out",
            str(tmp_path / "out")]
    argv += (["--state_dict", str(ref)] if command == "import-checkpoint"
             else ["--checkpoint", str(tmp_path / "ckpt")])
    with pytest.raises(SystemExit) as want:
        jcli.main(argv)
    with pytest.raises(SystemExit) as got:
        pcli.main(argv, device="cpu")
    assert str(got.value) == str(want.value)
    assert "EfficientNet" in str(got.value)
