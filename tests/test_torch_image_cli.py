"""``serve --tower cv|multimodal`` and ``embed --kind cv`` end to end: the
JAX commands against the port's, on the CPU, on one corpus on disk.

Images live in the reference layouts ({img_root}/{key}/{j}.jpg for cv,
{img_root}/{key}.jpg for multimodal), written with ``cv2.imwrite``. The
JAX commands get their tower from a JAX-initialized tiny model (its
``_load_cv_tower`` / ``_multimodal_embedder`` replaced, since their
checkpoints are orbax directories); the port's read a port checkpoint of
the same weights (``cv_classifier_from_jax`` /
``multimodal_classifier_from_jax``) through its own loaders, which fold
the cv tower's BatchNorm. Both run the bf16 inference policy: answers
agree within 2e-2, and keys wherever the JAX scores around them are
further apart. The packed ``--emb_cache``, the ``--emb_table`` warm start
(keys in the table decode no image; the rest are embedded or dropped)
and the refusals are covered too.
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

from multimodalsimilar_tpu.cli import build_parser
from multimodalsimilar_tpu.cli import embed as jembed_cli
from multimodalsimilar_tpu.cli import embedders as jembedders
from multimodalsimilar_tpu.cli import serve as jserve
from multimodalsimilar_tpu.data.tokenizer import TextTokenizer as JTokenizer
from multimodalsimilar_tpu.models.bert import BertConfig as JBertConfig
from multimodalsimilar_tpu.models.efficientnet import (
    EfficientNetConfig as JEfficientNetConfig)
from multimodalsimilar_tpu.models.fold_bn import (
    fold_cv_classifier as jfold_cv_classifier)
from multimodalsimilar_tpu.models.multimodal import (
    MultimodalClassifier as JMultimodalClassifier)
from multimodalsimilar_tpu.models.vision import (
    CvImageClassifier as JCvImageClassifier)
from multimodalsimilar_tpu.pipelines.embedders import (
    MultimodalEmbedder as JMultimodalEmbedder)
from multimodalsimilar_tpu.utils.dtypes import DTypePolicy as JPolicy
from multimodalsimilar_tpu_torch.cli import embed as cli_embed
from multimodalsimilar_tpu_torch.cli import embedders as cli_embedders
from multimodalsimilar_tpu_torch.cli import serve as cli
from multimodalsimilar_tpu_torch.data import images as I
from multimodalsimilar_tpu_torch.data.datasets import InputError
from multimodalsimilar_tpu_torch.data.tokenizer import build_char_vocab
from multimodalsimilar_tpu_torch.models.bert import BertConfig
from multimodalsimilar_tpu_torch.models.convert import (
    cv_classifier_from_jax, multimodal_classifier_from_jax)
from multimodalsimilar_tpu_torch.models.efficientnet import EfficientNetConfig
from multimodalsimilar_tpu_torch.pipelines.embed import parse_embeddings
from multimodalsimilar_tpu_torch.pipelines.embedders import ImageEmbedder
from multimodalsimilar_tpu_torch.train.checkpoint import CheckpointManager
from tests.test_torch_image_serving import _jiggle, images

torch.set_num_threads(1)

IMG, FC, N = 32, 16, 16
TOL = 2e-2
TITLES = [f"{'甲乙丙丁戊己'[i % 6] * (1 + i % 3)}商品{i}" for i in range(N)]


def _flags(*extra):
    return ["--backbone", "tiny", "--image_size", str(IMG), "--fc_dim",
            str(FC), "--num_labels", "5", "--batch_size", "8", *extra]


def assert_same_answer(got, want, tol=TOL):
    assert len(got) == len(want)
    ws = np.array([w["score"] for w in want])
    np.testing.assert_allclose([g["score"] for g in got], ws, atol=tol,
                               rtol=0)
    gaps = np.abs(np.diff(ws))
    for i in range(len(want) - 1):
        if (i == 0 or gaps[i - 1] > tol) and gaps[i] > tol:
            assert got[i]["key"] == want[i]["key"], (i, got, want)


@pytest.fixture(scope="module")
def cv_setup(tmp_path_factory):
    """The corpus (a CSV of keys and categories, images per key, the last
    key with none), a port checkpoint, and the JAX folded tower."""
    d = tmp_path_factory.mktemp("cv")
    keys = [f"sku{i}" for i in range(N)]
    ims = images(2 * N, seed=30)
    for i, k in enumerate(keys[:-1]):
        os.makedirs(d / "img" / k)
        for j in range(1 + i % 2):
            cv2.imwrite(str(d / "img" / k / f"{j}.jpg"), ims[2 * i + j])
    os.makedirs(d / "img" / keys[-1])
    pd.DataFrame({"spu_sn": keys, "goods_sku": keys,
                  "lv1": [str(i % 3) for i in range(N)]}).to_csv(
        d / "corpus.csv", index=False)
    jcfg = JEfficientNetConfig.tiny()
    jmodel = JCvImageClassifier(jcfg, num_labels=5, fc_dim=FC,
                                policy=JPolicy.full_precision())
    v = _jiggle(jax.jit(lambda x: jmodel.init(
        {"params": jax.random.key(7)}, x, label=jnp.zeros(1, jnp.int32)))(
            jnp.zeros((1, IMG, IMG, 3))), 8)
    CheckpointManager(str(d / "ckpt")).save(0, {"model": cv_classifier_from_jax(
        v, EfficientNetConfig.tiny())})
    jfcfg, jfv = jfold_cv_classifier(v, jcfg)
    jtower = (JCvImageClassifier(jfcfg, num_labels=5, fc_dim=FC,
                                 policy=JPolicy.inference()), jfv)
    return d, keys, jtower


def _jax_cv_tower(monkeypatch, jtower):
    monkeypatch.setattr(jserve, "_load_cv_tower", lambda *a: jtower)
    monkeypatch.setattr(jembedders, "_load_cv_tower", lambda *a: jtower)
    monkeypatch.setattr(jserve, "_knn_backend_mesh",
                        lambda a: ("xla", None, None))


@pytest.mark.parametrize("emb_cache", [False, True],
                         ids=["emb_txt", "packed"])
def test_cli_serve_cv_matches_jax_cli(cv_setup, monkeypatch, tmp_path,
                                      emb_cache):
    d, keys, jtower = cv_setup
    _jax_cv_tower(monkeypatch, jtower)
    services = {}
    for side in ("jax", "port"):
        # each side its own image tree copy: both write emb.txt files
        root = tmp_path / side
        shutil.copytree(d / "img", root)
        extra = ["--emb_cache", str(tmp_path / f"{side}_c")] \
            if emb_cache else []
        args = build_parser().parse_args(
            ["serve", "--tower", "cv", "--data", str(d / "corpus.csv"),
             "--img_root", str(root), "--category_col", "lv1", "--k", "4",
             "--max_batch", "8", "--checkpoint", str(d / "ckpt"),
             *_flags(*extra)])
        build = jserve._build_serve_service if side == "jax" else (
            lambda a: cli._build_serve_service(a, device="cpu"))
        svc, n = build(args)
        (jserve if side == "jax" else cli)._warm_serve_service(svc, args)
        services[side] = svc
        assert n == N - 1                       # the imageless key dropped
    jsvc, svc = services["jax"], services["port"]
    try:
        assert svc.engine.keys == jsvc.engine.keys
        assert svc._fused_similar is not None and svc.score_th == 0.15
        for q in list(images(4, seed=31)) + [cv2.cvtColor(cv2.imread(str(
                d / "img" / "sku3" / "0.jpg")), cv2.COLOR_BGR2RGB)]:
            assert_same_answer(svc.similar(q, score_th=None),
                               jsvc.similar(q, score_th=None))
        own = svc.similar(cv2.cvtColor(cv2.imread(str(
            d / "img" / "sku4" / "0.jpg")), cv2.COLOR_BGR2RGB),
            score_th=None)
        assert own[0]["key"] == "sku4"
        if emb_cache:
            from multimodalsimilar_tpu_torch.pipelines.embcache import (
                EmbeddingCache)
            cache = EmbeddingCache(str(tmp_path / "port_c"), FC)
            assert len(cache) == N - 1
            cache.close()
    finally:
        jsvc.close()
        svc.close()


def test_embed_incremental_cv_matches_jax_then_serve_emb_table(
        cv_setup, monkeypatch, tmp_path, capsys):
    """``embed incremental --kind cv`` (the image job's full rebuild) gives
    the JAX command's table; ``serve --emb_table`` then starts from it,
    decoding no image of a key the table holds."""
    d, keys, jtower = cv_setup
    _jax_cv_tower(monkeypatch, jtower)
    tables = {}
    for side, cmd in (("jax", jembed_cli.cmd_embed_incremental),
                      ("port", lambda a: cli_embed.cmd_embed_incremental(
                          a, device="cpu"))):
        root = tmp_path / side
        shutil.copytree(d / "img", root)
        table = str(tmp_path / f"{side}.parquet")
        args = build_parser().parse_args(
            ["embed", "incremental", "--kind", "cv", "--data",
             str(d / "corpus.csv"), "--table", table, "--img_root",
             str(root), "--dt", "2026-08-16", "--checkpoint",
             str(d / "ckpt"), *_flags()])
        cmd(args)
        tables[side] = pd.read_parquet(table)
    outs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert outs[0] == {**outs[1], "table": outs[0]["table"]}
    assert outs[1]["mode"] == "rebuild" and outs[1]["written"] == N - 1
    got, want = tables["port"], tables["jax"]
    assert list(got.columns) == list(want.columns)
    assert list(got["goods_sku"]) == list(want["goods_sku"])
    assert set(got["dt"]) == {"2026-08-16"}
    np.testing.assert_allclose(parse_embeddings(got["embedding"]),
                               parse_embeddings(want["embedding"]), atol=TOL)

    decoded = []
    real = ImageEmbedder.embed_keys
    monkeypatch.setattr(ImageEmbedder, "embed_keys",
                        lambda self, ks, pf: decoded.append(list(ks))
                        or real(self, ks, pf))
    args = build_parser().parse_args(
        ["serve", "--tower", "cv", "--data", str(d / "corpus.csv"),
         "--img_root", str(tmp_path / "port"), "--emb_table",
         str(tmp_path / "port.parquet"), "--key_col", "goods_sku", "--k",
         "4", "--max_batch", "8", "--checkpoint", str(d / "ckpt"),
         *_flags()])
    svc, n = cli._build_serve_service(args, device="cpu")
    try:
        # only the key the table lacks goes to the tower: it has no image
        assert decoded == [["sku15"]] and n == N - 1
        q = cv2.cvtColor(cv2.imread(str(tmp_path / "port" / "sku6" /
                                        "0.jpg")), cv2.COLOR_BGR2RGB)
        assert svc.similar(q, score_th=None)[0]["key"] == "sku6"
    finally:
        svc.close()


def test_embed_bulk_cv_and_bert_columns(cv_setup, tmp_path, capsys,
                                        monkeypatch):
    d, keys, _ = cv_setup
    table = str(tmp_path / "bulk.parquet")
    data = str(tmp_path / "bulk.csv")
    pd.DataFrame({"goods_sku": keys, "spu_name": TITLES}).to_csv(
        data, index=False)
    args = build_parser().parse_args(
        ["embed", "bulk", "--data", data, "--table", table, "--kinds",
         "bert,cv", "--img_root", str(d / "img"), "--max_length", "12",
         "--checkpoint", str(d / "ckpt"), *_flags()])
    # one --checkpoint serves both towers; here it is the cv tower's and
    # the text tower takes seed 0
    args.checkpoint, cv_ckpt = None, args.checkpoint
    real = cli_embedders._load_cv_tower
    monkeypatch.setattr(cli_embedders, "_load_cv_tower",
                        lambda a, c, n: real(a, cv_ckpt, n))
    cli_embed.cmd_embed_bulk(args, device="cpu")
    out = pd.read_parquet(table)
    assert list(out.columns) == ["goods_sku", "bert_emb", "cv_emb"]
    assert len(out) == N and out["cv_emb"].isna().sum() == 1
    assert '"towers": ["bert", "cv"]' in capsys.readouterr().out


@pytest.fixture(scope="module")
def mm_setup(tmp_path_factory):
    """Pairs on disk ({img_root}/{key}.jpg; the last key has none), the
    vocab, a port checkpoint, and the JAX embedder of the same weights."""
    d = tmp_path_factory.mktemp("mm")
    keys = [f"spu{i}" for i in range(N)]
    ims = images(N, seed=40)
    os.makedirs(d / "img")
    for k, im in zip(keys[:-1], ims):
        cv2.imwrite(str(d / "img" / f"{k}.jpg"), im)
    pd.DataFrame({"spu_sn": keys, "spu_name": TITLES}).to_csv(
        d / "pairs.csv", index=False)
    vocab = str(d / "vocab.txt")
    build_char_vocab(TITLES, out_path=vocab)
    jmodel = JMultimodalClassifier(JBertConfig.tiny(),
                                   JEfficientNetConfig.tiny(), num_labels=5,
                                   fc_dim=FC, policy=JPolicy.full_precision())
    v = _jiggle(jax.jit(lambda x, i: jmodel.init(
        {"params": jax.random.key(9)}, x, i, label=jnp.zeros(1, jnp.int32)))(
            jnp.zeros((1, IMG, IMG, 3)), jnp.zeros((1, 12), jnp.int32)), 10)
    CheckpointManager(str(d / "ckpt")).save(0, {
        "model": multimodal_classifier_from_jax(
            v, BertConfig.tiny(), EfficientNetConfig.tiny())})
    jinf = JMultimodalClassifier(JBertConfig.tiny(),
                                 JEfficientNetConfig.tiny(), num_labels=5,
                                 fc_dim=FC, policy=JPolicy.inference())
    jemb = JMultimodalEmbedder(jinf, v, JTokenizer.from_vocab_file(vocab),
                               max_length=12, image_size=IMG, batch_size=8)
    return d, keys, vocab, jemb


def _mm_args(d, vocab, *extra):
    return build_parser().parse_args(
        ["serve", "--tower", "multimodal", "--data", str(d / "pairs.csv"),
         "--img_root", str(d / "img"), "--tokenizer", vocab,
         "--checkpoint", str(d / "ckpt"), "--max_length", "12", "--k", "4",
         "--max_batch", "8", *_flags(*extra)])


@pytest.mark.parametrize("emb_table", [False, True],
                         ids=["images", "emb_table"])
def test_cli_serve_multimodal_matches_jax_cli(mm_setup, monkeypatch,
                                              tmp_path, emb_table):
    d, keys, vocab, jemb = mm_setup
    monkeypatch.setattr(jserve, "_multimodal_embedder", lambda a, df: jemb)
    monkeypatch.setattr(jserve, "_knn_backend_mesh",
                        lambda a: ("xla", None, None))
    extra = []
    if emb_table:
        # a fused table covering half the keys; the rest embed fresh
        args = _mm_args(d, vocab)
        emb, keep = cli_embedders._fused_embeddings(
            args, pd.read_csv(d / "pairs.csv")[:8], device="cpu")
        pd.DataFrame({"spu_sn": keys[:8], "embedding": [
            "[" + ",".join(map(str, e)) + "]" for e in emb]}).to_parquet(
            tmp_path / "fused.parquet")
        extra = ["--emb_table", str(tmp_path / "fused.parquet")]
    args = _mm_args(d, vocab, *extra)
    jsvc, jn = jserve._build_serve_service(args)
    svc, n = cli._build_serve_service(args, device="cpu")
    try:
        assert n == jn == N - 1 and svc.engine.keys == jsvc.engine.keys
        assert svc.engine.metric == "l2" and svc.score_th is None
        jserve._warm_serve_service(jsvc, args)
        cli._warm_serve_service(svc, args)
        np.testing.assert_allclose(svc.engine._emb, jsvc.engine._emb,
                                   atol=TOL)
        for i, t in enumerate(TITLES[3:7], 3):
            # the corpus image as the tower saw it: decoded from its JPEG
            im = I.load_eval(str(d / "img" / f"spu{i}.jpg"), IMG,
                             normalize_host=False)
            got = svc.similar((t, im), score_th=None)
            assert got[0]["key"] == f"spu{TITLES.index(t)}"
            assert got[0]["score"] <= 1e-3
            assert_same_answer(got, jsvc.similar((t, im), score_th=None))
    finally:
        jsvc.close()
        svc.close()


def test_refusals(cv_setup, mm_setup, tmp_path):
    d, keys, _ = cv_setup
    table = {"spu_sn": ["a"], "spu_name": ["b"]}
    # the fasttext tower needs its model; daodian has its own service
    for tower, err, match in (("fasttext", SystemExit, "--fasttext_model"),
                              ("daodian", ValueError,
                               "_build_daodian_service")):
        args = build_parser().parse_args(["serve", "--tower", tower,
                                          "--data", "x"])
        with pytest.raises(err, match=match):
            cli._build_serve_service(args, table=table, device="cpu")
    md, _, vocab, _ = mm_setup
    args = _mm_args(md, vocab)
    args.checkpoint = None
    with pytest.raises(SystemExit, match="checkpoint"):
        cli._build_serve_service(args, device="cpu")
    # a ViT backbone is ported: it gets as far as the images, which the
    # default --img_root does not hold
    args = build_parser().parse_args(
        ["serve", "--tower", "cv", "--data", "x", "--backbone", "vit_test",
         "--image_size", "32", "--img_root", str(tmp_path / "none")])
    with pytest.raises(SystemExit, match="no readable images"):
        cli._build_serve_service(args, table=table, device="cpu")
    # a checkpoint of another backbone does not fit the flags
    args = build_parser().parse_args(
        ["serve", "--tower", "cv", "--data", "x", "--checkpoint",
         str(d / "ckpt"), "--backbone", "efficientnet_b0", "--fc_dim",
         str(FC)])
    with pytest.raises(InputError, match="does not fit"):
        cli_embedders._load_cv_tower(args, args.checkpoint, 5)
    args = build_parser().parse_args(
        ["serve", "--tower", "cv", "--data", str(d / "corpus.csv"),
         "--img_root", str(tmp_path / "none"), *_flags()])
    with pytest.raises(SystemExit, match="no readable images"):
        cli._build_serve_service(args, device="cpu")
