"""The port stands alone: no JAX, no Flax, nothing of multimodalsimilar_tpu.

A subprocess blocks those modules in ``sys.modules`` and imports every
module of the port and ``chip_smoke`` (without running it); an AST scan
finds no such import anywhere in the port's source; and the entry points
refuse to run without a card unless asked for the CPU.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "multimodalsimilar_tpu_torch")
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "multimodalsimilar_tpu")

torch.set_num_threads(1)

_PROBE = r"""
import importlib, importlib.util, json, pkgutil, sys
BLOCKED = %r
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
for name in BLOCKED:
    sys.modules[name] = None      # "import jax" now raises ImportError
import multimodalsimilar_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", %r)
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED
          and sys.modules[m] is not None]
print(json.dumps([names, leaked]))
"""

# the serving and export modules, which pull in the most of the package,
# the image slice's, the daodian slice's, the training recipes', the
# command line's, the ViT, ConvNeXt and int8 towers', the multi-GPU
# layouts' and sharded serving's
SERVING = ["cli.common", "cli.embed", "cli.embedders", "cli.serve",
           "pipelines.embed", "pipelines.microbatch", "pipelines.serving",
           "data.images", "pipelines.embcache", "models.efficientnet",
           "models.fold_bn", "models.vision", "models.multimodal",
           "models.fasttext", "models.convert", "pipelines.similar",
           "pipelines.daodian_serving", "cli.similar", "native",
           "ops.arcface_loss", "train.optim", "train.tasks",
           "train.trainer", "cli.train", "data.sampling", "data.datasets",
           "models.classifiers", "utils.profiling",
           # the command line's
           "cli", "cli.__main__", "cli.parser", "cli.config", "cli.ckpt",
           "cli.ops", "models.reference_import", "models.reference_export",
           "pipelines.spark", "pipelines.download",
           # the ViT, ConvNeXt and int8 towers
           "models.vit", "models.convnext", "models.quant",
           "models.hf_import",
           # the multi-GPU layouts
           "parallel", "parallel.mesh", "parallel.spawn",
           # sharded serving
           "pipelines.sharded_serving"]


def _py_files():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_imports_with_jax_blocked():
    code = _PROBE % (BLOCKED, os.path.join(ROOT, "chip_smoke.py"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names, leaked = json.loads(out.stdout)
    assert len(names) >= 20 and leaked == []
    assert {f"multimodalsimilar_tpu_torch.{m}" for m in SERVING} <= set(names)


@pytest.mark.parametrize("path", list(_py_files()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [node.module.split(".")[0]]
        else:
            continue
        assert not set(roots) & set(BLOCKED), (path, node.lineno, roots)


def test_no_module_level_pandas_or_transformers():
    for path in _py_files():
        tree = ast.parse(open(path, encoding="utf-8").read())
        for node in tree.body:
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import) else [node.module])
                assert not {n.split(".")[0] for n in names} & {
                    "pandas", "transformers", "redis", "triton", "yaml",
                    "pyspark"}, path


def test_entry_points_need_cuda_or_explicit_cpu(monkeypatch):
    from multimodalsimilar_tpu_torch.data.tokenizer import TextTokenizer
    from multimodalsimilar_tpu_torch.models.bert import BertConfig
    from multimodalsimilar_tpu_torch.models.classifiers import (
        NlpTextClassifier)
    from multimodalsimilar_tpu_torch.pipelines.embedders import TextEmbedder
    from multimodalsimilar_tpu_torch.pipelines.similar import nlp_similar_job
    from multimodalsimilar_tpu_torch.pipelines.sinks import InMemoryKVSink
    from multimodalsimilar_tpu_torch.retrieval.engine import SimilarityEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = NlpTextClassifier(BertConfig.tiny())
    tok = TextTokenizer.from_corpus(["苹果", "牛奶"])
    emb = np.eye(4, dtype=np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TextEmbedder(model, tok)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SimilarityEngine(emb, list("abcd"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nlp_similar_job({"spu_name": list("abcd"), "spu_sn": list("abcd")},
                        lambda texts: emb, InMemoryKVSink())
    # asked for the CPU, they run
    TextEmbedder(model, tok, device="cpu")
    assert nlp_similar_job({"spu_name": list("abcd"),
                            "spu_sn": list("abcd")}, lambda texts: emb,
                           InMemoryKVSink(), score_th=-2.0,
                           device="cpu") == 4


def test_serve_and_embed_need_cuda_or_explicit_cpu(monkeypatch, tmp_path):
    import argparse

    from multimodalsimilar_tpu_torch.cli.embed import cmd_embed_bulk
    from multimodalsimilar_tpu_torch.cli.serve import _build_serve_service

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    table = {"spu_sn": ["a", "b"], "spu_name": ["苹果", "牛奶"]}
    args = argparse.Namespace(
        tower="bert", k=13, text_col="spu_name", key_col="spu_sn",
        category_col=None, tokenizer=None, checkpoint=None,
        bert_preset="tiny", num_labels=2, max_length=8, batch_size=4,
        max_batch=4, max_wait_ms=1.0, score_th=None, emb_table=None,
        data="unused")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _build_serve_service(args, table=table)
    service, n = _build_serve_service(args, table=table, device="cpu")
    service.close()
    assert n == 2
    path = tmp_path / "c.csv"
    path.write_text("goods_sku,spu_name\na,苹果\n", encoding="utf-8")
    bulk = argparse.Namespace(
        data=str(path), table=str(tmp_path / "t.parquet"), kinds="bert",
        key_col="goods_sku", text_col="spu_name", tokenizer=None,
        checkpoint=None, bert_preset="tiny", num_labels=2, max_length=8,
        batch_size=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cmd_embed_bulk(bulk)


def test_image_entry_points_need_cuda_or_explicit_cpu(monkeypatch):
    from multimodalsimilar_tpu_torch.data.tokenizer import TextTokenizer
    from multimodalsimilar_tpu_torch.models.bert import BertConfig
    from multimodalsimilar_tpu_torch.models.efficientnet import (
        EfficientNetConfig)
    from multimodalsimilar_tpu_torch.models.multimodal import (
        MultimodalClassifier)
    from multimodalsimilar_tpu_torch.models.vision import CvImageClassifier
    from multimodalsimilar_tpu_torch.pipelines.embedders import (
        ImageEmbedder, MultimodalEmbedder)
    from multimodalsimilar_tpu_torch.pipelines.similar import (
        multimodal_similar_job)
    from multimodalsimilar_tpu_torch.pipelines.sinks import InMemoryKVSink

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cv = CvImageClassifier(EfficientNetConfig.tiny(), num_labels=3, fc_dim=8)
    mm = MultimodalClassifier(BertConfig.tiny(), EfficientNetConfig.tiny(),
                              num_labels=3, fc_dim=8)
    tok = TextTokenizer.from_corpus(["苹果"])
    emb = np.eye(4, dtype=np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ImageEmbedder(cv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultimodalEmbedder(mm, tok)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multimodal_similar_job({"spu_sn": list("abcd")}, emb,
                               InMemoryKVSink())
    out = ImageEmbedder(cv, image_size=16, device="cpu").embed_batch(
        np.zeros((2, 16, 16, 3), np.uint8))
    assert out.shape == (2, 8)
    assert multimodal_similar_job({"spu_sn": list("abcd")}, emb,
                                  InMemoryKVSink(), device="cpu") == 4


def test_daodian_entry_points_need_cuda_or_explicit_cpu(monkeypatch):
    from multimodalsimilar_tpu_torch.models.fasttext import train_supervised
    from multimodalsimilar_tpu_torch.pipelines.daodian_serving import (
        DaodianService)
    from multimodalsimilar_tpu_torch.pipelines.similar import (
        daodian_similar_job)
    from multimodalsimilar_tpu_torch.pipelines.sinks import InMemoryKVSink

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    table = {"area_id": [1, 1], "spu_sn": ["a", "b"], "title": ["x", "y"],
             "first_level_category_id": [1, 1],
             "second_level_category_id": [2, 2]}

    def embed(titles):
        return np.eye(2, dtype=np.float32)[: len(titles)]

    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_supervised(["苹果", "牛奶"], [0, 1], dim=4, bucket=10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        daodian_similar_job(table, embed, lambda a: {}, InMemoryKVSink())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DaodianService(table, embed, lambda a: {})
    assert train_supervised(["苹果", "牛奶"], [0, 1], dim=4, bucket=10,
                            device="cpu").dim == 4
    assert daodian_similar_job(table, embed, lambda a: {}, InMemoryKVSink(),
                               nlp_score_th=-2.0, device="cpu") == {
        "a": ["b"], "b": ["a"]}


def test_trainer_needs_cuda_or_explicit_cpu(monkeypatch):
    from multimodalsimilar_tpu_torch.models.bert import BertConfig
    from multimodalsimilar_tpu_torch.models.classifiers import (
        NlpTextClassifier)
    from multimodalsimilar_tpu_torch.train.optim import (
        dual_group_adamw, linear_schedule_with_warmup)
    from multimodalsimilar_tpu_torch.train.tasks import text_arcface_task
    from multimodalsimilar_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    task = text_arcface_task(NlpTextClassifier(BertConfig.tiny(),
                                               num_labels=3))
    sched = linear_schedule_with_warmup(1e-3, 0, 10)

    def make(model):
        return dual_group_adamw(model, sched, sched)

    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(task, make)
    assert Trainer(task, make, device="cpu").device.type == "cpu"


def test_train_commands_need_cuda_or_explicit_cpu(monkeypatch, tmp_path):
    from multimodalsimilar_tpu_torch.cli.train import (cmd_train_multilabel,
                                                       cmd_train_pair)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    import argparse
    common = dict(tokenizer=None, max_length=8, no_clean=True,
                  bert_preset="tiny", batch_size=2, epochs=1, tower_lr=1e-3,
                  head_lr=1e-3, head_warmup_frac=0.0, weight_decay=0.0,
                  head_weight_decay=0.0, eval_every=10, save_every=10,
                  log_every=10, margin=0.4, margin_delta_per_epoch=0.0,
                  weighted_sampling=False, fused_loss=False, seed=0)
    ml = argparse.Namespace(
        **common, text_col="t", lv1_col="a", lv2_col="b", tag_col="c",
        lv1_weight=1.0, lv2_weight=1.0, tag_weight=1.0,
        output=str(tmp_path / "ml"))
    table = {"t": ["苹果", "牛奶"], "a": [0, 1], "b": [0, 1], "c": [1, 0]}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cmd_train_multilabel(ml, table=table)
    assert cmd_train_multilabel(ml, table=table, device="cpu").step == 1
    pair = argparse.Namespace(**common, output=str(tmp_path / "pair"))
    pairs = {"title": ["苹果", "牛奶"], "tag_id": [0, 1],
             "lv2_category_id": [0, 1], "lv1_category_id": [0, 0]}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cmd_train_pair(pair, table=pairs)
    assert cmd_train_pair(pair, table=pairs, device="cpu").step == 1


def test_chip_smoke_refuses_without_cuda():
    """Run as a script without a card it exits non-zero, printing no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
