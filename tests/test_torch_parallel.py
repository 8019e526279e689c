"""Multi-GPU layouts on the CPU: the port over gloo against the JAX package
over the same mesh shape on tests/conftest.py's 8 virtual CPU devices.

The port's ranks are processes (``parallel/spawn.py``, one torch thread
each, a port the OS picks, a time limit per spawn); what they run is in
``tests/torch_parallel_workers.py``, which imports no JAX. Two spawns
serve every case: a world of 2 (data 2, or data 1 x model 2) and one of
4 (data 2 x model 2, or data 1 x model 4), started in the background
while the JAX references compute. Weights go JAX -> port through the
``*_from_jax`` converters; models are tiny, in full precision, dropout
off against JAX.

The cases: data parallelism in f32 and bf16; class-sharded heads, padded
and heterogeneous; AdamP over class-sharded heads and the fused loss over
them at both mesh shapes (ROADMAP C3); tensor parallelism, tensor and
sequence parallelism, with remat, at an odd sequence length (9 over 4
ranks: padded inside the region) and from a fused-QKV tree, against the
JAX Trainer with ``tensor_parallel``/``sequence_parallel`` on the same
mesh. With dropout on, the port's 4 tensor- and sequence-parallel ranks
are held against the port on one process instead (the packages draw
their masks from different generators): the same masks, so the same
losses.

Tolerances: Adam turns float noise in a near-zero gradient into an
lr-sized step, so fits are compared through their per-step losses (f32:
rtol 1e-4, as the JAX package's own model-parallel test) and through the
first batch's gradients (within 1e-4 of each tensor's largest entry, as
tests/test_torch_train_recipes.py). ``--bf16_grads`` rounds each rank's
gradients to bfloat16 and their sum again before the mean, where both
packages round (``_assert_bf16_grads`` reckons the bound from the
ranks' own gradients); losses rtol 2e-3 (both packages round the same
f32 gradients). The search is exact: indices and scores equal.
"""

import concurrent.futures
import dataclasses
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parallel_workers as W
import multimodalsimilar_tpu.cli as jcli
from multimodalsimilar_tpu.cli import embedders as jembedders
from multimodalsimilar_tpu.cli import similar as jsimilar
from multimodalsimilar_tpu.data.tokenizer import TextTokenizer as JTokenizer
from multimodalsimilar_tpu.models import efficientnet as JE
from multimodalsimilar_tpu.models.bert import BertConfig as JBertConfig
from multimodalsimilar_tpu.models.classifiers import (
    NlpMultilabelClassifier as JMultilabel)
from multimodalsimilar_tpu.models.classifiers import (
    NlpTextClassifier as JClassifier)
from multimodalsimilar_tpu.models.vision import (
    CvImageClassifier as JCvImageClassifier)
from multimodalsimilar_tpu.models.multimodal import (
    MultimodalClassifier as JMultimodalClassifier)
from multimodalsimilar_tpu.parallel.mesh import create_mesh as j_mesh
from multimodalsimilar_tpu.parallel.mesh import shard_batch as j_shard
from multimodalsimilar_tpu.retrieval.knn import pad_corpus as j_pad
from multimodalsimilar_tpu.retrieval.knn import (
    sharded_knn_search as j_sharded)
from multimodalsimilar_tpu.pipelines.embedders import (
    MultimodalEmbedder as JMultimodalEmbedder)
from multimodalsimilar_tpu.pipelines.sinks import (
    InMemoryKVSink as JInMemoryKVSink)
from multimodalsimilar_tpu.train import tasks as JT
from multimodalsimilar_tpu.train.optim import adamp as j_adamp
from multimodalsimilar_tpu.train.optim import dual_group as j_dual_group
from multimodalsimilar_tpu.train.optim import dual_group_adamw as j_adamw
from multimodalsimilar_tpu.train.trainer import Trainer as JTrainer
from multimodalsimilar_tpu.train.trainer import TrainState as JTrainState
from multimodalsimilar_tpu.train.trainer import (
    TrainerConfig as JTrainerConfig)
from multimodalsimilar_tpu.utils.dtypes import DTypePolicy as JPolicy
from multimodalsimilar_tpu_torch import cli
from multimodalsimilar_tpu_torch.cli import similar as CS
from multimodalsimilar_tpu_torch.models.bert import BertConfig
from multimodalsimilar_tpu_torch.models.classifiers import NlpTextClassifier
from multimodalsimilar_tpu_torch.data.tokenizer import build_char_vocab
from multimodalsimilar_tpu_torch.models.convert import (
    cv_classifier_from_jax, multilabel_classifier_from_jax,
    multimodal_classifier_from_jax, text_classifier_from_jax)
from multimodalsimilar_tpu_torch.models.efficientnet import (
    EfficientNetConfig, set_stats_mesh)
from multimodalsimilar_tpu_torch.models.heads import ArcFaceHead
from multimodalsimilar_tpu_torch.parallel.mesh import (Mesh, MeshRules,
                                                       shard_batch)
from multimodalsimilar_tpu_torch.parallel.spawn import spawn
from multimodalsimilar_tpu_torch.pipelines.similar import nlp_similar_job
from multimodalsimilar_tpu_torch.pipelines.sinks import InMemoryKVSink
from multimodalsimilar_tpu_torch.retrieval.knn import knn_search
from multimodalsimilar_tpu_torch.train.checkpoint import CheckpointManager
from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy
from tests.test_torch_image_serving import _jiggle, images
from multimodalsimilar_tpu_torch.train.optim import (AdamP,
                                                     dual_group,
                                                     dual_group_adamw)
from multimodalsimilar_tpu_torch.train.tasks import text_arcface_task
from multimodalsimilar_tpu_torch.train.trainer import Trainer, TrainerConfig

torch.set_num_threads(1)

JFULL = JPolicy.full_precision()
NO_DROPOUT = dict(hidden_dropout=0.0, attention_dropout=0.0)
VOCAB = 96
BERT = dict(vocab_size=VOCAB, num_layers=1, **NO_DROPOUT)
BERT_HIDDEN = 64
B, S = 8, 10
LRS = (1e-3, 1e-2)
TIMEOUT = 120


def _text_batches(n, labels, seed, keys=("labels",), s=S):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(5, VOCAB, (B, s)).astype(np.int32)
        mask = (np.arange(s)[None] < rng.integers(3, s + 1, (B, 1))
                ).astype(np.int32)
        b = {"input_ids": ids * mask, "attention_mask": mask,
             "token_type_ids": np.zeros_like(ids)}
        for key, c in zip(keys, labels):
            b[key] = rng.integers(0, c, B).astype(np.int32)
        out.append(b)
    return out


def _images(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, (n, 16, 16, 3)).astype(np.uint8)


class _NoDropCv(JCvImageClassifier):
    """The JAX image classifier with the neck's dropout off in train mode."""

    def predict_emb(self, images, train=False, deterministic=None):
        return super().predict_emb(images, train=train, deterministic=True)


def _cv_cfgs():
    return (dataclasses.replace(JE.EfficientNetConfig.tiny(),
                                drop_path_rate=0.0),
            dataclasses.replace(
                W.E.EfficientNetConfig.tiny(), drop_path_rate=0.0))


# -- the cases: (JAX model + task, mesh shape, port spec, batches) -----------

_TOWER = {}


def _tower():
    """One JAX init of the tiny tower, shared by every text case (each
    case draws its heads with numpy): a compile saved per case."""
    if not _TOWER:
        jmodel = JClassifier(JBertConfig.tiny(**BERT), num_labels=2)
        _TOWER["params"] = jax.device_get(jax.jit(lambda: jmodel.init(
            {"params": jax.random.key(0)}, jnp.zeros((2, S), jnp.int32),
            label=jnp.zeros(2, jnp.int32)))()["params"]["tower"])
    return _TOWER["params"]


def _head(c, rng):
    """xavier-uniform [C, D], as both packages' ArcFace heads draw."""
    d = BERT_HIDDEN
    bound = np.sqrt(6.0 / (c + d))
    return {"weight": rng.uniform(-bound, bound, (c, d)).astype(np.float32)}


def _fuse_qkv(tower):
    """The tower's q/k/v kernels [H, nh, hd] stacked to the fused-QKV
    layout [H, 3, nh, hd] (biases [3, nh, hd]), as JAX ``fused_qkv``
    builds it."""
    enc = dict(tower["encoder"])
    for key, layer in enc.items():
        if not key.startswith("layer_"):
            continue
        att = layer["attention"]
        qkv = [att[n] for n in ("query", "key", "value")]
        enc[key] = dict(layer, attention={
            "qkv": {"kernel": np.stack([p["kernel"] for p in qkv], 1),
                    "bias": np.stack([p["bias"] for p in qkv], 0)},
            "out": att["out"]})
    return dict(tower, encoder=enc)


def _case_text(num_labels, num_valid, seed, fused_loss=False,
               fused_qkv=False, s=S, **bert):
    """``bert``: BertConfig fields of both packages (remat,
    sequence_parallel, dropout)."""
    bert = dict(BERT, **bert)
    jmodel = JClassifier(JBertConfig.tiny(**bert, fused_qkv=fused_qkv),
                         num_labels=num_labels, policy=JFULL)
    batches = _text_batches(3, [num_valid or num_labels], seed, s=s)
    tower = _fuse_qkv(_tower()) if fused_qkv else _tower()
    params = {"tower": tower,
              "head": _head(num_labels, np.random.default_rng(seed))}
    sd = text_classifier_from_jax(params, BertConfig.tiny(**bert))
    spec = {"bert": bert, "num_labels": num_labels, "num_valid": num_valid,
            "fused_loss": fused_loss}
    return (JT.text_arcface_task(jmodel, num_valid=num_valid,
                                 fused_loss=fused_loss),
            {"params": params}, spec, sd, batches)


def _case_multilabel(labels, seed):
    jmodel = JMultilabel(JBertConfig.tiny(**BERT), *labels, policy=JFULL)
    keys = ("lv1_label", "lv2_label", "tag_label")
    batches = _text_batches(4, labels, seed, keys)
    rng = np.random.default_rng(seed)
    params = {"tower": _tower(), **{f"{lv}_head": _head(c, rng) for lv, c
                                    in zip(("lv1", "lv2", "tag"), labels)}}
    sd = multilabel_classifier_from_jax(params, BertConfig.tiny(**BERT))
    return (JT.multilabel_arcface_task(jmodel), {"params": params},
            {"bert": BERT, "labels": labels}, sd, batches)


_CV = {}


def _case_cv(seed, num_labels=7):
    """The tiny EfficientNet classifier (one JAX init per class count,
    shared by the cv cases) and one batch: after one step the running
    statistics depend only on the init."""
    jcfg, cfg = _cv_cfgs()
    jmodel = _NoDropCv(jcfg, num_labels=num_labels, fc_dim=12,
                       policy=JFULL)
    rng = np.random.default_rng(seed)
    batches = [{"images": _images(B, seed),
                "labels": rng.integers(0, num_labels, B).astype(np.int32)}]
    if num_labels not in _CV:
        _CV[num_labels] = jax.device_get(jax.jit(lambda x: jmodel.init(
            {"params": jax.random.key(0)}, x,
            label=jnp.zeros(B, jnp.int32)))(
            jnp.zeros((B, 16, 16, 3), jnp.float32)))
    v = _CV[num_labels]
    sd = cv_classifier_from_jax(v, cfg)
    return (JT.cv_arcface_task(jmodel), v,
            {"num_labels": num_labels, "fc_dim": 12}, sd, batches)


MP = {"model_parallel_heads": True}
TP = dict(MP, tensor_parallel=True)
SP = dict(TP, sequence_parallel=True)
CASES = {
    # world 2: data 2
    "dp_f32": (lambda: _case_text(11, None, 1), (2, 1), {"eval_every": 3}),
    "dp_bf16": (lambda: _case_text(11, None, 2), (2, 1),
                {"bf16_grad_allreduce": True}),
    "cv_f32": (lambda: _case_cv(3), (2, 1), {}),
    "cv_bf16": (lambda: _case_cv(4), (2, 1),
                {"bf16_grad_allreduce": True}),
    # world 4: data 2 x model 2
    "mp_padded": (lambda: _case_text(38, 37, 5), (2, 2),
                  {"model_parallel_heads": True, "eval_every": 3}),
    # heterogeneous heads (lv1's 5 classes stay whole) and --grad_accum
    "mp_multilabel": (lambda: _case_multilabel((5, 8, 12), 6), (2, 2),
                      {"model_parallel_heads": True, "grad_accum": 2}),
    # C3: AdamP (a train cv-style head) and the fused loss over class
    # blocks, at data 1 x model 2 (world 2) and data 2 x model 2
    "c3_cv_adamp_1x2": (lambda: _case_cv(7, 8), (1, 2), MP, "adamp"),
    "c3_cv_adamp_2x2": (lambda: _case_cv(8, 8), (2, 2), MP, "adamp"),
    "c3_fused_1x2": (lambda: _case_text(12, None, 9, fused_loss=True),
                     (1, 2), MP),
    "c3_fused_2x2": (lambda: _case_text(12, None, 10, fused_loss=True),
                     (2, 2), MP),
    # tensor and sequence parallelism, composed with the class blocks
    "tp_2x2": (lambda: _case_text(12, None, 11), (2, 2), TP),
    "tp_sp_2x2": (lambda: _case_text(12, None, 12,
                                     sequence_parallel=True), (2, 2), SP),
    # 9 tokens over 4 ranks: padded to 12 inside the region
    "tp_sp_remat_1x4": (lambda: _case_text(
        12, None, 13, s=9, sequence_parallel=True, remat=True), (1, 4),
        SP),
    "tp_sp_fused_qkv_2x2": (lambda: _case_text(
        12, None, 14, fused_qkv=True, sequence_parallel=True,
        remat=True, remat_policy="dots"), (2, 2), SP),
    # AdamP over the cut tower weights (the JAX CLI builds AdamP for every
    # recipe and lets it meet --tensor_parallel)
    "tp_adamp_1x4": (lambda: _case_text(12, None, 16), (1, 4), TP,
                     "adamp"),
}
TP_CASES = [n for n in CASES if n.startswith("tp_")]
# JAX's jitted gradient of the tiny EfficientNet's depthwise convs on a
# data 2 x model 2 mesh is twice its gradient on one device (with or
# without class-sharded heads; 1 x 2 and 2 x 1 agree with one device):
# that case's first gradients are held against JAX on one device, its
# losses against the JAX Trainer on the 2 x 2 mesh as every case's
GRADS_ON_ONE_DEVICE = ("c3_cv_adamp_2x2",)


def _jax_run(name, ref, tmp):
    """JAX: the first batch's gradients and the per-step losses of
    ``Trainer.fit`` on the case's mesh, from the case's init."""
    _, shape, cfg, *opt = CASES[name]
    jtask, variables, spec, sd, batches = ref
    mesh = j_mesh(jax.devices()[:shape[0] * shape[1]], *shape)
    accum = cfg.get("grad_accum", 1)
    if opt == ["adamp"]:
        tx = j_dual_group(j_adamp(lambda s: LRS[0]),
                          j_adamp(lambda s: LRS[1]))
    else:
        tx = j_adamw(lambda s: LRS[0], lambda s: LRS[1])
    if accum > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=accum)
    path = os.path.join(tmp, f"{name}.jax.jsonl")
    trainer = JTrainer(jtask, tx, mesh, JTrainerConfig(
        log_every=1, metrics_path=path, **cfg))
    state = trainer._place_state(JTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables.get("batch_stats", {}),
        opt_state=tx.init(variables["params"]),
        margin=jnp.asarray(0.4, jnp.float32)))
    grad = jax.jit(jax.grad(lambda p, b: jtask.train_loss(
        p, state.batch_stats, b, jax.random.key(0), state.margin)[0]))
    if cfg.get("bf16_grad_allreduce"):
        # the shard_map step: each shard's gradients (its own BatchNorm
        # statistics), meaned before the bf16 rounding
        halves = [{k: v[h * B // 2:(h + 1) * B // 2]
                   for k, v in batches[0].items()} for h in range(2)]
        grads = jax.tree_util.tree_map(
            lambda a, b: (a + b) / 2,
            *[jax.device_get(grad(state.params, h)) for h in halves])
    elif name in GRADS_ON_ONE_DEVICE:
        grads = jax.device_get(grad(variables["params"], batches[0]))
    else:
        grads = jax.device_get(grad(state.params, j_shard(mesh,
                                                          batches[0])))
    evals = _evals(cfg, batches)
    final = trainer.fit(W.Batches(batches), 1, B,
                        W.Batches(evals) if evals else None,
                        initial_state=state)
    return {"grads": grads, "losses": _losses(path),
            "evals": {key: _losses(path, f"eval/{key}")
                      for key in ("acc", "loss")},
            "final": jax.device_get(final), "spec": spec,
            "batches": batches, "variables": variables}


def _evals(cfg, batches):
    """The eval split of a case that evaluates: the first batch and 7 rows
    of the second (not divisible by the data axis: left whole on every
    rank, weighted by its share)."""
    if "eval_every" not in cfg:
        return None
    return [batches[0], {k: v[:7] for k, v in batches[1].items()}]


def _losses(path, key="train/loss"):
    return [(ln["step"], ln[key]) for ln in map(
        json.loads, open(path)) if key in ln]


def _search_cases():
    rng = np.random.default_rng(11)
    ints = rng.integers(-3, 4, (20, 8)).astype(np.float32)
    ints[10] = ints[9]                  # a tie across the shard boundary
    ints[12] = ints[3]
    q_int = np.concatenate([ints[[9, 3]], rng.integers(
        -3, 4, (3, 8)).astype(np.float32)])
    x = rng.standard_normal((37, 16)).astype(np.float32)
    q = rng.standard_normal((5, 16)).astype(np.float32)
    big = rng.standard_normal((400, 8)).astype(np.float32)
    qb = rng.standard_normal((3, 8)).astype(np.float32)
    return [(x, q, 7, "ip", None), (x, q, 7, "l2", None),
            (ints, q_int, 6, "ip", None), (ints, q_int, 6, "l2", None),
            (x[:9], q, 8, "ip", None),       # k > the 5 rows a shard holds
            (x[:16], q, 6, "l2", 7),         # ragged true_n: shard 1 empty
            (big, qb, 150, "ip", None)]      # k > 128


def _similar_table():
    words = ["苹果", "香蕉", "牛奶", "酸奶", "可乐", "汽水", "面包"]
    rng = np.random.default_rng(12)
    titles = ["".join(rng.choice(words, 3)) for _ in range(30)]
    titles += titles[:5]                     # duplicates: exact ties
    return {"spu_sn": [f"s{i}" for i in range(len(titles))],
            "spu_name": titles}


def _similar_weights():
    from multimodalsimilar_tpu_torch.data.tokenizer import TextTokenizer
    tok = TextTokenizer.from_corpus(_similar_table()["spu_name"])
    bert = dict(vocab_size=tok.vocab_size, **NO_DROPOUT)
    model = NlpTextClassifier(BertConfig.tiny(**bert), num_labels=3,
                              generator=torch.Generator().manual_seed(3))
    return bert, {k: v.numpy() for k, v in model.state_dict().items()}


MM_IMG, MM_FC = 32, 16


def _mm_similar_inputs(tmp):
    """``similar multimodal --checkpoint`` on two tables over one image
    root: "split", 24 rows whose rows 2, 9 (rank 0's block) and 15, 22
    (rank 1's) have no image; "one_block", 20 rows whose second half (rank
    1's block) has none. A tiny JAX multimodal model (BN statistics
    jiggled), its port checkpoint and vocab, and the JAX embedder of the
    same weights. Returns (the JAX embedder, {table: argv})."""
    base = ["红富士苹果 5斤装", "青苹果 新鲜", "纯牛奶 250ml", "酸奶 原味",
            "可乐 330ml 罐装", "雪碧 柠檬味", "香蕉 进口", "橙汁 100%"]
    d = os.path.join(tmp, "mm_similar")
    os.makedirs(os.path.join(d, "img"))
    keys = [f"spu{i}" for i in range(24)]
    titles = [base[i % len(base)] + str(i) for i in range(24)]
    for i, im in enumerate(images(24, seed=43, size=MM_IMG)):
        if i not in (2, 9, 15, 22):
            cv2.imwrite(os.path.join(d, "img", f"{keys[i]}.jpg"), im)
    tables = {"split": (keys, titles),
              "one_block": (keys[:10] + [f"gone{i}" for i in range(10)],
                            titles[:10] + titles[12:22])}
    for name, (ks, ts) in tables.items():
        with open(os.path.join(d, f"{name}.csv"), "w",
                  encoding="utf-8") as f:
            f.write("spu_sn,spu_name\n")
            f.writelines(f"{k},{t}\n" for k, t in zip(ks, ts))
    vocab = os.path.join(d, "vocab.txt")
    build_char_vocab(titles, out_path=vocab)
    jmodel = JMultimodalClassifier(JBertConfig.tiny(),
                                   JE.EfficientNetConfig.tiny(),
                                   num_labels=5, fc_dim=MM_FC,
                                   policy=JPolicy.full_precision())
    v = _jiggle(jax.jit(lambda x, i: jmodel.init(
        {"params": jax.random.key(11)}, x, i,
        label=jnp.zeros(1, jnp.int32)))(
            jnp.zeros((1, MM_IMG, MM_IMG, 3)),
            jnp.zeros((1, 12), jnp.int32)), 12)
    CheckpointManager(os.path.join(d, "ckpt")).save(0, {
        "model": multimodal_classifier_from_jax(
            v, BertConfig.tiny(), EfficientNetConfig.tiny())})
    jemb = JMultimodalEmbedder(jmodel, v, JTokenizer.from_vocab_file(vocab),
                               max_length=12, image_size=MM_IMG,
                               batch_size=4)
    return jemb, {name: [
        "similar", "multimodal", "--data", os.path.join(d, f"{name}.csv"),
        "--k", "4", "--checkpoint", os.path.join(d, "ckpt"),
        "--tokenizer", vocab, "--img_root", os.path.join(d, "img"),
        "--backbone", "tiny", "--image_size", str(MM_IMG), "--fc_dim",
        str(MM_FC), "--num_labels", "5", "--max_length", "12",
        "--batch_size", "4"] for name in tables}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns in the background, the JAX references meanwhile.
    Returns {"port": {key: [rank 0's result, ...]}, "jax": {case: ...}}
    with the fit cases keyed by name, the others by (function, world)."""
    tmp = str(tmp_path_factory.mktemp("parallel"))
    refs = {name: case[0]() for name, case in CASES.items()}
    jobs = {2: [(("mesh_layout", 2), "mesh_layout", ((2, 1),)),
                (("collectives", 2), "collectives", ((1, 2), 2))],
            4: [(("mesh_layout", 4), "mesh_layout", ((2, 2),)),
                (("collectives", 4), "collectives", ((1, 4), 4))]}
    for name, (_, shape, cfg, *opt) in CASES.items():
        _, _, spec, sd, batches = refs[name]
        out = os.path.join(tmp, name)
        os.makedirs(out)
        if name in ("mp_padded", "tp_2x2"):
            cfg = dict(cfg, checkpoint_dir=os.path.join(out, "ckpt"))
        jobs[shape[0] * shape[1]].append((name, "fit", (
            _kind(name), spec, {k: v.numpy() for k, v in sd.items()},
            batches, shape, cfg, LRS, out, _evals(cfg, batches),
            *opt)))
    dropout = _dropout_case(tmp, "tp_dropout_1x4")
    jobs[4].append(("tp_dropout_1x4", "fit", dropout))
    mixed = _mixed_case(tmp, "tp_sp_mixed_1x2")
    jobs[2].append(("tp_sp_mixed_1x2", "fit", mixed))
    jobs[4].append((("train_cli", 4), "train_cli", (
        _train_argv(tmp),)))
    jobs[4].append((("train_cli_tp", 4), "train_cli", (
        _train_argv(tmp, "cli_tp") + [
            "--model_parallel", "4", "--tensor_parallel",
            "--sequence_parallel", "--remat"],)))
    bert, weights = _similar_weights()
    jobs[2] += [(("search", 2), "search", (_search_cases(), 2)),
                (("similar", 2), "similar", (_similar_table(), weights,
                                             bert, 2, 5, 0.5))]
    jemb, mm_argv = _mm_similar_inputs(tmp)
    jobs[2] += [(("similar_mm", name), "similar_multimodal", (argv,))
                for name, argv in mm_argv.items()]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = {world: pool.submit(
            spawn, W.run, world, ([(fn, args) for _, fn, args in js],),
            timeout=TIMEOUT) for world, js in jobs.items()}
        jax_out = {name: _jax_run(name, refs[name], tmp) for name in CASES}
        port = {world: f.result() for world, f in futures.items()}
    results = {key: [ranks[i] for ranks in port[world]]
               for world, js in jobs.items()
               for i, (key, _, _) in enumerate(js)}
    # the port-only cases' reference: the port on one process
    for case, name in ((dropout, "tp_dropout_one"),
                       (mixed, "tp_sp_mixed_one")):
        one = case[:4] + ((1, 1), {}) + case[6:7] + (
            os.path.join(tmp, name),)
        os.makedirs(one[-1])
        results[name] = [W.fit(*one)]
    return {"port": results, "jax": jax_out, "tmp": tmp,
            "mm": (jemb, mm_argv)}


def _mixed_case(tmp, name):
    """Worker ``fit`` args of TP + SP at data 1 x model 2 over a tower
    whose 3 heads and 97-row vocabulary do not divide by 2 (attention
    and word table whole, the MLP cut), 9 tokens: the whole blocks'
    entries and exits into the sequence region."""
    bert = dict(BERT, vocab_size=97, hidden_size=48, num_heads=3,
                sequence_parallel=True)
    model = NlpTextClassifier(BertConfig.tiny(**bert), num_labels=12,
                              generator=torch.Generator().manual_seed(5))
    out = os.path.join(tmp, name)
    os.makedirs(out)
    return ("text", {"bert": bert, "num_labels": 12},
            {k: v.numpy() for k, v in model.state_dict().items()},
            _text_batches(3, [12], 17, s=9), (1, 2), SP, LRS, out)


def _dropout_case(tmp, name):
    """Worker ``fit`` args of TP + SP + remat at data 1 x model 4 with
    dropout 0.1: the port's ranks against the port on one process."""
    bert = dict(BERT, num_layers=2, hidden_dropout=0.1,
                attention_dropout=0.1, sequence_parallel=True, remat=True)
    model = NlpTextClassifier(BertConfig.tiny(**bert), num_labels=12,
                              generator=torch.Generator().manual_seed(4))
    out = os.path.join(tmp, name)
    os.makedirs(out)
    return ("text", {"bert": bert, "num_labels": 12},
            {k: v.numpy() for k, v in model.state_dict().items()},
            _text_batches(3, [12], 15, s=9), (1, 4), SP, LRS, out)


def _train_argv(tmp, out="cli"):
    """``train nlp --model_parallel 2`` over 37 classes of titles."""
    rng = np.random.default_rng(13)
    path = os.path.join(tmp, "train.csv")
    with open(path, "w", encoding="utf-8") as f:
        f.write("spu_name,labels\n")
        for i in range(64):
            f.write(f"{'甲乙丙丁戊'[i % 5] * 2}{rng.integers(0, 999)},"
                    f"{i % 37}\n")
    return ["train", "nlp", "--data", path, "--output",
            os.path.join(tmp, out), "--batch_size", "16", "--epochs", "1",
            "--max_length", "12", "--eval_every", "1000", "--save_every",
            "1000", "--log_every", "2", "--model_parallel", "2"]


def _kind(name):
    return ("cv" if name.startswith("cv") or "_cv_" in name else
            "multilabel" if "multilabel" in name else "text")


def _assert_grads(got, want, tol):
    """Every gradient within ``tol`` of its tensor's largest entry
    (floored at 1e-4 of the model's largest gradient); the ones that are
    zero in exact arithmetic below 1e-6 of it on both sides."""
    want = {n: np.asarray(want[n]) for n in got}
    top = max(float(np.abs(w).max()) for w in want.values())
    for n, w in want.items():
        g = np.asarray(got[n])
        if np.abs(w).max() <= 1e-6 * top:
            assert np.abs(g).max() <= 1e-5 * top, n
            continue
        scale = max(float(np.abs(w).max()), 1e-4 * top)
        assert np.abs(g - w).max() <= tol * scale, (n, np.abs(g - w).max(),
                                                   scale)


# bfloat16's unit roundoff (8 significant bits)
BF16_U = 2.0 ** -8
# the noise floor of a gradient that is zero in exact arithmetic, against
# the model's largest gradient (see _assert_bf16_grads)
ZERO_NOISE = 1e-4


def _assert_bf16_grads(got, want, local):
    """``--bf16_grads``: each package rounds every rank's f32 gradient to
    bfloat16 (within u = 2^-8 of it), sums them, rounds the sum and halves
    it, so each side lies within 2u L of the exact mean, L the tensor's
    largest entry on any rank before the mean (``local``), and the two
    sides within 4u L. L is the scale, not the mean's largest entry:
    ranks' gradients that nearly cancel leave a mean far smaller than
    what was rounded.

    A gradient that is zero in exact arithmetic (a bias that feeds a
    train-mode BatchNorm, as the cv neck's ``fc.bias``, which each rank
    normalizes with its own statistics here) is f32 cancellation noise on
    every rank, whose size follows the order of the sums: 1.2e-5 of the
    model's largest gradient on one machine, while the smallest gradient
    that is not zero in exact arithmetic is 6.3e-3 of it (1.3e-2 on a
    rank). Such a tensor is held below ``ZERO_NOISE`` of the largest on
    every rank and in JAX, not against JAX's noise."""
    want = {n: np.asarray(want[n]) for n in got}
    top = max(float(np.abs(w).max()) for w in want.values())
    for n, w in want.items():
        g = np.asarray(got[n])
        if local[n] <= ZERO_NOISE * top and \
                np.abs(w).max() <= ZERO_NOISE * top:
            assert np.abs(g).max() <= local[n] * (1 + 2 * BF16_U), n
            continue
        err = np.abs(g - w).max()
        assert err <= 4 * BF16_U * local[n], (n, err, local[n])


def _want_grads(name, ref):
    grads = ref["grads"]
    cfg = BertConfig.tiny(**BERT)
    if _kind(name) == "text":
        return text_classifier_from_jax(grads, cfg)
    if _kind(name) == "multilabel":
        return multilabel_classifier_from_jax(grads, cfg)
    return cv_classifier_from_jax(
        {"params": grads, "batch_stats": ref["variables"]["batch_stats"]},
        _cv_cfgs()[1])


# -- the mesh ----------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_mesh_coordinates_groups_and_collectives(runs, world):
    """Rank r sits at (r // model, r % model); the data group holds the
    ranks of its model coordinate, the model group those of its data
    coordinate; all-reduce, all-gather (equal and ragged rows) and the
    object broadcast over each; ``shard_batch`` cuts divisible leaves."""
    model = 1 if world == 2 else 2
    for r, got in enumerate(runs["port"][("mesh_layout", world)]):
        d, m = r // model, r % model
        assert got["coords"] == (d, m)
        data_ranks = [i * model + m for i in range(world // model)]
        model_ranks = [d * model + j for j in range(model)]
        assert got["sum_data"] == sum(data_ranks)
        assert got["max_data"] == max(data_ranks)
        assert got["gather_data"] == data_ranks
        assert got["sum_model"] == sum(model_ranks)
        assert got["gather_model"] == model_ranks
        assert got["rows_data"] == [float(i) for i in data_ranks
                                    for _ in range(i + 1)]
        assert got["object"] == {"from": 0}
        n_data = world // model
        rows = np.arange(24).reshape(8, 3)[
            d * 8 // n_data:(d + 1) * 8 // n_data]
        np.testing.assert_array_equal(got["batch"]["x"], rows)
        np.testing.assert_array_equal(got["batch"]["meta"], np.arange(3))


def test_shard_batch_and_mesh_rules_in_process():
    """A hand-built mesh needs no process group for the placement rules;
    ``strict`` refuses an indivisible leaf with the JAX bf16 message."""
    mesh = Mesh(2, 2, rank=3)
    assert (mesh.data_index, mesh.model_index) == (1, 1)
    rules = MeshRules(mesh)
    assert rules.batch(8) == slice(4, 8)
    assert rules.class_sharded(38) == slice(19, 38)
    assert rules.corpus_sharded(512) == slice(256, 512)
    with pytest.raises(ValueError, match="not divisible"):
        rules.class_sharded(37)
    got = shard_batch(mesh, {"x": np.arange(6), "y": np.arange(3)})
    np.testing.assert_array_equal(got["x"], [3, 4, 5])
    np.testing.assert_array_equal(got["y"], [0, 1, 2])   # left whole
    with pytest.raises(ValueError, match="not divisible by the data axis"):
        shard_batch(mesh, {"x": np.arange(3)}, strict=True)


def test_head_class_block_layout_in_process():
    """``ArcFaceHead.shard`` keeps the block at the rank's model
    coordinate; ``local_labels`` maps the whole head's labels to its
    columns (-1 on another block) and ``num_classes`` counts every
    block's classes."""
    head = ArcFaceHead(6, 4, generator=torch.Generator().manual_seed(0))
    whole = head.weight.detach().clone()
    labels = torch.tensor([0, 3, 5, -1])
    assert torch.equal(head.local_labels(labels), labels)
    assert (head.num_classes, head.column_offset, head.mesh) == (6, 0, None)
    mesh = Mesh(2, 2, rank=1)
    assert (mesh.data_index, mesh.model_index) == (0, 1)
    assert head.shard(mesh) == slice(3, 6)
    torch.testing.assert_close(head.weight.detach(), whole[3:],
                               rtol=0, atol=0)
    assert (head.num_classes, head.column_offset) == (6, 3)
    assert head.local_labels(labels).tolist() == [-1, 0, 2, -1]


def test_batch_norm_stats_mesh_field_in_process():
    """Every BatchNorm of the image classifier declares ``stats_mesh``
    (None: this rank's batch alone) and ``set_stats_mesh`` sets each."""
    model, _ = W.build("cv", {"num_labels": 7, "fc_dim": 12})
    bns = [m for m in model.modules()
           if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
    assert bns and all(m.stats_mesh is None for m in bns)
    mesh = Mesh(2, 1, rank=0)
    set_stats_mesh(model, mesh)
    assert all(m.stats_mesh is mesh for m in bns)


# -- training ----------------------------------------------------------------

@pytest.mark.parametrize("name", list(CASES))
def test_fit_losses_match_jax(runs, name):
    """Per-step losses of the port's fit over the mesh (rank 0's
    metrics.jsonl, meaned over the data group) against the JAX Trainer's
    on the same mesh shape."""
    ref = runs["jax"][name]
    got = _losses(os.path.join(runs["tmp"], name, "metrics.jsonl"))
    want = ref["losses"]
    assert [s for s, _ in got] == [s for s, _ in want]
    rtol = 2e-3 if "bf16" in name else 1e-4
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=rtol)


@pytest.mark.parametrize("name", ["dp_f32", "mp_padded"])
def test_eval_matches_jax(runs, name):
    """``evaluate`` over the mesh (each rank's block of a divisible batch,
    the 7-row batch whole on every rank at half its weight, sums over
    the data group; over class blocks, the sharded cross-entropy and the
    global argmax) against the JAX Trainer's eval on the same split."""
    ref = runs["jax"][name]
    path = os.path.join(runs["tmp"], name, "metrics.jsonl")
    for key, rtol in (("acc", 0), ("loss", 1e-4)):
        got, want = _losses(path, f"eval/{key}"), ref["evals"][key]
        assert [s for s, _ in got] == [s for s, _ in want] == [3]
        np.testing.assert_allclose([v for _, v in got],
                                   [v for _, v in want], rtol=rtol,
                                   atol=1e-7)


@pytest.mark.parametrize("name", list(CASES))
def test_first_gradients_match_jax(runs, name):
    """The first batch's gradients, meaned over the data group (bf16 under
    ``--bf16_grads``) and, for class-sharded heads and tensor-parallel
    blocks, gathered over the model group, against JAX's gradients of the
    global batch (on one device for ``GRADS_ON_ONE_DEVICE``)."""
    ref = runs["jax"][name]
    port = runs["port"][name][0]
    if "bf16" in name:
        _assert_bf16_grads(port["grads"], _want_grads(name, ref),
                           port["grads_local_max"])
    else:
        _assert_grads(port["grads"], _want_grads(name, ref), 1e-4)


@pytest.mark.parametrize("name", ["mp_padded", "mp_multilabel"])
def test_model_parallel_heads_are_class_blocks(runs, name):
    """Each rank holds rows [j C / 2, (j + 1) C / 2) of each head whose
    class count divides (the padded 38 = 37 + 1, the multilabel lv2 and
    tag heads), the same block on both data coordinates; the indivisible
    lv1 head (5 classes) stays whole; the gathered state is whole."""
    ranks = runs["port"][name]
    final = ranks[0]["state"]
    want = {"mp_padded": {"head.weight": 38},
            "mp_multilabel": {"lv2_head.weight": 8,
                              "tag_head.weight": 12}}[name]
    for got in ranks:
        assert set(got["heads"]) == set(want)
        d, m = got["coords"]
        for key, c in want.items():
            assert final[key].shape[0] == c
            np.testing.assert_array_equal(
                got["heads"][key], final[key][m * c // 2:(m + 1) * c // 2])
    if name == "mp_multilabel":
        assert final["lv1_head.weight"].shape[0] == 5


def test_train_nlp_command_pads_and_shards_the_head(runs):
    """``train nlp --model_parallel 2`` on 4 ranks (data 2 x model 2): 37
    classes padded to 38, a block of 19 rows a rank, the checkpoint in the
    one-card layout."""
    for got in runs["port"][("train_cli", 4)]:
        assert got["shards"] == ["head.weight"]
        assert got["block"] == (19, BERT_HIDDEN)
        assert got["saved"] == (38, BERT_HIDDEN)


def test_train_nlp_command_runs_tensor_and_sequence_parallel(runs):
    """``train nlp --model_parallel 4 --tensor_parallel
    --sequence_parallel --remat`` through the command line on 4 ranks
    (data 1 x model 4): 37 classes padded to 40, 10 rows a rank; the
    tower's heads, MLP and word table (the corpus's char vocabulary, 4
    divides it or it stays whole) cut; the checkpoint in the one-card
    layout."""
    for got in runs["port"][("train_cli_tp", 4)]:
        assert got["block"] == (10, BERT_HIDDEN)
        assert got["saved"] == (40, BERT_HIDDEN)
        layer = "tower.encoder.encoder.layer.0."
        assert {f"{layer}attention.self.query.weight",
                f"{layer}intermediate.dense.weight",
                f"{layer}output.dense.weight"} <= set(got["shards"])
        assert got["remat"] and got["sequence_partial"]


def test_batch_norm_statistics_match_jax(runs):
    """Default path: BatchNorm normalizes with the global batch's
    statistics (every BN module given the mesh); ``--bf16_grads``: with
    each shard's, the running statistics meaned over the data group. The
    running statistics after the fit equal JAX's (atol 1e-5)."""
    _, cfg = _cv_cfgs()
    for name in ("cv_f32", "cv_bf16"):
        ref = runs["jax"][name]
        rank0 = runs["port"][name][0]
        assert (rank0["bn_mesh"] > 0) == (name == "cv_f32")
        final = ref["final"]
        want = cv_classifier_from_jax({"params": final.params,
                                       "batch_stats": final.batch_stats},
                                      cfg)
        for key, v in rank0["state"].items():
            if key.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(v, want[key].numpy(), rtol=0,
                                           atol=1e-5, err_msg=key)


def test_model_parallel_checkpoint_restores_on_one_rank(runs):
    """A checkpoint written at model 2 is in the one-card layout: one
    process with the unsharded model restores it (optimizer moments of
    the whole head included) and its parameters equal the gathered
    final state."""
    ref = runs["jax"]["mp_padded"]
    state = CheckpointManager(os.path.join(
        runs["tmp"], "mp_padded", "ckpt")).restore()
    assert state["model"]["head.weight"].shape[0] == 38
    model, task = W.build("text", ref["spec"])
    trainer = Trainer(task, lambda m: dual_group_adamw(m, lambda s: LRS[0],
                                                       lambda s: LRS[1]),
                      TrainerConfig(), device="cpu")
    trainer.load_state(state)
    final = runs["port"]["mp_padded"][0]["state"]
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), final[k], err_msg=k)
    moments = trainer.optimizer.state[model.head.weight]
    assert moments["exp_avg"].shape == model.head.weight.shape
    assert trainer.step == 3
    metrics = trainer.eval_step({k: torch.from_numpy(v) for k, v in
                                 ref["batches"][0].items()})
    assert np.isfinite(float(metrics["loss"]))


def _j_trainer_error(cfg, shape=(1, 2), bert=None):
    """The JAX Trainer's ValueError for ``cfg`` on a mesh of ``shape``."""
    jmodel = JClassifier(JBertConfig.tiny(**(bert or BERT)), num_labels=4)
    with pytest.raises(ValueError) as want:
        JTrainer(JT.text_arcface_task(jmodel), optax.adamw(1e-3),
                 j_mesh(jax.devices()[:shape[0] * shape[1]], *shape),
                 JTrainerConfig(**cfg))
    return str(want.value)


def test_refusals_match_jax(capsys):
    """The JAX Trainer's refusals, word for word: ``--bf16_grads`` with
    class-sharded heads or with tensor parallelism, pipeline parallelism
    with tensor or sequence parallelism, tensor parallelism at model 1,
    sequence parallelism without tensor parallelism or at model 1, a
    model axis that divides no head, a model no tensor-parallel rule
    cuts, and a sequence-parallel Trainer over a model not built for it.
    A pipeline-parallel Trainer over a model that holds no stage raises
    JAX's message of a state without the stacked layers (held against
    JAX in tests/test_torch_pp.py). The fused loss and AdamP over class blocks (C3) and tensor
    parallelism with an indivisible block (a notice) now build."""
    model = NlpTextClassifier(BertConfig.tiny(**BERT), num_labels=37)
    opt = lambda m: dual_group_adamw(m, lambda s: 1e-3,  # noqa: E731
                                     lambda s: 1e-3)
    for cfg, shape in (
            (dict(bf16_grad_allreduce=True, model_parallel_heads=True),
             (1, 2)),
            (dict(bf16_grad_allreduce=True, tensor_parallel=True), (1, 2)),
            (dict(pipeline_parallel=True, tensor_parallel=True), (1, 2)),
            (dict(pipeline_parallel=True, sequence_parallel=True), (1, 2)),
            (dict(tensor_parallel=True), (2, 1)),
            (dict(sequence_parallel=True), (1, 2)),
            (dict(sequence_parallel=True, tensor_parallel=True), (2, 1))):
        with pytest.raises(ValueError) as got:
            Trainer(text_arcface_task(model), opt, TrainerConfig(**cfg),
                    device="cpu", mesh=Mesh(*shape))
        assert str(got.value) == _j_trainer_error(cfg, shape), cfg
    with pytest.raises(ValueError,
                       match="holds no stacked layer tree \\(pp_layers\\)"):
        Trainer(text_arcface_task(model), opt,
                TrainerConfig(pipeline_parallel=True), device="cpu",
                mesh=Mesh(1, 2))
    mesh = Mesh(1, 2)          # placement only: no collective runs
    with pytest.raises(ValueError, match="cannot shard any head"):
        Trainer(text_arcface_task(model), opt,
                TrainerConfig(model_parallel_heads=True), device="cpu",
                mesh=mesh)
    # a model with no BERT tower: JAX's _diagnose_tp message
    cv, cv_task = W.build("cv", {"num_labels": 8, "fc_dim": 12})
    with pytest.raises(ValueError) as got:
        Trainer(cv_task, opt, TrainerConfig(tensor_parallel=True),
                device="cpu", mesh=mesh)
    jtrainer = JTrainer(JT.cv_arcface_task(_NoDropCv(
        _cv_cfgs()[0], num_labels=8, fc_dim=12)), optax.adamw(1e-3),
        j_mesh(jax.devices()[:2], 1, 2), JTrainerConfig())
    with pytest.raises(ValueError) as want:
        jtrainer._diagnose_tp(_case_cv(3, 8)[1], 2)
    assert str(got.value) == str(want.value)
    # sequence parallelism over a model built without it: JAX raises at
    # its first step, the port when it cuts the model
    with pytest.raises(ValueError) as got:
        Trainer(text_arcface_task(NlpTextClassifier(
            BertConfig.tiny(**BERT), num_labels=4)), opt,
            TrainerConfig(tensor_parallel=True, sequence_parallel=True),
            device="cpu", mesh=mesh)
    ref = _case_text(4, None, 3)
    jtrainer = JTrainer(ref[0], optax.adamw(1e-3),
                        j_mesh(jax.devices()[:2], 1, 2),
                        JTrainerConfig(tensor_parallel=True,
                                       sequence_parallel=True))
    with pytest.raises(ValueError) as want:
        jtrainer.fit(W.Batches(ref[4][:1]), 1, B)
    assert str(got.value) == str(want.value)
    # these build: the fused loss and AdamP over class blocks, and a tower
    # whose heads (3) do not divide by 2 (attention stays whole, notice)
    for task, make in ((text_arcface_task(NlpTextClassifier(
            BertConfig.tiny(**BERT), num_labels=4), fused_loss=True), opt),
            (text_arcface_task(NlpTextClassifier(
                BertConfig.tiny(**BERT), num_labels=4)),
             lambda m: dual_group(m, AdamP, lambda s: 1e-3,
                                  lambda s: 1e-3))):
        trainer = Trainer(task, make, TrainerConfig(
            model_parallel_heads=True), device="cpu", mesh=Mesh(1, 2))
        assert list(trainer.shards) == ["head.weight"]
    capsys.readouterr()
    trainer = Trainer(text_arcface_task(NlpTextClassifier(
        BertConfig.tiny(**dict(BERT, num_heads=1, hidden_size=48)),
        num_labels=4)), opt, TrainerConfig(tensor_parallel=True),
        device="cpu", mesh=mesh)
    assert "replicating indivisible tower leaves " \
        "tower.encoder.attention" in capsys.readouterr().out
    assert not any("attention" in k for k in trainer.shards)


# -- tensor and sequence parallelism -----------------------------------------

@pytest.mark.parametrize("name", TP_CASES)
def test_tensor_parallel_blocks(runs, name):
    """Each rank holds its blocks of Megatron's layout (the JAX package's
    ``tp_partition_spec``) and of the head, with the dimension and whole
    size the checkpoints gather along; the row-parallel biases, the
    LayerNorms and the position table stay whole. Under sequence
    parallelism the LayerNorms and the row-parallel biases are the
    parameters whose gradients the Trainer sums over the model group."""
    _, (_, n), cfg, *_ = CASES[name]
    H, inter, t = BERT_HIDDEN, 128, "tower.encoder."
    layer = t + "encoder.layer.0."
    want = {t + "embeddings.word_embeddings.weight": ((VOCAB // n, H), 0,
                                                      VOCAB),
            layer + "attention.output.dense.weight": ((H, H // n), 1, H),
            layer + "intermediate.dense.weight": ((inter // n, H), 0,
                                                  inter),
            layer + "intermediate.dense.bias": ((inter // n,), 0, inter),
            layer + "output.dense.weight": ((H, inter // n), 1, inter),
            "head.weight": ((12 // n, H), 0, 12)}
    for proj in ("query", "key", "value"):
        want[f"{layer}attention.self.{proj}.weight"] = ((H // n, H), 0, H)
        want[f"{layer}attention.self.{proj}.bias"] = ((H // n,), 0, H)
    partial = set()
    if cfg.get("sequence_parallel"):
        partial = {f"{t}embeddings.LayerNorm.{w}" for w in ("weight",
                                                            "bias")}
        partial |= {f"{layer}{ln}.{w}" for ln in (
            "attention.output.LayerNorm", "output.LayerNorm")
            for w in ("weight", "bias")}
        partial |= {f"{layer}attention.output.dense.bias",
                    f"{layer}output.dense.bias"}
    for got in runs["port"][name]:
        assert got["cut"] == want
        assert set(got["sequence_partial"]) == partial


def test_tensor_parallel_checkpoint_reloads_and_exports(runs, monkeypatch,
                                                       tmp_path, capsys):
    """A checkpoint written at data 2 x model 2 with tensor parallelism is
    in the one-card layout: one process restores it into the whole model
    (the optimizer moments of the cut weights gathered too), evaluates,
    and ``export-checkpoint`` writes the reference layout of the gathered
    state."""
    from multimodalsimilar_tpu_torch.cli import ckpt as CK
    from multimodalsimilar_tpu_torch.models import reference_export as pre
    ref = runs["jax"]["tp_2x2"]
    path = os.path.join(runs["tmp"], "tp_2x2", "ckpt")
    state = CheckpointManager(path).restore()
    final = runs["port"]["tp_2x2"][0]["state"]
    for k, v in final.items():
        np.testing.assert_array_equal(state["model"][k].numpy(), v,
                                      err_msg=k)
    model, task = W.build("text", ref["spec"])
    trainer = Trainer(task, lambda m: dual_group_adamw(m, lambda s: LRS[0],
                                                       lambda s: LRS[1]),
                      TrainerConfig(), device="cpu")
    trainer.load_state(state)
    layer = model.tower.encoder.encoder.layer[0]
    for p in (layer.attention.self.query.weight,
              layer.output.dense.weight,
              model.tower.encoder.embeddings.word_embeddings.weight):
        assert trainer.optimizer.state[p]["exp_avg"].shape == p.shape
    metrics = trainer.eval_step({k: torch.from_numpy(v) for k, v in
                                 ref["batches"][0].items()})
    assert np.isfinite(float(metrics["loss"]))
    monkeypatch.setattr(CK, "_bert_config",
                        lambda preset, **kw: BertConfig.tiny(**BERT))
    out = str(tmp_path / "ref.pt")
    cli.main(["export-checkpoint", "--kind", "nlp", "--bert_preset", "tiny",
              "--checkpoint", path, "--out", out], device="cpu")
    capsys.readouterr()
    got = torch.load(out, weights_only=True)
    want = pre.nlp_classifier_to_reference(
        {k: torch.from_numpy(v) for k, v in final.items()},
        BertConfig.tiny(**BERT))
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_tensor_sequence_parallel_dropout_matches_one_process(runs):
    """With dropout on (0.1), TP + SP + remat over 4 ranks (data 1 x model
    4, 9 tokens: padded in the region) against the port on one process
    from the same weights: every rank draws the whole tensor's masks and
    keeps its block, so the masks are one process's and the per-step
    losses and first gradients agree as the f32 cases do."""
    got = _losses(os.path.join(runs["tmp"], "tp_dropout_1x4",
                               "metrics.jsonl"))
    want = _losses(os.path.join(runs["tmp"], "tp_dropout_one",
                                "metrics.jsonl"))
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2, 3]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=1e-5)
    _assert_grads(runs["port"]["tp_dropout_1x4"][0]["grads"],
                  runs["port"]["tp_dropout_one"][0]["grads"], 1e-4)


def test_sequence_parallel_with_whole_blocks_matches_one_process(runs):
    """TP + SP over 2 ranks where only the MLP divides (3 heads, a
    97-row vocabulary: whole on every rank, with the notice): the
    attention's and the word table's whole outputs enter the sequence
    region split, their inputs gathered, and the per-step losses and
    first gradients equal the port's on one process as the f32 cases do;
    only the MLP weights are cut."""
    got = _losses(os.path.join(runs["tmp"], "tp_sp_mixed_1x2",
                               "metrics.jsonl"))
    want = _losses(os.path.join(runs["tmp"], "tp_sp_mixed_one",
                                "metrics.jsonl"))
    assert [s for s, _ in got] == [s for s, _ in want] == [1, 2, 3]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               rtol=1e-5)
    rank0 = runs["port"]["tp_sp_mixed_1x2"][0]
    _assert_grads(rank0["grads"], runs["port"]["tp_sp_mixed_one"][0][
        "grads"], 1e-4)
    assert sorted(rank0["cut"]) == ["head.weight"] + [
        f"tower.encoder.encoder.layer.0.{n}" for n in (
            "intermediate.dense.bias", "intermediate.dense.weight",
            "output.dense.weight")]


@pytest.mark.parametrize("world", [2, 4])
def test_reduce_scatter_and_gather_along_a_dimension(runs, world):
    """``Mesh.reduce_scatter`` / ``all_gather_dim`` over the model group
    (data 1 x model N), and the sequence-parallel pair of autograd
    functions at a length that does not divide by N: the forward sums
    and concatenates in coordinate order, and the backward of gather
    after reduce-scatter gives every rank the sum of all ranks'
    gradients of the gathered whole."""
    n = world
    xs = [np.arange(2 * 2 * n * 3, dtype=np.float32).reshape(2, 2 * n, 3)
          + 100 * r for r in range(n)]
    S = 2 * n + 1
    c = -(-S // n)                           # block rows after padding
    ys = [np.pad(np.arange(2 * S * 3, dtype=np.float32).reshape(2, S, 3)
                 + 10 * r, ((0, 0), (0, c * n - S), (0, 0)))
          for r in range(n)]
    blocks = [sum(ys)[:, q * c:(q + 1) * c] for q in range(n)]
    back = np.concatenate([b * (q + 1) for q, b in enumerate(blocks)],
                          axis=1)[:, :S]
    grad = np.broadcast_to((n * (np.arange(S) // c + 1) * np.arange(S)
                            ).astype(np.float32)[None, :, None],
                           (2, S, 3))
    for r, got in enumerate(runs["port"][("collectives", world)]):
        assert got["coords"] == (0, r)
        np.testing.assert_array_equal(got["rs"],
                                      sum(xs)[:, 2 * r:2 * r + 2])
        np.testing.assert_array_equal(got["ag"], np.concatenate(xs, 2))
        np.testing.assert_array_equal(got["block"], blocks[r])
        np.testing.assert_array_equal(got["back"], back)
        np.testing.assert_array_equal(got["grad"], grad)


# -- retrieval ---------------------------------------------------------------

@pytest.mark.parametrize("case", range(len(_search_cases())))
def test_sharded_search_matches_one_shard_and_jax(runs, case):
    """``sharded_knn_search`` over 2 ranks: equal on both ranks, equal to
    the one-shard ``knn_search`` (FAISS order, ties to the lower index
    across the shard boundary) and to the JAX ``sharded_knn_search`` on a
    2-device mesh (indices equal, scores within f32 rounding; exact on
    the integer cases)."""
    corpus, queries, k, metric, true_n = _search_cases()[case]
    ranks = [r[case] for r in runs["port"][("search", 2)]]
    np.testing.assert_array_equal(ranks[0][0], ranks[1][0])
    np.testing.assert_array_equal(ranks[0][1], ranks[1][1])
    v, i = ranks[0]
    limit = len(corpus) if true_n is None else true_n
    wv, wi = knn_search(torch.from_numpy(corpus), torch.from_numpy(queries),
                        k, metric, true_n=limit)
    np.testing.assert_array_equal(i, wi.numpy())
    np.testing.assert_allclose(v, wv.numpy(), rtol=1e-6, atol=1e-6)
    mesh = j_mesh(jax.devices()[:2], 2, 1)
    padded, n = j_pad(corpus, 2, metric)
    jv, ji = j_sharded(mesh, jnp.asarray(padded), jnp.asarray(queries), k,
                       metric, true_n=n if true_n is None else true_n)
    np.testing.assert_array_equal(i, np.asarray(ji))
    np.testing.assert_allclose(v, np.asarray(jv), rtol=1e-5, atol=1e-5)


def test_sharded_similar_nlp_writes_the_one_rank_lists(runs):
    """``nlp_similar_job`` over 2 ranks (each embeds its own rows, the
    query set all-gathered, the corpus searched in blocks, rank 0 writes)
    writes exactly the one-rank job's KV items, and every rank returns the
    count."""
    got = runs["port"][("similar", 2)]
    bert, weights = _similar_weights()
    model = NlpTextClassifier(BertConfig.tiny(**bert), num_labels=3)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in weights.items()})
    from multimodalsimilar_tpu_torch.data.tokenizer import TextTokenizer
    from multimodalsimilar_tpu_torch.pipelines.embedders import TextEmbedder
    table = _similar_table()
    embedder = TextEmbedder(model, TextTokenizer.from_corpus(
        table["spu_name"]), max_length=12, batch_size=16, device="cpu")
    sink = InMemoryKVSink()
    n = nlp_similar_job(table, lambda t: embedder(list(t)), sink, k=5,
                        score_th=0.5, device="cpu")
    assert n > 0 and got[0]["n"] == got[1]["n"] == n
    assert got[0]["items"] == {k: v for k, (v, _) in sink.data.items()}


def _mm_one_process(runs, name, monkeypatch, capsys):
    """The KV items of JAX ``cmd_similar_multimodal`` (its embedder the
    JAX tower of the checkpoint's weights, one device) and of the port's
    command on one process, both towers in f32, on table ``name``; the
    port's printed result."""
    jemb, argv = runs["mm"]
    js, ps = JInMemoryKVSink(), InMemoryKVSink()
    monkeypatch.setattr(JPolicy, "inference",
                        classmethod(lambda cls: cls.full_precision()))
    monkeypatch.setattr(DTypePolicy, "inference",
                        classmethod(lambda cls: cls.full_precision()))
    monkeypatch.setattr(jsimilar, "_kv_sink", lambda a: js)
    monkeypatch.setattr(jsimilar, "_knn_backend_mesh",
                        lambda a: ("xla", None, None))
    monkeypatch.setattr(jembedders, "_multimodal_embedder",
                        lambda a, df: jemb)
    monkeypatch.setattr(CS, "_kv_sink", lambda a: ps)
    jcli.main(argv[name])
    want = capsys.readouterr().out
    cli.main(argv[name], device="cpu")
    assert capsys.readouterr().out == want
    return ({k: v for k, (v, _) in js.data.items()},
            {k: v for k, (v, _) in ps.data.items()}, json.loads(want))


@pytest.mark.parametrize("name", ["split", "one_block"])
def test_sharded_similar_multimodal_writes_the_one_process_lists(
        runs, name, monkeypatch, capsys):
    """``similar multimodal --checkpoint`` over 2 ranks (each embeds its
    own block of rows, the vectors and kept rows all-gathered in row
    order, the corpus searched in blocks, rank 0 writes) writes exactly
    the KV items of the port on one process and of JAX
    ``cmd_similar_multimodal``; a block with no readable image at all
    ("one_block": rank 1's) is no error."""
    jax_items, one, printed = _mm_one_process(runs, name, monkeypatch,
                                              capsys)
    got = runs["port"][("similar_mm", name)]
    assert printed["written"] == len(one) > 0
    assert one == jax_items
    assert got[0]["items"] == one
    assert got[1]["items"] == {}


@pytest.mark.parametrize("name", ["split", "one_block"])
def test_sharded_similar_multimodal_embeds_each_rank_block(runs, name):
    """Each rank embeds only its own block of the table (rows [0, 12) and
    [12, 24) of "split", [0, 10) and [10, 20) of "one_block"), and both
    search the kept rows in the table's order, the keys without an image
    skipped in both blocks."""
    _, argv = runs["mm"]
    keys = [line.split(",")[0] for line in open(
        argv[name][3], encoding="utf-8").read().splitlines()[1:]]
    got = runs["port"][("similar_mm", name)]
    half = len(keys) // 2
    assert got[0]["embedded"] == keys[:half]
    assert got[1]["embedded"] == keys[half:]
    missing = {"spu2", "spu9", "spu15", "spu22"}
    kept = [k for k in keys if k not in missing and not
            k.startswith("gone")]
    assert got[0]["kept"] == got[1]["kept"] == kept


def test_approx_recall_runs_the_exact_search(tmp_path, monkeypatch, capsys):
    """``similar nlp --approx_recall 0.95`` writes the lists the command
    writes without it, after one notice on stderr (the JAX package runs
    its approximate TPU search exactly off a TPU, without a mesh); a
    recall outside (0, 1] raises as JAX's ``knn_search`` does."""
    table = _similar_table()
    path = tmp_path / "t.csv"
    path.write_text("spu_sn,spu_name\n" + "".join(
        f"{k},{t}\n" for k, t in zip(table["spu_sn"], table["spu_name"])),
        encoding="utf-8")
    base = ["similar", "nlp", "--data", str(path), "--bert_preset", "tiny",
            "--max_length", "12", "--score_th", "0.5"]
    written = []
    for extra in ([], ["--approx_recall", "0.95"]):
        sink = InMemoryKVSink()
        monkeypatch.setattr(CS, "_kv_sink", lambda args, s=sink: s)
        cli.main(base + extra, device="cpu")
        written.append({k: v for k, (v, _) in sink.data.items()})
    assert written[0] and written[0] == written[1]
    err = capsys.readouterr().err
    assert err.count("--approx_recall 0.95") == 1 and "exact" in err
    with pytest.raises(ValueError, match="approx_recall"):
        cli.main(base + ["--approx_recall", "0"], device="cpu")
