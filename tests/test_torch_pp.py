"""Pipeline parallelism on the CPU: the port's GPipe schedule over gloo
ranks against the JAX package's ``parallel/pp.py`` on the same mesh shape
(tests/conftest.py's 8 virtual CPU devices).

The port's ranks are processes (``parallel/spawn.py``); what they run is
in ``tests/torch_parallel_workers.py``, which imports no JAX. Two spawns
serve every case, a world of 2 (data 1 x model 2) and one of 4 (data 2 x
model 2, or data 1 x model 4), started in the background while the JAX
references compute. Weights go JAX -> port through the ``*_from_jax``
converters from the JAX package's stacked ``pp_layers`` tree; models are
tiny (4 layers), in full precision, dropout off against JAX.

Tolerances: the schedule on toy layers equals the layers in turn within
1e-12 in f64, and in f32 within 32 units of roundoff of each quantity's
largest entry on one microbatch (the microbatches' products round
apart and their parameter gradients add in another order;
``test_gpipe_matches_sequential``);
the encoder matches JAX's ``PipelinedBertLayers`` within 1e-5; the
Trainer matches the JAX Trainer with ``pipeline_parallel`` within 1e-4
(losses, rtol, JAX's own in tests/test_pp.py; first gradients, of each
tensor's largest entry; final parameters, abs, where the first gradient
sets the sign of Adam's first step, ``_steered``). With dropout on, the
port's ranks are held against the port on one process (the packages draw
their masks from different generators): the same masks, so the same
losses within 1e-6 and gradients within 1e-5 (the microbatches sum in
another order).
"""

import concurrent.futures
import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parallel_workers as W
from multimodalsimilar_tpu.cli import train as JCT
from multimodalsimilar_tpu.cli.parser import build_parser as j_parser
from multimodalsimilar_tpu.models import efficientnet as JE
from multimodalsimilar_tpu.models import multimodal as JM
from multimodalsimilar_tpu.models.bert import BertConfig as JBertConfig
from multimodalsimilar_tpu.models.bert import BertEncoderModel as JEncoder
from multimodalsimilar_tpu.models.bert import stack_tree, unstack_tree
from multimodalsimilar_tpu.models.classifiers import (
    NlpMultilabelClassifier as JMultilabel)
from multimodalsimilar_tpu.models.classifiers import (
    NlpTextClassifier as JClassifier)
from multimodalsimilar_tpu.models.classifiers import (
    SiamesePairModel as JSiamese)
from multimodalsimilar_tpu.models.vision import (
    CvImageClassifier as JCvImageClassifier)
from multimodalsimilar_tpu.parallel import pp as jpp
from multimodalsimilar_tpu.parallel.mesh import create_mesh as j_mesh
from multimodalsimilar_tpu.parallel.mesh import shard_batch as j_shard
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
from multimodalsimilar_tpu_torch.cli.parser import build_parser
from multimodalsimilar_tpu_torch.models.bert import (BertConfig,
                                                     BertEncoderModel)
from multimodalsimilar_tpu_torch.models.classifiers import NlpTextClassifier
from multimodalsimilar_tpu_torch.models.convert import (
    multilabel_classifier_from_jax, multimodal_classifier_from_jax,
    siamese_pair_from_jax, text_classifier_from_jax, unstack_layer_params)
from multimodalsimilar_tpu_torch.parallel import pp
from multimodalsimilar_tpu_torch.parallel.mesh import Mesh
from multimodalsimilar_tpu_torch.parallel.spawn import spawn
from multimodalsimilar_tpu_torch.train.checkpoint import CheckpointManager
from multimodalsimilar_tpu_torch.train.optim import dual_group_adamw
from multimodalsimilar_tpu_torch.train.tasks import text_arcface_task
from multimodalsimilar_tpu_torch.train.trainer import (PP_NO_STAGES,
                                                       PP_NOT_APPLIED,
                                                       Trainer,
                                                       TrainerConfig)

torch.set_num_threads(1)

JFULL = JPolicy.full_precision()
NO_DROPOUT = dict(hidden_dropout=0.0, attention_dropout=0.0)
VOCAB, LAYERS = 96, 4
BERT = dict(vocab_size=VOCAB, num_layers=LAYERS, **NO_DROPOUT)
HIDDEN = 64
B, S = 8, 10
LRS = (1e-3, 1e-2)
TIMEOUT = 180
PP_ON = dict(pipeline_parallel=True, model_parallel_heads=True)


def _pp(m, **kw):
    """BertConfig fields of a pipeline-parallel tower of M microbatches."""
    return dict(BERT, pipeline_parallel=True, pp_microbatches=m, **kw)


def _text_batches(n, keys_classes, seed, rows=B):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rng.integers(5, VOCAB, (rows, S)).astype(np.int32)
        mask = (np.arange(S)[None] < rng.integers(3, S + 1, (rows, 1))
                ).astype(np.int32)
        b = {"input_ids": ids * mask, "attention_mask": mask,
             "token_type_ids": np.zeros_like(ids)}
        for key, c in keys_classes:
            b[key] = rng.integers(0, c, rows).astype(np.int32)
        out.append(b)
    return out


def _pair_batches(n, seed):
    out = []
    for i, (q, t) in enumerate(zip(_text_batches(n, [("labels", 2)], seed),
                                   _text_batches(n, (), seed + 100))):
        b = {f"query_{k}": v for k, v in q.items() if k != "labels"}
        b.update({f"title_{k}": v for k, v in t.items()})
        b["labels"] = q["labels"]
        out.append(b)
    return out


def _head(c, d, rng):
    bound = np.sqrt(6.0 / (c + d))
    return {"weight": rng.uniform(-bound, bound, (c, d)).astype(np.float32)}


_INIT = {}


def _init(key, make):
    if key not in _INIT:
        _INIT[key] = jax.device_get(make())
    return _INIT[key]


def _tower():
    """One JAX init of the tiny 4-layer tower (sequential layout)."""
    jmodel = JClassifier(JBertConfig.tiny(**BERT), num_labels=2)
    return _init("tower", lambda: jax.jit(lambda: jmodel.init(
        {"params": jax.random.key(0)}, jnp.zeros((2, S), jnp.int32),
        label=jnp.zeros(2, jnp.int32)))()["params"]["tower"])


class _NoDropCv(JCvImageClassifier):
    """The JAX image classifier with the neck's dropout off in train mode."""

    def predict_emb(self, images, train=False, deterministic=None):
        return super().predict_emb(images, train=train, deterministic=True)


def _cv_cfg():
    import dataclasses
    return (dataclasses.replace(JE.EfficientNetConfig.tiny(),
                                drop_path_rate=0.0),
            dataclasses.replace(W.E.EfficientNetConfig.tiny(),
                                drop_path_rate=0.0))


# -- the Trainer cases: (JAX task, stacked variables, port spec and state
# dict, batches) -------------------------------------------------------------

def _case_text(m, seed, fused_loss=False, **bert):
    jbert = _pp(m, **bert)
    jmodel = JClassifier(JBertConfig.tiny(**jbert), num_labels=12,
                         policy=JFULL)
    params = stack_tree({"tower": _tower(), "head": _head(
        12, HIDDEN, np.random.default_rng(seed))})
    sd = text_classifier_from_jax(params, BertConfig.tiny(**jbert))
    return (JT.text_arcface_task(jmodel, fused_loss=fused_loss),
            {"params": params},
            {"bert": jbert, "num_labels": 12, "fused_loss": fused_loss}, sd,
            _text_batches(3, [("labels", 12)], seed))


def _case_multilabel(seed):
    bert, labels = _pp(2), (5, 8, 12)
    jmodel = JMultilabel(JBertConfig.tiny(**bert), *labels, policy=JFULL)
    rng = np.random.default_rng(seed)
    params = stack_tree({"tower": _tower(), **{
        f"{lv}_head": _head(c, HIDDEN, rng)
        for lv, c in zip(("lv1", "lv2", "tag"), labels)}})
    sd = multilabel_classifier_from_jax(params, BertConfig.tiny(**bert))
    keys = list(zip(("lv1_label", "lv2_label", "tag_label"), labels))
    return (JT.multilabel_arcface_task(jmodel), {"params": params},
            {"bert": bert, "labels": labels}, sd,
            _text_batches(1, keys, seed))


def _case_pair(seed):
    bert = _pp(2)
    jmodel = JSiamese(JBertConfig.tiny(**bert), policy=JFULL)
    rng = np.random.default_rng(seed)
    params = stack_tree({"tower": _tower(), "classifier": {
        "kernel": (rng.standard_normal((3 * HIDDEN, 2)) * 0.05).astype(
            np.float32), "bias": np.zeros(2, np.float32)}})
    sd = siamese_pair_from_jax(params, BertConfig.tiny(**bert))
    return (JT.pair_task(jmodel), {"params": params}, {"bert": bert}, sd,
            _pair_batches(1, seed))


def _case_multimodal(seed):
    bert = _pp(2)
    jcfg, cfg = _cv_cfg()
    jmodel = JM.MultimodalClassifier(JBertConfig.tiny(**bert), jcfg,
                                     num_labels=12, fc_dim=12, policy=JFULL)
    batch = _text_batches(1, [("labels", 12)], seed)[0]
    batch["images"] = np.random.default_rng(seed).integers(
        0, 256, (B, 16, 16, 3)).astype(np.uint8)
    v = _init("multimodal", lambda: jax.jit(lambda x, i: jmodel.init(
        {"params": jax.random.key(1)}, x, i,
        label=jnp.zeros(B, jnp.int32)))(
            jnp.asarray(batch["images"], jnp.float32),
            jnp.asarray(batch["input_ids"])))
    v = {"params": v["params"], "batch_stats": v["batch_stats"]}
    sd = multimodal_classifier_from_jax(v, BertConfig.tiny(**bert), cfg)
    return (JT.multimodal_arcface_task(jmodel), v,
            {"bert": bert, "num_labels": 12, "fc_dim": 12}, sd, [batch])


# name: (case, mesh shape, port Trainer config, optimizer, the JAX run it
# is held against)
CASES = {
    "pp_1x2": (lambda: _case_text(2, 1), (1, 2), {}, "adamw", "pp_1x2"),
    "pp_1x2_remat": (lambda: _case_text(2, 1, remat=True), (1, 2), {},
                     "adamw", "pp_1x2"),
    # partial eval batches of 12 and 10 rows: 6 rows a data rank (two
    # microbatches), then 5 (the M = 1 route)
    "pp_2x2_remat": (lambda: _case_text(2, 2, remat=True), (2, 2),
                     {"eval_every": 3}, "adamw", "pp_2x2_remat"),
    "pp_2x2": (lambda: _case_text(2, 2), (2, 2), {"eval_every": 3},
               "adamw", "pp_2x2_remat"),
    "pp_adamp_1x2": (lambda: _case_text(2, 3), (1, 2), {}, "adamp",
                     "pp_adamp_1x2"),
    # the fused loss over the class blocks, after the broadcast
    "pp_fused_1x2": (lambda: _case_text(2, 7, fused_loss=True), (1, 2), {},
                     "adamw", "pp_fused_1x2"),
    "pp_multilabel_1x2": (lambda: _case_multilabel(4), (1, 2), {}, "adamw",
                          "pp_multilabel_1x2"),
    "pp_pair_1x2": (lambda: _case_pair(5), (1, 2), {}, "adamw",
                    "pp_pair_1x2"),
    "pp_multimodal_1x2": (lambda: _case_multimodal(6), (1, 2), {}, "adamw",
                          "pp_multimodal_1x2"),
}
KINDS = {"pp_multilabel_1x2": "multilabel", "pp_pair_1x2": "pair",
         "pp_multimodal_1x2": "multimodal"}


def _evals(cfg):
    if "eval_every" not in cfg:
        return None
    return [_text_batches(1, [("labels", 12)], 20, rows=12)[0],
            _text_batches(1, [("labels", 12)], 21, rows=10)[0]]


def _losses(path, key="train/loss"):
    return [ln[key] for ln in map(json.loads, open(path)) if key in ln]


def _jax_run(name, ref, tmp):
    """The JAX Trainer with ``pipeline_parallel`` on the case's mesh: the
    first batch's gradients (sequential layout), the per-step losses, the
    eval metrics and the final parameters."""
    _, shape, cfg, opt, _ = CASES[name]
    jtask, variables, spec, sd, batches = ref
    mesh = j_mesh(jax.devices()[:shape[0] * shape[1]], *shape)
    if opt == "adamp":
        tx = j_dual_group(j_adamp(lambda s: LRS[0]),
                          j_adamp(lambda s: LRS[1]))
    else:
        tx = j_adamw(lambda s: LRS[0], lambda s: LRS[1])
    path = os.path.join(tmp, f"{name}.jax.jsonl")
    trainer = JTrainer(jtask, tx, mesh, JTrainerConfig(
        log_every=1, metrics_path=path, **PP_ON, **cfg))
    state = trainer._place_state(JTrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats=variables.get("batch_stats", {}),
        opt_state=tx.init(variables["params"]),
        margin=jnp.asarray(0.4, jnp.float32)))
    grads = jax.device_get(jax.jit(jax.grad(lambda p, b: jtask.train_loss(
        p, state.batch_stats, b, jax.random.key(0), state.margin)[0]))(
            state.params, j_shard(mesh, batches[0])))
    evals = _evals(cfg)
    final = trainer.fit(W.Batches(batches), 1, B,
                        W.Batches(evals) if evals else None,
                        initial_state=state)
    return {"grads": unstack_tree(grads), "losses": _losses(path),
            "evals": {k: _losses(path, f"eval/{k}") for k in ("acc",
                                                              "loss")},
            "params": unstack_tree(jax.device_get(final.params)),
            "batch_stats": jax.device_get(final.batch_stats)}


def _to_port(name, tree, stats=None):
    """A JAX params tree of case ``name`` as the port's state dict."""
    spec = CASES[name][0]()[2] if name not in _REFS else _REFS[name][2]
    cfg = BertConfig.tiny(**spec["bert"])
    kind = KINDS.get(name, "text")
    if kind == "multilabel":
        return multilabel_classifier_from_jax(tree, cfg)
    if kind == "pair":
        return siamese_pair_from_jax(tree, cfg)
    if kind == "multimodal":
        return multimodal_classifier_from_jax(
            {"params": tree, "batch_stats": stats}, cfg, _cv_cfg()[1])
    return text_classifier_from_jax(tree, cfg)


_REFS = {}


# -- the spawns --------------------------------------------------------------

def _write_csv(path, header, rows):
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


def _cli_tables(tmp):
    """A title table (nlp, multilabel, multimodal), a pair table and the
    images of the multimodal rows."""
    import cv2
    rng = np.random.default_rng(13)
    text = os.path.join(tmp, "titles.csv")
    _write_csv(text, ["spu_name", "labels", "tag_new_id", "lv1_category_id",
                      "lv2_category_id", "goods_sku"],
               [(f"{'甲乙丙丁戊'[i % 5] * 2}{rng.integers(0, 999)}",
                 i % 6, i % 6, i % 2, i % 4, str(i)) for i in range(32)])
    pairs = os.path.join(tmp, "pairs.csv")
    _write_csv(pairs, ["title", "sku_sn_name", "tag_id", "lv2_category_id",
                       "lv1_category_id"],
               [(f"标题{i % 12}号", f"s{i // 2}", i % 5, i % 3, i % 2)
                for i in range(32)])
    img = os.path.join(tmp, "img")
    os.makedirs(img)
    for i in range(32):
        cv2.imwrite(os.path.join(img, f"{i}.jpg"), rng.integers(
            0, 256, (20, 20, 3)).astype(np.uint8))
    return text, pairs, img


def _cli(tmp, out, *extra, kind="nlp", data=None, m=2):
    return (["train", kind, "--data", data, "--output",
             os.path.join(tmp, out), "--batch_size", "8", "--epochs", "1",
             "--max_length", "12", "--eval_every", "1000", "--save_every",
             "1000", "--log_every", "1", "--model_parallel", "2",
             "--pipeline_parallel", str(m)] + list(extra))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns in the background, the JAX references meanwhile (the
    JAX multimodal model with its image classifier's neck dropout off)."""
    saved = JM.CvImageClassifier
    JM.CvImageClassifier = _NoDropCv
    try:
        return _runs(str(tmp_path_factory.mktemp("pp")))
    finally:
        JM.CvImageClassifier = saved


def _runs(tmp):
    refs = {name: case[0]() for name, case in CASES.items()}
    _REFS.update(refs)
    jobs = {2: [], 4: []}
    for shape, m in (((1, 2), 1), ((1, 2), 2), ((1, 2), 3), ((2, 2), 2),
                     ((1, 4), 2)):
        jobs[shape[0] * shape[1]].append(
            (("schedule", shape, m), "pp_schedule", (shape, m)))
    enc = _encoder_inputs()
    jobs[4].append((("encoder", (2, 2)), "pp_encoder",
                    ((2, 2), _pp(2), enc["sd"], enc["ids"], enc["mask"])))
    jobs[2].append((("encoder_dropout", (1, 2)), "pp_encoder",
                    ((1, 2), _pp(2, hidden_dropout=0.1,
                                 attention_dropout=0.1, remat=True),
                     enc["sd"], enc["ids"][:B], enc["mask"][:B], 7)))
    for name, (_, shape, cfg, opt, _) in CASES.items():
        _, _, spec, sd, batches = refs[name]
        out = os.path.join(tmp, name)
        os.makedirs(out)
        jobs[shape[0] * shape[1]].append((name, "fit", (
            KINDS.get(name, "text"), spec,
            {k: v.numpy() for k, v in sd.items()}, batches, shape,
            dict(PP_ON, **cfg), LRS, out, _evals(cfg), opt)))
    dropout = _dropout_case(tmp)
    jobs[2].append(("pp_dropout_1x2", "fit", dropout))
    text, pairs, img = _cli_tables(tmp)
    image = ["--img_root", img, "--backbone", "tiny", "--image_size", "16",
             "--fc_dim", "8", "--key_col", "goods_sku", "--label_col",
             "tag_new_id"]
    jobs[2] += [
        ("cli_nlp", "train_cli_pp", (_cli(tmp, "nlp", "--remat",
                                          data=text),)),
        ("cli_resume_1", "train_cli_pp", (_cli(tmp, "resume", "--remat",
                                               data=text, m=1),)),
        ("cli_resume_2", "train_cli_pp", (_cli(
            tmp, "resume", "--remat", "--resume", data=text, m=1),)),
        ("cli_multilabel", "train_cli_pp", (_cli(
            tmp, "ml", kind="multilabel", data=text),)),
        ("cli_pair", "train_cli_pp", (_cli(tmp, "pair", kind="pair",
                                           data=pairs),)),
        ("cli_multimodal", "train_cli_pp", (_cli(
            tmp, "mm", *image, kind="multimodal", data=text),)),
        ("cli_large_pp", "train_cli_pp", ([
            "train", "nlp", "--config", os.path.join(
                os.path.dirname(__file__), "..", "configs",
                "train_nlp_large_pp.yaml"),
            "--bert_preset", "tiny", "--data", text, "--label_col",
            "labels", "--output", os.path.join(tmp, "large_pp"),
            "--batch_size", "16", "--epochs", "1", "--log_every", "1"],))]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = {world: pool.submit(
            spawn, W.run, world, ([(fn, args) for _, fn, args in js],),
            timeout=TIMEOUT) for world, js in jobs.items()}
        jax_out = {name: _jax_run(name, refs[name], tmp)
                   for name in {c[4] for c in CASES.values()}}
        jax_out["encoder"] = _jax_encoder(enc)
        port = {world: f.result() for world, f in futures.items()}
    results = {key: [ranks[i] for ranks in port[world]]
               for world, js in jobs.items()
               for i, (key, _, _) in enumerate(js)}
    # the port-only references: the port on one process
    one = dropout[:4] + ((1, 1), {}) + dropout[6:7] + (
        os.path.join(tmp, "pp_dropout_one"),)
    os.makedirs(one[-1])
    spec = dict(one[1], bert=dict(one[1]["bert"], pipeline_parallel=False))
    results["pp_dropout_one"] = [W.fit(one[0], spec, *one[2:])]
    _, _, spec, sd, batches = refs["pp_2x2"]
    out = os.path.join(tmp, "pp_2x2_one")
    os.makedirs(out)
    results["pp_2x2_one"] = [W.fit(
        "text", dict(spec, bert=dict(spec["bert"], pipeline_parallel=False)),
        {k: v.numpy() for k, v in sd.items()}, batches, (1, 1),
        {"eval_every": 3}, LRS, out, _evals({"eval_every": 3}))]
    return {"port": results, "jax": jax_out, "tmp": tmp}


def _dropout_case(tmp):
    """Worker ``fit`` args of PP (M = 2) + remat at data 1 x model 2 with
    dropout 0.1: the port's ranks against the port on one process."""
    bert = _pp(2, hidden_dropout=0.1, attention_dropout=0.1, remat=True)
    model = NlpTextClassifier(BertConfig.tiny(**dict(
        bert, pipeline_parallel=False)), num_labels=12,
        generator=torch.Generator().manual_seed(4))
    out = os.path.join(tmp, "pp_dropout_1x2")
    os.makedirs(out)
    return ("text", {"bert": bert, "num_labels": 12},
            {k: v.numpy() for k, v in model.state_dict().items()},
            _text_batches(3, [("labels", 12)], 15), (1, 2), PP_ON, LRS, out)


def _encoder_inputs():
    rng = np.random.default_rng(3)
    ids = rng.integers(1, VOCAB, (2 * B, S)).astype(np.int32)
    mask = (rng.random((2 * B, S)) > 0.2).astype(np.int32)
    mask[:, 0] = 1
    tower = _tower()
    sd = text_classifier_from_jax({"tower": stack_tree(tower)},
                                  BertConfig.tiny(**BERT))
    return {"ids": ids, "mask": mask, "tower": tower,
            "sd": {k[len("tower.encoder."):]: v.numpy()
                   for k, v in sd.items()}}


def _jax_encoder(enc):
    """JAX's ``PipelinedBertLayers`` under ``pp.active`` on a data 2 x
    model 2 mesh, M = 2: outputs, and the gradients of mean(pooled ** 2)
    over data block 0's rows (sequential layout)."""
    model = JEncoder(JBertConfig.tiny(**_pp(2)), JFULL)
    params = stack_tree(enc["tower"]["encoder"])
    mesh = j_mesh(jax.devices()[:4], 2, 2)
    ids, mask = jnp.asarray(enc["ids"]), jnp.asarray(enc["mask"])

    def loss(p):
        out = model.apply({"params": p}, ids, mask)
        return (out["pooler_output"][:B] ** 2).mean()

    with jpp.active(mesh):
        out = jax.jit(model.apply)({"params": params}, ids, mask)
        grads = jax.jit(jax.grad(loss))(params)
    return {"hidden": np.asarray(out["last_hidden_state"]),
            "pooled": np.asarray(out["pooler_output"]),
            "grads": unstack_layer_params(jax.device_get(grads))}


# -- the schedule and the encoder --------------------------------------------

@pytest.mark.parametrize("shape,m", [((1, 2), 1), ((1, 2), 2), ((2, 2), 2),
                                     ((1, 4), 2)])
def test_gpipe_matches_sequential(runs, shape, m):
    """``gpipe`` over (data, model, M) equals the layers in turn on one
    process, forward and gradients (of the input, summed over the model
    group: stage 0's, the others' zero; and of each stage's layers); each
    rank holds layers [s L/P, (s + 1) L/P).

    In f64 every difference is below 1e-12 (3e-15 read): the schedule
    computes what the layers in turn compute. In f32 each microbatch's
    rows go through products of fewer rows, whose rounding may differ by
    entry, and the weight and bias gradients are sums of the
    microbatches' partials where the layers in turn sum all the rows in
    one product. That rounding runs through the 2L = 16 layer passes of
    the forward and the backward, each of which may round an entry once
    more or less in its product and once in its tanh or the tanh's slope:
    every quantity agrees within 2 * 2L = 32 units of roundoff (2^-24) of
    its largest entry on one microbatch's rows (``scales``), 6.5e-6 at
    this seed's weight partials of up to 3.4. Read over seeds 0-2 and the
    four layouts: at most 14.0 units (12.4 at seed 0: grad_w 2.15e-6)."""
    ranks = runs["port"][("schedule", shape, m)]
    n = 8 // shape[1]
    for r in ranks:
        s = r["rank"] % shape[1]
        assert r["layers"] == list(range(s * n, (s + 1) * n))
        assert r["applied"] == r["f64"]["applied"] == 1
        for key in ("out", "grad_x", "grad_w", "grad_b"):
            assert r["f64"][key] <= 1e-12, (shape, m, r)
            assert r[key] <= 32 * 2.0 ** -24 * r["scales"][key], \
                (shape, m, key, r)
        assert r["grad_x_off_stage0"] == r["f64"]["grad_x_off_stage0"] \
            == 0.0


def test_gpipe_indivisible_batch_runs_one_microbatch(runs):
    """A local batch of 8 rows in 3 microbatches runs the schedule with
    M = 1 (JAX's sequential fallback), exactly, without counting as the
    configured schedule."""
    for r in runs["port"][("schedule", (1, 2), 3)]:
        assert r["applied"] == r["f64"]["applied"] == 0
        assert max(r[k] for k in ("out", "grad_x", "grad_w", "grad_b")) \
            <= 1e-6


def test_encoder_matches_jax_pipelined_layers(runs):
    """The port's pipeline-parallel encoder (each rank its two layers) and
    JAX's ``PipelinedBertLayers`` under ``pp.active`` at data 2 x model 2,
    M = 2: hidden states and pooled outputs of every data block, with and
    without a graph, and the gradients of data block 0, within 1e-5."""
    want = runs["jax"]["encoder"]
    for r in runs["port"][("encoder", (2, 2))]:
        rows = slice(*r["rows"])
        assert r["layers"] == ([0, 1] if r["rank"] % 2 == 0 else [2, 3])
        for key, got in (("hidden", r["hidden"]),
                         ("hidden", r["hidden_no_grad"]),
                         ("pooled", r["pooled"])):
            np.testing.assert_allclose(got, want[key][rows], rtol=0,
                                       atol=1e-5)
    grads = runs["port"][("encoder", (2, 2))][0]["grads"]
    jgrads = text_classifier_from_jax(
        {"tower": {"encoder": want["grads"]}}, BertConfig.tiny(**BERT))
    jgrads = {k[len("tower.encoder."):]: v for k, v in jgrads.items()}
    assert set(grads) == set(jgrads)
    _assert_grads(grads, jgrads, 1e-5)


def test_encoder_dropout_matches_one_process(runs):
    """Dropout 0.1 and remat on the pipeline (M = 2 microbatches, each
    layer's masks drawn for the whole batch and cut to the microbatch's
    rows): the port's one process draws the same masks, so the outputs
    agree within 1e-6 and the gradients within 1e-5 of each tensor's
    largest entry (the microbatches' gradients add in another order)."""
    from multimodalsimilar_tpu_torch.models.bert import (
        set_dropout_generator)
    enc = _encoder_inputs()
    bert = _pp(2, hidden_dropout=0.1, attention_dropout=0.1, remat=True)
    model = BertEncoderModel(BertConfig.tiny(**bert), W.FULL)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in enc["sd"].items()})
    model.train()
    set_dropout_generator(model, torch.Generator().manual_seed(7))
    out = model(torch.from_numpy(enc["ids"][:B]),
                torch.from_numpy(enc["mask"][:B]))
    (out["pooler_output"] ** 2).mean().backward()
    ranks = runs["port"][("encoder_dropout", (1, 2))]
    for r in ranks:
        np.testing.assert_allclose(r["hidden"],
                                   out["last_hidden_state"].detach(),
                                   rtol=0, atol=1e-6)
    _assert_grads(ranks[0]["grads"], {n: p.grad for n, p in
                                      model.named_parameters()}, 1e-5)


# -- the Trainer -------------------------------------------------------------

def _assert_grads(got, want, tol):
    """Every gradient within ``tol`` of its tensor's largest entry
    (floored at 1e-4 of the model's largest gradient); the ones that are
    zero in exact arithmetic below 1e-6 of it on both sides (as
    tests/test_torch_parallel.py holds them)."""
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


def _steered(grads):
    """name -> the elements whose first gradient sets the sign of Adam's
    first step: at least 1e-3 of the tensor's largest entry, in a tensor
    whose gradient is not zero in exact arithmetic (the attention's key
    biases: softmax ignores a shift along the keys). Adam turns float
    noise in a near-zero gradient into an lr-sized step of either sign in
    either package, so the other elements' final values are not
    compared."""
    top = max(float(v.abs().max()) for v in grads.values())
    out = {}
    for k, v in grads.items():
        big = float(v.abs().max())
        if big > 1e-6 * top:
            out[k] = (v.abs() >= 1e-3 * big).numpy()
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_trainer_matches_jax_pipeline_parallel(runs, name):
    """The port's Trainer with ``pipeline_parallel`` against the JAX
    Trainer with ``pipeline_parallel`` on the same mesh and weights: the
    per-step losses (rtol 1e-4), the first batch's gradients (1e-4 of
    each tensor's largest entry) and the final parameters and running
    statistics (abs 1e-4; of the parameters, the elements that
    ``_steered`` keeps)."""
    jref = runs["jax"][CASES[name][4]]
    ranks = runs["port"][name]
    got = ranks[0]
    losses = _losses(os.path.join(runs["tmp"], name, "metrics.jsonl"))
    np.testing.assert_allclose(losses, jref["losses"], rtol=1e-4)
    grads = _to_port(name, jref["grads"], jref["batch_stats"])
    _assert_grads(got["grads"], grads, 1e-4)
    final = _to_port(name, jref["params"], jref["batch_stats"])
    assert set(final) <= set(got["state"])
    steered = _steered(grads)
    for k, v in final.items():
        if k in grads and k not in steered:
            continue
        keep = steered.get(k, ...)
        np.testing.assert_allclose(got["state"][k][keep], v.numpy()[keep],
                                   rtol=0, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("name", ["pp_1x2_remat", "pp_2x2"])
def test_placement_holds_only_the_stage(runs, name):
    """Each rank builds, holds and keeps optimizer moments of its stage's
    layers only (two of four, 16 parameters each); the embeddings are
    the pipeline-partial gradients; the class-sharded head is the only
    cut parameter."""
    n_model = CASES[name][1][1]
    for r in runs["port"][name]:
        s = r["coords"][1]
        layers = list(range(2 * s, 2 * s + 2))
        st = r["stage"]
        assert st["layers"] == layers and st["moment_layers"] == layers
        assert st["layer_params"] == 16 * len(layers)
        assert st["pipeline_partial"] == [
            f"tower.encoder.embeddings.{n}" for n in (
                "word_embeddings.weight", "position_embeddings.weight",
                "token_type_embeddings.weight", "LayerNorm.weight",
                "LayerNorm.bias")]
        assert list(r["cut"]) == ["head.weight"]
        assert r["cut"]["head.weight"][0] == (12 // n_model, HIDDEN)


def test_partial_eval_batches_match_one_process(runs):
    """In-loop eval over batches of 12 and 10 rows at data 2 x model 2
    (6 rows a rank in two microbatches, then 5 in one): the metrics of
    the port's one process, and of JAX's sequential fallback."""
    path = os.path.join(runs["tmp"], "{}", "metrics.jsonl")
    for name in ("pp_2x2", "pp_2x2_remat"):
        for key in ("acc", "loss"):
            got = _losses(path.format(name), f"eval/{key}")
            one = _losses(path.format("pp_2x2_one"), f"eval/{key}")
            assert len(got) == 1
            np.testing.assert_allclose(got, one, rtol=1e-6)
            np.testing.assert_allclose(
                got, runs["jax"]["pp_2x2_remat"]["evals"][key], rtol=1e-4)


def test_dropout_matches_one_process(runs):
    """Dropout 0.1 with remat: two pipeline ranks (M = 2) against the
    port on one process. The masks are one process's, so the losses agree
    within 1e-6 and the first gradients within 1e-5 of each tensor's
    largest entry."""
    got = runs["port"]["pp_dropout_1x2"][0]
    one = runs["port"]["pp_dropout_one"][0]
    path = os.path.join(runs["tmp"], "{}", "metrics.jsonl")
    np.testing.assert_allclose(_losses(path.format("pp_dropout_1x2")),
                               _losses(path.format("pp_dropout_one")),
                               rtol=1e-6)
    _assert_grads(got["grads"], one["grads"], 1e-5)


# -- the command line and checkpoints -----------------------------------------

def test_cli_recipes_train_pipeline_parallel(runs):
    """``train nlp|multilabel|pair|multimodal --pipeline_parallel 2
    --model_parallel 2`` on two ranks: each rank holds one stage (one of
    the tiny preset's two layers) and its moments, M = 2, and rank 0
    writes the one-card layout (every layer)."""
    for key, out in (("cli_nlp", "nlp"), ("cli_multilabel", "ml"),
                     ("cli_pair", "pair"), ("cli_multimodal", "mm")):
        ranks = runs["port"][key]
        for r in ranks:
            s = r["rank"]
            assert r["stage"]["layers"] == [s], key
            assert r["stage"]["moment_layers"] == [s], key
            assert r["microbatches"] == [2], key
            assert r["step"] == ranks[0]["step"] > 0, key
            assert {W._layer_index(n) for n in r["saved"]
                    if ".encoder.layer." in n} == {0, 1}, key
        losses = _losses(os.path.join(runs["tmp"], out, "metrics.jsonl"))
        assert np.isfinite(losses).all(), key
        assert len(losses) >= ranks[0]["step"], key


def test_cli_large_pp_config_runs_tiny(runs):
    """``train nlp --config configs/train_nlp_large_pp.yaml`` with the
    preset overridden to tiny: model 2, ``--pipeline_parallel 2``,
    ``--remat``, the buckets of 48/64/96 tokens, weighted sampling."""
    for r in runs["port"]["cli_large_pp"]:
        assert r["microbatches"] == [2] and r["remat"] == [True]
        assert r["stage"]["layers"] == [r["rank"]]
        assert r["step"] == 2


def test_resume_and_one_process_load(runs, tmp_path):
    """``train nlp`` over two pipeline ranks for an epoch, then
    ``--resume`` for another (each rank's stage cut from the one-card
    checkpoint, the optimizer renumbered), logs the losses of the same
    two runs on one process (dropout on: the same masks); the final
    checkpoint loads on one process, moments of every layer included,
    and exports as a one-card checkpoint does. The stages run one
    microbatch (``--pipeline_parallel 1``): the tower computes in
    bfloat16, and two microbatches round their weight gradients apart
    (2e-4 of the losses after a step), where one rounds as one
    process."""
    from multimodalsimilar_tpu_torch.models.reference_export import (
        nlp_classifier_to_reference)
    tmp = runs["tmp"]
    text = os.path.join(tmp, "titles.csv")
    argv = _cli(str(tmp_path), "one", "--remat", data=text)
    argv = argv[:argv.index("--model_parallel")]
    cli.main(argv, device="cpu")
    cli.main(argv + ["--resume"], device="cpu")
    got = _losses(os.path.join(tmp, "resume", "metrics.jsonl"))
    assert len(got) == 8
    np.testing.assert_allclose(
        got, _losses(str(tmp_path / "one" / "metrics.jsonl")), rtol=1e-5)
    a = CheckpointManager(os.path.join(tmp, "resume", "ckpt")).restore()
    assert a["step"] == 8 == runs["port"]["cli_resume_2"][0]["step"]
    model = NlpTextClassifier(BertConfig.tiny(remat=True), num_labels=6)
    trainer = Trainer(text_arcface_task(model),
                      lambda m: dual_group_adamw(m, lambda s: 0.0,
                                                 lambda s: 0.0),
                      TrainerConfig(), device="cpu")
    trainer.load_state(a)
    for k, v in model.state_dict().items():
        assert torch.equal(v, a["model"][k]), k
    for name, p in model.named_parameters():
        assert trainer.optimizer.state[p]["exp_avg"].shape == p.shape, name
    out = str(tmp_path / "ref.pt")
    cli.main(["export-checkpoint", "--kind", "nlp", "--checkpoint",
              os.path.join(tmp, "resume", "ckpt"), "--out", out,
              "--bert_preset", "tiny"], device="cpu")
    want = nlp_classifier_to_reference(a["model"], BertConfig.tiny())
    got = torch.load(out, weights_only=True)
    assert list(got) == list(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_import_checkpoint_pipeline_parallel(tmp_path, capsys):
    """``import-checkpoint --pipeline_parallel 2`` writes the one-card
    layout for a text kind and prints the JAX command's line; ``--kind
    cv`` is refused with the JAX command's text."""
    from multimodalsimilar_tpu_torch.models.reference_export import (
        nlp_classifier_to_reference)
    cfg = BertConfig.tiny()
    model = NlpTextClassifier(cfg, num_labels=3)
    torch.save(nlp_classifier_to_reference(model.state_dict(), cfg),
               tmp_path / "ref.pt")
    base = ["import-checkpoint", "--state_dict", str(tmp_path / "ref.pt"),
            "--bert_preset", "tiny", "--pipeline_parallel", "2"]
    cli.main(base + ["--kind", "nlp", "--out", str(tmp_path / "ckpt")],
             device="cpu")
    assert json.loads(capsys.readouterr().out.strip()) == {
        "imported": "nlp", "out": str(tmp_path / "ckpt")}
    saved = CheckpointManager(str(tmp_path / "ckpt")).restore()["model"]
    assert set(saved) == set(model.state_dict())
    with pytest.raises(SystemExit) as got:
        cli.main(base + ["--kind", "cv", "--out", str(tmp_path / "cv")],
                 device="cpu")
    assert str(got.value) == (
        "import-checkpoint: --pipeline_parallel shards the BERT layer "
        "stack; --kind cv has no text tower, so the flag would have no "
        "effect. Drop it (train cv refuses it too).")


@pytest.mark.parametrize("stages,index", [(2, 0), (2, 1), (4, 2)])
def test_stage_init_draws_one_process_weights(stages, index):
    """A stage built from a seed holds the weights one process draws for
    its layers, and every other parameter (embeddings, pooler, the head
    drawn after the tower) equal too: the init draws and drops the other
    stages' layers."""
    cfg = BertConfig.tiny(**_pp(2))
    one = NlpTextClassifier(cfg, num_labels=5,
                            generator=torch.Generator().manual_seed(3))
    with pp.building(Mesh(1, stages, rank=index)):
        stage = NlpTextClassifier(cfg, num_labels=5,
                                  generator=torch.Generator().manual_seed(3))
    n = LAYERS // stages
    assert [i for i, _ in stage.tower.encoder.layers()] == list(
        range(index * n, index * n + n))
    want = one.state_dict()
    got = stage.state_dict()
    assert set(got) < set(want)
    for k, v in got.items():
        assert torch.equal(v, want[k]), k


def test_convert_reads_a_stacked_tree():
    """``text_classifier_from_jax`` of a JAX ``stack_tree`` tree equals
    the sequential tree's; ``unstack_layer_params`` inverts JAX's
    ``stack_tree`` leaf for leaf."""
    tower = _tower()
    cfg = BertConfig.tiny(**BERT)
    flat = text_classifier_from_jax({"tower": tower}, cfg)
    stacked = text_classifier_from_jax({"tower": stack_tree(tower)}, cfg)
    assert list(flat) == list(stacked)
    for k, v in flat.items():
        assert torch.equal(v, stacked[k]), k
    back = unstack_layer_params(stack_tree(tower)["encoder"])
    want = unstack_tree(stack_tree(tower))["encoder"]
    assert sorted(back) == sorted(want)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- refusals ----------------------------------------------------------------

def _j_error(cfg, shape, bert=None):
    jmodel = JClassifier(JBertConfig.tiny(**(bert or BERT)), num_labels=4)
    with pytest.raises(ValueError) as want:
        JTrainer(JT.text_arcface_task(jmodel), optax.adamw(1e-3),
                 j_mesh(jax.devices()[:shape[0] * shape[1]], *shape),
                 JTrainerConfig(**cfg))
    return str(want.value)


def _opt(m):
    return dual_group_adamw(m, lambda s: 1e-3, lambda s: 1e-3)


def test_refusals_match_jax():
    """The JAX Trainer's and the JAX pipeline's refusals, word for word:
    a model axis of 1; pipeline with tensor or sequence parallelism; the
    bf16 all-reduce with pipeline parallelism; a Trainer with the flag
    over a model that holds no stage (JAX: no ``pp_layers`` tree);
    ``remat_skip`` with the stacked layers; layers that do not divide
    into the stages; a batch that does not divide into microbatches and
    a microbatch count below 1."""
    model = NlpTextClassifier(BertConfig.tiny(**BERT), num_labels=4)
    for cfg, shape in ((dict(pipeline_parallel=True), (2, 1)),
                       (dict(pipeline_parallel=True, tensor_parallel=True),
                        (1, 2)),
                       (dict(pipeline_parallel=True,
                             sequence_parallel=True), (1, 2)),
                       (dict(pipeline_parallel=True,
                             bf16_grad_allreduce=True), (1, 2))):
        with pytest.raises(ValueError) as got:
            Trainer(text_arcface_task(model), _opt, TrainerConfig(**cfg),
                    device="cpu", mesh=Mesh(*shape))
        assert str(got.value) == _j_error(cfg, shape), cfg
    with pytest.raises(ValueError) as got:
        Trainer(text_arcface_task(model), _opt,
                TrainerConfig(pipeline_parallel=True), device="cpu",
                mesh=Mesh(1, 2))
    assert str(got.value) == PP_NO_STAGES
    jtr = JTrainer(JT.text_arcface_task(JClassifier(
        JBertConfig.tiny(**BERT), num_labels=4)), optax.adamw(1e-3),
        j_mesh(jax.devices()[:2], 1, 2),
        JTrainerConfig(pipeline_parallel=True))
    batch = _text_batches(1, [("labels", 4)], 0)[0]
    with pytest.raises(ValueError) as want:
        jtr.init_state_from_device_batch(j_shard(jtr.mesh, batch))
    assert PP_NO_STAGES == str(want.value)
    with pytest.raises(ValueError) as got:
        BertEncoderModel(BertConfig.tiny(**_pp(2, remat=True,
                                                remat_skip=2)))
    jenc = JEncoder(JBertConfig.tiny(**_pp(2, remat=True, remat_skip=2)),
                    JFULL)
    with pytest.raises(ValueError) as want:
        jenc.init(jax.random.key(0), jnp.zeros((2, S), jnp.int32))
    assert str(got.value) == str(want.value)
    toy = {"w": jnp.zeros((6, 4, 4))}
    with jpp.active(j_mesh(jax.devices()[:4], 1, 4)), \
            pytest.raises(ValueError) as want:
        jpp.gpipe(lambda p, h, c, k: h, toy, jnp.zeros((8, 4)),
                  jnp.zeros((8, 4)), jax.random.key(0), 2)
    with pytest.raises(ValueError) as got:
        pp.stage_of(6, Mesh(1, 4))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jpp._microbatch(jnp.zeros((5, 2)), 2)
    with pytest.raises(ValueError) as got:
        pp.microbatch(torch.zeros(5, 2), 2)
    assert str(got.value) == str(want.value)
    with jpp.active(j_mesh(jax.devices()[:2], 1, 2)), \
            pytest.raises(ValueError) as want:
        jpp.gpipe(lambda p, h, c, k: h, {"w": jnp.zeros((2, 4))},
                  jnp.zeros((8, 4)), jnp.zeros((8, 4)),
                  jax.random.key(0), 0)
    with pytest.raises(ValueError) as got:
        pp.gpipe(lambda h, c, r: h, torch.zeros(8, 4), torch.zeros(8, 4),
                 Mesh(1, 2), 0)
    assert str(got.value) == str(want.value)


def test_half_configured_step_refuses_as_jax(tmp_path):
    """A first training step whose batch does not split into the
    configured microbatches (8 rows, M = 3) rode the M = 1 route: both
    Trainers refuse with JAX's message and its hint."""
    bert = _pp(3)
    batch = _text_batches(1, [("labels", 4)], 0)
    mesh = Mesh(1, 2)          # stage 0 of 2; no collective runs
    with pp.building(mesh):
        model = NlpTextClassifier(BertConfig.tiny(**bert), num_labels=4)
    trainer = Trainer(text_arcface_task(model), _opt,
                      TrainerConfig(pipeline_parallel=True), device="cpu",
                      mesh=mesh)
    with pytest.raises(ValueError) as got:
        trainer.train_step({k: torch.from_numpy(v)
                            for k, v in batch[0].items()})
    jmodel = JClassifier(JBertConfig.tiny(**bert), num_labels=4)
    jtr = JTrainer(JT.text_arcface_task(jmodel), optax.adamw(1e-3),
                   j_mesh(jax.devices()[:2], 1, 2),
                   JTrainerConfig(pipeline_parallel=True))
    with pytest.raises(ValueError) as want:
        jtr.fit(W.Batches(batch), 1, B)
    assert str(got.value) == str(want.value) == PP_NOT_APPLIED


def test_train_cv_refuses_pipeline_parallel_as_jax(tmp_path):
    """``train cv --pipeline_parallel 2``: the JAX command's message."""
    from multimodalsimilar_tpu_torch.cli.train import cmd_train_cv
    argv = ["train", "cv", "--data", "x.csv", "--img_root", "x",
            "--output", str(tmp_path), "--pipeline_parallel", "2"]
    with pytest.raises(SystemExit) as want:
        JCT.cmd_train_cv(j_parser().parse_args(argv))
    with pytest.raises(SystemExit) as got:
        cmd_train_cv(build_parser().parse_args(argv), device="cpu")
    assert str(got.value) == str(want.value)
