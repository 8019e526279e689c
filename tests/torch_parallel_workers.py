"""What each rank runs in tests/test_torch_parallel.py,
tests/test_torch_pp.py and tests/test_torch_sharded_serving.py.

The ranks start under ``spawn`` (``multimodalsimilar_tpu_torch.parallel.
spawn``) and import this module afresh, so it imports torch and the port
only: no JAX (whose import costs seconds and would miss
tests/conftest.py's platform setup). Every function runs on every rank
of a gloo process group on the CPU and returns plain numpy and Python
values.
"""

import contextlib
import dataclasses
import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import torch

from multimodalsimilar_tpu_torch.models import efficientnet as E
from multimodalsimilar_tpu_torch.models.bert import BertConfig
from multimodalsimilar_tpu_torch.models.classifiers import (
    NlpMultilabelClassifier, NlpTextClassifier, SiamesePairModel)
from multimodalsimilar_tpu_torch.models.vision import CvImageClassifier
from multimodalsimilar_tpu_torch.parallel import pp
from multimodalsimilar_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS,
                                                       MeshRules,
                                                       create_mesh,
                                                       shard_batch)
from multimodalsimilar_tpu_torch.pipelines.similar import nlp_similar_job
from multimodalsimilar_tpu_torch.pipelines.sinks import InMemoryKVSink
from multimodalsimilar_tpu_torch.retrieval.knn import (pad_corpus,
                                                       sharded_knn_search)
from multimodalsimilar_tpu_torch.train.checkpoint import (
    gather_shard, gather_stage_tensors)
from multimodalsimilar_tpu_torch.train.optim import (AdamP, adamp_views,
                                                     dual_group,
                                                     dual_group_adamw)
from multimodalsimilar_tpu_torch.train.tasks import (cv_arcface_task,
                                                     multilabel_arcface_task,
                                                     multimodal_arcface_task,
                                                     pair_task,
                                                     text_arcface_task)
from multimodalsimilar_tpu_torch.train.trainer import Trainer, TrainerConfig
from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy

FULL = DTypePolicy.full_precision()


class Batches:
    """A source that yields the same global batches on every rank (the
    Trainer cuts each rank's block)."""

    def __init__(self, batches):
        self.items = batches

    def __len__(self):
        return sum(len(next(iter(b.values()))) for b in self.items)

    def batches(self, batch_size, shuffle=True, seed=0, epoch=0,
                sampler=None, drop_remainder=True):
        yield from self.items


def build(kind, spec):
    """(model, task) of a tiny model in full precision (dropout as
    ``spec["bert"]`` sets it, off in the image model)."""
    if kind == "text":
        model = NlpTextClassifier(BertConfig.tiny(**spec["bert"]),
                                  policy=FULL,
                                  num_labels=spec["num_labels"])
        return model, text_arcface_task(
            model, num_valid=spec.get("num_valid"),
            fused_loss=spec.get("fused_loss", False))
    if kind == "multilabel":
        model = NlpMultilabelClassifier(BertConfig.tiny(**spec["bert"]),
                                        *spec["labels"], policy=FULL)
        return model, multilabel_arcface_task(
            model, num_valid=spec.get("num_valid", (None,) * 3))
    if kind == "pair":
        model = SiamesePairModel(BertConfig.tiny(**spec["bert"]),
                                 policy=FULL)
        return model, pair_task(model)
    cfg = dataclasses.replace(E.EfficientNetConfig.tiny(),
                              drop_path_rate=0.0)
    if kind == "multimodal":
        from multimodalsimilar_tpu_torch.models.multimodal import (
            MultimodalClassifier)
        model = MultimodalClassifier(BertConfig.tiny(**spec["bert"]), cfg,
                                     num_labels=spec["num_labels"],
                                     fc_dim=spec["fc_dim"], policy=FULL)
        model.cv.dropout.p = 0.0
        return model, multimodal_arcface_task(model, spec.get("num_valid"))
    model = CvImageClassifier(cfg, num_labels=spec["num_labels"],
                              fc_dim=spec["fc_dim"], policy=FULL)
    model.dropout.p = 0.0
    return model, cv_arcface_task(model, spec.get("num_valid"))


def _numpy(state):
    return {k: v.detach().cpu().numpy() for k, v in state.items()}


def _optimizer(name, lrs):
    if name == "adamw":
        return lambda m: dual_group_adamw(m, lambda s: lrs[0],
                                          lambda s: lrs[1])
    return lambda m: dual_group(m, AdamP, lambda s: lrs[0],
                                lambda s: lrs[1], views=adamp_views(m))


def fit(kind, spec, state_dict, batches, mesh_shape, config, lrs,
        out_dir, evals=None, optimizer="adamw"):
    """Gradients of the first batch, then ``Trainer.fit`` over the batches
    for one epoch (and ``evals`` as the eval split), on a ``mesh_shape`` =
    (data, model) mesh, with AdamW or AdamP (``optimizer``). Rank 0
    returns the gradients and the final model state (one-card layout);
    every rank its coordinates, its own head blocks and the shapes of
    its cut parameters."""
    mesh = create_mesh(*mesh_shape)
    staged = config.get("pipeline_parallel", False)
    with pp.building(mesh) if staged else contextlib.nullcontext():
        model, task = build(kind, spec)
    own = model.state_dict()
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in state_dict.items()
                           if not staged or k in own})
    trainer = Trainer(
        task, _optimizer(optimizer, lrs),
        TrainerConfig(log_every=1, metrics_path=os.path.join(
            out_dir, "metrics.jsonl"), **config), device="cpu", mesh=mesh)
    # the gradients of the first batch's loss, reduced as a step reduces
    # (the BatchNorm statistics this forward moves are put back after)
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    model.train()
    loss, _ = task.train_loss(shard_batch(mesh, _tensors(batches[0])),
                              trainer.margin)
    loss.backward()
    # each tensor's largest entry on any rank before the data-group mean:
    # the scale of what --bf16_grads rounds
    names = [n for n, p in model.named_parameters() if p.grad is not None]
    local_max = mesh.all_reduce(torch.stack([
        dict(model.named_parameters())[n].grad.abs().max() for n in names]),
        DATA_AXIS, "max")
    trainer._reduce_gradients()
    grads = {}
    for name, p in model.named_parameters():
        g = p.grad
        if name in trainer.shards:
            g = gather_shard(g, trainer.shards[name], mesh)
        grads[name] = g
    if trainer.stages:
        grads = gather_stage_tensors(grads, trainer.stages, mesh)
    grads = {k: v.numpy() for k, v in grads.items()}
    trainer.optimizer.zero_grad(set_to_none=True)
    model.load_state_dict(saved)
    state = trainer.fit(Batches([_numpy_batch(b) for b in batches]), 1,
                        len(next(iter(batches[0].values()))),
                        Batches(evals) if evals else None)
    heads = {name: s.param.detach().numpy() for name, s in
             trainer.shards.items() if "head" in name}
    out = {"rank": mesh.rank, "coords": (mesh.data_index, mesh.model_index),
           "heads": heads,
           "cut": {name: (tuple(sh.param.shape), sh.dim, sh.size)
                   for name, sh in trainer.shards.items()},
           "sequence_partial": list(trainer.sequence_partial),
           "bn_mesh": sum(getattr(m, "stats_mesh", None) is not None
                          for m in trainer._batch_norms()),
           "stage": _stage_layout(trainer)}
    if mesh.rank == 0:
        out.update(grads=grads, state=_numpy(state["model"]),
                   grads_local_max=dict(zip(names, local_max.tolist())))
    return out


def _layer_index(name):
    """The global layer index of an encoder layer's parameter name."""
    return int(name.split(".encoder.layer.")[1].split(".")[0])


def _stage_layout(trainer):
    """The layers this rank holds, those its optimizer holds moments of,
    and its embeddings' names (the pipeline-partial gradients)."""
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    layers = [n for n in names.values() if ".encoder.layer." in n]
    moments = [names[id(p)] for p, st in trainer.optimizer.state.items()
               if "exp_avg" in st]
    return {"layers": sorted({_layer_index(n) for n in layers}),
            "layer_params": len(layers),
            "moment_layers": sorted({_layer_index(n) for n in moments
                                     if ".encoder.layer." in n}),
            "moments": len(moments),
            "pipeline_partial": list(trainer.pipeline_partial)}


def _tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _numpy_batch(batch):
    return {k: np.asarray(v) for k, v in batch.items()}


def mesh_layout(mesh_shape):
    """Coordinates and the collectives over both axes."""
    mesh = create_mesh(*mesh_shape)
    r = float(mesh.rank)
    out = {"rank": mesh.rank, "coords": (mesh.data_index, mesh.model_index)}
    for axis in (DATA_AXIS, MODEL_AXIS):
        out[f"sum_{axis}"] = float(mesh.all_reduce(torch.tensor([r]),
                                                   axis)[0])
        out[f"max_{axis}"] = float(mesh.all_reduce(torch.tensor([r]), axis,
                                                   "max")[0])
        out[f"gather_{axis}"] = mesh.all_gather(
            torch.tensor([mesh.rank]), axis)[:, 0].tolist()
        rows = torch.full((mesh.rank + 1, 2), r)
        out[f"rows_{axis}"] = mesh.all_gather_rows(rows, axis)[:, 0].tolist()
    out["object"] = mesh.broadcast_object({"from": mesh.rank})
    batch = {"x": np.arange(8 * 3).reshape(8, 3), "meta": np.arange(3),
             "s": np.float32(1.0)}
    out["batch"] = {k: np.asarray(v) for k, v in
                    shard_batch(mesh, batch).items()}
    return out


def search(cases, n_data):
    """``sharded_knn_search`` of every case over an ``n_data``-rank data
    axis, each rank holding its block of the padded corpus."""
    mesh = create_mesh(n_data)
    out = []
    for corpus, queries, k, metric, true_n in cases:
        padded, n = pad_corpus(corpus, n_data, metric)
        block = padded[MeshRules(mesh).corpus_sharded(len(padded))]
        v, i = sharded_knn_search(
            mesh, torch.from_numpy(np.ascontiguousarray(block)),
            torch.from_numpy(queries), k, metric,
            true_n=n if true_n is None else true_n)
        out.append((v.numpy(), i.numpy()))
    return out


def similar(table, state_dict, bert, n_data, k, score_th):
    """The sharded ``nlp_similar_job`` with a tiny tower; rank 0 returns
    what it wrote."""
    from multimodalsimilar_tpu_torch.data.tokenizer import TextTokenizer
    from multimodalsimilar_tpu_torch.pipelines.embedders import TextEmbedder
    mesh = create_mesh(n_data)
    model = NlpTextClassifier(BertConfig.tiny(**bert), num_labels=3)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in state_dict.items()})
    tok = TextTokenizer.from_corpus(table["spu_name"])
    embedder = TextEmbedder(model, tok, max_length=12, batch_size=16,
                            device="cpu")
    sink = InMemoryKVSink()
    n = nlp_similar_job(table, lambda t: embedder(list(t)), sink, k=k,
                        score_th=score_th, device="cpu", mesh=mesh)
    items = {key: v for key, (v, _) in sink.data.items()}
    return {"n": n, "items": items if mesh.rank == 0 else None}


def train_cli(argv):
    """``train nlp`` through the command line on this rank; returns its
    head block's shape, the checkpoint's whole head, the names of the cut
    parameters and the layouts it runs."""
    from multimodalsimilar_tpu_torch import cli
    from multimodalsimilar_tpu_torch.train.checkpoint import (
        CheckpointManager)
    trainer = cli.main(argv, device="cpu")
    ckpt = CheckpointManager(trainer.config.checkpoint_dir).restore()
    return {"block": tuple(trainer.model.head.weight.shape),
            "saved": tuple(ckpt["model"]["head.weight"].shape),
            "shards": sorted(trainer.shards),
            "remat": trainer.model.tower.encoder.config.remat,
            "sequence_partial": len(trainer.sequence_partial)}


def train_cli_pp(argv):
    """A ``train`` command through the command line on this rank: its
    step, its stage's layout and the checkpoint's parameter names."""
    from multimodalsimilar_tpu_torch import cli
    from multimodalsimilar_tpu_torch.train.checkpoint import (
        CheckpointManager)
    trainer = cli.main(argv, device="cpu")
    ckpt = CheckpointManager(trainer.config.checkpoint_dir).restore()
    return {"rank": trainer.mesh.rank, "step": trainer.step,
            "stage": _stage_layout(trainer),
            "saved": sorted(ckpt["model"]),
            "microbatches": [enc.config.pp_microbatches
                             for enc in trainer.stages.values()],
            "remat": [enc.config.remat for enc in trainer.stages.values()]}


# -- sharded serving (tests/test_torch_sharded_serving.py) -------------------

@contextlib.contextmanager
def full_precision():
    """The f32 policy wherever the command line picks the inference one
    (its towers then agree with the JAX package's to f32 rounding)."""
    from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy
    saved = DTypePolicy.__dict__["inference"]
    DTypePolicy.inference = classmethod(lambda cls: cls.full_precision())
    try:
        yield
    finally:
        DTypePolicy.inference = saved


def drive(base, script, calls=None):
    """Each ``(path, body)`` of ``script`` sent to the daemon at ``base``
    (GET when ``body`` is None): [(HTTP status, reply)]. ``calls()``, when
    given, is read after each request and kept beside its reply."""
    out = []
    for path, body in script:
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(
            base + path, data=data,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                got = (r.status, json.loads(r.read()))
        except urllib.error.HTTPError as e:
            got = (e.code, json.loads(e.read()))
        out.append(got + ((calls(),) if calls else ()))
    return out


def serve_cli(argv, script, model_parallel=None):
    """``serve`` through ``cli.main`` on this rank, its tower in f32. The
    serving rank's daemon answers ``script`` over HTTP from a client
    thread, which then shuts the server down (``cmd_serve`` then closes
    the service, and that stops the followers). Rank 0 (or the one
    process) returns the replies with its engine's lockstep calls after
    each; a follower returns what ``cmd_serve`` returns, the calls it
    replayed. ``model_parallel`` puts that many ranks on the mesh's model
    axis (the command line's ``serve`` has no such flag; a library
    caller's Namespace may)."""
    from multimodalsimilar_tpu_torch import cli
    from multimodalsimilar_tpu_torch.cli import serve as cli_serve
    from multimodalsimilar_tpu_torch.pipelines import serving
    out = {}
    make, mesh_of = serving.make_server, cli_serve._knn_backend_mesh

    def with_model_axis(args):
        args.model_parallel = model_parallel or 1
        return mesh_of(args)

    def serving_daemon(service, host, port):
        httpd = make(service, host, port)
        calls = getattr(service.engine, "calls", None)

        def client():
            try:
                out["replies"] = drive(
                    f"http://127.0.0.1:{httpd.server_address[1]}", script,
                    (lambda: sum(calls.values())) if calls is not None
                    else None)
            finally:
                httpd.shutdown()

        threading.Thread(target=client, daemon=True).start()
        return httpd

    serving.make_server = serving_daemon
    cli_serve._knn_backend_mesh = with_model_axis
    try:
        with full_precision():
            followed = cli.main(argv, device="cpu")
    finally:
        serving.make_server, cli_serve._knn_backend_mesh = make, mesh_of
    if "replies" not in out:
        return {"followed": followed}
    return out


def l2_ops(eng, queries, k, update, as_tensor):
    """One sequence of engine calls, on any engine with the port's API
    (the JAX package's too; ``as_tensor`` makes its device queries):
    host and device queries, ``search_device``, an empty query set, an
    update refused for a duplicate key, a real one, the searches after
    it and the self-search. Returns each answer as numpy."""
    def np_pair(vi):
        return tuple(np.asarray(a) for a in vi)

    out = {"host": np_pair(eng.search(k, queries=queries)),
           "tensor": np_pair(eng.search(k, queries=as_tensor(
               queries[::-1].copy()))),
           "device": np_pair(eng.search_device(k, as_tensor(queries[:3]))),
           "empty": [np.asarray(a).shape for a in eng.search(
               k, queries=np.zeros((0, queries.shape[1]), np.float32))]}
    new_emb, new_keys = update
    try:
        eng.update(new_emb[:2], [new_keys[0]] * 2)
    except ValueError as e:
        out["refused"] = str(e)
    out["update"] = tuple(eng.update(new_emb, new_keys))
    out["after_update"] = np_pair(eng.search(k, queries=queries))
    out["self"] = np_pair(eng.search(k))
    return out


def lockstep_l2(emb, queries, k, update):
    """``l2_ops`` on an l2 engine over un-normalized rows (the multimodal
    daemon's metric): over several ranks each holds its block, rank 0
    drives a ``LockstepEngine`` and returns the answers and its calls,
    the others follow and return what they replayed."""
    from multimodalsimilar_tpu_torch.pipelines.sharded_serving import (
        LockstepEngine, follow)
    from multimodalsimilar_tpu_torch.retrieval.engine import SimilarityEngine
    mesh = create_mesh()
    engine = SimilarityEngine(emb, [f"r{i}" for i in range(len(emb))],
                              metric="l2", normalize=False, device="cpu",
                              mesh=mesh)
    if mesh.rank != 0:
        return {"followed": follow(engine, mesh)}
    fused = engine.fused_search_fn(lambda q: q, k)
    eng = LockstepEngine(engine, mesh) if engine.sharded else engine
    out = {"fused_is_none": fused is None, "sharded": engine.sharded,
           "block_rows": engine._ensure_corpus_dev()[0].shape[0],
           **l2_ops(eng, queries, k, update, torch.from_numpy)}
    if engine.sharded:
        eng.stop()
        out["calls"] = dict(eng.calls)
    return out


def embed_blocks(n, drop):
    """The sharded corpus passes' helpers on rows 0..n-1, each rank
    embedding its own block: ``embed_sharded`` (every row),
    ``embed_kept`` and ``embed_keys_sharded`` (rows and keys whose index
    divides by ``drop`` cannot be embedded, as a key without a readable
    image). Row i embeds as [i, -i]."""
    from multimodalsimilar_tpu_torch.pipelines.similar import (
        embed_kept, embed_keys_sharded, embed_sharded)
    mesh = create_mesh()

    def vecs(rows):
        rows = list(rows)
        return (np.stack([[i, -i] for i in rows]).astype(np.float32)
                if rows else np.zeros((0, 0), np.float32))

    def embed_rows(rows):
        kept = [j for j, i in enumerate(rows) if i % drop]
        return vecs(rows[j] for j in kept), kept

    emb, kept = embed_kept(mesh, n, embed_rows, "cpu")
    by_key = embed_keys_sharded(
        mesh, [f"k{i}" for i in range(n)],
        lambda kk: {k: np.float32([int(k[1:]), -int(k[1:])])
                    for k in kk if int(k[1:]) % drop}, "cpu")
    return {"all": embed_sharded(mesh, n, vecs, "cpu"), "kept": kept,
            "kept_emb": emb,
            "by_key": {k: v.tolist() for k, v in by_key.items()}}


def similar_daodian(argv):
    """``similar daodian`` through ``cli.main`` on this rank into an
    in-memory sink: the job's return on every rank, the items rank 0
    wrote."""
    from multimodalsimilar_tpu_torch import cli
    from multimodalsimilar_tpu_torch.cli import similar as cli_similar
    from multimodalsimilar_tpu_torch.pipelines import similar as P
    sink, job, got = InMemoryKVSink(), P.daodian_similar_job, {}

    def recorded(*a, **kw):
        got["merged"] = job(*a, **kw)
        return got["merged"]

    saved = cli_similar._kv_sink
    cli_similar._kv_sink = lambda args: sink
    P.daodian_similar_job = recorded
    try:
        cli.main(argv, device="cpu")
    finally:
        cli_similar._kv_sink, P.daodian_similar_job = saved, job
    return {"merged": got["merged"],
            "items": {k: v for k, (v, _) in sink.data.items()}}


def similar_multimodal(argv):
    """``similar multimodal --checkpoint`` through ``cli.main`` on this
    rank, the towers in f32 (as the JAX package's full-precision policy),
    into an in-memory sink: the keys this rank embedded, the keys of the
    table the job searched (the kept rows, in order) and the items rank 0
    wrote."""
    from multimodalsimilar_tpu_torch import cli
    from multimodalsimilar_tpu_torch.cli import embedders as cli_embedders
    from multimodalsimilar_tpu_torch.cli import similar as cli_similar
    from multimodalsimilar_tpu_torch.data.datasets import column
    from multimodalsimilar_tpu_torch.pipelines import similar as P
    sink, embedded, got = InMemoryKVSink(), [], {}
    fused, job = cli_embedders._fused_embeddings, P.multimodal_similar_job

    def embed(args, df, *a, **kw):
        embedded.extend(column(df, args.key_col))
        return fused(args, df, *a, **kw)

    def search(table, *a, key_col="spu_sn", **kw):
        got["kept"] = list(column(table, key_col))
        return job(table, *a, key_col=key_col, **kw)

    saved = (cli_similar._kv_sink, DTypePolicy.__dict__["inference"])
    cli_similar._kv_sink = lambda args: sink
    cli_embedders._fused_embeddings, P.multimodal_similar_job = embed, search
    DTypePolicy.inference = classmethod(lambda cls: cls.full_precision())
    try:
        cli.main(argv, device="cpu")
    finally:
        cli_similar._kv_sink, DTypePolicy.inference = saved
        cli_embedders._fused_embeddings, P.multimodal_similar_job = fused, job
    return {"embedded": embedded, "kept": got["kept"],
            "items": {k: v for k, (v, _) in sink.data.items()}}


def refused(argv):
    """What ``cli.main(argv)`` raises on this rank: (type, message)."""
    from multimodalsimilar_tpu_torch import cli
    try:
        cli.main(argv, device="cpu")
    except (SystemExit, NotImplementedError) as e:
        return type(e).__name__, str(e)
    return None


def run(jobs):
    """Every ``(function name, args)`` of ``jobs`` in turn, on one process
    group: one spawn serves many cases."""
    return [globals()[name](*args) for name, args in jobs]


# -- on the card (tests/test_torch_cuda.py): ranks on cuda:0 over gloo -------

def _card_inputs(b, c, d, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((c, d), dtype=np.float32))
    labels = torch.from_numpy(rng.integers(0, c, b).astype(np.int32))
    labels[:2] = torch.tensor([c // 2 - 1, c // 2])  # on both blocks' edges
    return x, w, labels


def card_head(b, c, d, seed):
    """A class-sharded ``ArcFaceHead`` over the ranks' model axis: its
    margin logits (the kernel on this rank's block), the cross-entropy
    over the model group and the gradients of x and of the block."""
    from multimodalsimilar_tpu_torch.models.heads import ArcFaceHead
    from multimodalsimilar_tpu_torch.ops import arcface as A
    from multimodalsimilar_tpu_torch.train.tasks import _ce
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = create_mesh(1, int(torch.distributed.get_world_size()))
    x, w, labels = _card_inputs(b, c, d, seed)
    head = ArcFaceHead(c, d).to(dev)
    with torch.no_grad():
        head.weight.copy_(w.to(dev))
    head.shard(mesh)
    x = x.to(dev).requires_grad_(True)
    A.LAUNCHES["arcface"] = 0
    logits = head(x, labels.to(dev), m=0.4)
    loss = _ce(logits, labels.to(dev), head)
    loss.backward()
    torch.cuda.synchronize()
    return {"logits": logits.detach().cpu().numpy(), "loss": float(loss),
            "grad_x": x.grad.cpu().numpy(),
            "grad_w": head.weight.grad.cpu().numpy(),
            "launches": A.LAUNCHES["arcface"]}


def card_search(corpus, queries, k, metric):
    """``sharded_knn_search`` over the ranks' data axis on the card."""
    from multimodalsimilar_tpu_torch.ops import topk as T
    dev = torch.device("cuda", 0)
    mesh = create_mesh()
    padded, n = pad_corpus(corpus, mesh.data, metric)
    block = padded[MeshRules(mesh).corpus_sharded(len(padded))]
    T.LAUNCHES["topk"] = T.LAUNCHES["topk_select"] = 0
    v, i = sharded_knn_search(
        mesh, torch.from_numpy(np.ascontiguousarray(block)).to(dev),
        torch.from_numpy(queries).to(dev), k, metric, true_n=n)
    torch.cuda.synchronize()
    return {"v": v.cpu().numpy(), "i": i.cpu().numpy(),
            "launches": T.LAUNCHES["topk"] + T.LAUNCHES["topk_select"]}


def collectives(shape, n_model):
    """The model group's reduce-scatter and all-gather along a dimension
    and the sequence-parallel autograd functions, forward and backward,
    on [2, 2 * n_model + 1, 3] tensors that differ by rank."""
    from multimodalsimilar_tpu_torch.parallel import sp
    mesh = create_mesh(*shape)
    r = mesh.rank
    x = torch.arange(2 * (2 * n_model) * 3, dtype=torch.float32).reshape(
        2, 2 * n_model, 3) + 100 * r
    out = {"rank": r, "coords": (mesh.data_index, mesh.model_index),
           "rs": mesh.reduce_scatter(x, 1).cpu().numpy(),
           "ag": mesh.all_gather_dim(x, 2).cpu().numpy()}
    S = 2 * n_model + 1                      # not divisible: padded
    y = (torch.arange(2 * S * 3, dtype=torch.float32).reshape(2, S, 3)
         + 10 * r).requires_grad_(True)
    block = sp.to_sequence(y, mesh, partial=True)
    back = sp.from_sequence(block * (r + 1), mesh, True, S)
    (back * torch.arange(S, dtype=torch.float32)[None, :, None]).sum(
        ).backward()
    out.update(block=block.detach().cpu().numpy(),
               back=back.detach().cpu().numpy(), grad=y.grad.cpu().numpy())
    return out


def card_collectives(n_model):
    """``collectives`` on ``cuda:0`` over gloo, and whether gloo runs the
    tensor-in, tensor-out reduce-scatter and all-gather on CUDA tensors
    itself (the wrappers compose them from the all-reduce and the list
    all-gather on gloo either way)."""
    import torch.distributed as dist
    torch.cuda.set_device(0)
    native = {}
    x = torch.ones(2 * dist.get_world_size(), device="cuda")
    for name, call in (
            ("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
                torch.empty(2, device="cuda"), x)),
            ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
                torch.empty(2 * x.numel(), device="cuda"), x))):
        try:
            call()
            torch.cuda.synchronize()
            native[name] = True
        except (RuntimeError, NotImplementedError, ValueError) as e:
            native[name] = f"{type(e).__name__}: {str(e)[:160]}"
    dist.barrier()
    with torch.device("cuda"):
        out = collectives((1, n_model), n_model)
    out["native"] = native
    return out


# -- pipeline parallelism (tests/test_torch_pp.py) ---------------------------

def pp_schedule(shape, m, L=8, B=8, D=16, seed=0, device="cpu"):
    """``pp.gpipe`` over layers tanh(h @ W_l + b_l + c) against the same
    layers in turn on this process, forward and gradients of
    sum(out ** 2), on this rank's rows of the batch (on ``device``): the
    largest differences in f32 and in f64 (``"f64"``), whether the
    configured microbatches ran, and the largest entry of each compared
    quantity of the layers in turn on any one microbatch's rows
    (``scales``: for the parameters, the partials the schedule sums)."""
    mesh = create_mesh(*shape)
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((L, D, D)) * 0.3).astype(np.float32)
    b = (rng.standard_normal((L, D)) * 0.1).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)
    c = (rng.standard_normal((B, D)) * 0.2).astype(np.float32)
    rows = MeshRules(mesh).batch(B)
    stage = pp.stage_of(L, mesh)
    own = slice(stage.layers.start, stage.layers.stop)

    def layers(h, cc, ws, bs):
        for wl, bl in zip(ws, bs):
            h = torch.tanh(h @ wl + bl + cc)
        return h

    def sequential(dtype, part=slice(None)):
        ref = [torch.tensor(a, device=device, dtype=dtype,
                            requires_grad=True)
               for a in (x[rows][part], w, b)]
        want = layers(ref[0], torch.tensor(c[rows][part], device=device,
                                           dtype=dtype), ref[1], ref[2])
        (want ** 2).sum().backward()
        return want.detach(), [r.grad for r in ref]

    def schedule(dtype):
        want, ref = sequential(dtype)
        cc = torch.tensor(c[rows], device=device, dtype=dtype)
        got = [torch.tensor(a, device=device, dtype=dtype,
                            requires_grad=True)
               for a in (x[rows], w[own], b[own])]
        before = pp.applied_count()
        out = pp.gpipe(lambda h, ci, sl: layers(h, ci, got[1], got[2]),
                       got[0], cc, mesh, m)
        (out ** 2).sum().backward()
        g_x = mesh.all_reduce(got[0].grad.clone(), MODEL_AXIS)

        def err(a, b):
            return float((a - b).abs().max())

        return {"applied": pp.applied_count() - before,
                "out": err(out.detach(), want),
                "grad_x": err(g_x, ref[0]),
                "grad_x_off_stage0": float(got[0].grad.abs().max())
                if stage.layers.start else 0.0,
                "grad_w": err(got[1].grad, ref[1][own]),
                "grad_b": err(got[2].grad, ref[2][own])}

    n = len(range(B)[rows])
    parts = [sequential(torch.float32, slice(i * n // m, (i + 1) * n // m))
             for i in range(m if n % m == 0 else 1)]
    return dict(schedule(torch.float32), rank=mesh.rank,
                layers=list(stage.layers), f64=schedule(torch.float64),
                scales={key: max(float(f(*p).abs().max()) for p in parts)
                        for key, f in (
                            ("out", lambda o, g: o),
                            ("grad_x", lambda o, g: g[0]),
                            ("grad_w", lambda o, g: g[1][own]),
                            ("grad_b", lambda o, g: g[2][own]))})


def pp_encoder(shape, bert, state_dict, ids, mask, train_seed=None):
    """A pipeline-parallel ``BertEncoderModel`` (this rank's stage) in
    full precision: its outputs on this rank's rows with no gradient,
    and, with a graph, the gradients of mean(pooled ** 2) gathered to
    the one-card layout (rank 0). ``train_seed``: in train() mode,
    dropout drawn from a generator of that seed."""
    from multimodalsimilar_tpu_torch.models.bert import (
        BertEncoderModel, set_dropout_generator)
    mesh = create_mesh(*shape)
    with pp.building(mesh):
        model = BertEncoderModel(BertConfig.tiny(**bert), FULL)
    own = model.state_dict()
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in state_dict.items() if k in own})
    rows = MeshRules(mesh).batch(len(ids))
    ids, mask = (torch.from_numpy(a[rows]) for a in (ids, mask))
    if train_seed is not None:
        model.train()
        set_dropout_generator(model, torch.Generator().manual_seed(
            train_seed))
    with torch.no_grad():
        plain = model(ids, mask)
    if train_seed is not None:
        set_dropout_generator(model, torch.Generator().manual_seed(
            train_seed))
    out = model(ids, mask)
    (out["pooler_output"] ** 2).mean().backward()
    grads = gather_stage_tensors(
        {n: p.grad for n, p in model.named_parameters()},
        {"": model}, mesh)
    grads = {n: mesh.all_reduce(g.clone(), MODEL_AXIS)
             if n.startswith("embeddings.") else g
             for n, g in grads.items()}
    return {"rank": mesh.rank, "rows": (rows.start, rows.stop),
            "layers": list(model.pp.layers),
            "hidden": out["last_hidden_state"].detach().numpy(),
            "pooled": out["pooler_output"].detach().numpy(),
            "hidden_no_grad": plain["last_hidden_state"].numpy(),
            "grads": {n: g.numpy() for n, g in grads.items()}
            if mesh.rank == 0 else None}


def card_pipeline():
    """The stage hand-off (``Mesh.shift`` both ways) and ``broadcast_from``
    forward and backward on this rank's card (over gloo: ``cuda:0``, the
    tensors staged through the host; over NCCL: its own card), and the
    toy schedule of ``pp_schedule`` there, at data 1 x model world."""
    import torch.distributed as dist
    from multimodalsimilar_tpu_torch.parallel.mesh import broadcast_from
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    world = dist.get_world_size()
    mesh = create_mesh(1, world)
    r = mesh.rank
    x = torch.arange(6, dtype=torch.bfloat16, device=dev).reshape(2, 3) + r
    out = {"rank": r, "next": mesh.shift(x).float().cpu().numpy(),
           "prev": mesh.shift(x, reverse=True).float().cpu().numpy()}
    y = (torch.arange(4, dtype=torch.float32, device=dev) + 10 * r
         ).requires_grad_(True)
    z = broadcast_from(y, mesh, world - 1)
    (z * (r + 1)).sum().backward()
    out.update(bcast=z.detach().cpu().numpy(), grad=y.grad.cpu().numpy(),
               schedule=pp_schedule((1, world), 2, device=dev))
    torch.cuda.synchronize()
    return out
