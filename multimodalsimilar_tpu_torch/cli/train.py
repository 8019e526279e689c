"""``train {nlp,multilabel,cv,pair,multimodal,fasttext}`` (counterpart
of multimodalsimilar_tpu/cli/train.py), taking a device where the JAX
package takes a mesh.

The commands are functions of the ``argparse.Namespace`` that the port's
parser (``cli/parser.py``) builds, with the JAX parser's flags:
``cmd_train_*(args, table=None, eval_table=None, device="cuda")`` reads
``args.data`` (and ``args.eval_data``) with ``read_table``, or takes the
tables as ``{column: list}`` mappings, trains, writes ``{output}/ckpt``,
``{output}/metrics.jsonl`` and, for the text recipes without
``--tokenizer``, ``{output}/vocab.txt``, and returns the Trainer
(``train fasttext`` writes ``{output}/fasttext.pkl`` and returns the
model). Under ``torchrun`` every rank runs the command over the mesh of
``_mesh(args)``: ``--batch_size`` is the global batch, ``--bf16_grads``
all-reduces the gradients in bfloat16 and ``--model_parallel N`` shards
the ArcFace heads' classes over N ranks, each head padded to a multiple
of N with the pad classes masked (``_pad_for_model_parallel``);
``--tensor_parallel`` and ``--sequence_parallel`` cut the BERT tower over
the same ranks, ``--pipeline_parallel M`` builds each rank's stage of its
layers and trains them in the GPipe schedule with M microbatches
(``parallel/pp.py``; ``train nlp|multilabel|multimodal|pair``) and
``--remat*`` rematerialize its layers. Each command refuses the flags the
JAX command refuses.
"""

from __future__ import annotations

import contextlib
import os
import sys

import torch

from multimodalsimilar_tpu_torch.data.datasets import InputError, column

def _set_flags(args, flags) -> dict:
    """The ``flags`` (name -> the value that leaves it off) that ``args``
    sets."""
    return {k: getattr(args, k) for k, off in flags.items()
            if getattr(args, k, off) != off}


def _layout(args):
    """(mesh, the scope to build the model in) of ``args``: under
    ``--pipeline_parallel`` the model is built as this rank's stage
    (``parallel/pp.py:building``), after the Trainer's refusals of the
    layouts that do not compose."""
    from multimodalsimilar_tpu_torch.cli.common import _mesh
    mesh = _mesh(args)
    if not getattr(args, "pipeline_parallel", 0):
        return mesh, contextlib.nullcontext()
    from multimodalsimilar_tpu_torch.parallel import pp
    from multimodalsimilar_tpu_torch.train.trainer import (TrainerConfig,
                                                           check_layouts)
    check_layouts(TrainerConfig(
        model_parallel_heads=getattr(args, "model_parallel", 1) > 1,
        tensor_parallel=getattr(args, "tensor_parallel", False),
        sequence_parallel=getattr(args, "sequence_parallel", False),
        bf16_grad_allreduce=getattr(args, "bf16_grads", False),
        pipeline_parallel=True), mesh)
    return mesh, pp.building(mesh)


def _pad_for_model_parallel(num_labels, args):
    """(head_size, num_valid): pad a class count up to a
    ``--model_parallel`` multiple (a class block per rank; 10205 =
    5*13*157 shares no factor with 2, 4 or 8). Pad classes are masked to
    -inf in the task loss and eval (``train/tasks._mask_pad``): loss and
    accuracy equal the unpadded head's."""
    mp = int(getattr(args, "model_parallel", 1) or 1)
    if mp <= 1 or num_labels % mp == 0:
        return num_labels, None
    padded = -(-num_labels // mp) * mp
    print(f"--model_parallel {mp}: padding head {num_labels} -> {padded} "
          f"classes ({padded - num_labels} masked pad classes)",
          file=sys.stderr)
    return padded, num_labels


def _opt_step_units(args, steps_per_epoch):
    """(accum, optimizer steps per epoch, total optimizer steps).
    Schedules advance once per OPTIMIZER step, so under --grad_accum K
    they are built in optimizer-step units."""
    accum = int(getattr(args, "grad_accum", 1) or 1)
    per_epoch = max(steps_per_epoch // accum, 1)
    return accum, per_epoch, args.epochs * per_epoch


def _schedules(args, steps_per_epoch):
    """(tower, head) schedules of ``--scheduler``, in optimizer steps."""
    from multimodalsimilar_tpu_torch.train.optim import (
        cosine_warm_restarts, linear_schedule_with_warmup,
        timm_cosine_schedule)
    _, per_epoch, total = _opt_step_units(args, steps_per_epoch)
    scheduler = getattr(args, "scheduler", "linear")
    if scheduler == "timm_cosine":
        t_initial = max(args.epochs - args.cooldown_epochs, 1)
        return tuple(timm_cosine_schedule(
            lr, t_initial, per_epoch, args.warmup_epochs,
            args.warmup_lr_init, args.lr_min)
            for lr in (args.tower_lr, args.head_lr))
    if scheduler == "cosine_warm_restarts":
        return tuple(cosine_warm_restarts(lr, args.t0_epochs, per_epoch)
                     for lr in (args.tower_lr, args.head_lr))
    if scheduler != "linear":
        raise ValueError(f"unknown --scheduler {scheduler!r}")
    return (linear_schedule_with_warmup(
                args.tower_lr,
                getattr(args, "tower_warmup_frac", 0.0) * total, total),
            linear_schedule_with_warmup(
                args.head_lr, args.head_warmup_frac * total, total))


def _trainer(task, args, steps_per_epoch, device="cuda", mesh=None):
    """``--optimizer`` (AdamW or AdamP, each as one optimizer with a tower
    group and a head group with their own weight decay) under
    ``--scheduler``, ``--grad_accum`` and ``--profile``, and the Trainer
    of ``args`` over ``mesh`` (default ``_mesh(args)``:
    ``--model_parallel``, ``--tensor_parallel``, ``--sequence_parallel``,
    ``--pipeline_parallel``, ``--bf16_grads``); checkpoints and
    ``metrics.jsonl`` go under ``args.output``."""
    from multimodalsimilar_tpu_torch.cli.common import _mesh
    from multimodalsimilar_tpu_torch.train.optim import (AdamP, adamp_views,
                                                         dual_group)
    from multimodalsimilar_tpu_torch.train.trainer import (Trainer,
                                                           TrainerConfig)
    accum = _opt_step_units(args, steps_per_epoch)[0]
    tower_sched, head_sched = _schedules(args, steps_per_epoch)
    optimizer = getattr(args, "optimizer", "adamw")
    if optimizer not in ("adamw", "adamp"):
        raise ValueError(f"unknown --optimizer {optimizer!r}")

    def make_optimizer(model):
        kw = ({"views": adamp_views(model)} if optimizer == "adamp"
              else {})
        return dual_group(model, AdamP if optimizer == "adamp"
                          else torch.optim.AdamW, tower_sched, head_sched,
                          args.weight_decay, args.head_weight_decay, **kw)

    cfg = TrainerConfig(
        eval_every=args.eval_every, save_every=args.save_every,
        log_every=args.log_every,
        margin_init=args.margin,
        margin_delta_per_epoch=args.margin_delta_per_epoch,
        checkpoint_dir=os.path.join(args.output, "ckpt"),
        metrics_path=os.path.join(args.output, "metrics.jsonl"),
        profile_dir=getattr(args, "profile", None),
        model_parallel_heads=getattr(args, "model_parallel", 1) > 1,
        tensor_parallel=getattr(args, "tensor_parallel", False),
        sequence_parallel=getattr(args, "sequence_parallel", False),
        pipeline_parallel=getattr(args, "pipeline_parallel", 0) > 0,
        bf16_grad_allreduce=getattr(args, "bf16_grads", False),
        grad_accum=accum,
        overwrite=getattr(args, "overwrite", False),
        async_save=getattr(args, "async_save", False),
        seed=args.seed)
    os.makedirs(args.output, exist_ok=True)
    return Trainer(task, make_optimizer, cfg, device=device,
                   mesh=mesh if mesh is not None else _mesh(args))


def _sampler_fn(args, table, label_col):
    """Class-balanced replacement sampling per epoch (the _v2 recipes'
    WeightedRandomSampler), or None without ``weighted_sampling``."""
    if not args.weighted_sampling:
        return None
    from multimodalsimilar_tpu_torch.data.sampling import (
        WeightedSampler, class_balance_weights)
    w = class_balance_weights(column(table, label_col))
    return lambda epoch: WeightedSampler(w, seed=args.seed + epoch)


# -- the commands ------------------------------------------------------------

def _tables(args, table, eval_table, require=()):
    """(train table, eval table or None): the given tables, else
    ``args.data`` and ``args.eval_data`` through ``read_table``."""
    from multimodalsimilar_tpu_torch.data.datasets import read_table
    if table is None:
        table = read_table(args.data, require=require)
    missing = [c for c in require if c not in table]
    if missing:
        raise InputError(f"the table has no column(s) {missing}")
    if eval_table is None and getattr(args, "eval_data", None):
        eval_table = read_table(args.eval_data)
    return table, eval_table


def _text_config(args):
    """The tower's BertConfig: ``--bert_preset`` with ``--remat*``,
    ``--sequence_parallel`` and ``--pipeline_parallel``."""
    from multimodalsimilar_tpu_torch.cli.common import _bert_config
    return _bert_config(args.bert_preset,
                        remat=getattr(args, "remat", False),
                        sequence_parallel=getattr(args, "sequence_parallel",
                                                  False),
                        pipeline_parallel=getattr(args, "pipeline_parallel",
                                                  0),
                        remat_policy=getattr(args, "remat_policy", "full"),
                        remat_skip=getattr(args, "remat_skip", 0))


def _num_labels(table, col) -> int:
    return int(max(column(table, col))) + 1


def _generator(args):
    return torch.Generator().manual_seed(args.seed)


def _fit(trainer, args, src, eval_src, sampler_fn):
    trainer.fit(src, args.epochs, args.batch_size, eval_src,
                sampler_fn=sampler_fn,
                resume=getattr(args, "resume", False))
    return trainer


def _refuse(args, command, flags, reason):
    """The JAX command's refusals: ``flags`` (name -> the value that
    leaves it off) do not apply to ``command``."""
    bad = [f"--{f}" for f in _set_flags(args, flags)]
    if bad:
        raise SystemExit(f"train {command}: {'/'.join(bad)} {reason} — "
                         f"refusing to silently ignore them")


def cmd_train_nlp(args, table=None, eval_table=None, device="cuda"):
    """``train nlp``: the text tower + one ArcFace head
    (configs/train_nlp_*.yaml)."""
    from multimodalsimilar_tpu_torch.cli.common import _tokenizer
    from multimodalsimilar_tpu_torch.data.datasets import (
        TextClassificationSource)
    from multimodalsimilar_tpu_torch.models.classifiers import (
        NlpTextClassifier)
    from multimodalsimilar_tpu_torch.ops.arcface import ArcFaceParams
    from multimodalsimilar_tpu_torch.train.tasks import text_arcface_task
    config = _text_config(args)
    table, eval_table = _tables(args, table, eval_table,
                                [args.text_col, args.label_col])
    tok = _tokenizer(args, df=table, save_dir=args.output)

    def source(t):
        return TextClassificationSource(
            t, tok, args.text_col, args.label_col, args.max_length,
            clean=not args.no_clean,
            seq_buckets=getattr(args, "seq_buckets", None))

    src = source(table)
    num_labels, num_valid = _pad_for_model_parallel(
        _num_labels(table, args.label_col), args)
    mesh, scope = _layout(args)
    with scope:
        model = NlpTextClassifier(
            config, pool=getattr(args, "pool", "cls"),
            generator=_generator(args), num_labels=num_labels,
            arcface=ArcFaceParams(m=args.margin))
    trainer = _trainer(text_arcface_task(model, fused_loss=args.fused_loss,
                                         num_valid=num_valid),
                       args, max(len(src) // args.batch_size, 1), device,
                       mesh)
    return _fit(trainer, args, src,
                source(eval_table) if eval_table is not None else None,
                _sampler_fn(args, table, args.label_col))


class _Renamed:
    """Multi-label batches with the label columns under the task's names
    (``lv1_label``, ``lv2_label``, ``tag_label``)."""

    def __init__(self, source, cols):
        self.source = source
        self.names = dict(zip(cols, ("lv1_label", "lv2_label",
                                     "tag_label")))

    def __len__(self):
        return len(self.source)

    def batches(self, *a, **kw):
        for b in self.source.batches(*a, **kw):
            yield {self.names.get(k, k): v for k, v in b.items()}


def cmd_train_multilabel(args, table=None, eval_table=None, device="cuda"):
    """``train multilabel``: the shared tower + the (lv1, lv2, tag) heads
    with the weighted loss (configs/train_multilabel_v3.yaml)."""
    from multimodalsimilar_tpu_torch.cli.common import _tokenizer
    from multimodalsimilar_tpu_torch.data.datasets import (
        TextClassificationSource)
    from multimodalsimilar_tpu_torch.models.classifiers import (
        NlpMultilabelClassifier)
    from multimodalsimilar_tpu_torch.train.tasks import (
        multilabel_arcface_task)
    config = _text_config(args)
    cols = [args.lv1_col, args.lv2_col, args.tag_col]
    table, eval_table = _tables(args, table, eval_table,
                                [args.text_col] + cols)
    tok = _tokenizer(args, df=table, save_dir=args.output)

    def source(t):
        return _Renamed(TextClassificationSource(
            t, tok, args.text_col, cols, args.max_length,
            clean=not args.no_clean,
            seq_buckets=getattr(args, "seq_buckets", None)), cols)

    src = source(table)
    sizes, valid = zip(*(_pad_for_model_parallel(_num_labels(table, c),
                                                 args) for c in cols))
    mesh, scope = _layout(args)
    with scope:
        model = NlpMultilabelClassifier(config, *sizes,
                                        generator=_generator(args))
    task = multilabel_arcface_task(
        model, weights=(args.lv1_weight, args.lv2_weight, args.tag_weight),
        fused_loss=args.fused_loss, num_valid=valid)
    trainer = _trainer(task, args, max(len(src) // args.batch_size, 1),
                       device, mesh)
    return _fit(trainer, args, src,
                source(eval_table) if eval_table is not None else None,
                _sampler_fn(args, table, args.lv2_col))


# flags of the BERT-tower text recipes, which train cv refuses
_TEXT_ONLY = {"fused_loss": False, "remat": False, "remat_skip": 0,
              "remat_policy": "full", "tensor_parallel": False,
              "sequence_parallel": False, "pipeline_parallel": 0}


def cmd_train_cv(args, table=None, eval_table=None, device="cuda"):
    """``train cv``: a ``--backbone`` (EfficientNet, ViT or ConvNeXt) +
    fc/BN neck + ArcFace on uint8 images from ``{img_root}/{key}.jpg``
    (configs/train_cv_*.yaml). Eval and checkpoints default to once per
    epoch, as the daodian reference."""
    from multimodalsimilar_tpu_torch.data.datasets import (
        ImageClassificationSource)
    from multimodalsimilar_tpu_torch.models.vision import (
        CvImageClassifier, backbone_config)
    from multimodalsimilar_tpu_torch.ops.arcface import ArcFaceParams
    from multimodalsimilar_tpu_torch.train.tasks import cv_arcface_task
    if _set_flags(args, _TEXT_ONLY):
        raise SystemExit(
            "train cv: --fused_loss/--remat/--remat_policy/--remat_skip/"
            "--tensor_parallel/--sequence_parallel/--pipeline_parallel "
            "apply to the BERT-tower text recipes; the cv task has none "
            "of them — refusing to silently ignore them")
    table, eval_table = _tables(args, table, eval_table,
                                [args.key_col, args.label_col])
    steps_per_epoch = max(len(column(table, args.label_col))
                          // args.batch_size, 1)
    if args.eval_every is None:
        args.eval_every = steps_per_epoch
    if args.save_every is None:
        args.save_every = steps_per_epoch

    def source(t, train_aug):
        return ImageClassificationSource(
            t, args.img_root, args.key_col, args.label_col, args.image_size,
            train_aug=train_aug, decode_cache=args.decode_cache)

    num_labels, num_valid = _pad_for_model_parallel(
        _num_labels(table, args.label_col), args)
    model = CvImageClassifier(
        backbone_config(args.backbone, image_size=args.image_size),
        num_labels=num_labels, fc_dim=args.fc_dim,
        arcface=ArcFaceParams(m=args.margin), generator=_generator(args))
    model = model.to(memory_format=torch.channels_last)
    trainer = _trainer(cv_arcface_task(model, num_valid), args,
                       steps_per_epoch, device)
    return _fit(trainer, args, source(table, True),
                source(eval_table, False) if eval_table is not None
                else None, _sampler_fn(args, table, args.label_col))


def cmd_train_pair(args, table=None, eval_table=None, device="cuda"):
    """``train pair``: the Siamese pair model on sampled (query, title)
    pairs, anchors class-balanced by tag (configs/train_pair.yaml)."""
    from multimodalsimilar_tpu_torch.cli.common import _tokenizer
    from multimodalsimilar_tpu_torch.data.datasets import PairTextSource
    from multimodalsimilar_tpu_torch.models.classifiers import (
        SiamesePairModel)
    from multimodalsimilar_tpu_torch.train.tasks import pair_task
    _refuse(args, "pair", {"fused_loss": False}, "needs an ArcFace head; "
            "the pair loss is 2-class CE")
    config = _text_config(args)
    table, eval_table = _tables(args, table, eval_table)
    tok = _tokenizer(args, df=table, save_dir=args.output, text_col="title")

    def source(t):
        return PairTextSource(t, tok, args.max_length, seed=args.seed,
                              seq_buckets=getattr(args, "seq_buckets",
                                                  None))

    src = source(table)
    mesh, scope = _layout(args)
    with scope:
        model = SiamesePairModel(config, generator=_generator(args))
    trainer = _trainer(pair_task(model), args,
                       max(len(src) // args.batch_size, 1), device, mesh)
    # the reference class-balances anchors by inverse tag frequency
    # (nlp_st_train_daodian.py:102-116,131-132)
    return _fit(trainer, args, src,
                source(eval_table) if eval_table is not None else None,
                _sampler_fn(args, src.table, "tag_id"))


def cmd_train_multimodal(args, table=None, eval_table=None,
                         device="cuda"):
    """``train multimodal``: the image and text towers fused under one
    ArcFace head (configs/train_multimodal.yaml)."""
    from multimodalsimilar_tpu_torch.cli.common import _tokenizer
    from multimodalsimilar_tpu_torch.data.datasets import MultimodalSource
    from multimodalsimilar_tpu_torch.models.multimodal import (
        MultimodalClassifier)
    from multimodalsimilar_tpu_torch.models.vision import backbone_config
    from multimodalsimilar_tpu_torch.train.tasks import (
        multimodal_arcface_task)
    _refuse(args, "multimodal", {"fused_loss": False},
            "is not wired for the fused-tower task")
    config = _text_config(args)
    table, eval_table = _tables(args, table, eval_table,
                                [args.text_col, args.key_col,
                                 args.label_col])
    tok = _tokenizer(args, df=table, save_dir=args.output)

    def source(t, train_aug):
        return MultimodalSource(
            t, tok, args.img_root, args.text_col, args.key_col,
            args.label_col, args.max_length, args.image_size,
            train_aug=train_aug, decode_cache=args.decode_cache,
            seq_buckets=getattr(args, "seq_buckets", None),
            clean=not args.no_clean)

    src = source(table, True)
    num_labels, num_valid = _pad_for_model_parallel(
        _num_labels(table, args.label_col), args)
    mesh, scope = _layout(args)
    with scope:
        model = MultimodalClassifier(
            config, backbone_config(args.backbone,
                                    image_size=args.image_size),
            num_labels=num_labels, fc_dim=args.fc_dim,
            generator=_generator(args))
    model = model.to(memory_format=torch.channels_last)
    trainer = _trainer(multimodal_arcface_task(model, num_valid), args,
                       max(len(src) // args.batch_size, 1), device, mesh)
    return _fit(trainer, args, src,
                source(eval_table, False) if eval_table is not None
                else None, _sampler_fn(args, table, args.label_col))


def cmd_train_fasttext(args, table=None, eval_table=None, device="cuda"):
    """``train fasttext``: supervised fastText (fasttext_train.py,
    configs/train_fasttext.yaml) through ``models/fasttext.py:
    train_supervised`` on ``device``; the model goes to
    ``{output}/fasttext.pkl`` (``FastTextClassifier.save``, the file
    ``--fasttext_model`` loads). With ``--eval_data`` it prints
    ``{"n", "precision", "recall"}``.

    ``--chain_steps`` keeps the JAX flag; its JAX default picks by XLA
    backend (8 SGD steps per compiled program on a TPU, 1 on the CPU).
    The port takes one step per iteration whatever it says (a CUDA step
    has no per-program dispatch floor to amortize), so its default is
    1."""
    import json
    from multimodalsimilar_tpu_torch.models.fasttext import train_supervised
    table, eval_table = _tables(args, table, eval_table,
                                [args.text_col, args.label_col])
    model = train_supervised(
        [str(t) for t in column(table, args.text_col)],
        column(table, args.label_col), dim=args.dim, lr=args.lr,
        epochs=args.epochs, word_ngrams=2,
        chain_steps=args.chain_steps or 1, device=device)
    os.makedirs(args.output, exist_ok=True)
    model.save(os.path.join(args.output, "fasttext.pkl"))
    if eval_table is not None:
        n, p, r = model.test([str(t) for t in column(eval_table,
                                                     args.text_col)],
                             column(eval_table, args.label_col))
        print(json.dumps({"n": n, "precision": p, "recall": r}))
    return model
