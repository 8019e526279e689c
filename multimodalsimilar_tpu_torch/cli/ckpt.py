"""``eval`` / ``import-checkpoint`` / ``export-checkpoint`` — standalone
margin-free evaluation and reference-checkpoint interchange (counterpart
of multimodalsimilar_tpu/cli/ckpt.py), on ``device``.

Checkpoints are the port's own (``train/checkpoint.py``: ``{step,
model, ...}``); ``import-checkpoint`` writes one at step 0 from a
reference state_dict, ``export-checkpoint`` writes the latest one back
out in the reference's layout (``models/reference_{import,export}.py``).
"""

from __future__ import annotations

import json
import sys

from multimodalsimilar_tpu_torch.cli.common import (
    _bert_config, _on_meta, _require_tokenizer_with_checkpoint,
    _restore_required, _seq_buckets, _tokenizer)
from multimodalsimilar_tpu_torch.data.datasets import column

_KINDS = ("nlp", "multilabel", "siamese", "cv", "multimodal")


def cmd_eval(args, device="cuda"):
    """Margin-free evaluation of a checkpoint on a labeled dataset (the
    reference's in-loop is_test=True eval, as a standalone job).

    The head width comes from the checkpoint: a head wider than the data
    implies is evaluated at its width with the classes past
    ``--num_labels`` (the training class count) masked to -inf, as the
    in-loop eval masks a padded head (``train/tasks.py:_mask_pad``).
    Three refusals: a head narrower than the labels, a ``--num_labels``
    outside [data-implied, head width], and a wider head without
    ``--num_labels``."""
    from multimodalsimilar_tpu_torch.data.datasets import (
        TextClassificationSource, read_table)
    from multimodalsimilar_tpu_torch.models.classifiers import (
        NlpTextClassifier)
    from multimodalsimilar_tpu_torch.train.optim import dual_group_adamw
    from multimodalsimilar_tpu_torch.train.tasks import text_arcface_task
    from multimodalsimilar_tpu_torch.train.trainer import (Trainer,
                                                           TrainerConfig)

    table = read_table(args.data)
    _require_tokenizer_with_checkpoint(args)
    tok = _tokenizer(args, df=table)
    src = TextClassificationSource(table, tok, args.text_col, args.label_col,
                                   args.max_length,
                                   seq_buckets=_seq_buckets(args))
    # what this split's labels require of the head — enforced against the
    # checkpoint whatever --num_labels says
    data_implied = int(max(column(table, args.label_col))) + 1
    num_labels = args.num_labels or data_implied
    restored = (_restore_required(args.checkpoint)["model"]
                if args.checkpoint else None)
    num_valid = None
    head_w = (restored or {}).get("head.weight")
    if head_w is not None:
        head_classes = int(head_w.shape[0])
        if head_classes < data_implied:
            raise SystemExit(
                f"eval: checkpoint head has {head_classes} classes but the "
                f"data implies {data_implied} (max {args.label_col} + 1) — "
                f"labels out of the head's range. Wrong checkpoint, wrong "
                f"--label_col, or a label map mismatch.")
        if args.num_labels:
            # masked (pad) classes must not appear as labels either —
            # a -inf true-class logit is an always-wrong row + inf loss
            if not data_implied <= args.num_labels <= head_classes:
                raise SystemExit(
                    f"eval: --num_labels {args.num_labels} must lie in "
                    f"[data-implied {data_implied}, checkpoint head "
                    f"{head_classes}] — it is the TRAINING class count "
                    f"(the head size before --model_parallel padding)")
            if args.num_labels < head_classes:
                print(f"eval: checkpoint head {head_classes} classes, "
                      f"--num_labels {args.num_labels} valid — masking "
                      f"{head_classes - args.num_labels} pad classes like "
                      f"the in-loop eval", file=sys.stderr, flush=True)
                num_valid = args.num_labels
        elif head_classes > data_implied:
            # only the user knows the trained class count: masking below
            # it would hide real trained classes
            raise SystemExit(
                f"eval: checkpoint head has {head_classes} classes, data "
                f"implies only {data_implied}. Pass --num_labels with the "
                f"TRAINING class count so only model-parallel pad classes "
                f"are masked (e.g. --num_labels 10205 for a 10208-padded "
                f"head); an inferred count would mask real classes.")
        num_labels = head_classes
    def make():
        return NlpTextClassifier(_bert_config(args.bert_preset),
                                 pool=args.pool, num_labels=num_labels)

    if restored is None:
        model = make()
    else:
        model = _on_meta(make)
        model.load_state_dict(restored, assign=True)
    trainer = Trainer(text_arcface_task(model, num_valid=num_valid),
                      lambda m: dual_group_adamw(m, lambda s: 0.0,
                                                 lambda s: 0.0),
                      TrainerConfig(log_every=10**9), device=device)
    # drop_remainder=False: evaluate the WHOLE split, as the in-loop eval
    metrics = trainer.evaluate(src.batches(args.batch_size, shuffle=False,
                                           drop_remainder=False))
    print(json.dumps({k: float(v) for k, v in metrics.items()}))
    return metrics


# the JAX commands' refusals of a ViT/ConvNeXt backbone, word for word
_NOT_EFFICIENTNET = {
    "import-checkpoint": (
        "import-checkpoint: reference cv/multimodal checkpoints are timm "
        "EfficientNets (cv_classifier_train_daodian.py:190) — pass an "
        "efficientnet_* backbone. ViT/ConvNeXt towers train from scratch "
        "or import timm weights via "
        "hf_import.{vit,convnext}_params_from_timm."),
    "export-checkpoint": (
        "export-checkpoint: ViT/ConvNeXt backbones have no reference "
        "equivalent (the reference CvClassifier requires a timm CNN with a "
        ".classifier head, cv_classifier.py:24) — only EfficientNet "
        "checkpoints export."),
}


def _image_config(args, command: str):
    """The EfficientNet config of ``--backbone``; ViT and ConvNeXt are
    refused with the JAX command's message (the reference's image models
    are timm EfficientNets)."""
    from multimodalsimilar_tpu_torch.models.efficientnet import (
        EfficientNetConfig)
    if args.backbone.startswith(("vit", "convnext")):
        raise SystemExit(_NOT_EFFICIENTNET[command])
    return EfficientNetConfig.variant(args.backbone)


def _model_for(kind: str, bert, image, sd):
    """The port's module of ``kind`` (``bert`` and ``image`` configs),
    sized from ``sd`` (head widths), to load ``sd`` into strictly."""
    from multimodalsimilar_tpu_torch.models.classifiers import (
        NlpMultilabelClassifier, NlpTextClassifier, SiamesePairModel)
    from multimodalsimilar_tpu_torch.models.multimodal import (
        MultimodalClassifier)
    from multimodalsimilar_tpu_torch.models.vision import CvImageClassifier
    if kind == "nlp":
        return NlpTextClassifier(bert, num_labels=sd["head.weight"].shape[0])
    if kind == "multilabel":
        return NlpMultilabelClassifier(
            bert, *(sd[f"{h}_head.weight"].shape[0]
                    for h in ("lv1", "lv2", "tag")))
    if kind == "siamese":
        return SiamesePairModel(bert)
    if kind == "cv":
        return CvImageClassifier(image, sd["head.weight"].shape[0],
                                 fc_dim=sd["fc.weight"].shape[0])
    return MultimodalClassifier(bert, image, sd["head.weight"].shape[0],
                                fc_dim=sd["cv.fc.weight"].shape[0])


def cmd_import_checkpoint(args, device="cuda"):
    """Migrate a reference torch checkpoint (a state_dict .pt) into a port
    checkpoint at step 0 that every command here reads. The state_dict is
    loaded strictly into the port's module built from the flags, so a
    wrong ``--bert_preset`` or ``--backbone`` fails here.

    For whole-module pickles (torch.save(model)), first extract the
    state_dict with the reference code importable:
        torch.save(torch.load('model.pt').state_dict(), 'sd.pt')
    """
    import torch
    from multimodalsimilar_tpu_torch.models import reference_import as ri
    from multimodalsimilar_tpu_torch.train.checkpoint import CheckpointManager

    del device       # a checkpoint is written from host tensors
    if args.kind not in _KINDS:
        raise SystemExit(f"unknown kind {args.kind}")
    if getattr(args, "pipeline_parallel", 0) and args.kind == "cv":
        # --pipeline_parallel is accepted for the text kinds: the port's
        # checkpoints are in the one-card layout, which a pipeline-parallel
        # run loads as it is (each rank keeps its stage)
        raise SystemExit(
            "import-checkpoint: --pipeline_parallel shards the BERT "
            "layer stack; --kind cv has no text tower, so the flag "
            "would have no effect. Drop it (train cv refuses it too).")
    ref = torch.load(args.state_dict, map_location="cpu", weights_only=True)
    bert = _bert_config(args.bert_preset)
    image = (_image_config(args, "import-checkpoint")
             if args.kind in ("cv", "multimodal") else None)
    if args.kind == "nlp":
        sd = ri.nlp_classifier_from_reference(ref, bert)
    elif args.kind == "multilabel":
        sd = ri.multilabel_classifier_from_reference(ref, bert)
    elif args.kind == "siamese":
        sd = ri.siamese_from_reference(ref, bert)
    elif args.kind == "cv":
        sd = ri.cv_classifier_from_reference(ref, image)
    else:
        sd = ri.multimodal_from_reference(ref, bert, image)
    _model_for(args.kind, bert, image, sd).load_state_dict(sd)  # strict
    ckpt = CheckpointManager(args.out)
    # importing step 0 into a directory holding a previous run's LATER
    # steps would be silently shadowed (restore picks the latest step)
    existing = ckpt.latest_step()
    if existing is not None and not args.overwrite:
        raise SystemExit(
            f"import-checkpoint: {args.out} already holds checkpoints "
            f"(latest step {existing}); the imported step-0 weights would "
            f"be shadowed by them on restore. Pass --overwrite to clear "
            f"the directory, or use a fresh --out.")
    if existing is not None:
        ckpt.clear()
    ckpt.save(0, {"step": 0, "model": sd}, force=True)
    print(json.dumps({"imported": args.kind, "out": args.out}))


def cmd_export_checkpoint(args, device="cuda"):
    """The inverse of import-checkpoint: the latest port checkpoint under
    ``--checkpoint`` as a reference-layout torch state_dict (.pt) that the
    reference's own modules load with load_state_dict(strict=True)."""
    import torch
    from multimodalsimilar_tpu_torch.models import reference_export as re_
    from multimodalsimilar_tpu_torch.train.checkpoint import CheckpointManager

    del device
    if args.kind not in _KINDS:
        raise SystemExit(f"unknown kind {args.kind}")
    image = (_image_config(args, "export-checkpoint")
             if args.kind in ("cv", "multimodal") else None)
    state = CheckpointManager(args.checkpoint).restore()
    if state is None:
        raise SystemExit(f"no checkpoint found at {args.checkpoint}")
    sd = state["model"]
    bert = _bert_config(args.bert_preset)
    if args.kind == "nlp":
        out = re_.nlp_classifier_to_reference(sd, bert)
    elif args.kind == "multilabel":
        out = re_.multilabel_classifier_to_reference(sd, bert)
    elif args.kind == "siamese":
        out = re_.siamese_to_reference(sd, bert)
    elif args.kind == "cv":
        out = re_.cv_classifier_to_reference(sd, image)
    else:
        out = re_.multimodal_to_reference(sd, bert, image)
    torch.save(out, args.out)
    print(json.dumps({"exported": args.kind, "out": args.out,
                      "tensors": len(out)}))
