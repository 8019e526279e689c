"""Task adapters: bind a model to its loss and eval logic for the Trainer
(counterpart of multimodalsimilar_tpu/train/tasks.py).

A ``Task`` holds the model and two functions of a device batch:
``train_loss(batch, margin) -> (loss, {"loss", "acc"})`` and
``eval_metrics(batch) -> {"acc", ...}``. The Trainer puts the model in
``train()`` or ``eval()`` mode around them; BatchNorm statistics are
module buffers that move in ``train()`` mode, so no task carries them.

* ``text_arcface_task``       <- nlp_classifier_train*.py (CE over margin
  logits)
* ``multilabel_arcface_task`` <- nlp_classifier_train_daodian_v3_dist.py
  (weighted 3-head CE, 10/5/1 by default, :79-87; accuracy on the tag
  head, :168-169)
* ``cv_arcface_task``         <- cv_classifier_train*.py
* ``multimodal_arcface_task`` <- multimodal_classifier_train.py
* ``pair_task``               <- nlp_st_train_daodian.py (2-class CE)

``fused_loss=True`` (text and multilabel) streams ArcFace+CE over class
tiles (``ops/arcface_loss.py``): the [B, C] logits never exist; over a
class-sharded head each rank streams its block and the statistics are
combined over the model group.

A head that ``models/heads.py:ArcFaceHead.shard`` cut to this rank's block
of classes (``--model_parallel``) gives [B, C / model] logits: the
cross-entropy takes the row max and the sum of exponentials over the
model group and the target logit from the rank that holds it
(``_ShardedCrossEntropy``), and the accuracy the global argmax, ties to
the lowest class, as the JAX package computes them on the whole row.
``num_valid`` (every task with an ArcFace head) masks the pad classes of
a head widened to a multiple of the model axis.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F

from multimodalsimilar_tpu_torch.models.vision import (device_normalize,
                                                       to_nchw)
from multimodalsimilar_tpu_torch.ops.arcface_loss import (arcface_ce_loss,
                                                          cosine_max)
from multimodalsimilar_tpu_torch.parallel.mesh import (MODEL_AXIS,
                                                       copy_to_group)

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Task:
    model: Any
    train_loss: Callable
    eval_metrics: Callable
    # False for tasks whose loss ignores the Trainer's margin; the Trainer
    # refuses a margin curriculum for them
    dynamic_margin: bool = True


class _ShardedCrossEntropy(torch.autograd.Function):
    """Per-example cross-entropy of logits whose classes lie in blocks on
    the ranks of the model group: ``z`` [B, C / model] (f32) is this
    rank's block, ``target`` [B] the label's column in it or -1. The
    loss, log(sum exp(z - max)) + max - z[label], comes out the same on
    every rank; the backward gives each rank its block of softmax -
    onehot, with no collective."""

    @staticmethod
    def forward(ctx, z, target, mesh):
        zmax = mesh.all_reduce(z.max(dim=1).values, MODEL_AXIS, "max")
        e = torch.exp(z - zmax[:, None])
        total = mesh.all_reduce(e.sum(dim=1), MODEL_AXIS)
        hit = target >= 0
        picked = torch.gather(z, 1, target.clamp(min=0).long()[:, None])
        t = mesh.all_reduce(torch.where(hit, picked[:, 0],
                                        torch.zeros_like(zmax)), MODEL_AXIS)
        ctx.save_for_backward(e / total[:, None], target)
        return torch.log(total) + zmax - t

    @staticmethod
    def backward(ctx, grad):
        p, target = ctx.saved_tensors
        onehot = torch.zeros_like(p)
        rows = torch.nonzero(target >= 0)[:, 0]
        onehot[rows, target[rows].long()] = 1.0
        return (p - onehot) * grad[:, None], None, None


def _sharded(head) -> bool:
    return head is not None and head.mesh is not None


def _ce(logits: torch.Tensor, labels: torch.Tensor,
        head=None) -> torch.Tensor:
    if not _sharded(head):
        return F.cross_entropy(logits.float(), labels.long())
    return _ShardedCrossEntropy.apply(
        logits.float(), head.local_labels(labels.long()), head.mesh).mean()


def _argmax(logits: torch.Tensor, head=None) -> torch.Tensor:
    """The argmax class of each row, ties to the lowest class; over every
    rank's block for a class-sharded head."""
    if not _sharded(head):
        return torch.argmax(logits, -1)
    mesh = head.mesh
    best = logits.float().amax(dim=-1)
    col = torch.argmax(logits.float(), dim=-1)
    top = mesh.all_reduce(best.clone(), MODEL_AXIS, "max")
    cand = torch.where(best == top, col + head.column_offset,
                       torch.full_like(col, head.num_classes))
    return mesh.all_reduce(cand, MODEL_AXIS, "min")


def _acc(logits: torch.Tensor, labels: torch.Tensor,
         head=None) -> torch.Tensor:
    return (_argmax(logits, head) == labels.long()).float().mean()


def _mask_pad(logits: torch.Tensor, num_valid, head=None) -> torch.Tensor:
    """Pad classes (a head widened past the true class count) become
    -inf: softmax weight 0, never the argmax."""
    first, width = ((head.column_offset, head.num_classes)
                    if _sharded(head) else (0, logits.shape[-1]))
    if num_valid is None or num_valid >= width:
        return logits
    col = first + torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(col < num_valid, logits, float("-inf"))


def _text_inputs(batch: Batch) -> dict:
    return dict(input_ids=batch["input_ids"],
                attention_mask=batch.get("attention_mask"),
                token_type_ids=batch.get("token_type_ids"))


def _fused_head_loss(emb, head, labels, margin, af, tile_c):
    """The mean fused ArcFace+CE of ``head``; a class-sharded head streams
    this rank's block, the embedding entering as the head's forward takes
    it (the blocks' gradients summed over the model group)."""
    if not _sharded(head):
        return torch.mean(arcface_ce_loss(emb, head.weight, labels, margin,
                                          af.s, af.easy_margin, tile_c))
    return torch.mean(arcface_ce_loss(
        copy_to_group(emb, head.mesh), head.weight,
        head.local_labels(labels.long()), margin, af.s, af.easy_margin,
        tile_c, mesh=head.mesh))


def _fused_acc(emb, head, labels, tile_c):
    """Accuracy of the blockwise cosine argmax; over a class-sharded head
    the global argmax, ties to the lowest class."""
    best, col = cosine_max(emb, head.weight, tile_c)
    if _sharded(head):
        mesh = head.mesh
        top = mesh.all_reduce(best.clone(), MODEL_AXIS, "max")
        col = mesh.all_reduce(torch.where(
            best == top, col + head.column_offset,
            torch.full_like(col, head.num_classes)), MODEL_AXIS, "min")
    return (col == labels.long()).float().mean()


def text_arcface_task(model, fused_loss: bool = False,
                      loss_tile_c: int = 1024,
                      num_valid: int = None) -> Task:
    """CE over the head's margin logits; eval CE is taken on s * cosine
    (forward_test returns the raw cosine; the reference evaluates CE at
    the model's own logit scale). ``num_valid``: true class count when the
    head is padded (see ``_mask_pad``); the fused loss cannot mask."""
    if fused_loss and num_valid is not None \
            and num_valid < model.num_labels:
        raise ValueError(
            "--fused_loss streams class tiles and cannot mask padded "
            "classes; drop --fused_loss or pick a --model_parallel that "
            "divides the class count")

    def train_loss(batch: Batch, margin: float):
        labels = batch["labels"]
        if fused_loss:
            emb = model.predict_emb(**_text_inputs(batch))
            loss = _fused_head_loss(emb, model.head, labels, margin,
                                    model.arcface, loss_tile_c)
            return loss, {"loss": loss.detach(),
                          "acc": _fused_acc(emb, model.head, labels,
                                            loss_tile_c)}
        head = model.head
        logits = _mask_pad(model(**_text_inputs(batch), label=labels,
                                 m=margin), num_valid, head)
        loss = _ce(logits, labels, head)
        return loss, {"loss": loss.detach(),
                      "acc": _acc(logits.detach(), labels, head)}

    def eval_metrics(batch: Batch):
        head = model.head
        logits = _mask_pad(model(**_text_inputs(batch), is_test=True),
                           num_valid, head)
        return {"acc": _acc(logits, batch["labels"], head),
                "loss": _ce(model.arcface.s * logits, batch["labels"],
                            head)}

    return Task(model, train_loss, eval_metrics)


_LEVELS = ("lv1", "lv2", "tag")


def multilabel_arcface_task(model, weights=(10.0, 5.0, 1.0),
                            fused_loss: bool = False,
                            loss_tile_c: int = 1024,
                            num_valid=(None, None, None)) -> Task:
    """Weighted three-head loss, v3_dist.py:164-166 semantics: each head
    trains at its own fixed margin, so the task ignores the Trainer's
    margin (``dynamic_margin=False``). ``fused_loss=True`` computes each
    head's ArcFace+CE blockwise on the shared embedding. ``num_valid``:
    the (lv1, lv2, tag) true class counts of padded heads."""
    if fused_loss and any(v is not None for v in num_valid):
        raise ValueError(
            "--fused_loss streams class tiles and cannot mask padded "
            "classes; drop --fused_loss or pick a --model_parallel that "
            "divides every head's class count")

    def heads():
        return [getattr(model, f"{lv}_head") for lv in _LEVELS]

    def train_loss(batch: Batch, margin: float):
        if fused_loss:
            emb = model.predict_emb(**_text_inputs(batch))
            loss = 0.0
            for w_loss, lv in zip(weights, _LEVELS):
                af = getattr(model, f"{lv}_arcface")
                loss = loss + w_loss * _fused_head_loss(
                    emb, getattr(model, f"{lv}_head"),
                    batch[f"{lv}_label"], af.m, af, loss_tile_c)
            acc = _fused_acc(emb, model.tag_head, batch["tag_label"],
                             loss_tile_c)
            return loss, {"loss": loss.detach(), "acc": acc}
        hs = heads()
        logits = [_mask_pad(lg, v, h) for lg, v, h in zip(
            model(**_text_inputs(batch),
                  **{f"{lv}_label": batch[f"{lv}_label"]
                     for lv in _LEVELS}), num_valid, hs)]
        loss = sum(w * _ce(lg, batch[f"{lv}_label"], h)
                   for w, lg, lv, h in zip(weights, logits, _LEVELS, hs))
        return loss, {"loss": loss.detach(),
                      "acc": _acc(logits[2].detach(), batch["tag_label"],
                                  hs[2])}

    def eval_metrics(batch: Batch):
        hs = heads()
        l1, l2, lt = (_mask_pad(lg, v, h) for lg, v, h in zip(
            model(**_text_inputs(batch), is_test=True), num_valid, hs))
        return {"acc": _acc(lt, batch["tag_label"], hs[2]),
                "lv1_acc": _acc(l1, batch["lv1_label"], hs[0]),
                "lv2_acc": _acc(l2, batch["lv2_label"], hs[1])}

    return Task(model, train_loss, eval_metrics, dynamic_margin=False)


def _images(batch: Batch) -> torch.Tensor:
    """uint8 NHWC images normalized on their device, as NCHW."""
    return to_nchw(device_normalize(batch["images"]))


def _classifier_task(model, inputs, num_valid=None) -> Task:
    """CE over margin logits of ``model(*inputs(batch), label=, m=)``;
    eval accuracy on the cosine logits (micro-F1 == accuracy for
    single-label multiclass, cv_classifier_train_daodian.py:173)."""

    def train_loss(batch: Batch, margin: float):
        args, kw = inputs(batch)
        logits = _mask_pad(model(*args, **kw, label=batch["labels"],
                                 m=margin), num_valid, model.head)
        loss = _ce(logits, batch["labels"], model.head)
        return loss, {"loss": loss.detach(),
                      "acc": _acc(logits.detach(), batch["labels"],
                                  model.head)}

    def eval_metrics(batch: Batch):
        args, kw = inputs(batch)
        logits = _mask_pad(model(*args, **kw, is_test=True), num_valid,
                           model.head)
        return {"acc": _acc(logits, batch["labels"], model.head)}

    return Task(model, train_loss, eval_metrics)


def cv_arcface_task(model, num_valid: int = None) -> Task:
    """The image classifier: uint8 batches normalized on the device."""
    return _classifier_task(model, lambda b: ((_images(b),), {}),
                            num_valid)


def multimodal_arcface_task(model, num_valid: int = None) -> Task:
    """The fused classifier: the batch's images and tokens."""
    return _classifier_task(model, lambda b: ((_images(b),),
                                              _text_inputs(b)), num_valid)


_PAIR_INPUTS = ("query_input_ids", "title_input_ids",
                "query_attention_mask", "query_token_type_ids",
                "title_attention_mask", "title_token_type_ids")


def pair_task(model) -> Task:
    """2-class CE on the Siamese pair logits; no margin."""

    def logits_of(batch: Batch):
        return model(**{k: batch.get(k) for k in _PAIR_INPUTS})

    def train_loss(batch: Batch, margin: float):
        logits = logits_of(batch)
        loss = _ce(logits, batch["labels"])
        return loss, {"loss": loss.detach(),
                      "acc": _acc(logits.detach(), batch["labels"])}

    def eval_metrics(batch: Batch):
        logits = logits_of(batch)
        return {"acc": _acc(logits, batch["labels"]),
                "loss": _ce(logits, batch["labels"])}

    return Task(model, train_loss, eval_metrics, dynamic_margin=False)
