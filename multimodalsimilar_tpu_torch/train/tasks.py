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
tiles (``ops/arcface_loss.py``): the [B, C] logits never exist.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F

from multimodalsimilar_tpu_torch.models.vision import (device_normalize,
                                                       to_nchw)
from multimodalsimilar_tpu_torch.ops.arcface_loss import (arcface_ce_loss,
                                                          cosine_argmax)

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Task:
    model: Any
    train_loss: Callable
    eval_metrics: Callable
    # False for tasks whose loss ignores the Trainer's margin; the Trainer
    # refuses a margin curriculum for them
    dynamic_margin: bool = True


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits.float(), labels.long())


def _acc(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (torch.argmax(logits, -1) == labels.long()).float().mean()


def _mask_pad(logits: torch.Tensor, num_valid) -> torch.Tensor:
    """Pad classes (a head widened past the true class count) become
    -inf: softmax weight 0, never the argmax."""
    if num_valid is None or num_valid >= logits.shape[-1]:
        return logits
    col = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(col < num_valid, logits, float("-inf"))


def _text_inputs(batch: Batch) -> dict:
    return dict(input_ids=batch["input_ids"],
                attention_mask=batch.get("attention_mask"),
                token_type_ids=batch.get("token_type_ids"))


def _fused_head_loss(emb, weight, labels, margin, af, tile_c):
    return torch.mean(arcface_ce_loss(emb, weight, labels, margin, af.s,
                                      af.easy_margin, tile_c))


def _fused_acc(emb, weight, labels, tile_c):
    return (cosine_argmax(emb, weight, tile_c) == labels.long()
            ).float().mean()


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
            "classes")

    def train_loss(batch: Batch, margin: float):
        labels = batch["labels"]
        if fused_loss:
            emb = model.predict_emb(**_text_inputs(batch))
            w = model.head.weight
            loss = _fused_head_loss(emb, w, labels, margin, model.arcface,
                                    loss_tile_c)
            return loss, {"loss": loss.detach(),
                          "acc": _fused_acc(emb, w, labels, loss_tile_c)}
        logits = _mask_pad(model(**_text_inputs(batch), label=labels,
                                 m=margin), num_valid)
        loss = _ce(logits, labels)
        return loss, {"loss": loss.detach(),
                      "acc": _acc(logits.detach(), labels)}

    def eval_metrics(batch: Batch):
        logits = _mask_pad(model(**_text_inputs(batch), is_test=True),
                           num_valid)
        return {"acc": _acc(logits, batch["labels"]),
                "loss": _ce(model.arcface.s * logits, batch["labels"])}

    return Task(model, train_loss, eval_metrics)


_LEVELS = ("lv1", "lv2", "tag")


def multilabel_arcface_task(model, weights=(10.0, 5.0, 1.0),
                            fused_loss: bool = False,
                            loss_tile_c: int = 1024) -> Task:
    """Weighted three-head loss, v3_dist.py:164-166 semantics: each head
    trains at its own fixed margin, so the task ignores the Trainer's
    margin (``dynamic_margin=False``). ``fused_loss=True`` computes each
    head's ArcFace+CE blockwise on the shared embedding."""

    def train_loss(batch: Batch, margin: float):
        if fused_loss:
            emb = model.predict_emb(**_text_inputs(batch))
            loss = 0.0
            for w_loss, lv in zip(weights, _LEVELS):
                af = getattr(model, f"{lv}_arcface")
                loss = loss + w_loss * _fused_head_loss(
                    emb, getattr(model, f"{lv}_head").weight,
                    batch[f"{lv}_label"], af.m, af, loss_tile_c)
            acc = _fused_acc(emb, model.tag_head.weight, batch["tag_label"],
                             loss_tile_c)
            return loss, {"loss": loss.detach(), "acc": acc}
        logits = model(**_text_inputs(batch),
                       **{f"{lv}_label": batch[f"{lv}_label"]
                          for lv in _LEVELS})
        loss = sum(w * _ce(lg, batch[f"{lv}_label"])
                   for w, lg, lv in zip(weights, logits, _LEVELS))
        return loss, {"loss": loss.detach(),
                      "acc": _acc(logits[2].detach(), batch["tag_label"])}

    def eval_metrics(batch: Batch):
        l1, l2, lt = model(**_text_inputs(batch), is_test=True)
        return {"acc": _acc(lt, batch["tag_label"]),
                "lv1_acc": _acc(l1, batch["lv1_label"]),
                "lv2_acc": _acc(l2, batch["lv2_label"])}

    return Task(model, train_loss, eval_metrics, dynamic_margin=False)


def _images(batch: Batch) -> torch.Tensor:
    """uint8 NHWC images normalized on their device, as NCHW."""
    return to_nchw(device_normalize(batch["images"]))


def _classifier_task(model, inputs) -> Task:
    """CE over margin logits of ``model(*inputs(batch), label=, m=)``;
    eval accuracy on the cosine logits (micro-F1 == accuracy for
    single-label multiclass, cv_classifier_train_daodian.py:173)."""

    def train_loss(batch: Batch, margin: float):
        args, kw = inputs(batch)
        logits = model(*args, **kw, label=batch["labels"], m=margin)
        loss = _ce(logits, batch["labels"])
        return loss, {"loss": loss.detach(),
                      "acc": _acc(logits.detach(), batch["labels"])}

    def eval_metrics(batch: Batch):
        args, kw = inputs(batch)
        return {"acc": _acc(model(*args, **kw, is_test=True),
                            batch["labels"])}

    return Task(model, train_loss, eval_metrics)


def cv_arcface_task(model) -> Task:
    """The image classifier: uint8 batches normalized on the device."""
    return _classifier_task(model, lambda b: ((_images(b),), {}))


def multimodal_arcface_task(model) -> Task:
    """The fused classifier: the batch's images and tokens."""
    return _classifier_task(model, lambda b: ((_images(b),),
                                              _text_inputs(b)))


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
