"""Task adapters: bind a model to its loss and eval logic for the Trainer
(counterpart of multimodalsimilar_tpu/train/tasks.py).

A ``Task`` holds the model and two functions of a device batch:
``train_loss(batch, margin) -> (loss, {"loss", "acc"})`` and
``eval_metrics(batch) -> {"acc", "loss"}``. The Trainer puts the model in
``train()`` or ``eval()`` mode around them.

* ``text_arcface_task`` <- nlp_classifier_train*.py (CE over margin logits)

The multilabel, cv, multimodal and pair tasks come with later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F

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


def text_arcface_task(model, fused_loss: bool = False,
                      loss_tile_c: int = 1024,
                      num_valid: int = None) -> Task:
    """CE over the head's margin logits; eval CE is taken on s * cosine
    (forward_test returns the raw cosine; the reference evaluates CE at
    the model's own logit scale). ``num_valid``: true class count when the
    head is padded (see ``_mask_pad``)."""
    if fused_loss:
        raise NotImplementedError(
            "fused_loss streams ArcFace+CE over class tiles "
            "(multimodalsimilar_tpu/ops/arcface_loss.py), which is not "
            "ported yet")

    def train_loss(batch: Batch, margin: float):
        logits = _mask_pad(model(**_text_inputs(batch),
                                 label=batch["labels"], m=margin),
                           num_valid)
        loss = _ce(logits, batch["labels"])
        return loss, {"loss": loss.detach(),
                      "acc": _acc(logits.detach(), batch["labels"])}

    def eval_metrics(batch: Batch):
        logits = _mask_pad(model(**_text_inputs(batch), is_test=True),
                           num_valid)
        return {"acc": _acc(logits, batch["labels"]),
                "loss": _ce(model.arcface.s * logits, batch["labels"])}

    return Task(model, train_loss, eval_metrics)
