"""Trainer assembly of ``train nlp`` (counterpart of the helpers of
multimodalsimilar_tpu/cli/train.py: ``_opt_step_units``, ``_trainer``,
``_sampler_fn``), taking a device where the JAX package takes a mesh.

The command line itself (``cmd_train_nlp`` and its parser) comes with the
port's CLI; until then a caller builds an ``argparse.Namespace`` with the
flag values (see ``configs/train_nlp_v2.yaml``). Flags whose code is not
ported raise here instead of being ignored.
"""

from __future__ import annotations

import os

from multimodalsimilar_tpu_torch.data.datasets import column

# flag -> the value that leaves it off; anything else is not ported yet
_NOT_PORTED = {"optimizer": "adamw", "scheduler": "linear", "grad_accum": 1,
               "profile": None, "model_parallel": 1, "tensor_parallel": False,
               "sequence_parallel": False, "pipeline_parallel": 0,
               "bf16_grads": False, "fused_loss": False}


def _check_ported(args) -> None:
    bad = {k: getattr(args, k) for k, off in _NOT_PORTED.items()
           if getattr(args, k, off) != off}
    if bad:
        raise NotImplementedError(
            f"flags {bad} are not ported to the PyTorch trainer yet")


def _opt_step_units(args, steps_per_epoch):
    """(accum, optimizer steps per epoch, total optimizer steps).
    Schedules advance once per optimizer step."""
    accum = int(getattr(args, "grad_accum", 1) or 1)
    per_epoch = max(steps_per_epoch // accum, 1)
    return accum, per_epoch, args.epochs * per_epoch


def _trainer(task, args, steps_per_epoch, device="cuda"):
    """The dual-group AdamW (tower and head groups, each with its own
    linear schedule and weight decay) and the Trainer of ``args``;
    checkpoints and ``metrics.jsonl`` go under ``args.output``."""
    from multimodalsimilar_tpu_torch.train.optim import (
        dual_group_adamw, linear_schedule_with_warmup)
    from multimodalsimilar_tpu_torch.train.trainer import (Trainer,
                                                           TrainerConfig)
    _check_ported(args)
    _, _, total = _opt_step_units(args, steps_per_epoch)
    tower_sched = linear_schedule_with_warmup(
        args.tower_lr, getattr(args, "tower_warmup_frac", 0.0) * total,
        total)
    head_sched = linear_schedule_with_warmup(
        args.head_lr, args.head_warmup_frac * total, total)

    def make_optimizer(model):
        return dual_group_adamw(model, tower_sched, head_sched,
                                weight_decay=args.weight_decay,
                                head_weight_decay=args.head_weight_decay)

    cfg = TrainerConfig(
        eval_every=args.eval_every, save_every=args.save_every,
        log_every=args.log_every,
        margin_init=args.margin,
        margin_delta_per_epoch=args.margin_delta_per_epoch,
        checkpoint_dir=os.path.join(args.output, "ckpt"),
        metrics_path=os.path.join(args.output, "metrics.jsonl"),
        overwrite=getattr(args, "overwrite", False),
        async_save=getattr(args, "async_save", False),
        seed=args.seed)
    os.makedirs(args.output, exist_ok=True)
    return Trainer(task, make_optimizer, cfg, device=device)


def _sampler_fn(args, table, label_col):
    """Class-balanced replacement sampling per epoch (the _v2 recipes'
    WeightedRandomSampler), or None without ``weighted_sampling``."""
    if not args.weighted_sampling:
        return None
    from multimodalsimilar_tpu_torch.data.sampling import (
        WeightedSampler, class_balance_weights)
    w = class_balance_weights(column(table, label_col))
    return lambda epoch: WeightedSampler(w, seed=args.seed + epoch)
