"""How far the training policy's bf16 products move EfficientNet-B4's first
gradients from full precision, in the JAX package and in the port, from
the same weights and batch: the cv recipe's model (B4, fc 512, 4,181
ArcFace classes, margin 0.2) in train() mode, dropout and drop-path off,
on the CPU.

    JAX_PLATFORMS=cpu python tests/torch_b4_rounding.py [--size 64] \
        [--batch 8] [--seed 0]

Prints one JSON line. Each comparison gives, over the model's gradients,
the largest difference of a tensor from the other side's as a share of
that tensor's largest entry there (floored at 1e-4 of the model's
largest gradient, as the parity tests floor it), its median over the
tensors, and the worst tensors:

* ``jax_bf16_vs_jax_f32`` and ``port_bf16_vs_port_f32``: what bf16
  rounding does to each package's gradients;
* ``port_f32_vs_jax_f32``: the two packages in full precision (the
  same computation summed in another order);
* ``port_bf16_vs_jax_bf16``: the two packages under the training policy.

Where the port rounded where JAX does not, or the other way round, the
last would stand far above the first two.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from multimodalsimilar_tpu.models import efficientnet as JE  # noqa: E402
from multimodalsimilar_tpu.models.vision import (  # noqa: E402
    CvImageClassifier as JCvImageClassifier)
from multimodalsimilar_tpu.train import tasks as JT  # noqa: E402
from multimodalsimilar_tpu.utils.dtypes import (  # noqa: E402
    DTypePolicy as JPolicy)
from multimodalsimilar_tpu_torch.models import efficientnet as E  # noqa: E402
from multimodalsimilar_tpu_torch.models.convert import (  # noqa: E402
    cv_classifier_from_jax)
from multimodalsimilar_tpu_torch.models.vision import (  # noqa: E402
    CvImageClassifier)
from multimodalsimilar_tpu_torch.train.tasks import (  # noqa: E402
    cv_arcface_task)
from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy  # noqa: E402

CLASSES, FC, MARGIN = 4_181, 512, 0.2


class _NoDropCv(JCvImageClassifier):
    """The JAX image classifier with the neck's dropout off in train
    mode."""

    def predict_emb(self, images, train=False, deterministic=None):
        return super().predict_emb(images, train=train, deterministic=True)


def jax_grads(cfg, policy, variables, batch) -> dict:
    """The JAX task's first gradients, in the port's names."""
    task = JT.cv_arcface_task(_NoDropCv(cfg, num_labels=CLASSES,
                                        fc_dim=FC, policy=policy))

    def loss_fn(p):
        return task.train_loss(p, variables["batch_stats"], batch,
                               jax.random.key(0), MARGIN)[0]

    grads = jax.device_get(jax.jit(jax.grad(loss_fn))(variables["params"]))
    return cv_classifier_from_jax({"params": grads,
                                   "batch_stats": variables["batch_stats"]},
                                  cfg)


def port_grads(cfg, policy, state, batch) -> dict:
    model = CvImageClassifier(cfg, num_labels=CLASSES, fc_dim=FC,
                              policy=policy)
    model.load_state_dict(state)
    model.dropout.p = 0.0
    model.train()
    loss, _ = cv_arcface_task(model).train_loss(
        {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()},
        MARGIN)
    loss.backward()
    return {n: p.grad for n, p in model.named_parameters()}


def gap(got: dict, want: dict) -> dict:
    names = [n for n in want if n in got and not n.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]
    top = max(float(want[n].abs().max()) for n in names)
    rel = sorted(((float((got[n] - want[n]).abs().max())
                   / max(float(want[n].abs().max()), 1e-4 * top), n)
                  for n in names), reverse=True)
    return {"max": rel[0][0], "median": float(np.median([r for r, _ in rel])),
            "worst": [[n, r] for r, n in rel[:5]], "tensors": len(rel)}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--size", type=int, default=64)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    a = parser.parse_args(argv)
    jax.config.update("jax_platforms", "cpu")
    jcfg = JE.EfficientNetConfig.b4(drop_path_rate=0.0)
    cfg = dataclasses.replace(E.EfficientNetConfig.b4(), drop_path_rate=0.0)
    rng = np.random.default_rng(a.seed)
    batch = {"images": rng.integers(0, 256, (a.batch, a.size, a.size, 3)
                                    ).astype(np.uint8),
             "labels": rng.integers(0, CLASSES, a.batch).astype(np.int32)}
    init = JCvImageClassifier(jcfg, num_labels=CLASSES, fc_dim=FC,
                              policy=JPolicy.full_precision())
    variables = jax.device_get(jax.jit(lambda x, y: init.init(
        {"params": jax.random.key(a.seed)}, x, label=y))(
        jnp.asarray(batch["images"], jnp.float32),
        jnp.asarray(batch["labels"])))
    state = cv_classifier_from_jax(variables, cfg)
    got = {}
    for tag, jpol, pol in (("f32", JPolicy.full_precision(),
                            DTypePolicy.full_precision()),
                           ("bf16", JPolicy(), DTypePolicy())):
        got[f"jax_{tag}"] = jax_grads(jcfg, jpol, variables, batch)
        got[f"port_{tag}"] = port_grads(cfg, pol, state, batch)
    print(json.dumps({
        "size": a.size, "batch": a.batch, "seed": a.seed,
        "jax_bf16_vs_jax_f32": gap(got["jax_bf16"], got["jax_f32"]),
        "port_bf16_vs_port_f32": gap(got["port_bf16"], got["port_f32"]),
        "port_f32_vs_jax_f32": gap(got["port_f32"], got["jax_f32"]),
        "port_bf16_vs_jax_bf16": gap(got["port_bf16"], got["jax_bf16"])}))


if __name__ == "__main__":
    main()
