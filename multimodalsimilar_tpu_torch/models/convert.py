"""Weight carry-over from the JAX package's parameter trees.

``text_classifier_from_jax`` reads the Flax ``NlpTextClassifier`` tree
(``params["tower"]["encoder"]``, the layout that
``multimodalsimilar_tpu/models/hf_import.py:bert_params_from_torch``
writes) in reverse and returns a ``state_dict`` for the port's
``NlpTextClassifier``. Only numpy is needed to read the tree.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from multimodalsimilar_tpu_torch.models.bert import BertConfig


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def text_classifier_from_jax(params: Mapping, config: BertConfig
                             ) -> Dict[str, torch.Tensor]:
    """JAX ``NlpTextClassifier`` params (``variables["params"]``) -> the
    port's ``NlpTextClassifier`` state_dict.

    Flax Dense kernels are [in, out] and become torch [out, in]; attention
    q/k/v kernels [in, heads, head_dim] and the output kernel
    [heads, head_dim, out] flatten back to [H, H]. The ArcFace head's
    ``params["head"]["weight"]`` is [C, D] in both packages and carries
    over as it is, when the tree has it."""
    enc = params["tower"]["encoder"]
    H = config.hidden_size
    sd: Dict[str, torch.Tensor] = {}

    def lin(name, p, kernel_2d):
        sd[f"tower.encoder.{name}.weight"] = _t(np.asarray(kernel_2d).T)
        sd[f"tower.encoder.{name}.bias"] = _t(np.asarray(p["bias"])
                                              .reshape(-1))

    def ln(name, p):
        sd[f"tower.encoder.{name}.weight"] = _t(p["scale"])
        sd[f"tower.encoder.{name}.bias"] = _t(p["bias"])

    for n in ("word", "position", "token_type"):
        sd[f"tower.encoder.embeddings.{n}_embeddings.weight"] = _t(
            enc[f"{n}_embeddings"]["embedding"])
    ln("embeddings.LayerNorm", enc["embeddings_norm"])
    for i in range(config.num_layers):
        p = enc[f"layer_{i}"]
        att = p["attention"]
        if "qkv" in att:
            raise ValueError("fused_qkv checkpoints are not ported")
        t = f"encoder.layer.{i}"
        for n in ("query", "key", "value"):
            lin(f"{t}.attention.self.{n}", att[n],
                np.asarray(att[n]["kernel"]).reshape(H, H))
        lin(f"{t}.attention.output.dense", att["out"],
            np.asarray(att["out"]["kernel"]).reshape(H, H))
        ln(f"{t}.attention.output.LayerNorm", p["attention_norm"])
        lin(f"{t}.intermediate.dense", p["intermediate"],
            p["intermediate"]["kernel"])
        lin(f"{t}.output.dense", p["output"], p["output"]["kernel"])
        ln(f"{t}.output.LayerNorm", p["output_norm"])
    lin("pooler.dense", enc["pooler"], enc["pooler"]["kernel"])
    if "head" in params:
        sd["head.weight"] = _t(params["head"]["weight"])
    return sd
