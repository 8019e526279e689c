"""Weight carry-over from the JAX package's parameter trees.

Each function reads a Flax tree (nested dicts of arrays) and returns a
``state_dict`` for the port's counterpart; only numpy is needed to read
the tree.

* ``text_classifier_from_jax``: ``NlpTextClassifier``
  (``params["tower"]["encoder"]``, the layout that
  ``multimodalsimilar_tpu/models/hf_import.py:bert_params_from_torch``
  writes, read in reverse).
* ``multilabel_classifier_from_jax`` and ``siamese_pair_from_jax``:
  ``NlpMultilabelClassifier`` (the tower and the three heads) and
  ``SiamesePairModel`` (the tower and the 2-way ``classifier``).
* ``efficientnet_from_jax``: ``EfficientNet``, the reverse of
  ``hf_import.py:efficientnet_params_from_timm`` (HWIO kernels become
  OIHW; the depthwise [k, k, 1, C] becomes [C, 1, k, k] by the same
  permutation). A folded tree (``fold_bn.py:fold_cv_classifier`` output)
  carries over into a ``folded`` config.
* ``image_tower_from_jax``, ``cv_classifier_from_jax`` and
  ``multimodal_classifier_from_jax``: the image tower (backbone, optional
  BatchNorm), the image classifier (backbone, fc, neck BatchNorm, head)
  and the fused classifier (its ``cv`` and ``nlp`` sub-classifiers and
  its head).
* ``fasttext_from_jax``: a ``FastTextClassifier`` from a JAX model's
  numpy ``{"input", "output"}`` tables, its vocab's word -> id table and
  bucket, its labels and its ``dim`` / ``word_ngrams`` / ``max_tokens``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from multimodalsimilar_tpu_torch.models.bert import BertConfig
from multimodalsimilar_tpu_torch.models.efficientnet import (
    EfficientNetConfig, round_repeats)


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


def multilabel_classifier_from_jax(params: Mapping, config: BertConfig
                                   ) -> Dict[str, torch.Tensor]:
    """JAX ``NlpMultilabelClassifier`` params -> the port's state_dict: the
    tower as ``text_classifier_from_jax`` reads it, and the [C, D] weights
    of ``lv1_head``, ``lv2_head`` and ``tag_head`` as they are."""
    sd = text_classifier_from_jax(params, config)
    for head in ("lv1_head", "lv2_head", "tag_head"):
        sd[f"{head}.weight"] = _t(params[head]["weight"])
    return sd


def siamese_pair_from_jax(params: Mapping, config: BertConfig
                          ) -> Dict[str, torch.Tensor]:
    """JAX ``SiamesePairModel`` params -> the port's state_dict: the tower,
    and the ``classifier`` Dense [3H, 2] as a Linear [2, 3H]."""
    sd = text_classifier_from_jax(params, config)
    sd["classifier.weight"] = _t(np.asarray(params["classifier"]["kernel"]).T)
    sd["classifier.bias"] = _t(params["classifier"]["bias"])
    return sd


def _bn_entries(sd: Dict[str, torch.Tensor], name: str, p: Mapping,
                s: Mapping) -> None:
    """A Flax BatchNorm (``scale``/``bias`` params, ``mean``/``var``
    statistics) as torch ``BatchNorm`` entries under ``name``."""
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])
    sd[f"{name}.running_mean"] = _t(s["mean"])
    sd[f"{name}.running_var"] = _t(s["var"])
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def efficientnet_from_jax(params: Mapping, batch_stats: Mapping,
                          cfg: EfficientNetConfig, prefix: str = ""
                          ) -> Dict[str, torch.Tensor]:
    """JAX ``EfficientNet`` (params, batch_stats) -> the port's
    ``EfficientNet`` state_dict, keys under ``prefix``. With
    ``cfg.folded`` every conv carries its bias and there is no BN."""
    sd: Dict[str, torch.Tensor] = {}

    def conv(name, p):
        sd[f"{prefix}{name}.weight"] = _t(
            np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in p:
            sd[f"{prefix}{name}.bias"] = _t(p["bias"])

    def pair(name, bn, p, s):
        conv(name, p[name])
        if not cfg.folded:
            _bn_entries(sd, f"{prefix}{bn}", p[bn], s[bn])

    pair("conv_stem", "bn1", params, batch_stats)
    for st, (expand, _, repeats, _, _) in enumerate(cfg.stages):
        for i in range(round_repeats(repeats, cfg.depth_mult)):
            jp = params[f"blocks_{st}_{i}"]
            js = batch_stats.get(f"blocks_{st}_{i}", {})
            t = f"blocks.{st}.{i}"
            order = ((("conv_pw", "bn1"), ("conv_dw", "bn2"),
                      ("conv_pwl", "bn3")) if expand != 1 else
                     (("conv_dw", "bn1"), ("conv_pw", "bn2")))
            for c, b in order:
                conv(f"{t}.{c}", jp[c])
                if not cfg.folded:
                    _bn_entries(sd, f"{prefix}{t}.{b}", jp[b], js[b])
            for name in ("conv_reduce", "conv_expand"):
                conv(f"{t}.se.{name}", jp["se"][name])
    pair("conv_head", "bn2", params, batch_stats)
    return sd


def image_tower_from_jax(variables: Mapping, cfg: EfficientNetConfig
                         ) -> Dict[str, torch.Tensor]:
    """JAX ``ImageTower`` variables -> the port's ``ImageTower``
    state_dict (the backbone, and ``bn_layer`` when the tower has one)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd = efficientnet_from_jax(params["backbone"],
                               stats.get("backbone", {}), cfg,
                               prefix="backbone.")
    if "bn_layer" in params:
        _bn_entries(sd, "bn_layer", params["bn_layer"], stats["bn_layer"])
    return sd


def cv_classifier_from_jax(variables: Mapping, cfg: EfficientNetConfig
                           ) -> Dict[str, torch.Tensor]:
    """JAX ``CvImageClassifier`` variables (``params`` and
    ``batch_stats``) -> the port's ``CvImageClassifier`` state_dict: the
    backbone, ``fc`` (Dense [in, out] -> Linear [out, in]), the neck
    ``bn`` with its statistics, and the ArcFace ``head`` when the tree has
    one."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd = efficientnet_from_jax(params["backbone"],
                               stats.get("backbone", {}), cfg,
                               prefix="backbone.")
    if "fc" in params:
        sd["fc.weight"] = _t(np.asarray(params["fc"]["kernel"]).T)
        sd["fc.bias"] = _t(params["fc"]["bias"])
        _bn_entries(sd, "bn", params["bn"], stats["bn"])
    if "head" in params:
        sd["head.weight"] = _t(params["head"]["weight"])
    return sd


def multimodal_classifier_from_jax(variables: Mapping,
                                   text_config: BertConfig,
                                   image_config: EfficientNetConfig
                                   ) -> Dict[str, torch.Tensor]:
    """JAX ``MultimodalClassifier`` variables -> the port's
    ``MultimodalClassifier`` state_dict: ``cv.*`` through
    ``cv_classifier_from_jax``, ``nlp.*`` through
    ``text_classifier_from_jax`` and the fused ``head`` (the sub-towers'
    heads never run, so the JAX tree holds none)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    cv = cv_classifier_from_jax(
        {"params": params["cv"], "batch_stats": stats.get("cv", {})},
        image_config)
    nlp = text_classifier_from_jax(params["nlp"], text_config)
    sd = {f"cv.{k}": v for k, v in cv.items()}
    sd.update({f"nlp.{k}": v for k, v in nlp.items()})
    sd["head.weight"] = _t(params["head"]["weight"])
    return sd


def fasttext_from_jax(params: Mapping, words: Mapping[str, int], bucket: int,
                      labels: Sequence, dim: int, word_ngrams: int = 2,
                      max_tokens: int = 64, min_count: int = 1,
                      device="cuda"):
    """The port's ``FastTextClassifier`` with a JAX model's weights: the
    vocab ids, and so every sentence vector, stay as they were."""
    from multimodalsimilar_tpu_torch.models.fasttext import (
        FastTextClassifier, FastTextVocab)
    vocab = FastTextVocab(dict(words), int(bucket), int(min_count))
    tables = {name: _t(params[name]) for name in ("input", "output")}
    if tables["input"].shape != (vocab.size, dim) \
            or tables["output"].shape != (len(labels), dim):
        raise ValueError(f"tables {[tuple(t.shape) for t in tables.values()]}"
                         f" do not fit {vocab.size} ids, {len(labels)} "
                         f"labels and dim {dim}")
    return FastTextClassifier(vocab, tables, list(labels), dim,
                              word_ngrams, max_tokens, device=device)
