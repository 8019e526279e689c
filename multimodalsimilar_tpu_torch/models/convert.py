"""Weight carry-over from the JAX package's parameter trees.

Each function reads a Flax tree (nested dicts of arrays) and returns a
``state_dict`` for the port's counterpart; only numpy is needed to read
the tree.

* ``text_classifier_from_jax``: ``NlpTextClassifier``
  (``params["tower"]["encoder"]``, the layout that
  ``multimodalsimilar_tpu/models/hf_import.py:bert_params_from_torch``
  writes, read in reverse; a ``fused_qkv`` layer's [H, 3, nh, hd] kernel
  and [3, nh, hd] bias split into the three projections; a pipeline-
  parallel tree's stacked ``pp_layers/stack`` unstacked first, by
  ``unstack_layer_params``, this module's numpy copy of the JAX
  function of that name). The other text converters go through it.
* ``multilabel_classifier_from_jax`` and ``siamese_pair_from_jax``:
  ``NlpMultilabelClassifier`` (the tower and the three heads) and
  ``SiamesePairModel`` (the tower and the 2-way ``classifier``).
* ``efficientnet_from_jax``: ``EfficientNet``, the reverse of
  ``hf_import.py:efficientnet_params_from_timm`` (HWIO kernels become
  OIHW; the depthwise [k, k, 1, C] becomes [C, 1, k, k] by the same
  permutation). A folded tree (``fold_bn.py:fold_cv_classifier`` output)
  carries over into a ``folded`` config.
* ``vit_from_jax`` and ``convnext_from_jax``: ``ViT`` and ``ConvNeXt``,
  the reverse of ``hf_import.py:vit_params_from_timm`` (the qkv kernel
  [D, 3, heads, head_dim] becomes timm's packed [3D, D], the proj kernel
  [heads, head_dim, D] a [D, D] Linear) and of
  ``convnext_params_from_timm`` (HWIO kernels become OIHW).
* ``image_tower_from_jax``, ``cv_classifier_from_jax`` and
  ``multimodal_classifier_from_jax``: the image tower (backbone, optional
  BatchNorm), the image classifier (backbone, fc, neck BatchNorm, head)
  and the fused classifier (its ``cv`` and ``nlp`` sub-classifiers and
  its head), over any of the three backbones (``backbone_from_jax``).
* ``fasttext_from_jax``: a ``FastTextClassifier`` from a JAX model's
  numpy ``{"input", "output"}`` tables, its vocab's word -> id table and
  bucket, its labels and its ``dim`` / ``word_ngrams`` / ``max_tokens``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from multimodalsimilar_tpu_torch.models.bert import BertConfig
from multimodalsimilar_tpu_torch.models.convnext import ConvNeXtConfig
from multimodalsimilar_tpu_torch.models.efficientnet import (
    EfficientNetConfig, round_repeats)
from multimodalsimilar_tpu_torch.models.vit import ViTConfig


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _dense(sd: Dict[str, torch.Tensor], name: str, p: Mapping,
           kernel=None) -> None:
    """A Flax Dense as a torch Linear under ``name``: the [in, out]
    ``kernel`` (default ``p["kernel"]``; multi-axis kernels come reshaped
    to 2-D) becomes [out, in], the bias is flattened."""
    k = np.asarray(p["kernel"] if kernel is None else kernel)
    sd[f"{name}.weight"] = _t(k.T)
    sd[f"{name}.bias"] = _t(np.asarray(p["bias"]).reshape(-1))


def _ln(sd: Dict[str, torch.Tensor], name: str, p: Mapping) -> None:
    """A Flax LayerNorm (``scale``, ``bias``) under ``name``."""
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])


def _conv(sd: Dict[str, torch.Tensor], name: str, p: Mapping) -> None:
    """A Flax Conv (HWIO kernel; depthwise [k, k, 1, C]) as a torch Conv2d
    (OIHW; [C, 1, k, k] by the same permutation), with its bias when it
    has one."""
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[f"{name}.bias"] = _t(p["bias"])


def unstack_layer_params(encoder: Mapping) -> dict:
    """A JAX encoder tree in the pipeline-parallel layout (``pp_layers``:
    ``{"stack": tree with a leading [L] axis}``) in the sequential one
    (``layer_0`` .. ``layer_{L-1}``); any other tree as it is (JAX
    ``models/bert.py:unstack_layer_params``)."""
    if "pp_layers" not in encoder:
        return dict(encoder)
    out = {k: v for k, v in encoder.items() if k != "pp_layers"}
    stack = encoder["pp_layers"]["stack"]

    def take(tree, i):
        if isinstance(tree, Mapping):
            return {k: take(v, i) for k, v in tree.items()}
        return np.asarray(tree)[i]

    first = stack
    while isinstance(first, Mapping):
        first = next(iter(first.values()))
    for i in range(np.asarray(first).shape[0]):
        out[f"layer_{i}"] = take(stack, i)
    return out


def text_classifier_from_jax(params: Mapping, config: BertConfig
                             ) -> Dict[str, torch.Tensor]:
    """JAX ``NlpTextClassifier`` params (``variables["params"]``) -> the
    port's ``NlpTextClassifier`` state_dict.

    Flax Dense kernels are [in, out] and become torch [out, in]; attention
    q/k/v kernels [in, heads, head_dim] and the output kernel
    [heads, head_dim, out] flatten back to [H, H]. The ArcFace head's
    ``params["head"]["weight"]`` is [C, D] in both packages and carries
    over as it is, when the tree has it."""
    enc = unstack_layer_params(params["tower"]["encoder"])
    H = config.hidden_size
    sd: Dict[str, torch.Tensor] = {}
    e = "tower.encoder"

    for n in ("word", "position", "token_type"):
        sd[f"{e}.embeddings.{n}_embeddings.weight"] = _t(
            enc[f"{n}_embeddings"]["embedding"])
    _ln(sd, f"{e}.embeddings.LayerNorm", enc["embeddings_norm"])
    for i in range(config.num_layers):
        p = enc[f"layer_{i}"]
        att = p["attention"]
        t = f"{e}.encoder.layer.{i}"
        for j, n in enumerate(("query", "key", "value")):
            if "qkv" in att:     # fused: [H, 3, nh, hd] and [3, nh, hd]
                proj = {"kernel": np.asarray(att["qkv"]["kernel"])[:, j],
                        "bias": np.asarray(att["qkv"]["bias"])[j]}
            else:
                proj = att[n]
            _dense(sd, f"{t}.attention.self.{n}", proj,
                   np.asarray(proj["kernel"]).reshape(H, H))
        _dense(sd, f"{t}.attention.output.dense", att["out"],
               np.asarray(att["out"]["kernel"]).reshape(H, H))
        _ln(sd, f"{t}.attention.output.LayerNorm", p["attention_norm"])
        _dense(sd, f"{t}.intermediate.dense", p["intermediate"])
        _dense(sd, f"{t}.output.dense", p["output"])
        _ln(sd, f"{t}.output.LayerNorm", p["output_norm"])
    _dense(sd, f"{e}.pooler.dense", enc["pooler"])
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

    def pair(name, bn, p, s):
        _conv(sd, f"{prefix}{name}", p[name])
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
                _conv(sd, f"{prefix}{t}.{c}", jp[c])
                if not cfg.folded:
                    _bn_entries(sd, f"{prefix}{t}.{b}", jp[b], js[b])
            for name in ("conv_reduce", "conv_expand"):
                _conv(sd, f"{prefix}{t}.se.{name}", jp["se"][name])
    pair("conv_head", "bn2", params, batch_stats)
    return sd


def vit_from_jax(params: Mapping, cfg: ViTConfig, prefix: str = ""
                 ) -> Dict[str, torch.Tensor]:
    """JAX ``ViT`` params -> the port's ``ViT`` state_dict, keys under
    ``prefix`` (timm's names)."""
    sd: Dict[str, torch.Tensor] = {}
    D = cfg.hidden_size
    sd[f"{prefix}cls_token"] = _t(params["cls_token"])
    sd[f"{prefix}pos_embed"] = _t(params["pos_embed"])
    _conv(sd, f"{prefix}patch_embed.proj", params["patch_embed"])
    _ln(sd, f"{prefix}norm", params["norm"])
    for i in range(cfg.num_layers):
        p, t = params[f"block_{i}"], f"{prefix}blocks.{i}"
        _ln(sd, f"{t}.norm1", p["norm1"])
        _ln(sd, f"{t}.norm2", p["norm2"])
        # [D, 3, heads, head_dim] -> rows q; k; v of [3D, D]
        _dense(sd, f"{t}.attn.qkv", p["qkv"],
               np.asarray(p["qkv"]["kernel"]).reshape(D, 3 * D))
        _dense(sd, f"{t}.attn.proj", p["proj"],
               np.asarray(p["proj"]["kernel"]).reshape(D, D))
        _dense(sd, f"{t}.mlp.fc1", p["fc1"])
        _dense(sd, f"{t}.mlp.fc2", p["fc2"])
    return sd


def convnext_from_jax(params: Mapping, cfg: ConvNeXtConfig,
                      prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX ``ConvNeXt`` params -> the port's ``ConvNeXt`` state_dict, keys
    under ``prefix`` (timm's names)."""
    sd: Dict[str, torch.Tensor] = {}
    _conv(sd, f"{prefix}stem.0", params["stem_conv"])
    _ln(sd, f"{prefix}stem.1", params["stem_norm"])
    for s, depth in enumerate(cfg.depths):
        st = f"{prefix}stages.{s}"
        if s > 0:
            _ln(sd, f"{st}.downsample.0", params[f"downsample_norm_{s}"])
            _conv(sd, f"{st}.downsample.1", params[f"downsample_conv_{s}"])
        for b in range(depth):
            p, t = params[f"stage_{s}_block_{b}"], f"{st}.blocks.{b}"
            _conv(sd, f"{t}.conv_dw", p["conv_dw"])
            _ln(sd, f"{t}.norm", p["norm"])
            _dense(sd, f"{t}.mlp.fc1", p["fc1"])
            _dense(sd, f"{t}.mlp.fc2", p["fc2"])
            if cfg.ls_init:
                sd[f"{t}.gamma"] = _t(p["gamma"])
    _ln(sd, f"{prefix}head.norm", params["head_norm"])
    return sd


def backbone_from_jax(params: Mapping, batch_stats: Mapping, cfg,
                      prefix: str = "") -> Dict[str, torch.Tensor]:
    """Any JAX backbone -> the port's state_dict, by the type of ``cfg``
    (ViT and ConvNeXt have no batch statistics)."""
    if isinstance(cfg, ViTConfig):
        return vit_from_jax(params, cfg, prefix)
    if isinstance(cfg, ConvNeXtConfig):
        return convnext_from_jax(params, cfg, prefix)
    return efficientnet_from_jax(params, batch_stats, cfg, prefix)


def image_tower_from_jax(variables: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """JAX ``ImageTower`` variables -> the port's ``ImageTower``
    state_dict (the backbone, and ``bn_layer`` when the tower has one)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd = backbone_from_jax(params["backbone"], stats.get("backbone", {}),
                           cfg, prefix="backbone.")
    if "bn_layer" in params:
        _bn_entries(sd, "bn_layer", params["bn_layer"], stats["bn_layer"])
    return sd


def cv_classifier_from_jax(variables: Mapping, cfg
                           ) -> Dict[str, torch.Tensor]:
    """JAX ``CvImageClassifier`` variables (``params`` and
    ``batch_stats``) -> the port's ``CvImageClassifier`` state_dict: the
    backbone, ``fc`` (Dense [in, out] -> Linear [out, in]), the neck
    ``bn`` with its statistics, and the ArcFace ``head`` when the tree has
    one."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd = backbone_from_jax(params["backbone"], stats.get("backbone", {}),
                           cfg, prefix="backbone.")
    if "fc" in params:
        _dense(sd, "fc", params["fc"])
        _bn_entries(sd, "bn", params["bn"], stats["bn"])
    if "head" in params:
        sd["head.weight"] = _t(params["head"]["weight"])
    return sd


def multimodal_classifier_from_jax(variables: Mapping,
                                   text_config: BertConfig, image_config
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
