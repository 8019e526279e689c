"""Reference task-model checkpoints (torch state_dicts) -> the port's
state_dicts (counterpart of multimodalsimilar_tpu/models/reference_import.py).

The reference saves whole pickled modules (torch.save(model),
nlp_classifier_train.py:158) or state_dicts
(cv_classifier_train_daodian.py:298); the supported interchange is the
``state_dict()`` (or a torch.load of a saved one). Its text models hold an
HF ``BertModel`` and its image models a timm EfficientNet, and the port's
modules keep those names (``tower.encoder.*`` and ``backbone.*``), so
each converter is a key map, tensor for tensor, with no numpy round trip:

* NlpClassifier        — ptm.* (or its alias emb_layer.ptm.*) ->
  tower.encoder.*, classifier.weight -> head.weight
  (nlp_classifier.py:14-15)
* NlpClassifierMultilabel — {firstcate,secondcate,tag}_classifier.weight
  -> {lv1,lv2,tag}_head.weight (nlp_classifier_multilabel.py:15-17)
* NlpSentenceTransformer  — classifier.{weight,bias} (Linear 3H -> 2) as
  they are (nlp_sentence_transformer.py:17)
* CvClassifier         — backbone.* (timm EfficientNet), fc./bn. neck,
  classifier.weight -> head.weight (cv_classifier.py:23-38)
* MultimodalClassifier — cv.* and nlp.* sub-models + classifier.weight
  -> head.weight (multimodal_classifier.py:16-22); the sub-models' own
  heads are dead weights there and have no place in the port's module.

Like the JAX importers, each reads exactly the keys its module needs
(a missing one raises ``KeyError``; extra ones, such as transformers'
``embeddings.position_ids`` buffer, are ignored), and accepts
``nn.DataParallel``'s ``module.`` prefix.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import torch

from multimodalsimilar_tpu_torch.models.bert import BertConfig
from multimodalsimilar_tpu_torch.models.efficientnet import (
    EfficientNetConfig, round_repeats)

StateDict = Dict[str, torch.Tensor]


def _tensor(v) -> torch.Tensor:
    """A detached, contiguous CPU copy; floats as float32, integer
    buffers (BatchNorm's ``num_batches_tracked``) as they are."""
    t = torch.as_tensor(v).detach().cpu()
    return (t.float() if t.is_floating_point() else t).contiguous().clone()


def bert_keys(config: BertConfig) -> List[str]:
    """HF ``BertModel`` state_dict names of a ``config`` tower (those of
    the port's ``BertEncoderModel``)."""
    keys = [f"embeddings.{n}_embeddings.weight"
            for n in ("word", "position", "token_type")]
    keys += ["embeddings.LayerNorm.weight", "embeddings.LayerNorm.bias"]
    for i in range(config.num_layers):
        t = f"encoder.layer.{i}"
        for name in ("attention.self.query", "attention.self.key",
                     "attention.self.value", "attention.output.dense",
                     "attention.output.LayerNorm", "intermediate.dense",
                     "output.dense", "output.LayerNorm"):
            keys += [f"{t}.{name}.weight", f"{t}.{name}.bias"]
    return keys + ["pooler.dense.weight", "pooler.dense.bias"]


def _bn(name: str) -> List[str]:
    return [f"{name}.{p}" for p in ("weight", "bias", "running_mean",
                                    "running_var", "num_batches_tracked")]


def efficientnet_keys(config: EfficientNetConfig) -> List[str]:
    """timm EfficientNet state_dict names of a ``config`` backbone (those
    of the port's ``EfficientNet``, unfolded)."""
    keys = ["conv_stem.weight", *_bn("bn1")]
    for st, (expand, _, repeats, _, _) in enumerate(config.stages):
        for i in range(round_repeats(repeats, config.depth_mult)):
            t = f"blocks.{st}.{i}"
            order = ((("conv_pw", "bn1"), ("conv_dw", "bn2")) if expand != 1
                     else (("conv_dw", "bn1"),))
            for c, b in order:
                keys += [f"{t}.{c}.weight", *_bn(f"{t}.{b}")]
            keys += [f"{t}.se.conv_reduce.weight", f"{t}.se.conv_reduce.bias",
                     f"{t}.se.conv_expand.weight", f"{t}.se.conv_expand.bias"]
            last = ("conv_pwl", "bn3") if expand != 1 else ("conv_pw", "bn2")
            keys += [f"{t}.{last[0]}.weight", *_bn(f"{t}.{last[1]}")]
    return keys + ["conv_head.weight", *_bn("bn2")]


def _unwrap_dataparallel(sd: Mapping) -> Mapping:
    """Strip nn.DataParallel's 'module.' key prefix (the v2_dist/v3_dist
    jobs save wrapped modules, nlp_classifier_train_daodian_v2_dist.py
    :82-86)."""
    if sd and all(k.startswith("module.") for k in sd):
        return {k[len("module."):]: v for k, v in sd.items()}
    return sd


def _strip(sd: Mapping, prefix: str) -> Dict:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _take(sd: Mapping, keys, src: str = "", dst: str = "") -> StateDict:
    """``{dst + key: sd[src + key]}`` for every key (BatchNorm's
    ``num_batches_tracked`` is 0 where the reference has none)."""
    out = {}
    for k in keys:
        if k.endswith("num_batches_tracked") and src + k not in sd:
            out[dst + k] = torch.tensor(0, dtype=torch.long)
        else:
            out[dst + k] = _tensor(sd[src + k])
    return out


def _tower(sd: Mapping, config: BertConfig) -> StateDict:
    """The BertModel of a reference text model as ``tower.encoder.*``;
    prefers the 'ptm.' alias (identical tensors also appear under
    'emb_layer.ptm.'), and takes HF's optional 'bert.' prefix."""
    bert = _strip(sd, "ptm.") or _strip(sd, "emb_layer.ptm.")
    bert = {k.removeprefix("bert."): v for k, v in bert.items()}
    return _take(bert, bert_keys(config), dst="tower.encoder.")


def nlp_classifier_from_reference(sd: Mapping, config: BertConfig
                                  ) -> StateDict:
    """-> state_dict of ``models.classifiers.NlpTextClassifier``."""
    sd = _unwrap_dataparallel(sd)
    out = _tower(sd, config)
    out["head.weight"] = _tensor(sd["classifier.weight"])
    return out


def multilabel_classifier_from_reference(sd: Mapping, config: BertConfig
                                         ) -> StateDict:
    """-> state_dict of ``NlpMultilabelClassifier``."""
    sd = _unwrap_dataparallel(sd)
    out = _tower(sd, config)
    for head, ref in (("lv1", "firstcate"), ("lv2", "secondcate"),
                      ("tag", "tag")):
        out[f"{head}_head.weight"] = _tensor(sd[f"{ref}_classifier.weight"])
    return out


def siamese_from_reference(sd: Mapping, config: BertConfig) -> StateDict:
    """-> state_dict of ``SiamesePairModel``."""
    sd = _unwrap_dataparallel(sd)
    out = _tower(sd, config)
    out.update(_take(sd, ["classifier.weight", "classifier.bias"]))
    return out


def cv_classifier_from_reference(sd: Mapping, config: EfficientNetConfig,
                                 use_fc: bool = True) -> StateDict:
    """-> state_dict of ``models.vision.CvImageClassifier`` (BatchNorm
    statistics included: they are module buffers in the port)."""
    sd = _unwrap_dataparallel(sd)
    out = _take(sd, efficientnet_keys(config), "backbone.", "backbone.")
    if use_fc:
        out.update(_take(sd, ["fc.weight", "fc.bias", *_bn("bn")]))
    out["head.weight"] = _tensor(sd["classifier.weight"])
    return out


def multimodal_from_reference(sd: Mapping, text_config: BertConfig,
                              image_config: EfficientNetConfig
                              ) -> StateDict:
    """-> state_dict of ``models.multimodal.MultimodalClassifier``."""
    sd = _unwrap_dataparallel(sd)
    cv = cv_classifier_from_reference(_strip(sd, "cv."), image_config)
    nlp = _tower(_strip(sd, "nlp."), text_config)
    out = {f"cv.{k}": v for k, v in cv.items() if k != "head.weight"}
    out.update({f"nlp.{k}": v for k, v in nlp.items()})
    out["head.weight"] = _tensor(sd["classifier.weight"])
    return out
