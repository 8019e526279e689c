"""The port's state_dicts BACK to reference-layout torch state_dicts
(counterpart of multimodalsimilar_tpu/models/reference_export.py).

The inverse of ``reference_import``: a model trained by the port loads
into the reference's own modules (``load_state_dict(strict=True)`` on
NlpClassifier / NlpClassifierMultilabel / NlpSentenceTransformer /
CvClassifier / MultimodalClassifier) and serves through its unmodified
inference scripts. Key maps, tensor for tensor (float32, contiguous),
with what strict loading needs beside them:

* The reference's text models register the SAME BertModel twice (``ptm``
  and ``emb_layer.ptm``, nlp_classifier.py:9,14); both key aliases are
  emitted.
* TransformerEmb carries dead weights (``emb_layer``: Linear(hidden,
  128), ``bn_layer``: BatchNorm1d(hidden) — created and never called,
  transformer_emb.py:12-13), emitted with fresh defaults (zeros / BN
  identity) as the JAX exporter does (its
  ``_dead_transformer_emb_weights``).
* The fused model holds whole sub-models with their ArcFace heads, which
  its forward never runs (multimodal_classifier.py:50-53) and the port's
  ``MultimodalClassifier`` does not have: they are emitted as zeros of 2
  classes, the JAX exporter's default sub-head.
"""

from __future__ import annotations

from typing import Mapping

import torch

from multimodalsimilar_tpu_torch.models.bert import BertConfig
from multimodalsimilar_tpu_torch.models.efficientnet import EfficientNetConfig
from multimodalsimilar_tpu_torch.models.reference_import import (
    StateDict, _bn, _take, _tensor, bert_keys, efficientnet_keys)


def _dead_transformer_emb_weights(config: BertConfig, emb_size: int = 128,
                                  prefix: str = "emb_layer."
                                  ) -> StateDict:
    """TransformerEmb's never-used emb_layer/bn_layer (transformer_emb.py
    :12-13) — defaults only, required for strict state_dict loading."""
    H = config.hidden_size
    return {
        f"{prefix}emb_layer.weight": torch.zeros(emb_size, H),
        f"{prefix}emb_layer.bias": torch.zeros(emb_size),
        f"{prefix}bn_layer.weight": torch.ones(H),
        f"{prefix}bn_layer.bias": torch.zeros(H),
        f"{prefix}bn_layer.running_mean": torch.zeros(H),
        f"{prefix}bn_layer.running_var": torch.ones(H),
        f"{prefix}bn_layer.num_batches_tracked": torch.tensor(
            0, dtype=torch.long),
    }


def _text_common(sd: Mapping, config: BertConfig) -> StateDict:
    bert = _take(sd, bert_keys(config), src="tower.encoder.")
    out = {}
    for k, v in bert.items():
        out[f"ptm.{k}"] = v
        out[f"emb_layer.ptm.{k}"] = v      # shared-module alias
    out.update(_dead_transformer_emb_weights(config))
    return out


def nlp_classifier_to_reference(sd: Mapping, config: BertConfig
                                ) -> StateDict:
    """``NlpTextClassifier`` state_dict -> reference NlpClassifier."""
    out = _text_common(sd, config)
    out["classifier.weight"] = _tensor(sd["head.weight"])
    return out


def multilabel_classifier_to_reference(sd: Mapping, config: BertConfig
                                       ) -> StateDict:
    out = _text_common(sd, config)
    for head, ref in (("lv1", "firstcate"), ("lv2", "secondcate"),
                      ("tag", "tag")):
        out[f"{ref}_classifier.weight"] = _tensor(sd[f"{head}_head.weight"])
    return out


def siamese_to_reference(sd: Mapping, config: BertConfig) -> StateDict:
    out = _text_common(sd, config)
    out.update(_take(sd, ["classifier.weight", "classifier.bias"]))
    return out


def cv_classifier_to_reference(sd: Mapping, config: EfficientNetConfig,
                               use_fc: bool = True) -> StateDict:
    """``CvImageClassifier`` state_dict -> reference CvClassifier."""
    out = _take(sd, efficientnet_keys(config), "backbone.", "backbone.")
    if use_fc:
        out.update(_take(sd, ["fc.weight", "fc.bias", *_bn("bn")]))
    out["classifier.weight"] = _tensor(sd["head.weight"])
    return out


def multimodal_to_reference(sd: Mapping, text_config: BertConfig,
                            image_config: EfficientNetConfig) -> StateDict:
    """``MultimodalClassifier`` state_dict -> reference
    MultimodalClassifier (cv.* = full CvClassifier, nlp.* = full
    NlpClassifier, classifier.weight = the fused ArcFace head)."""
    cv_sd = {k[len("cv."):]: v for k, v in sd.items() if k.startswith("cv.")}
    cv_dim = (cv_sd["fc.weight"].shape[0] if "fc.weight" in cv_sd
              else image_config.num_features)
    cv_sd.setdefault("head.weight", torch.zeros(2, cv_dim))
    nlp_sd = {k[len("nlp."):]: v for k, v in sd.items()
              if k.startswith("nlp.")}
    nlp_sd.setdefault("head.weight",
                      torch.zeros(2, text_config.hidden_size))
    out = {f"cv.{k}": v for k, v in
           cv_classifier_to_reference(cv_sd, image_config).items()}
    out.update({f"nlp.{k}": v for k, v in
                nlp_classifier_to_reference(nlp_sd, text_config).items()})
    out["classifier.weight"] = _tensor(sd["head.weight"])
    return out
