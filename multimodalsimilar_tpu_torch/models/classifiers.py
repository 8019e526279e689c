"""Task models (counterpart of multimodalsimilar_tpu/models/classifiers.py).

Each ``forward`` with labels returns margin logits (training), with
``is_test=True`` or no label the cosine logits; ``predict_emb`` is the
embedding the retrieval jobs use:

* ``NlpTextClassifier``       <- nlp_classifier.py:6-42
* ``NlpMultilabelClassifier`` <- nlp_classifier_multilabel.py:6-49 (shared
  tower; per-level heads with margins lv1 0.4 / lv2 0.2 / tag 0.1)
* ``SiamesePairModel``        <- nlp_sentence_transformer.py:6-52 (shared
  tower; Linear([u; v; |u - v|]) -> 2 similar/dissimilar logits)
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodalsimilar_tpu_torch.models.bert import (BertConfig,
                                                     init_bert_weights)
from multimodalsimilar_tpu_torch.models.heads import ArcFaceHead
from multimodalsimilar_tpu_torch.models.towers import TextTower
from multimodalsimilar_tpu_torch.ops.arcface import ArcFaceParams
from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy


class NlpTextClassifier(nn.Module):
    """Text tower + single ArcFace head (nlp_classifier.py).

    ``pool='cls'`` = TransformerEmb pooler semantics (the reference default);
    ``pool='mean'`` = TransformerSeqEmb masked-mean semantics. Weights are
    HF-style random draws from ``generator`` (seed 0 when none is given),
    the tower's first and then the head's (xavier-uniform);
    ``models.convert.text_classifier_from_jax`` carries trained weights
    over."""

    # ``predict_emb`` masks pad out of attention and pooling, so pad
    # columns do not change a row's embedding (``TextEmbedder`` trims them)
    padding_invariant = True

    def __init__(self, config: BertConfig, pool: str = "cls",
                 policy: DTypePolicy = DTypePolicy(),
                 generator: Optional[torch.Generator] = None, *,
                 num_labels: int = 2,
                 arcface: ArcFaceParams = ArcFaceParams()):
        super().__init__()
        self.config = config
        self.policy = policy
        self.num_labels = num_labels
        self.arcface = arcface
        self.tower = TextTower(config, pool=pool, policy=policy)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_bert_weights(self.tower, generator)
        self.head = ArcFaceHead(num_labels, config.hidden_size, arcface,
                                generator)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                label=None, is_test: bool = False, m=None) -> torch.Tensor:
        emb = self.tower(input_ids, attention_mask, token_type_ids)
        return self.head(emb, label, m=m, is_test=is_test)

    def predict_emb(self, input_ids, attention_mask=None,
                    token_type_ids=None) -> torch.Tensor:
        return self.tower(input_ids, attention_mask, token_type_ids)


class NlpMultilabelClassifier(nn.Module):
    """Shared CLS tower + three hierarchy heads ``lv1_head``, ``lv2_head``
    and ``tag_head`` (nlp_classifier_multilabel.py), margins 0.4, 0.2 and
    0.1 (:15-17). Weights are drawn from ``generator`` (seed 0 when none
    is given): the tower's, then the three heads' in that order."""

    # ``predict_emb`` masks pad out of attention and pooling, so pad
    # columns do not change a row's embedding (``TextEmbedder`` trims them)
    padding_invariant = True

    def __init__(self, config: BertConfig, lv1_labels: int, lv2_labels: int,
                 tag_labels: int,
                 lv1_arcface: ArcFaceParams = ArcFaceParams(m=0.4),
                 lv2_arcface: ArcFaceParams = ArcFaceParams(m=0.2),
                 tag_arcface: ArcFaceParams = ArcFaceParams(m=0.1),
                 policy: DTypePolicy = DTypePolicy(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config, self.policy = config, policy
        self.lv1_arcface, self.lv2_arcface = lv1_arcface, lv2_arcface
        self.tag_arcface = tag_arcface
        self.tower = TextTower(config, pool="cls", policy=policy)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_bert_weights(self.tower, generator)
        H = config.hidden_size
        self.lv1_head = ArcFaceHead(lv1_labels, H, lv1_arcface, generator)
        self.lv2_head = ArcFaceHead(lv2_labels, H, lv2_arcface, generator)
        self.tag_head = ArcFaceHead(tag_labels, H, tag_arcface, generator)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                lv1_label=None, lv2_label=None, tag_label=None,
                is_test: bool = False):
        emb = self.tower(input_ids, attention_mask, token_type_ids)
        return (self.lv1_head(emb, lv1_label, is_test=is_test),
                self.lv2_head(emb, lv2_label, is_test=is_test),
                self.tag_head(emb, tag_label, is_test=is_test))

    def predict_emb(self, input_ids, attention_mask=None,
                    token_type_ids=None) -> torch.Tensor:
        return self.tower(input_ids, attention_mask, token_type_ids)


class SiamesePairModel(nn.Module):
    """Shared-encoder sentence-pair classifier (nlp_sentence_transformer.py):
    the CLS embeddings u and v of both sides, [u; v; |u - v|]
    (:38-40) into a 2-way ``classifier`` computed in ``reduce_dtype``.
    Weights are drawn from ``generator`` (seed 0 when none is given): the
    tower's, then the classifier's (normal, std 1/sqrt(fan_in), zero
    bias)."""

    # ``predict_emb`` masks pad out of attention and pooling, so pad
    # columns do not change a row's embedding (``TextEmbedder`` trims them)
    padding_invariant = True

    def __init__(self, config: BertConfig,
                 policy: DTypePolicy = DTypePolicy(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config, self.policy = config, policy
        self.tower = TextTower(config, pool="cls", policy=policy)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_bert_weights(self.tower, generator)
        fan_in = 3 * config.hidden_size
        self.classifier = nn.Linear(fan_in, 2)
        with torch.no_grad():
            w = torch.empty(self.classifier.weight.shape)
            w.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)
            self.classifier.weight.copy_(w)
            self.classifier.bias.zero_()

    def forward(self, query_input_ids, title_input_ids,
                query_attention_mask=None, query_token_type_ids=None,
                title_attention_mask=None, title_token_type_ids=None
                ) -> torch.Tensor:
        rd = self.policy.reduce_dtype
        u = self.tower(query_input_ids, query_attention_mask,
                       query_token_type_ids).to(rd)
        v = self.tower(title_input_ids, title_attention_mask,
                       title_token_type_ids).to(rd)
        feats = torch.cat([u, v, torch.abs(u - v)], dim=-1)
        return F.linear(feats, self.classifier.weight.to(rd),
                        self.classifier.bias.to(rd))

    def predict_emb(self, input_ids, attention_mask=None,
                    token_type_ids=None) -> torch.Tensor:
        return self.tower(input_ids, attention_mask, token_type_ids)
