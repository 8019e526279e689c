"""Task models (counterpart of multimodalsimilar_tpu/models/classifiers.py).

``NlpTextClassifier`` is the text tower plus one ArcFace head: ``forward``
with a label returns margin logits (training), with ``is_test=True`` or no
label the cosine logits; ``predict_emb`` is the embedding the retrieval
jobs use. The multilabel and pair models come with later slices.
"""

from __future__ import annotations

from typing import Optional

import torch
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
