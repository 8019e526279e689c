"""Task models (counterpart of multimodalsimilar_tpu/models/classifiers.py).

Only ``NlpTextClassifier.predict_emb`` is ported so far: the embedding the
retrieval jobs use. The ArcFace head and the training ``__call__`` come
with the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from multimodalsimilar_tpu_torch.models.bert import (BertConfig,
                                                     init_bert_weights)
from multimodalsimilar_tpu_torch.models.towers import TextTower
from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy


class NlpTextClassifier(nn.Module):
    """Text tower of the nlp_classifier task model.

    ``pool='cls'`` = TransformerEmb pooler semantics (the reference default);
    ``pool='mean'`` = TransformerSeqEmb masked-mean semantics. Weights are
    HF-style random draws from ``generator`` (seed 0 when none is given);
    ``models.convert.text_classifier_from_jax`` carries trained weights
    over."""

    def __init__(self, config: BertConfig, pool: str = "cls",
                 policy: DTypePolicy = DTypePolicy(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.policy = policy
        self.tower = TextTower(config, pool=pool, policy=policy)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_bert_weights(self, generator)

    def predict_emb(self, input_ids, attention_mask=None,
                    token_type_ids=None) -> torch.Tensor:
        return self.tower(input_ids, attention_mask, token_type_ids)
