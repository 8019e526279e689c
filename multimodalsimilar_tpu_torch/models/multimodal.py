"""Two-stream multimodal fusion classifier.

Counterpart of ``multimodalsimilar_tpu/models/multimodal.py``
(multimodal_classifier.py:14-57): a CV and an NLP tower run on the same
batch; each tower's embedding is L2-normalized in ``reduce_dtype`` and
the two are concatenated (``fc_dim + hidden_size`` wide: 512 + 768 =
1,280 with the B4 neck and the base text tower), and an ArcFace head with
m=0.5 (:22) classifies the fused vector. In ``train()`` mode both towers
train: the image tower with BatchNorm batch statistics and the neck's
dropout, the text tower with its dropout.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from multimodalsimilar_tpu_torch.models.bert import BertConfig
from multimodalsimilar_tpu_torch.models.classifiers import NlpTextClassifier
from multimodalsimilar_tpu_torch.models.heads import ArcFaceHead
from multimodalsimilar_tpu_torch.models.vision import CvImageClassifier
from multimodalsimilar_tpu_torch.ops.arcface import ArcFaceParams, l2_normalize
from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy


class MultimodalClassifier(nn.Module):
    """norm(cv_emb) ++ norm(text_emb) -> ArcFace(m=0.5).

    ``cv`` and ``nlp`` are a ``CvImageClassifier`` and an
    ``NlpTextClassifier`` without their heads: only their towers run in
    the fused forward, so their heads never materialize in the JAX
    package's parameter tree either, and the state_dict matches that
    tree. ``image_config`` is any backbone config
    (``models.vision.backbone_config``). Weights are drawn from
    ``generator`` (seed 0 when none is given): the image classifier's,
    the text classifier's, then the fused head's."""

    def __init__(self, text_config: BertConfig,
                 image_config, num_labels: int,
                 fc_dim: int = 512,
                 arcface: ArcFaceParams = ArcFaceParams(m=0.5),
                 policy: DTypePolicy = DTypePolicy(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.policy = policy
        self.cv = CvImageClassifier(image_config, 1, fc_dim=fc_dim,
                                    policy=policy, generator=generator)
        self.nlp = NlpTextClassifier(text_config, policy=policy,
                                     generator=generator, num_labels=1)
        self.cv.head = self.nlp.head = None      # towers only
        self.head = ArcFaceHead(num_labels, fc_dim + text_config.hidden_size,
                                arcface, generator)
        self.eval()

    def predict_emb(self, images: torch.Tensor, input_ids: torch.Tensor,
                    attention_mask=None, token_type_ids=None) -> torch.Tensor:
        """[B, fc_dim + hidden] in ``reduce_dtype``; ``images`` is NCHW."""
        rd = self.policy.reduce_dtype
        img = l2_normalize(self.cv.predict_emb(images).to(rd))
        txt = l2_normalize(self.nlp.predict_emb(input_ids, attention_mask,
                                                token_type_ids).to(rd))
        return torch.cat([img, txt], dim=-1)

    def forward(self, images, input_ids, attention_mask=None,
                token_type_ids=None, label=None, is_test: bool = False,
                m=None) -> torch.Tensor:
        emb = self.predict_emb(images, input_ids, attention_mask,
                               token_type_ids)
        return self.head(emb, label, m=m, is_test=is_test)
