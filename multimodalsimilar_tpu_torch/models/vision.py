"""Image tower and image classifier.

Counterpart of ``multimodalsimilar_tpu/models/vision.py``:

* ``device_normalize`` — uint8 NHWC -> imagenet-normalized f32 on the
  device (the host ships uint8, 4x fewer bytes than f32); ``to_nchw``
  then permutes to the backbone's NCHW, which is ``channels_last`` in
  memory (no copy).
* ``ImageTower`` <- image_emb.py:14-32 — backbone features (classifier
  stripped), optional BatchNorm1d, always L2-normalized output.
* ``CvImageClassifier`` <- cv_classifier.py:17-55 — backbone -> global
  average pool -> Dropout(0.5) + Linear(fc_dim) + BatchNorm1d neck ->
  ArcFace head (m defaults to 0.2, cv_classifier.py:19). ``predict_emb``
  returns the neck output (the 512-d embedding cached to emb.txt by
  daodian_infer.py:283).

The modules are built in ``eval()`` mode. In ``train()`` mode BatchNorm
uses batch statistics (``models.efficientnet.batch_norm``) and the
neck's dropout is on, its masks from the generator that
``models.bert.set_dropout_generator`` hands out; the reference applies it
inside ``predict_emb``, so train-mode embeddings are noisy. Backbones are
EfficientNets only: ``vit*`` and ``convnext*`` raise (ROADMAP A16).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodalsimilar_tpu_torch.data.images import IMAGENET_MEAN, IMAGENET_STD
from multimodalsimilar_tpu_torch.models.bert import Dropout
from multimodalsimilar_tpu_torch.models.efficientnet import (
    EfficientNet, EfficientNetConfig, batch_norm)
from multimodalsimilar_tpu_torch.models.heads import ArcFaceHead
from multimodalsimilar_tpu_torch.ops.arcface import ArcFaceParams, l2_normalize
from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy


def device_normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> imagenet-normalized float32, on the images'
    device: ``x / 255`` then ``(x - mean) / std``, the same f32 math as
    ``data.images.normalize``. Float inputs pass through unchanged."""
    if images.dtype != torch.uint8:
        return images
    x = images.to(torch.float32) / 255.0
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


def to_nchw(images: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW as a view: the result is ``channels_last`` in
    memory, the layout the backbone's convolutions run in."""
    return images.permute(0, 3, 1, 2)


def backbone_config(name: str, **kw) -> EfficientNetConfig:
    """Name-string backbone API (cv_classifier.py:23's
    timm.create_model equivalent): efficientnet_b0..b7 and ``tiny``."""
    if name.startswith(("vit", "convnext")):
        raise NotImplementedError(
            f"backbone {name!r}: the ViT and ConvNeXt backbones are not "
            "ported (ROADMAP A16); use an efficientnet_b* backbone")
    return EfficientNetConfig.variant(name, **kw)


def build_backbone(cfg, policy: DTypePolicy,
                   generator: Optional[torch.Generator] = None
                   ) -> EfficientNet:
    if not isinstance(cfg, EfficientNetConfig):
        raise NotImplementedError(
            f"{type(cfg).__name__}: only EfficientNet backbones are ported "
            "(ROADMAP A16)")
    return EfficientNet(cfg, policy, generator)


def _bn1d(dim: int) -> nn.BatchNorm1d:
    return nn.BatchNorm1d(dim, eps=1e-5, momentum=0.1)   # flax momentum 0.9


class ImageTower(nn.Module):
    """L2-normalized pooled backbone features (image_emb.py semantics),
    on an NCHW batch."""

    def __init__(self, cfg: EfficientNetConfig = EfficientNetConfig.b4(),
                 use_bn: bool = False, policy: DTypePolicy = DTypePolicy(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.policy = policy
        self.backbone = build_backbone(cfg, policy, generator)
        self.bn_layer = _bn1d(cfg.num_features) if use_bn else None
        self.eval()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        feats = self.backbone.features(images)
        feats = batch_norm(feats, self.bn_layer, self.policy.reduce_dtype)
        return l2_normalize(feats)


class CvImageClassifier(nn.Module):
    """EfficientNet + FC/BN neck + ArcFace (cv_classifier.py contract).

    Weights are drawn from ``generator`` (seed 0 when none is given): the
    backbone's, then the fc's (normal, std 1/sqrt(fan_in), zero bias),
    then the head's; ``models.convert.cv_classifier_from_jax`` carries
    trained weights over."""

    def __init__(self, cfg: EfficientNetConfig, num_labels: int,
                 fc_dim: int = 512, use_fc: bool = True,
                 arcface: ArcFaceParams = ArcFaceParams(m=0.2),
                 policy: DTypePolicy = DTypePolicy(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.cfg, self.policy, self.use_fc = cfg, policy, use_fc
        self.backbone = build_backbone(cfg, policy, generator)
        dim = cfg.num_features
        if use_fc:
            self.dropout = Dropout(0.5)
            self.fc = nn.Linear(dim, fc_dim)
            self.bn = _bn1d(fc_dim)
            with torch.no_grad():
                w = torch.empty(self.fc.weight.shape, dtype=torch.float32)
                w.normal_(0.0, 1.0 / math.sqrt(dim), generator=generator)
                self.fc.weight.copy_(w)
                self.fc.bias.zero_()
            dim = fc_dim
        self.head = ArcFaceHead(num_labels, dim, arcface, generator)
        self.eval()

    def predict_emb(self, images: torch.Tensor) -> torch.Tensor:
        """Backbone -> GAP -> (dropout -> fc -> bn), in ``reduce_dtype``
        (cv_classifier.py:47-55)."""
        rd = self.policy.reduce_dtype
        feats = self.backbone.features(images)
        if self.use_fc:
            feats = self.dropout(feats)
            feats = F.linear(feats.to(rd), self.fc.weight.to(rd),
                             self.fc.bias.to(rd))
            feats = batch_norm(feats, self.bn, rd)
        return feats

    def forward(self, images: torch.Tensor, label=None, is_test: bool = False,
                m=None) -> torch.Tensor:
        return self.head(self.predict_emb(images), label, m=m,
                         is_test=is_test)
