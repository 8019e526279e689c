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

Backbones by name (``backbone_config``, ``build_backbone``):
EfficientNet B0-B7 and ``tiny``, ViT (``vit_tiny|small|base``,
``vit_test``; ``models/vit.py``) and ConvNeXt
(``convnext_tiny|small|base``, ``convnext_test``; ``models/convnext.py``).

The modules are built in ``eval()`` mode. In ``train()`` mode BatchNorm
uses batch statistics (``models.efficientnet.batch_norm``), drop-path and
the backbone's dropout are on, and so is the neck's dropout, their masks
from the generator that ``models.bert.set_dropout_generator`` hands out;
the reference applies the neck's dropout inside ``predict_emb``, so
train-mode embeddings are noisy.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodalsimilar_tpu_torch.data.images import IMAGENET_MEAN, IMAGENET_STD
from multimodalsimilar_tpu_torch.models.bert import Dropout
from multimodalsimilar_tpu_torch.models.convnext import (ConvNeXt,
                                                         ConvNeXtConfig)
from multimodalsimilar_tpu_torch.models.efficientnet import (
    EfficientNet, EfficientNetConfig, batch_norm, with_stats_mesh)
from multimodalsimilar_tpu_torch.models.heads import ArcFaceHead
from multimodalsimilar_tpu_torch.models.vit import ViT, ViTConfig
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


def backbone_config(name: str, image_size: Optional[int] = None, **kw):
    """Name-string backbone API (cv_classifier.py:23's timm.create_model
    equivalent): ``efficientnet_b0..b7`` / ``tiny`` -> EfficientNetConfig,
    ``vit_{tiny,small,base}`` / ``vit_test`` -> ViTConfig,
    ``convnext_{tiny,small,base}`` / ``convnext_test`` -> ConvNeXtConfig;
    ``kw`` overrides the preset.

    ``image_size`` sizes a ViT's position table (``resolution``) to the
    images it will see, as the JAX ViT sizes it from the image at init;
    the other backbones take any image size and ignore it."""
    if name.startswith("vit"):
        if image_size is not None:
            kw.setdefault("resolution", int(image_size))
        return ViTConfig.variant(name, **kw)
    if name.startswith("convnext"):
        return ConvNeXtConfig.variant(name, **kw)
    return EfficientNetConfig.variant(name, **kw)


def build_backbone(cfg, policy: DTypePolicy,
                   generator: Optional[torch.Generator] = None):
    if isinstance(cfg, ViTConfig):
        return ViT(cfg, policy, generator)
    if isinstance(cfg, ConvNeXtConfig):
        return ConvNeXt(cfg, policy, generator)
    if isinstance(cfg, EfficientNetConfig):
        return EfficientNet(cfg, policy, generator)
    raise TypeError(f"{type(cfg).__name__} is not a backbone config "
                    "(EfficientNetConfig, ViTConfig or ConvNeXtConfig)")


def _bn1d(dim: int) -> nn.BatchNorm1d:
    # flax momentum 0.9
    return with_stats_mesh(nn.BatchNorm1d(dim, eps=1e-5, momentum=0.1))


class ImageTower(nn.Module):
    """L2-normalized pooled backbone features (image_emb.py semantics),
    on an NCHW batch; ``cfg`` is any backbone config."""

    def __init__(self, cfg=EfficientNetConfig.b4(),
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
    """Backbone + FC/BN neck + ArcFace (cv_classifier.py contract); ``cfg``
    is any backbone config.

    Weights are drawn from ``generator`` (seed 0 when none is given): the
    backbone's, then the fc's (normal, std 1/sqrt(fan_in), zero bias),
    then the head's; ``models.convert.cv_classifier_from_jax`` carries
    trained weights over."""

    def __init__(self, cfg, num_labels: int,
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
