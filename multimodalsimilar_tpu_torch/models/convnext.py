"""ConvNeXt backbone in PyTorch.

Counterpart of ``multimodalsimilar_tpu/models/convnext.py``
(``ConvNeXtConfig``, ``ConvNeXtBlock``, ``ConvNeXt``): timm's
``convnext_{tiny,small,base}`` layout — a 4x4 patchify stem and
LayerNorm, per stage a LayerNorm and a 2x2 stride-2 downsample, blocks of
conv_dw(7x7, per channel) -> LayerNorm -> fc1(4D) -> GELU -> fc2(D) ->
layer-scale gamma with per-sample drop-path, and ``features`` = global
average pool -> the head LayerNorm.

* NCHW modules on ``channels_last`` tensors: convolutions are
  ``F.conv2d`` (cuDNN on a card), as the JAX package leaves them to XLA;
  the LayerNorms and the block's two Linears run on the NHWC view
  (``permute(0, 2, 3, 1)``, no copy in ``channels_last``), the JAX
  module's layout.
* Casts follow the JAX module's dtype policy point for point:
  convolutions and Linears in ``compute_dtype``; LayerNorm statistics in
  f32, the result in ``reduce_dtype`` (``models.bert.flax_layer_norm``);
  the residual stream in ``compute_dtype``; the pool in ``reduce_dtype``.
* ``DropPath`` (``models/efficientnet.py``) on each block's branch with
  ``block_drop_paths``' linearly increasing rates, in ``train()`` mode
  only, its masks from the generator that
  ``models.bert.set_dropout_generator`` hands out.

Parameter names are timm's (``stem.{0,1}``, ``stages.{s}.downsample.
{0,1}``, ``stages.{s}.blocks.{b}.{conv_dw,norm,mlp.fc1,mlp.fc2,gamma}``,
``head.norm``), so ``multimodalsimilar_tpu/models/hf_import.py:
convnext_params_from_timm`` loads this module's ``state_dict`` into the
JAX model and ``models.convert.convnext_from_jax`` carries JAX weights
over.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodalsimilar_tpu_torch.models.bert import (_linear, _Module,
                                                     flax_layer_norm)
from multimodalsimilar_tpu_torch.models.efficientnet import DropPath, conv
from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy

_VARIANTS = {
    # name: (depths, dims)
    "convnext_tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "convnext_small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "convnext_base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
}


@dataclasses.dataclass(frozen=True)
class ConvNeXtConfig:
    depths: Tuple[int, ...] = (3, 3, 9, 3)
    dims: Tuple[int, ...] = (96, 192, 384, 768)
    drop_path_rate: float = 0.0
    ls_init: float = 1e-6          # layer-scale gamma init
    layer_norm_eps: float = 1e-6
    resolution: int = 224

    @classmethod
    def variant(cls, name: str, **kw) -> "ConvNeXtConfig":
        """A preset (``convnext_tiny|small|base``, or ``convnext_test``:
        depths 1/1/2/1, dims 8-64 at 32 px); ``kw`` overrides it."""
        if name == "convnext_test":
            base = dict(depths=(1, 1, 2, 1), dims=(8, 16, 32, 64),
                        resolution=32)
        else:
            depths, dims = _VARIANTS[name]
            base = dict(depths=depths, dims=dims)
        base.update(kw)
        return cls(**base)

    @property
    def num_features(self) -> int:
        return self.dims[-1]

    def block_drop_paths(self):
        """timm's linearly increasing per-block drop-path schedule."""
        total = sum(self.depths)
        rates, idx = [], 0
        for d in self.depths:
            stage = []
            for _ in range(d):
                stage.append(self.drop_path_rate * idx / max(total - 1, 1))
                idx += 1
            rates.append(stage)
        return rates


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, drop_path: float, cfg: ConvNeXtConfig,
                 policy: DTypePolicy):
        super().__init__()
        self.policy = policy
        self.conv_dw = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=cfg.layer_norm_eps)
        self.mlp = _Module()
        self.mlp.fc1 = nn.Linear(dim, 4 * dim)
        self.mlp.fc2 = nn.Linear(4 * dim, dim)
        self.gamma = (nn.Parameter(torch.full((dim,), cfg.ls_init))
                      if cfg.ls_init else None)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd, rd = self.policy.compute_dtype, self.policy.reduce_dtype
        h = _nhwc(conv(x, self.conv_dw, cd))
        h = _linear(flax_layer_norm(h, self.norm, rd), self.mlp.fc1, cd)
        h = _linear(F.gelu(h), self.mlp.fc2, cd)
        if self.gamma is not None:
            h = h * self.gamma.to(h.dtype)
        return x + self.drop_path(_nchw(h)).to(x.dtype)


class ConvNeXt(nn.Module):
    """timm ``convnext_*`` structure. ``forward`` returns the final
    [B, dims[-1], H/32, W/32] map (NCHW, ``compute_dtype``),
    ``features`` the pooled, head-normalized [B, dims[-1]] in
    ``reduce_dtype``. Weights are drawn by ``init_convnext_weights`` from
    ``generator`` (seed 0 when none is given)."""

    def __init__(self, cfg: ConvNeXtConfig = ConvNeXtConfig(),
                 policy: DTypePolicy = DTypePolicy(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg, self.policy = cfg, policy
        eps = cfg.layer_norm_eps
        self.stem = nn.ModuleList([nn.Conv2d(3, cfg.dims[0], 4, stride=4),
                                   nn.LayerNorm(cfg.dims[0], eps=eps)])
        drop_paths = cfg.block_drop_paths()
        self.stages = nn.ModuleList()
        for s, (depth, dim) in enumerate(zip(cfg.depths, cfg.dims)):
            stage = _Module()
            if s > 0:
                stage.downsample = nn.ModuleList([
                    nn.LayerNorm(cfg.dims[s - 1], eps=eps),
                    nn.Conv2d(cfg.dims[s - 1], dim, 2, stride=2)])
            stage.blocks = nn.ModuleList(
                ConvNeXtBlock(dim, drop_paths[s][b], cfg, policy)
                for b in range(depth))
            self.stages.append(stage)
        self.head = _Module()
        self.head.norm = nn.LayerNorm(cfg.dims[-1], eps=eps)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_convnext_weights(self, generator)
        self.eval()

    def _norm2d(self, x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
        rd, cd = self.policy.reduce_dtype, self.policy.compute_dtype
        return _nchw(flax_layer_norm(_nhwc(x), ln, rd)).to(cd)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cd = self.policy.compute_dtype
        x = self._norm2d(conv(images, self.stem[0], cd), self.stem[1])
        for s, stage in enumerate(self.stages):
            if s > 0:
                norm, down = stage.downsample
                x = conv(self._norm2d(x, norm), down, cd)
            for block in stage.blocks:
                x = block(x)
        return x

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """GAP then the head LayerNorm (timm's NormMlpClassifierHead with
        the classifier stripped, what ``reset_classifier(0)`` leaves)."""
        rd = self.policy.reduce_dtype
        x = self(images).to(rd).mean(dim=(2, 3))
        return flax_layer_norm(x, self.head.norm, rd)


def init_convnext_weights(module: nn.Module,
                          generator: torch.Generator) -> None:
    """timm's ConvNeXt init, drawn from ``generator``: convolution and
    Linear weights normal(0, 0.02) (timm's trunc_normal_ without the
    truncation) and zero biases, unit LayerNorm scales, gamma at
    ``ls_init``."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                w = torch.empty(m.weight.shape, dtype=torch.float32)
                w.normal_(0.0, 0.02, generator=generator)
                m.weight.copy_(w)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

