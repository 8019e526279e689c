"""Vision Transformer backbone in PyTorch.

Counterpart of ``multimodalsimilar_tpu/models/vit.py`` (``ViTConfig``,
``ViTBlock``, ``ViT``): timm's ``vit_{tiny,small,base}_patch16_224``
layout — a patch convolution, a CLS token and a learned position table,
pre-LN blocks with one fused qkv projection, a final LayerNorm, and CLS
pooling for ``features``.

* NCHW input (``channels_last`` in memory, as the embedders hand it
  over); the patch convolution is ``F.conv2d`` and its [B, D, h, w]
  output flattens row-major over (h, w), the JAX module's NHWC reshape.
* The position table has ``(resolution // patch_size) ** 2 + 1`` rows.
  The JAX module sizes it from the image at init, so the commands pass
  ``--image_size`` as the resolution (``models.vision.backbone_config``).
* Attention is plain ``torch.matmul``, softmax and ``torch.matmul``, as
  the JAX package leaves it to XLA. Casts follow the JAX module's dtype
  policy point for point: projections in ``compute_dtype``; the scores
  of ``compute_dtype`` q and k taken in f32, softmax in
  ``reduce_dtype``, the probabilities cast to ``compute_dtype``;
  LayerNorm statistics in f32 (Flax's ``_compute_stats``;
  ``models.bert.flax_layer_norm``), the result in ``reduce_dtype``; the
  residual stream in ``compute_dtype``.
* Dropout (``cfg.dropout``, timm's ``drop_rate``) after the embeddings,
  the attention projection and each MLP dense, only in ``train()`` mode,
  its masks from the generator that ``models.bert.set_dropout_generator``
  hands out.

Parameter names are timm's (``patch_embed.proj``, ``cls_token``,
``pos_embed``, ``blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,
mlp.fc2}``, ``norm``), so ``multimodalsimilar_tpu/models/hf_import.py:
vit_params_from_timm`` loads this module's ``state_dict`` into the JAX
model and ``models.convert.vit_from_jax`` carries JAX weights over.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from multimodalsimilar_tpu_torch.models.bert import (Dropout, _linear,
                                                     _Module,
                                                     flax_layer_norm)
from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy

_VARIANTS = {
    # name: (hidden, layers, heads, mlp, patch, resolution)
    "vit_tiny": (192, 12, 3, 768, 16, 224),
    "vit_small": (384, 12, 6, 1536, 16, 224),
    "vit_base": (768, 12, 12, 3072, 16, 224),
}


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    hidden_size: int = 384
    num_layers: int = 12
    num_heads: int = 6
    mlp_dim: int = 1536
    patch_size: int = 16
    resolution: int = 224
    dropout: float = 0.0
    layer_norm_eps: float = 1e-6

    @classmethod
    def variant(cls, name: str, **kw) -> "ViTConfig":
        """A preset (``vit_tiny|small|base``, or ``vit_test``: 2 layers,
        32 wide, 8 px patches at 32 px); ``kw`` overrides it."""
        if name == "vit_test":
            base = dict(hidden_size=32, num_layers=2, num_heads=4,
                        mlp_dim=64, patch_size=8, resolution=32)
        else:
            h, n, nh, mlp, p, res = _VARIANTS[name]
            base = dict(hidden_size=h, num_layers=n, num_heads=nh,
                        mlp_dim=mlp, patch_size=p, resolution=res)
        base.update(kw)
        return cls(**base)

    @property
    def num_features(self) -> int:
        return self.hidden_size

    @property
    def num_tokens(self) -> int:
        """Patches at ``resolution``, plus the CLS token."""
        return (self.resolution // self.patch_size) ** 2 + 1


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, policy: DTypePolicy):
        super().__init__()
        D = cfg.hidden_size
        self.num_heads, self.policy = cfg.num_heads, policy
        self.norm1 = nn.LayerNorm(D, eps=cfg.layer_norm_eps)
        self.attn = _Module()
        self.attn.qkv = nn.Linear(D, 3 * D)
        self.attn.proj = nn.Linear(D, D)
        self.norm2 = nn.LayerNorm(D, eps=cfg.layer_norm_eps)
        self.mlp = _Module()
        self.mlp.fc1 = nn.Linear(D, cfg.mlp_dim)
        self.mlp.fc2 = nn.Linear(cfg.mlp_dim, D)
        self.attn_drop = Dropout(cfg.dropout)
        self.fc1_drop = Dropout(cfg.dropout)
        self.fc2_drop = Dropout(cfg.dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd, rd = self.policy.compute_dtype, self.policy.reduce_dtype
        B, N, D = x.shape
        nh = self.num_heads
        hd = D // nh
        h = flax_layer_norm(x, self.norm1, rd)
        # [B, N, 3, nh, hd] -> three [B, nh, N, hd]
        qkv = _linear(h, self.attn.qkv, cd).view(B, N, 3, nh, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
        scores = scores / math.sqrt(hd)
        probs = torch.softmax(scores.to(rd), dim=-1).to(cd)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(B, N, D)
        out = self.attn_drop(_linear(out, self.attn.proj, cd))
        x = x + out.to(x.dtype)
        h = flax_layer_norm(x, self.norm2, rd)
        h = self.fc1_drop(F.gelu(_linear(h, self.mlp.fc1, cd)))
        h = self.fc2_drop(_linear(h, self.mlp.fc2, cd))
        return x + h.to(x.dtype)


class ViT(nn.Module):
    """timm ``vit_*_patch16`` structure. ``forward`` returns the
    [B, N + 1, hidden] tokens after the final LayerNorm (in
    ``reduce_dtype``), ``features`` the CLS token. Weights are drawn by
    ``init_vit_weights`` from ``generator`` (seed 0 when none is
    given)."""

    def __init__(self, cfg: ViTConfig = ViTConfig(),
                 policy: DTypePolicy = DTypePolicy(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg, self.policy = cfg, policy
        D, p = cfg.hidden_size, cfg.patch_size
        self.patch_embed = _Module()
        self.patch_embed.proj = nn.Conv2d(3, D, p, stride=p)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, D))
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_tokens, D))
        self.pos_drop = Dropout(cfg.dropout)
        self.blocks = nn.ModuleList(ViTBlock(cfg, policy)
                                    for _ in range(cfg.num_layers))
        self.norm = nn.LayerNorm(D, eps=cfg.layer_norm_eps)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_vit_weights(self, generator)
        self.eval()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cd, rd = self.policy.compute_dtype, self.policy.reduce_dtype
        proj = self.patch_embed.proj
        x = F.conv2d(images.to(cd), proj.weight.to(cd), proj.bias.to(cd),
                     proj.stride)
        B, D = x.shape[:2]
        x = x.flatten(2).transpose(1, 2)                # [B, h*w, D]
        if x.shape[1] + 1 != self.pos_embed.shape[1]:
            raise ValueError(
                f"{x.shape[1]} patches do not fit a position table of "
                f"{self.pos_embed.shape[1] - 1}: build the ViT at this "
                f"image size (resolution={self.cfg.resolution})")
        cls = self.cls_token.to(cd).expand(B, 1, D)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(cd)
        x = self.pos_drop(x)
        for block in self.blocks:
            x = block(x)
        return flax_layer_norm(x, self.norm, rd)

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """[B, hidden] CLS embedding — timm's 'token' pooling after the
        final norm."""
        return self(images)[:, 0]


def init_vit_weights(module: nn.Module, generator: torch.Generator) -> None:
    """timm's ViT init, drawn from ``generator``: Linear weights
    normal(0, 0.02) and zero biases, the patch convolution normal(0,
    1/sqrt(fan_in)) (LeCun) with a zero bias, the position table
    normal(0, 0.02), a zero CLS token, unit LayerNorm scales."""
    def normal(t: torch.Tensor, std: float) -> None:
        w = torch.empty(t.shape, dtype=torch.float32)
        w.normal_(0.0, std, generator=generator)
        t.copy_(w)

    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                normal(m.weight, 0.02)
                m.bias.zero_()
            elif isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                normal(m.weight, 1.0 / math.sqrt(fan_in))
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, ViT):
                normal(m.pos_embed, 0.02)
                m.cls_token.zero_()
