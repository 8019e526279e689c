"""EfficientNet (B0-B7) in PyTorch — the image tower backbone.

Counterpart of ``multimodalsimilar_tpu/models/efficientnet.py``
(``EfficientNet``, ``EfficientNetConfig``, ``SqueezeExcite``,
``DepthwiseSeparable``, ``InvertedResidual``):

* NCHW modules. Callers hand in an NHWC batch permuted to NCHW, which is
  a ``channels_last`` tensor, and the embedders convert the parameters to
  ``channels_last``, so cuDNN runs its NHWC kernels with no transposes.
  Convolutions are ``F.conv2d`` (cuDNN on a card), as the JAX package
  leaves them to XLA.
* torch-style *symmetric* padding (k//2 on each side, stride 2 included),
  so embeddings match timm's native (non-``tf_``) EfficientNet weights.
* Casts follow the JAX module's dtype policy point for point: every conv
  runs in ``compute_dtype``; BatchNorm computes ``(x - mean) *
  rsqrt(var + eps) * scale + bias`` against f32 statistics and returns
  ``reduce_dtype``; the squeeze-excite mean is
  taken in ``reduce_dtype`` and cast to ``compute_dtype``; the reduced SE
  width comes from the block's *input* channels (timm semantics).
* ``folded=True`` (``models/fold_bn.py``): every conv carries a bias and
  every BatchNorm is an identity.
* ``eval()`` mode (the modules are built in it): BatchNorm uses its
  running statistics and stochastic depth is off. ``train()`` mode: Flax
  ``BatchNorm(use_running_average=False)`` semantics (``batch_norm``),
  and ``DropPath`` on each residual branch with the linearly scaled rates
  of ``block_plan``, its masks from the generator that
  ``models.bert.set_dropout_generator`` hands out.

Parameter names are timm's (``conv_stem``/``bn1``,
``blocks.S.I.{conv_pw,bn1,conv_dw,bn2,se.conv_reduce,se.conv_expand,
conv_pwl,bn3}``, ``conv_head``/``bn2``), so
``multimodalsimilar_tpu/models/hf_import.py:efficientnet_params_from_timm``
loads this module's ``state_dict`` into the JAX model, and
``models.convert.efficientnet_from_jax`` carries JAX weights over.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multimodalsimilar_tpu_torch.models.bert import Dropout
from multimodalsimilar_tpu_torch.utils.dtypes import DTypePolicy

# (expand_ratio, channels, repeats, stride, kernel) — the EfficientNet-B0
# stage table; width/depth multipliers scale it to B1..B7.
_STAGES: Tuple[Tuple[int, int, int, int, int], ...] = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)

_VARIANTS = {
    # name: (width_mult, depth_mult, train_resolution, dropout)
    "efficientnet_b0": (1.0, 1.0, 224, 0.2),
    "efficientnet_b1": (1.0, 1.1, 240, 0.2),
    "efficientnet_b2": (1.1, 1.2, 260, 0.3),
    "efficientnet_b3": (1.2, 1.4, 300, 0.3),
    "efficientnet_b4": (1.4, 1.8, 380, 0.4),
    "efficientnet_b5": (1.6, 2.2, 456, 0.4),
    "efficientnet_b6": (1.8, 2.6, 528, 0.5),
    "efficientnet_b7": (2.0, 3.1, 600, 0.5),
}


def round_channels(channels: float, divisor: int = 8) -> int:
    """timm's make_divisible: round to nearest multiple, never below 90%."""
    new = max(divisor, int(channels + divisor / 2) // divisor * divisor)
    if new < 0.9 * channels:
        new += divisor
    return new


def round_repeats(repeats: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * repeats))


@dataclasses.dataclass(frozen=True)
class EfficientNetConfig:
    width_mult: float = 1.0
    depth_mult: float = 1.0
    resolution: int = 224
    dropout: float = 0.2
    drop_path_rate: float = 0.2
    bn_eps: float = 1e-5
    bn_momentum: float = 0.9          # flax EMA decay == 1 - torch momentum
    # Inference-only: BN pre-folded into conv weights/biases
    # (models.fold_bn.fold_efficientnet_bn); all BN ops vanish.
    folded: bool = False
    se_ratio: float = 0.25
    stem_channels: int = 32
    head_channels: int = 1280
    stages: Tuple[Tuple[int, int, int, int, int], ...] = _STAGES

    @classmethod
    def variant(cls, name: str, **kw) -> "EfficientNetConfig":
        if name == "tiny":  # 2-stage test/smoke backbone, not a B-variant
            return dataclasses.replace(cls.tiny(), **kw)
        w, d, res, drop = _VARIANTS[name]
        base = dict(width_mult=w, depth_mult=d, resolution=res,
                    dropout=drop)
        base.update(kw)            # kw overrides the preset
        return cls(**base)

    @classmethod
    def b4(cls, **kw) -> "EfficientNetConfig":
        return cls.variant("efficientnet_b4", **kw)

    @classmethod
    def tiny(cls) -> "EfficientNetConfig":
        """Two trimmed stages for tests."""
        return cls(stages=((1, 8, 1, 1, 3), (6, 16, 2, 2, 3)),
                   stem_channels=8, head_channels=32, drop_path_rate=0.1)

    @property
    def num_features(self) -> int:
        """Feature dim after conv_head (1792 for B4)."""
        return round_channels(self.head_channels * self.width_mult)

    def block_plan(self):
        """Expanded per-block plan: list of (expand, in_c, out_c, stride, k,
        drop_path) honoring width/depth multipliers."""
        plan = []
        in_c = round_channels(self.stem_channels * self.width_mult)
        total = sum(round_repeats(r, self.depth_mult)
                    for (_, _, r, _, _) in self.stages)
        idx = 0
        for (exp, c, r, s, k) in self.stages:
            out_c = round_channels(c * self.width_mult)
            for i in range(round_repeats(r, self.depth_mult)):
                dp = self.drop_path_rate * idx / max(total, 1)
                plan.append((exp, in_c, out_c, s if i == 0 else 1, k, dp))
                in_c = out_c
                idx += 1
        return plan


def _conv_module(cfg: EfficientNetConfig, in_c: int, out_c: int,
                 kernel: int, stride: int = 1, groups: int = 1) -> nn.Conv2d:
    """Conv with torch-style symmetric padding (k//2 each side); a bias
    only when BN has been folded in."""
    return nn.Conv2d(in_c, out_c, kernel, stride=stride,
                     padding=kernel // 2, groups=groups, bias=cfg.folded)


def _bn_module(cfg: EfficientNetConfig, channels: int
               ) -> Optional[nn.BatchNorm2d]:
    if cfg.folded:
        return None                     # BN folded into the conv
    return with_stats_mesh(nn.BatchNorm2d(
        channels, eps=cfg.bn_eps, momentum=round(1.0 - cfg.bn_momentum, 6)))


def with_stats_mesh(bn: nn.modules.batchnorm._BatchNorm
                    ) -> nn.modules.batchnorm._BatchNorm:
    """``bn`` with its ``stats_mesh`` field declared: the mesh over whose
    data group ``batch_norm`` takes the train()-mode statistics, ``None``
    (this rank's batch alone) until ``set_stats_mesh`` sets it."""
    bn.stats_mesh = None
    return bn


def set_stats_mesh(model: nn.Module, mesh) -> None:
    """Every BatchNorm of ``model`` takes its train()-mode statistics over
    ``mesh``'s data group (``None``: over this rank's batch alone). The
    Trainer calls it on its default data-parallel path."""
    for m in model.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.stats_mesh = mesh


def conv(x: torch.Tensor, mod: nn.Conv2d, dtype: torch.dtype
         ) -> torch.Tensor:
    """``mod`` applied in ``dtype`` (input, weight and bias cast to it)."""
    bias = None if mod.bias is None else mod.bias.to(dtype)
    return F.conv2d(x.to(dtype), mod.weight.to(dtype), bias, mod.stride,
                    mod.padding, mod.dilation, mod.groups)


def batch_norm(x: torch.Tensor, bn: Optional[nn.modules.batchnorm._BatchNorm],
               dtype: torch.dtype) -> torch.Tensor:
    """BatchNorm as Flax computes it: ``(x - mean) * (rsqrt(var + eps) *
    scale) + bias`` in f32, then cast to ``dtype``; channels on dim 1.
    ``None`` (folded) is the identity. In ``eval()`` mode the statistics
    are the running ones. In ``train()`` mode they are the batch's, in
    f32 over every dim but 1, with the *biased* variance E[x^2] - E[x]^2
    clipped at 0 (Flax ``_compute_stats``), and the running statistics
    move to ``momentum * running + (1 - momentum) * batch`` with that same
    biased variance (``F.batch_norm`` would store the unbiased one,
    n/(n-1) larger) at Flax's momentum (0.9, torch's 0.1).

    A module given a mesh (its ``stats_mesh`` field, ``set_stats_mesh``)
    takes the statistics of the global batch:
    the per-rank sums of x and x^2 are all-reduced over the mesh's data
    group, differentiably, as GSPMD normalizes over the whole batch (the
    ranks' shards are equal)."""
    if bn is None:
        return x
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if bn.training:
        xf = x.float()
        dims = [d for d in range(x.dim()) if d != 1]
        mesh = getattr(bn, "stats_mesh", None)
        if mesh is None:
            mean = xf.mean(dims)
            ex2 = (xf * xf).mean(dims)
        else:
            from torch.distributed.nn.functional import all_reduce

            from multimodalsimilar_tpu_torch.parallel.mesh import DATA_AXIS
            count = xf.numel() // xf.shape[1] * mesh.data
            sums = all_reduce(torch.stack([xf.sum(dims), (xf * xf).sum(dims)]),
                              group=mesh.group(DATA_AXIS))
            mean, ex2 = sums[0] / count, sums[1] / count
        var = torch.clamp_min(ex2 - mean * mean, 0.0)
        with torch.no_grad():
            keep = 1.0 - bn.momentum
            bn.running_mean.copy_(keep * bn.running_mean
                                  + bn.momentum * mean)
            bn.running_var.copy_(keep * bn.running_var + bn.momentum * var)
    else:
        mean, var = bn.running_mean, bn.running_var
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    y = (x - mean.view(shape)) * mul.view(shape)
    return (y + bn.bias.view(shape)).to(dtype)


class DropPath(Dropout):
    """Per-sample stochastic depth (timm ``drop_path``, JAX ``_DropPath``):
    in ``train()`` mode each sample's residual branch is dropped with
    probability ``p`` and the survivors are scaled by 1 / (1 - p), one
    mask draw per sample from ``self.generator``."""

    def mask_shape(self, x: torch.Tensor) -> tuple:
        return (x.shape[0],) + (1,) * (x.dim() - 1)


class SqueezeExcite(nn.Module):
    """SE gate; the reduced width comes from the block's *input* channels
    (timm semantics), not the expanded width."""

    def __init__(self, channels: int, reduced: int, policy: DTypePolicy):
        super().__init__()
        self.policy = policy
        self.conv_reduce = nn.Conv2d(channels, reduced, 1, bias=True)
        self.conv_expand = nn.Conv2d(reduced, channels, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd, rd = self.policy.compute_dtype, self.policy.reduce_dtype
        pooled = x.to(rd).mean(dim=(2, 3), keepdim=True).to(cd)
        s = F.silu(conv(pooled, self.conv_reduce, cd))
        s = conv(s, self.conv_expand, cd)
        return x * torch.sigmoid(s)


class DepthwiseSeparable(nn.Module):
    """Stage-0 block (expand ratio 1): dw conv + SE + pw project."""

    def __init__(self, cfg: EfficientNetConfig, in_c: int, out_c: int,
                 stride: int, kernel: int, drop_path: float,
                 policy: DTypePolicy):
        super().__init__()
        self.policy = policy
        self.conv_dw = _conv_module(cfg, in_c, in_c, kernel, stride,
                                    groups=in_c)
        self.bn1 = _bn_module(cfg, in_c)
        self.se = SqueezeExcite(in_c, max(1, int(in_c * cfg.se_ratio)),
                                policy)
        self.conv_pw = _conv_module(cfg, in_c, out_c, 1)
        self.bn2 = _bn_module(cfg, out_c)
        self.has_skip = stride == 1 and in_c == out_c
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd, rd = self.policy.compute_dtype, self.policy.reduce_dtype
        h = F.silu(batch_norm(conv(x, self.conv_dw, cd), self.bn1, rd))
        h = self.se(h)
        h = batch_norm(conv(h, self.conv_pw, cd), self.bn2, rd)
        return self.drop_path(h) + x if self.has_skip else h


class InvertedResidual(nn.Module):
    """MBConv: pw expand + dw + SE + pw-linear project, residual when
    stride 1 and channels match."""

    def __init__(self, cfg: EfficientNetConfig, expand: int, in_c: int,
                 out_c: int, stride: int, kernel: int, drop_path: float,
                 policy: DTypePolicy):
        super().__init__()
        self.policy = policy
        mid = in_c * expand
        self.conv_pw = _conv_module(cfg, in_c, mid, 1)
        self.bn1 = _bn_module(cfg, mid)
        self.conv_dw = _conv_module(cfg, mid, mid, kernel, stride,
                                    groups=mid)
        self.bn2 = _bn_module(cfg, mid)
        self.se = SqueezeExcite(mid, max(1, int(in_c * cfg.se_ratio)),
                                policy)
        self.conv_pwl = _conv_module(cfg, mid, out_c, 1)
        self.bn3 = _bn_module(cfg, out_c)
        self.has_skip = stride == 1 and in_c == out_c
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd, rd = self.policy.compute_dtype, self.policy.reduce_dtype
        h = F.silu(batch_norm(conv(x, self.conv_pw, cd), self.bn1, rd))
        h = F.silu(batch_norm(conv(h, self.conv_dw, cd), self.bn2, rd))
        h = self.se(h)
        h = batch_norm(conv(h, self.conv_pwl, cd), self.bn3, rd)
        return self.drop_path(h) + x if self.has_skip else h


class EfficientNet(nn.Module):
    """Feature extractor: stem -> MBConv stages -> conv_head.

    ``forward`` returns the [B, num_features, H', W'] feature map;
    ``features`` the globally average-pooled [B, num_features] embedding
    (in ``reduce_dtype``), the reference's ``reset_classifier(0)`` +
    AdaptiveAvgPool2d. Input is NCHW (``channels_last`` memory), float,
    already normalized. Weights are drawn by
    ``init_efficientnet_weights`` from ``generator`` (seed 0 when none is
    given)."""

    def __init__(self, cfg: EfficientNetConfig = EfficientNetConfig(),
                 policy: DTypePolicy = DTypePolicy(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg, self.policy = cfg, policy
        stem_c = round_channels(cfg.stem_channels * cfg.width_mult)
        self.conv_stem = _conv_module(cfg, 3, stem_c, 3, 2)
        self.bn1 = _bn_module(cfg, stem_c)
        plan = cfg.block_plan()
        self.blocks = nn.ModuleList()
        b = 0
        for (_, _, repeats, _, _) in cfg.stages:
            stage = nn.ModuleList()
            for _ in range(round_repeats(repeats, cfg.depth_mult)):
                exp, in_c, out_c, stride, k, dp = plan[b]
                stage.append(
                    DepthwiseSeparable(cfg, in_c, out_c, stride, k, dp,
                                       policy)
                    if exp == 1 else
                    InvertedResidual(cfg, exp, in_c, out_c, stride, k, dp,
                                     policy))
                b += 1
            self.blocks.append(stage)
        self.conv_head = _conv_module(cfg, plan[-1][2], cfg.num_features, 1)
        self.bn2 = _bn_module(cfg, cfg.num_features)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_efficientnet_weights(self, generator)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd, rd = self.policy.compute_dtype, self.policy.reduce_dtype
        h = F.silu(batch_norm(conv(x.to(cd), self.conv_stem, cd), self.bn1,
                              rd))
        for stage in self.blocks:
            for block in stage:
                h = block(h)
        return F.silu(batch_norm(conv(h, self.conv_head, cd), self.bn2, rd))

    def features(self, x: torch.Tensor) -> torch.Tensor:
        return self(x).to(self.policy.reduce_dtype).mean(dim=(2, 3))


def init_efficientnet_weights(module: nn.Module,
                              generator: torch.Generator) -> None:
    """timm's EfficientNet init, drawn from ``generator``: conv weights
    normal(0, sqrt(2 / fan_out)) with fan_out = k*k*out/groups, zero
    biases, unit BatchNorm scales and zero shifts (statistics 0 and 1)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Conv2d):
                kh, kw = m.kernel_size
                fan_out = kh * kw * m.out_channels // m.groups
                w = torch.empty(m.weight.shape, dtype=torch.float32)
                w.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
