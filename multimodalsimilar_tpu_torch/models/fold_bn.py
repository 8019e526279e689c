"""Inference-time BatchNorm folding for EfficientNet.

Counterpart of ``multimodalsimilar_tpu/models/fold_bn.py``
(``fold_efficientnet_bn``, ``fold_cv_classifier``), on the port's
state_dicts (timm names, OIHW kernels) instead of Flax trees.

Eval-mode BN is the affine ``y = (x - mean) / sqrt(var + eps) * gamma +
beta``; it folds into the preceding (bias-free) convolution as a
per-output-channel weight scale plus a bias. Folding removes every BN op
from the serving graph: fewer elementwise passes over the spatially wide
activations.

Usage:
    folded_cfg, sd = fold_cv_classifier(model.state_dict(), cfg)
    served = CvImageClassifier(folded_cfg, ...)
    served.load_state_dict(sd)

The folded model is inference-only (no BN statistics to update).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

import torch

from multimodalsimilar_tpu_torch.models.efficientnet import (
    EfficientNetConfig, round_repeats)


def _fold_pair(sd: Mapping[str, torch.Tensor], conv: str, bn: str,
               eps: float, out: Dict[str, torch.Tensor]) -> None:
    """``{conv}.weight`` (OIHW) and the ``{bn}.*`` entries -> a folded
    ``{conv}.weight`` and ``{conv}.bias`` in ``out``. The scale runs along
    O, dim 0 of OIHW (the last axis of the JAX package's HWIO)."""
    kernel = sd[f"{conv}.weight"].float()
    gamma = sd[f"{bn}.weight"].float()
    beta = sd[f"{bn}.bias"].float()
    mean = sd[f"{bn}.running_mean"].float()
    var = sd[f"{bn}.running_var"].float()
    scale = gamma / torch.sqrt(var + eps)
    out[f"{conv}.weight"] = kernel * scale.view(-1, 1, 1, 1)
    out[f"{conv}.bias"] = beta - mean * scale


def fold_efficientnet_bn(state_dict: Mapping[str, torch.Tensor],
                         cfg: EfficientNetConfig, prefix: str = ""
                         ) -> Dict[str, torch.Tensor]:
    """Fold every conv+BN pair of an EfficientNet state_dict (keys under
    ``prefix``) into a state_dict for ``dataclasses.replace(cfg,
    folded=True)``. SE convs already carry biases and have no BN — copied
    through."""
    eps = cfg.bn_eps
    p = prefix
    out: Dict[str, torch.Tensor] = {}
    _fold_pair(state_dict, f"{p}conv_stem", f"{p}bn1", eps, out)
    for s, (expand, _, repeats, _, _) in enumerate(cfg.stages):
        for i in range(round_repeats(repeats, cfg.depth_mult)):
            b = f"{p}blocks.{s}.{i}"
            for name in ("conv_reduce", "conv_expand"):
                for t in ("weight", "bias"):
                    key = f"{b}.se.{name}.{t}"
                    out[key] = state_dict[key].float()
            if expand != 1:                          # InvertedResidual
                _fold_pair(state_dict, f"{b}.conv_pw", f"{b}.bn1", eps, out)
                _fold_pair(state_dict, f"{b}.conv_dw", f"{b}.bn2", eps, out)
                _fold_pair(state_dict, f"{b}.conv_pwl", f"{b}.bn3", eps,
                           out)
            else:                                    # DepthwiseSeparable
                _fold_pair(state_dict, f"{b}.conv_dw", f"{b}.bn1", eps, out)
                _fold_pair(state_dict, f"{b}.conv_pw", f"{b}.bn2", eps, out)
    _fold_pair(state_dict, f"{p}conv_head", f"{p}bn2", eps, out)
    return out


def fold_cv_classifier(state_dict: Mapping[str, torch.Tensor],
                       cfg: EfficientNetConfig
                       ) -> Tuple[EfficientNetConfig, Dict[str, torch.Tensor]]:
    """Fold a ``CvImageClassifier``'s backbone BN for serving.

    Returns (folded_cfg, folded_state_dict). The 1-D neck BN (on the
    [B, fc_dim] fc output) is negligible and kept as it is, as are the fc
    and the head."""
    folded = fold_efficientnet_bn(state_dict, cfg, prefix="backbone.")
    rest = {k: v for k, v in state_dict.items()
            if not k.startswith("backbone.")}
    return dataclasses.replace(cfg, folded=True), {**folded, **rest}
