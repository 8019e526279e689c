"""timm ViT and ConvNeXt state_dicts into the port's modules.

Counterpart of the parts of ``multimodalsimilar_tpu/models/hf_import.py``
that are not identities here: the port keeps HF ``BertModel`` and timm
EfficientNet names, so those checkpoints load with ``load_state_dict``
as they are. What remains:

* ``vit_state_from_timm``: a timm ``vit_*_patch16`` state_dict for a
  ``ViT`` of ``config``. A checkpoint whose position grid differs from
  ``config.num_tokens`` is resized as the JAX importer resizes it
  (``_interpolate_vit_pos_embed``: ``jax.image.resize(..., "bicubic")``
  over the patch grid, the CLS position kept), here by
  ``resize_bicubic``; the classifier head is dropped.
* ``convnext_state_from_timm``: a timm ``convnext_*`` state_dict, or one
  with the original FB repo's names (``downsample_layers.{i}``,
  ``stages.{s}.{b}.{dwconv,pwconv1,pwconv2}``, ``norm``), as timm names
  for a ``ConvNeXt`` of ``config``; the classifier is dropped.
* ``deepseek_v2_state_from_hf``: a published DeepSeek-V2 checkpoint's
  state_dict (``model.layers.{i}.mlp.experts.{e}.gate_proj.weight``, ...)
  for a ``DeepseekV2Tower``: the ``model.`` prefix dropped, each MoE
  layer's routed experts stacked into ``mlp.experts.gate_up`` and
  ``mlp.experts.down``, the output head (``lm_head``) dropped;
  ``deepseek_v2_state_to_hf`` is its inverse, and
  ``load_deepseek_v2_checkpoint`` reads a checkpoint directory
  (``config.json`` and ``*.safetensors`` or ``pytorch_model*.bin``).

The first two take tensors or numpy arrays and return f32 tensors; the
DeepSeek pair keeps each tensor's dtype.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, Mapping

import numpy as np
import torch


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel with a = -0.5, on |x|."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out).astype(np.float32)


def cubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] f32 weights of ``jax.image.resize``'s "bicubic" along
    one axis (``jax._src.image.scale.compute_weight_mat`` with its
    defaults): half-pixel centres, the kernel widened by n_in / n_out when
    shrinking (antialiasing), each column renormalized to sum 1 (which
    handles the edges), columns whose sample falls outside the input
    zeroed."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None])
    w = _keys_cubic((x / kernel_scale).astype(f32))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(f32)


def resize_bicubic(grid: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """[H, W, C] -> [out_h, out_w, C] as ``jax.image.resize(grid, (out_h,
    out_w, C), "bicubic")`` computes it (antialiased when shrinking).
    ``torch.nn.functional.interpolate(mode="bicubic")`` differs: a =
    -0.75, clamped borders and no antialiasing."""
    grid = np.asarray(grid, np.float32)
    h, w = grid.shape[:2]
    wh = (cubic_weights(h, out_h) if out_h != h
          else np.eye(h, dtype=np.float32))
    ww = (cubic_weights(w, out_w) if out_w != w
          else np.eye(w, dtype=np.float32))
    return np.einsum("ijc,ia,jb->abc", grid, wh, ww).astype(np.float32)


def interpolate_pos_embed(pos: np.ndarray, target_tokens: int) -> np.ndarray:
    """A ViT position table [1, 1 + N, D] resized to ``target_tokens``
    rows: the patch grid bicubic-resized (timm's fine-tune recipe at
    another resolution), the CLS position kept as it is."""
    pos = np.asarray(pos, np.float32)
    n = pos.shape[1] - 1
    if n + 1 == target_tokens:
        return pos
    g_old = int(round(n ** 0.5))
    g_new = int(round((target_tokens - 1) ** 0.5))
    grid = pos[0, 1:].reshape(g_old, g_old, -1)
    resized = resize_bicubic(grid, g_new, g_new)
    return np.concatenate(
        [pos[:, :1], resized.reshape(1, g_new * g_new, -1)], axis=1)


def vit_state_from_timm(state_dict: Mapping, config
                        ) -> Dict[str, torch.Tensor]:
    """A timm ``vit_*_patch16`` state_dict -> the port's ``ViT`` of
    ``config`` (a ``ViTConfig``): the same names, the position table
    resized to ``config.num_tokens``, the classifier (``head.*``, stripped
    by the reference's ``reset_classifier(0)``) dropped."""
    sd = {k: _np(v) for k, v in state_dict.items()
          if not k.startswith(("head.", "fc_norm."))}
    sd["pos_embed"] = interpolate_pos_embed(sd["pos_embed"],
                                            config.num_tokens)
    return {k: _t(v) for k, v in sd.items()}


def convnext_state_from_timm(state_dict: Mapping, config
                             ) -> Dict[str, torch.Tensor]:
    """A timm ``convnext_*`` state_dict, or the FB repo's, -> the port's
    ``ConvNeXt`` of ``config`` (a ``ConvNeXtConfig``), timm's names. The
    classifier (``head.fc``; the FB repo's ``head``) is dropped."""
    sd = {k: _np(v) for k, v in state_dict.items()}

    def get(*names):
        for n in names:
            if n in sd:
                return sd[n]
        raise KeyError(names[0])

    out: Dict[str, np.ndarray] = {}

    def copy(timm_name, fb_name, parts=("weight", "bias")):
        for part in parts:
            out[f"{timm_name}.{part}"] = get(f"{timm_name}.{part}",
                                             f"{fb_name}.{part}")

    copy("stem.0", "downsample_layers.0.0")
    copy("stem.1", "downsample_layers.0.1")
    copy("head.norm", "norm")
    for s, depth in enumerate(config.depths):
        if s > 0:
            copy(f"stages.{s}.downsample.0", f"downsample_layers.{s}.0")
            copy(f"stages.{s}.downsample.1", f"downsample_layers.{s}.1")
        for b in range(depth):
            t, fb = f"stages.{s}.blocks.{b}", f"stages.{s}.{b}"
            copy(f"{t}.conv_dw", f"{fb}.dwconv")
            copy(f"{t}.norm", f"{fb}.norm")
            copy(f"{t}.mlp.fc1", f"{fb}.pwconv1")
            copy(f"{t}.mlp.fc2", f"{fb}.pwconv2")
            if config.ls_init:
                out[f"{t}.gamma"] = get(f"{t}.gamma", f"{fb}.gamma")
    return {k: _t(v) for k, v in out.items()}


_EXPERT = "mlp.experts."


def deepseek_v2_state_from_hf(state_dict: Mapping, config
                              ) -> Dict[str, torch.Tensor]:
    """A published DeepSeek-V2 state_dict -> a ``DeepseekV2Tower`` of
    ``config`` (a ``DeepseekV2Config``); a part of one (some layers)
    gives those layers' part."""
    sd = {k[len("model."):] if k.startswith("model.") else k: v
          for k, v in state_dict.items() if not k.startswith("lm_head.")}
    out = {k: v for k, v in sd.items() if _EXPERT not in k}
    E = config.n_routed_experts
    moe_layers = sorted({k.split(".")[1] for k in sd if _EXPERT in k},
                        key=int)
    for i in moe_layers:
        p = f"layers.{i}.{_EXPERT}"
        proj = {name: [sd[f"{p}{e}.{name}.weight"] for e in range(E)]
                for name in ("gate_proj", "up_proj", "down_proj")}
        out[p + "gate_up"] = torch.stack(
            [torch.cat([g, u]) for g, u in zip(proj["gate_proj"],
                                              proj["up_proj"])])
        out[p + "down"] = torch.stack(proj["down_proj"])
    return out


def deepseek_v2_state_to_hf(state_dict: Mapping, config
                            ) -> Dict[str, torch.Tensor]:
    """A ``DeepseekV2Tower``'s state_dict under the published names
    (``deepseek_v2_state_from_hf``'s inverse; no output head)."""
    inter = config.moe_intermediate_size
    out = {}
    for k, v in state_dict.items():
        if _EXPERT not in k:
            out["model." + k] = v
            continue
        p, part = k.rsplit(".", 1)
        for e in range(v.shape[0]):
            q = f"model.{p}.{e}."
            if part == "gate_up":
                out[q + "gate_proj.weight"] = v[e, :inter]
                out[q + "up_proj.weight"] = v[e, inter:]
            else:
                out[q + "down_proj.weight"] = v[e]
    return out


def load_deepseek_v2_checkpoint(path: str):
    """(``DeepseekV2Config``, the tower's state_dict) of a published
    checkpoint directory: ``config.json`` and its ``*.safetensors``
    shards (read with the ``safetensors`` package) or, without them,
    ``pytorch_model*.bin``."""
    from multimodalsimilar_tpu_torch.models.deepseek_v2 import (
        DeepseekV2Config)
    with open(os.path.join(path, "config.json"), encoding="utf-8") as f:
        config = DeepseekV2Config.from_hf(json.load(f))
    state: Dict[str, torch.Tensor] = {}
    shards = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if shards:
        from safetensors.torch import load_file
        for shard in shards:
            state.update(load_file(shard))
    else:
        shards = sorted(glob.glob(os.path.join(path, "pytorch_model*.bin")))
        for shard in shards:
            state.update(torch.load(shard, map_location="cpu",
                                    weights_only=True))
    if not shards:
        raise FileNotFoundError(f"{path}: no *.safetensors or "
                                f"pytorch_model*.bin weights")
    return config, deepseek_v2_state_from_hf(state, config)
