"""ArcFace (additive angular margin) logits: the CUDA kernel, its plain
version and the autograd wrapper that picks between them by device.

Counterpart of ``multimodalsimilar_tpu/ops/arcface.py`` (``arcface_logits``,
``arcface_logits_fused``, kernel ``_arcface_kernel``). Same contract:

    cosine = normalize(x) @ normalize(W).T      # W is [C, D]; eps 1e-12
    sine   = sqrt(clip(1 - cosine^2, 0, 1))
    phi    = cosine*cos(m) - sine*sin(m)
    easy_margin:  phi where cosine > 0           else cosine
    otherwise:    phi where cosine > cos(pi - m) else cosine - sin(pi - m)*m
    logits = s * (one_hot*phi + (1 - one_hot)*cosine)   # label -1: no target

all in f32, with m and s plain arguments, so the margin curriculum changes
nothing but an argument.

* ``arcface_logits`` is plain PyTorch; the CPU tests hold it against the
  JAX package and ``chip_smoke.py`` holds the kernel against it.
* ``arcface_logits_cuda`` launches ``csrc/arcface.cu`` (see the note at its
  top for the bound and the design).
* ``ArcFaceLogits`` is the autograd function: its forward is the kernel
  for CUDA tensors and the plain version for CPU tensors; its backward
  recomputes the plain version and returns its vector-Jacobian product,
  as the JAX package's ``custom_vjp`` does (no backward kernel there
  either). ``arcface_logits_fused`` applies it. A CUDA tensor reaches the
  kernel or raises.

``LAUNCHES["arcface"]`` counts kernel launches, so a run can show that its
main path went through the kernel.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import math
from typing import Tuple

import torch

EPS = 1e-12
TILE_ROWS = 128      # csrc/arcface.cu kBM: rows of x per block
TILE_CLASSES = 80    # csrc/arcface.cu kBN: classes per block
H100_F32_FLOPS = 67e12  # H100 SXM f32 peak outside the tensor cores
# The card's fastest f32-accurate route: the TF32 tensor cores (495 TFLOP/s
# dense) at three products per f32-accurate multiply-add (3xTF32).
H100_F32_ACCURATE_TC_FLOPS = 165e12
H100_HBM_BYTES = 3.35e12
LAUNCHES: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class ArcFaceParams:
    """Hyper-parameters of an ArcFace head; the margin m is also passed
    per call so a curriculum can move it."""

    s: float = 64.0
    m: float = 0.40
    easy_margin: bool = False

    def update_m(self, delta: float) -> "ArcFaceParams":
        """Margin curriculum step: the new margin takes effect only inside
        [1e-6, 1.0]."""
        new_m = self.m + delta
        if 1e-6 <= new_m <= 1.0:
            return dataclasses.replace(self, m=new_m)
        return self


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``F.normalize(p=2, eps=1e-12)``: divide by max(norm, eps)."""
    norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp_min(norm, EPS)


def cosine_logits(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Margin-free logits: the normalized cosine, [B, C] f32."""
    return torch.matmul(l2_normalize(x.float()),
                        l2_normalize(weight.float()).T)


def _apply_margin(cosine: torch.Tensor, label: torch.Tensor, m: float,
                  s: float, easy_margin: bool) -> torch.Tensor:
    f32 = dict(dtype=torch.float32, device=cosine.device)
    mt = torch.tensor(m, **f32)
    cos_m, sin_m = torch.cos(mt), torch.sin(mt)
    sine = torch.sqrt(torch.clamp(1.0 - cosine * cosine, 0.0, 1.0))
    phi = cosine * cos_m - sine * sin_m
    if easy_margin:
        phi = torch.where(cosine > 0, phi, cosine)
    else:
        th = torch.cos(torch.tensor(math.pi, **f32) - mt)
        mm = torch.sin(torch.tensor(math.pi, **f32) - mt) * mt
        phi = torch.where(cosine - th > 0, phi, cosine - mm)
    cols = torch.arange(cosine.shape[-1], device=cosine.device)
    target = cols[None, :] == label.long()[:, None]
    return s * torch.where(target, phi, cosine)


def _check(x: torch.Tensor, weight: torch.Tensor, label: torch.Tensor):
    if x.dim() != 2 or weight.dim() != 2 or label.dim() != 1:
        raise ValueError(f"x {tuple(x.shape)}, weight {tuple(weight.shape)} "
                         f"and label {tuple(label.shape)} must be [B, D], "
                         f"[C, D] and [B]")
    if x.shape[1] != weight.shape[1] or x.shape[0] != label.shape[0]:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)}, label {tuple(label.shape)}")


def arcface_logits(x: torch.Tensor, weight: torch.Tensor,
                   label: torch.Tensor, m: float, s: float = 64.0,
                   easy_margin: bool = False) -> torch.Tensor:
    """Training logits with the additive angular margin, in plain PyTorch
    on the inputs' device. x [B, D] (any float type, computed in f32),
    weight [C, D], label [B] (-1 = no target column); [B, C] f32."""
    _check(x, weight, label)
    return _apply_margin(cosine_logits(x, weight), label, m, s, easy_margin)


@functools.cache
def _lib() -> ctypes.CDLL:
    from multimodalsimilar_tpu_torch.ops import _build
    lib = _build.load("arcface")
    lib.mms_arcface.restype = ctypes.c_int
    lib.mms_arcface.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                                + [ctypes.c_float] * 2 + [ctypes.c_int]
                                + [ctypes.c_void_p])
    for fn in ("mms_arcface_tile_rows", "mms_arcface_tile_classes"):
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = []
    got = (lib.mms_arcface_tile_rows(), lib.mms_arcface_tile_classes())
    if got != (TILE_ROWS, TILE_CLASSES):
        raise RuntimeError(f"csrc/arcface.cu tile {got} disagrees with "
                           f"ops/arcface.py {(TILE_ROWS, TILE_CLASSES)}")
    return lib


def arcface_logits_cuda(x: torch.Tensor, weight: torch.Tensor,
                        label: torch.Tensor, m: float, s: float = 64.0,
                        easy_margin: bool = False) -> torch.Tensor:
    """Launch ``csrc/arcface.cu`` on the current stream. x is cast to f32
    and made contiguous (as the TPU kernel casts it); weight must be f32
    and contiguous, label integer; all on one CUDA device."""
    _check(x, weight, label)
    for name, t in (("x", x), ("weight", weight), ("label", label)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}, not a CUDA device")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if weight.dtype != torch.float32:
        raise ValueError(f"weight is {weight.dtype}, the kernel takes "
                         f"float32")
    if not weight.is_contiguous():
        raise ValueError("weight is not contiguous")
    if label.dtype.is_floating_point or label.dtype == torch.bool:
        raise ValueError(f"label is {label.dtype}, not an integer type")
    x = x.float().contiguous()
    label = label.to(torch.int32).contiguous()
    (b, d), c = x.shape, weight.shape[0]
    dev = x.device
    out = torch.empty((b, c), dtype=torch.float32, device=dev)
    if b == 0 or c == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.mms_arcface(x.data_ptr(), weight.data_ptr(),
                              label.data_ptr(), out.data_ptr(), b, c, d,
                              float(m), float(s),
                              int(easy_margin), stream)
    if err:
        raise RuntimeError(f"csrc/arcface.cu launch failed: cudaError {err}")
    LAUNCHES["arcface"] += 1
    return out


class ArcFaceLogits(torch.autograd.Function):
    """Margin logits whose forward is the kernel on CUDA tensors (the
    plain version on CPU tensors) and whose backward is the plain
    version's vector-Jacobian product for x and weight."""

    @staticmethod
    def forward(ctx, x, weight, label, m, s, easy_margin):
        ctx.save_for_backward(x, weight, label)
        ctx.margin = (m, s, easy_margin)
        if x.device.type == "cpu" and weight.device.type == "cpu":
            return arcface_logits(x, weight, label, m, s, easy_margin)
        return arcface_logits_cuda(x, weight, label, m, s, easy_margin)

    @staticmethod
    def backward(ctx, grad):
        x, weight, label = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad[:2]
        if not (need_x or need_w):
            return None, None, None, None, None, None
        with torch.enable_grad():
            xd = x.detach().requires_grad_(need_x)
            wd = weight.detach().requires_grad_(need_w)
            out = arcface_logits(xd, wd, label, *ctx.margin)
            inputs = [t for t, need in ((xd, need_x), (wd, need_w)) if need]
            grads = list(torch.autograd.grad(out, inputs, grad))
        gx = grads.pop(0) if need_x else None
        gw = grads.pop(0) if need_w else None
        return gx, gw, None, None, None, None


def arcface_logits_fused(x: torch.Tensor, weight: torch.Tensor,
                         label: torch.Tensor, m: float, s: float = 64.0,
                         easy_margin: bool = False) -> torch.Tensor:
    """``arcface_logits`` through the kernel on CUDA tensors (the plain
    version on CPU tensors), differentiable in x and weight."""
    return ArcFaceLogits.apply(x, weight, label, float(m), float(s),
                               bool(easy_margin))


def bound_ms(b: int, c: int, d: int,
             flops_rate: float = H100_F32_ACCURATE_TC_FLOPS
             ) -> Tuple[float, str]:
    """Least time an H100 SXM could take for one forward call, and what
    bounds it: 2*B*C*D operations at the card's fastest f32-accurate rate
    against x, W and the labels read once and the [B, C] logits written
    once. ``flops_rate=H100_F32_FLOPS`` gives the older CUDA-core
    bound."""
    flops = 2.0 * b * c * d
    nbytes = 4.0 * (b * d + c * d + b * c + b)
    t_ops, t_bytes = flops / flops_rate, nbytes / H100_HBM_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")
