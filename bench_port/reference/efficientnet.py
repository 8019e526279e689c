"""A plain EfficientNet with the fc/BN neck and an ArcFace head, trained by
plain AdamW, in float32, as functions of a ``{name: tensor}`` dict with
timm's parameter names (Tan & Le, arXiv:1905.11946; timm
``efficientnet_*``): the B0 stage table scaled by the width and depth
multipliers, MBConv blocks with squeeze-excite (reduced width from the
block's input channels), symmetric padding of k // 2, SiLU, BatchNorm on
the batch's statistics (biased variance) in training, per-sample drop
path on the residual branches at linearly rising rates, then global
average pooling, dropout, a linear layer, BatchNorm1d and the ArcFace
margin logits scaled by s, under a mean cross-entropy.

Dropout and drop-path masks are drawn from a ``torch.Generator`` the
caller seeds, one ``bernoulli_`` per masked tensor in forward order, so
a caller that seeds it as the training run seeds its own draws the same
masks.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from benchlib.weights import Spec

# (expand, channels, repeats, stride, kernel): EfficientNet-B0's stages
B0_STAGES = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5),
             (6, 80, 3, 2, 3), (6, 112, 3, 1, 5), (6, 192, 4, 2, 5),
             (6, 320, 1, 1, 3))
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def make_divisible(v: float, divisor: int = 8) -> int:
    """timm's rounding of a scaled channel count."""
    new = max(divisor, int(v + divisor / 2) // divisor * divisor)
    return new + divisor if new < 0.9 * v else new


def blocks(cfg: dict) -> List[dict]:
    """Every block: stage, index, expand, in and out channels, stride,
    kernel, drop-path rate and whether it has a residual. The stage table
    is B0's unless the configuration gives its own (``stages``)."""
    w, d = cfg["width_mult"], cfg["depth_mult"]
    stages = [tuple(s) for s in cfg.get("stages", B0_STAGES)]
    reps = [int(math.ceil(d * r)) for _, _, r, _, _ in stages]
    total = sum(reps)
    cin = make_divisible(cfg["stem_channels"] * w)
    out, idx = [], 0
    for s, ((e, c, _, st, k), n) in enumerate(zip(stages, reps)):
        cout = make_divisible(c * w)
        for i in range(n):
            stride = st if i == 0 else 1
            out.append(dict(stage=s, index=i, expand=e, cin=cin, cout=cout,
                            stride=stride, kernel=k,
                            drop_path=cfg["drop_path_rate"] * idx / total,
                            skip=stride == 1 and cin == cout))
            cin = cout
            idx += 1
    return out


def block_table(cfg: dict) -> List[Tuple[int, int, int, int, int]]:
    """(expand, in, out, stride, kernel) of every block, for
    ``benchlib/flops.py``."""
    return [(b["expand"], b["cin"], b["cout"], b["stride"], b["kernel"])
            for b in blocks(cfg)]


def param_specs(cfg: dict, num_classes: int) -> List[Spec]:
    """Every tensor, timm's init: convs normal(0, sqrt(2 / fan_out)), the
    squeeze-excite biases normal(0, 0.02); BatchNorm scales drawn as
    normal(0, 0.1) around the 1 that ``finish`` adds, shifts normal(0,
    0.1), statistics 0 and 1; the fc normal(0, 1 / sqrt(fan_in)) with a
    normal(0, 0.02) bias; the head xavier-uniform."""
    specs: List[Spec] = []
    stem = make_divisible(cfg["stem_channels"] * cfg["width_mult"])
    feats = make_divisible(cfg["head_channels"] * cfg["width_mult"])

    def conv(name, cout, cin_per_group, k):
        specs.append(Spec(name + ".weight", (cout, cin_per_group, k, k),
                          "normal", math.sqrt(2.0 / (k * k * cout))))

    def dwconv(name, c, k):
        specs.append(Spec(name + ".weight", (c, 1, k, k), "normal",
                          math.sqrt(2.0 / (k * k))))

    def bn(name, c):
        specs.extend([Spec(name + ".weight", (c,), "normal", 0.1),
                      Spec(name + ".bias", (c,), "normal", 0.1),
                      Spec(name + ".running_mean", (c,), "const", 0.0),
                      Spec(name + ".running_var", (c,), "const", 1.0),
                      Spec(name + ".num_batches_tracked", (), "zeros_int")])

    def se(name, mid, reduced):
        conv(name + ".conv_reduce", reduced, mid, 1)
        specs.append(Spec(name + ".conv_reduce.bias", (reduced,), "normal",
                          0.02))
        conv(name + ".conv_expand", mid, reduced, 1)
        specs.append(Spec(name + ".conv_expand.bias", (mid,), "normal",
                          0.02))

    b = "backbone."
    conv(b + "conv_stem", stem, 3, 3)
    bn(b + "bn1", stem)
    for blk in blocks(cfg):
        p = f"{b}blocks.{blk['stage']}.{blk['index']}."
        cin, cout, k = blk["cin"], blk["cout"], blk["kernel"]
        reduced = max(1, int(cin * cfg["se_ratio"]))
        if blk["expand"] == 1:
            dwconv(p + "conv_dw", cin, k)
            bn(p + "bn1", cin)
            se(p + "se", cin, reduced)
            conv(p + "conv_pw", cout, cin, 1)
            bn(p + "bn2", cout)
        else:
            mid = cin * blk["expand"]
            conv(p + "conv_pw", mid, cin, 1)
            bn(p + "bn1", mid)
            dwconv(p + "conv_dw", mid, k)
            bn(p + "bn2", mid)
            se(p + "se", mid, reduced)
            conv(p + "conv_pwl", cout, mid, 1)
            bn(p + "bn3", cout)
    conv(b + "conv_head", feats, blocks(cfg)[-1]["cout"], 1)
    bn(b + "bn2", feats)
    fc = cfg["fc_dim"]
    specs += [Spec("fc.weight", (fc, feats), "normal", 1.0 / math.sqrt(feats)),
              Spec("fc.bias", (fc,), "normal", 0.02)]
    bn("bn", fc)
    specs.append(Spec("head.weight", (num_classes, fc), "uniform",
                      math.sqrt(6.0 / (num_classes + fc))))
    return specs


def finish(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Add 1 to every BatchNorm scale (drawn around 0 by ``param_specs``).
    BatchNorm scales are the ``.weight`` of a ``bn*`` module."""
    return {k: (v + 1.0 if _is_bn_scale(k) else v) for k, v in params.items()}


def _is_bn_scale(name: str) -> bool:
    parts = name.split(".")
    return parts[-1] == "weight" and parts[-2].startswith("bn")


def trainable(params: Dict[str, torch.Tensor]) -> List[str]:
    """The names that are parameters (not BatchNorm statistics)."""
    return [k for k in params
            if not k.endswith(("running_mean", "running_var",
                               "num_batches_tracked"))]


class Masks:
    """Dropout and drop-path masks from one generator, in draw order."""

    def __init__(self, generator: Optional[torch.Generator]):
        self.generator = generator

    def drop(self, x: torch.Tensor, p: float, shape) -> torch.Tensor:
        if self.generator is None or p == 0.0:
            return x
        keep = torch.empty(shape, dtype=torch.float32, device=x.device)
        keep.bernoulli_(1.0 - p, generator=self.generator)
        return torch.where(keep > 0, x / (1.0 - p), torch.zeros((),
                                                                device=x.device))


def _bn_train(x: torch.Tensor, P, name: str, eps: float,
              stats: Optional[dict] = None) -> torch.Tensor:
    dims = [d for d in range(x.dim()) if d != 1]
    mean = x.mean(dims)
    var = torch.clamp_min((x * x).mean(dims) - mean * mean, 0.0)
    if stats is not None:
        stats[name] = (mean.detach(), var.detach())
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return (x - mean.view(shape)) * (torch.rsqrt(var + eps)
                                     * P[name + ".weight"]).view(shape) \
        + P[name + ".bias"].view(shape)


def normalized(images: torch.Tensor) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> ImageNet-normalised float32 NCHW."""
    mean = torch.tensor(IMAGENET_MEAN, device=images.device)
    std = torch.tensor(IMAGENET_STD, device=images.device)
    return ((images.float() / 255.0 - mean) / std).permute(0, 3, 1, 2)


def forward(P: Dict[str, torch.Tensor], cfg: dict, images: torch.Tensor,
            masks: Masks, q: Callable = lambda t: t,
            stats: Optional[dict] = None) -> torch.Tensor:
    """The neck's [B, fc_dim] embedding of uint8 [B, H, W, 3] images, in
    training mode. ``q`` rounds the operands of every conv and product
    (the identity, or ``reference/bert.py:fp8`` for the control); each
    BatchNorm's batch mean and biased variance go into ``stats`` under
    its name, where given."""
    eps = cfg["bn_eps"]
    x = normalized(images)
    b = "backbone."

    def conv(h, name, stride=1, groups=1, bias=False):
        w = P[name + ".weight"]
        return F.conv2d(q(h), q(w), P[name + ".bias"] if bias else None,
                        stride, w.shape[-1] // 2, 1, groups)

    def bn(h, name):
        return _bn_train(h, P, name, eps, stats)

    def se(h, name):
        s = h.mean((2, 3), keepdim=True)
        s = F.silu(conv(s, name + ".conv_reduce", bias=True))
        return h * torch.sigmoid(conv(s, name + ".conv_expand", bias=True))

    h = F.silu(bn(conv(x, b + "conv_stem", 2), b + "bn1"))
    for blk in blocks(cfg):
        p = f"{b}blocks.{blk['stage']}.{blk['index']}."
        if blk["expand"] == 1:
            y = F.silu(bn(conv(h, p + "conv_dw", blk["stride"], h.shape[1]),
                          p + "bn1"))
            y = bn(conv(se(y, p + "se"), p + "conv_pw"), p + "bn2")
        else:
            y = F.silu(bn(conv(h, p + "conv_pw"), p + "bn1"))
            y = F.silu(bn(conv(y, p + "conv_dw", blk["stride"], y.shape[1]),
                          p + "bn2"))
            y = bn(conv(se(y, p + "se"), p + "conv_pwl"), p + "bn3")
        if blk["skip"]:
            y = masks.drop(y, blk["drop_path"],
                           (y.shape[0],) + (1,) * (y.dim() - 1)) + h
        h = y
    h = F.silu(bn(conv(h, b + "conv_head"), b + "bn2"))
    feats = masks.drop(h.mean((2, 3)), cfg["neck_dropout"],
                       (h.shape[0], h.shape[1]))
    emb = F.linear(q(feats), q(P["fc.weight"]), P["fc.bias"])
    return _bn_train(emb, P, "bn", eps, stats)


def arcface_loss(emb: torch.Tensor, weight: torch.Tensor,
                 labels: torch.Tensor, m: float, s: float,
                 q: Callable = lambda t: t) -> torch.Tensor:
    """Mean cross-entropy of ArcFace margin logits (not easy_margin):
    cos = x^ . W^, phi = cos cos(m) - sin sin(m) where cos > cos(pi - m)
    else cos - m sin(pi - m), the target column phi, scaled by s."""
    x = emb / torch.clamp_min(emb.norm(dim=1, keepdim=True), 1e-12)
    w = weight / torch.clamp_min(weight.norm(dim=1, keepdim=True), 1e-12)
    cos = q(x) @ q(w).T
    sin = torch.sqrt(torch.clamp(1.0 - cos * cos, 0.0, 1.0))
    phi = cos * math.cos(m) - sin * math.sin(m)
    phi = torch.where(cos > math.cos(math.pi - m), phi,
                      cos - math.sin(math.pi - m) * m)
    one_hot = F.one_hot(labels.long(), cos.shape[1]).to(cos.dtype)
    return F.cross_entropy(s * (one_hot * phi + (1.0 - one_hot) * cos),
                           labels.long())


class AdamW:
    """Decoupled-weight-decay Adam over named tensors, one learning rate
    and weight decay per name, bias-corrected."""

    def __init__(self, names, betas=(0.9, 0.999), eps=1e-8):
        self.names, self.betas, self.eps = list(names), betas, eps
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t = 0

    def step(self, P, grads, lr: Dict[str, float], wd: Dict[str, float]):
        self.t += 1
        b1, b2 = self.betas
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        with torch.no_grad():
            for n in self.names:
                g = grads[n]
                if n not in self.m:
                    self.m[n] = torch.zeros_like(g)
                    self.v[n] = torch.zeros_like(g)
                self.m[n].mul_(b1).add_(g, alpha=1 - b1)
                self.v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                P[n].mul_(1 - lr[n] * wd[n])
                denom = (self.v[n] / c2).sqrt_().add_(self.eps)
                P[n].addcdiv_(self.m[n], denom, value=-lr[n] / c1)
