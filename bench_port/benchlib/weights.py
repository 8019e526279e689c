"""Weights drawn on the device from a seed, in a few large calls.

A table of ``Spec`` (name, shape, kind, scale) says what each tensor
holds: ``normal`` (scale = standard deviation), ``uniform`` (values in
[-scale, scale]), ``const`` (every value = scale) or ``zeros_int`` (an
int64 counter). All normal tensors come out of one ``randn`` call and
all uniform ones out of one ``rand`` call on a ``torch.Generator`` of the
device, seeded by the run's seed, so a seed gives the same weights on
any run of the same card type, and both the program and the plain
reference are handed (or draw again) the same values."""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Spec:
    name: str
    shape: Tuple[int, ...]
    kind: str           # normal | uniform | const | zeros_int
    scale: float = 0.0


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def draw(specs: Sequence[Spec], seed: int, device
         ) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` of ``specs`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & (2**63 - 1))
    flat = {}
    for kind, fill in (("normal", torch.randn), ("uniform", torch.rand)):
        group = [s for s in specs if s.kind == kind]
        total = sum(_numel(s.shape) for s in group)
        flat[kind] = (fill(total, generator=gen, device=device,
                           dtype=torch.float32)
                      if total else None)
    out: Dict[str, torch.Tensor] = {}
    offset = {"normal": 0, "uniform": 0}
    for s in specs:
        n = _numel(s.shape)
        if s.kind == "normal":
            part = flat["normal"][offset["normal"]:offset["normal"] + n]
            t = part.view(s.shape) * s.scale
        elif s.kind == "uniform":
            part = flat["uniform"][offset["uniform"]:offset["uniform"] + n]
            t = (part.view(s.shape) * 2.0 - 1.0) * s.scale
        elif s.kind == "const":
            t = torch.full(s.shape, s.scale, device=device,
                           dtype=torch.float32)
        elif s.kind == "zeros_int":
            out[s.name] = torch.zeros(s.shape, device=device,
                                      dtype=torch.int64)
            continue
        else:
            raise ValueError(f"unknown weight kind {s.kind!r} of {s.name}")
        if s.kind in offset:
            offset[s.kind] += n
        out[s.name] = t.contiguous()
    return out
