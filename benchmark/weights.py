"""Seeded raw weights of a configuration, drawn on the device in one call.

Both sides get these: the program loads them as its state dict, and the
reference reads them as they are (it folds weight norm itself). One
`torch.randn` over every parameter's elements, from a `torch.Generator`
on the device seeded with the run's seed, is cut into the parameters of
`reference.vc.param_specs` in their order and scaled by each one's kind;
a weight-norm gain is its `v`'s norm times 1 + N(0, 0.02) from the same
draw. The same seed on the same device gives the same weights.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference import vc as ref


def draw(model: dict, data: dict, hub: ref.Hubert, seed: int,
         device: torch.device) -> Dict[str, torch.Tensor]:
    """The generator's weights (benchmark/reference/vc.py:param_specs)."""
    return draw_specs(ref.param_specs(model, data, hub), seed, device)


def draw_specs(specs, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """Weights for (name, shape, kind) specs, in one draw from `seed`."""
    total = sum(math.prod(shape) for _, shape, _ in specs)
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out: Dict[str, torch.Tensor] = {}
    off = 0
    with torch.no_grad():
        for name, shape, kind in specs:
            n = math.prod(shape)
            t = buf[off:off + n].view(shape)
            off += n
            if kind == "g":
                v = out[name[:-2] + ".v"]
                norm = torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.ndim)), keepdim=True))
                t.mul_(0.02).add_(1.0).mul_(norm)
            elif kind == "b":
                t.mul_(0.02)
            elif kind == "ln":
                t.mul_(0.02).add_(1.0)
            else:  # ("k", std) or ("e", std)
                t.mul_(kind[1])
            out[name] = t
    return out
