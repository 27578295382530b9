"""Seeded weights for the network, made on the card in one draw.

Every multiply-accumulate layer's weight is lecun-normal (std sqrt(1 /
fan_in) / 0.8796, clipped at 2 std), as flax initialises it; biases are
zero, norm scales one.  The weights are made from the network's layout (the
reference's module, whose parameter names the program shares) and handed to
both sides.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def fan_in(name: str, shape) -> int:
    if name.endswith("deconv.weight"):          # (in, out, 2, 2)
        return shape[0] * shape[2] * shape[3]
    n = 1
    for d in shape[1:]:
        n *= d
    return n


def make_weights(model: torch.nn.Module, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device`` for every parameter of
    ``model``."""
    params = list(model.named_parameters())
    kernels = [(n, p.shape) for n, p in params
               if n.endswith("weight") and p.dim() >= 2]
    total = sum(math.prod(s) for _, s in kernels)
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.randn(total, generator=gen, device=device).clamp_(-2.0, 2.0)
    out, at = {}, 0
    for n, s in kernels:
        k = math.prod(s)
        std = math.sqrt(1.0 / fan_in(n, s)) / 0.87962566103423978
        out[n] = (draw[at:at + k] * std).reshape(s)
        at += k
    for n, p in params:
        if n not in out:
            fill = 1.0 if n.endswith("scale") or n.endswith(".var") else 0.0
            out[n] = torch.full(p.shape, fill, dtype=torch.float32,
                                device=device)
    return out
