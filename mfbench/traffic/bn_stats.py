"""Seeded FrozenBatchNorm statistics for the network's weights.

``traffic.weights`` leaves every FrozenBatchNorm the identity (mean 0, var
1, scale 1, bias 0), under which a program that skipped the normalisation
would give the same outputs.  A trained network's statistics are those of
what each layer sees: so each layer's are drawn around its input's on one
frame, in the reference in float32 (TF32 off), layer by layer in the order
the forward reaches them, each layer normalising with its own before the
next is measured.  For each channel, from one device generator seeded with
the seed:

- ``mean``: the channel's mean plus 0.2 of its standard deviation times a
  normal draw;
- ``var``: the channel's variance (at least a hundredth of the layer's
  mean variance) times a factor log-uniform in [1/2, 2];
- ``scale`` uniform in [0.5, 1.5], ``bias`` uniform in [-0.5, 0.5]; both
  a fifth of that in a bottleneck's last norm, before the residual sum, as
  a trained ResNet's are small there.  At full scale the random 101-layer
  network amplifies rounding: bfloat16 moved its outputs by 0.9 of their
  largest magnitude against float32 at 128 px on the CPU, 0.12-0.15 with
  the fifth.

The statistics are written into the weights that both the program and the
reference are given.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from mfbench.reference import maskrcnn as ref_mm

BRANCH_END = "norm3"         # a bottleneck's last norm, before the sum
BRANCH_END_DAMP = 0.2


def draw_(model: ref_mm.MaskRCNN, weights: Dict[str, torch.Tensor],
          image: torch.Tensor, seed: int) -> Dict[str, torch.Tensor]:
    """Fill every FrozenBatchNorm entry of ``weights`` (name -> tensor, the
    reference's parameter names) in place from one forward of ``model``
    (the reference holding ``weights``) on ``image`` (1, S, S, 3) float32
    in [0, 255] on the model's device.  Returns ``weights``."""
    dev = image.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    names = {mod: name for name, mod in model.named_modules()
             if isinstance(mod, ref_mm.FrozenBatchNorm)}

    def uniform(n, lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=gen, device=dev)

    def measure(mod, args):
        x = args[0].float()
        dims = [d for d in range(x.dim()) if d != 1]
        var, mu = torch.var_mean(x, dims, correction=0)
        var = var.clamp(min=0.01 * float(var.mean()) + 1e-12)
        c = var.shape[0]
        damp = BRANCH_END_DAMP if names[mod].endswith(BRANCH_END) else 1.0
        stats = {
            "mean": mu + 0.2 * var.sqrt() * torch.randn(
                c, generator=gen, device=dev),
            "var": var * torch.exp(uniform(c, -math.log(2), math.log(2))),
            "scale": damp * uniform(c, 0.5, 1.5),
            "bias": damp * uniform(c, -0.5, 0.5)}
        with torch.no_grad():
            for k, v in stats.items():
                getattr(mod, k).copy_(v)
                weights[f"{names[mod]}.{k}"].copy_(v)

    hooks = [mod.register_forward_pre_hook(measure) for mod in names]
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            model(image)
    finally:
        for h in hooks:
            h.remove()
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    return weights
