"""Fill-in: composite a model's predicted view with raw frame data.

A frozen copy of ``maskfusion_tpu_torch/ops/fill_in.py`` (imports rewritten
to this folder; nothing of the program is imported).

Port of ``maskfusion_tpu/ops/fill_in.py`` (ref FillIn +
fill_rgb/vertex/normal.frag, Core/FillIn.cpp:21-166): wherever the
prediction has holes, substitute the live frame's data so tracking always
sees a dense reference view.  `passthrough` forces the raw frame everywhere.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mfbench.reference.splat import Prediction


class FilledView(NamedTuple):
    rgb: torch.Tensor    # (H, W, 3) float32
    vmap: torch.Tensor   # (H, W, 3) camera frame
    nmap: torch.Tensor   # (H, W, 3)


def _predicted(pred: Prediction) -> torch.Tensor:
    return (pred.conf > 0) & torch.isfinite(pred.vmap[..., 0])


def fill_in(pred: Prediction, frame_rgb, frame_vmap, frame_nmap,
            passthrough: bool = False) -> FilledView:
    sel = (_predicted(pred) & (not passthrough))[..., None]
    return FilledView(
        rgb=torch.where(sel, pred.rgb, frame_rgb.to(torch.float32)),
        vmap=torch.where(sel, pred.vmap, frame_vmap),
        nmap=torch.where(sel, pred.nmap, frame_nmap),
    )


def coverage(pred: Prediction) -> torch.Tensor:
    """Fraction of pixels with a valid prediction (the engine's
    requiresFillIn check, MaskFusion.cpp:630-648)."""
    return _predicted(pred).to(torch.float32).mean()
