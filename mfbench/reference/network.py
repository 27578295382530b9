"""The plain reference of the served network's forward, and the comparison
of its outputs before the score threshold.

The reference is the frozen copy of the network (``maskrcnn.py``) in
float32 with TF32 off on the frame resized as the program resizes it
(``resize.py``), from the weights the benchmark made.  It judges two
outputs of a forward that the program served in the window:

- ``rpn_gap``: the RPN's class logits and box deltas over every anchor, the
  largest gap against the reference's largest magnitude;
- ``cls_gap``: the box head's class logits over the program's proposals
  (the proposals are the program's; the reference pools its own features
  at them), the largest gap against the reference's largest magnitude.

With ``fp8`` the reference is the control: every multiply-accumulate layer
computes in bfloat16 on operands rounded to fp8.
"""

from __future__ import annotations

from typing import Dict

import torch

from mfbench.reference import maskrcnn as mm
from mfbench.reference import train as ref_train
from mfbench.reference.resize import resize_rgb_u8


def forward(model: mm.MaskRCNN, rgb: torch.Tensor,
            proposals: torch.Tensor) -> Dict[str, torch.Tensor]:
    """rgb (H, W, 3) uint8 on the device; ``proposals`` (N, 4) the boxes at
    which the box head's logits are read."""
    cfg = model.cfg
    S = cfg.image_size
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            img = resize_rgb_u8(rgb, (S, S)).float()[None]
            feats = model.features(img)
            logits, deltas = model.rpn(feats)
            rois = mm.roi_align(feats, proposals.float(), cfg.roi_pool_size,
                                cfg)
            cls_logits, _ = model.box_head(rois)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    return {"rpn_logits": logits[0], "rpn_deltas": deltas[0],
            "class_logits": cls_logits}


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1e-30))


def compare(got: Dict[str, torch.Tensor],
            want: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {"rpn_gap": max(rel_gap(got["rpn_logits"], want["rpn_logits"]),
                           rel_gap(got["rpn_deltas"], want["rpn_deltas"])),
            "cls_gap": rel_gap(got["class_logits"], want["class_logits"])}


def build(net: Dict, weights, fp8: bool = False, device="cuda"):
    return ref_train.build(net, weights, fp8=fp8, device=device).eval()
