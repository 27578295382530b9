"""The plain reference of MaskFusion's labeller (matterport's COCO Mask
R-CNN) at the program's boxes, and the comparison of the outputs that no
score threshold hides.

``network.forward`` reads the RPN and the class logits; this adds the two
heads the labelling forward runs after them.  From the frame resized as
the program resizes it, in float32 with TF32 off (``maskrcnn.py``, from the
weights the benchmark made), it gives:

- ``rpn_logits``, ``rpn_deltas``: the RPN over every anchor;
- ``class_logits``, ``box_deltas``: the box head at the program's
  proposals (the reference pools its own features at them);
- ``mask_logits``: the mask head at the program's detection picks before
  the score threshold (``pick_boxes``), each for the program's class
  (``pick_classes``).

``compare`` gives each as its largest gap against the reference's largest
magnitude: ``rpn_gap`` (logits and deltas), ``cls_gap``, ``box_gap`` and
``mask_gap``.  With ``fp8`` (``network.build``) the reference is the
control.

The two NMS loops only feed those outputs, so ``nms_flips`` checks them by
themselves, as the training cell checks its proposals: the reference's
proposal stage run on the program's RPN outputs against the program's
proposals (``proposal_flips``), and the reference's detection assembly and
NMS run on the program's proposals and box head outputs against the
program's picks, their classes and which pass the score threshold
(``pick_flips``).  The same operations on the same tensors give the same
bits, so both read 0 unless a stage differs.
"""

from __future__ import annotations

from typing import Dict

import torch

from mfbench.reference import maskrcnn as mm
from mfbench.reference import network
from mfbench.reference import train as ref_train
from mfbench.reference.resize import resize_rgb_u8

KEYS = ("rpn_logits", "rpn_deltas", "class_logits", "box_deltas",
        "mask_logits")


def forward(model: mm.MaskRCNN, rgb: torch.Tensor, proposals: torch.Tensor,
            boxes: torch.Tensor, classes: torch.Tensor
            ) -> Dict[str, torch.Tensor]:
    """rgb (H, W, 3) uint8 on the device; ``proposals`` (N, 4) and
    ``boxes`` (D, 4) normalised y1x1y2x2; ``classes`` (D,) ints."""
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
            cls_logits, box_deltas = model.box_head(rois)
            mrois = mm.roi_align(feats, boxes.float(), cfg.mask_pool_size,
                                 cfg)
            masks = model.mask_head(mrois.permute(0, 3, 1, 2))
            masks = masks[torch.arange(masks.shape[0], device=masks.device),
                          classes.long()]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    return {"rpn_logits": logits[0], "rpn_deltas": deltas[0],
            "class_logits": cls_logits, "box_deltas": box_deltas,
            "mask_logits": masks.float()}


def program_outputs(out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The compared outputs of the program's forward dict."""
    return {"rpn_logits": out["rpn_logits"][0],
            "rpn_deltas": out["rpn_deltas"][0],
            "class_logits": out["class_logits"],
            "box_deltas": out["box_deltas"],
            "mask_logits": out["mask_logits"]}


def compare(got: Dict[str, torch.Tensor],
            want: Dict[str, torch.Tensor]) -> Dict[str, float]:
    gap = network.rel_gap
    return {"rpn_gap": max(gap(got["rpn_logits"], want["rpn_logits"]),
                           gap(got["rpn_deltas"], want["rpn_deltas"])),
            "cls_gap": gap(got["class_logits"], want["class_logits"]),
            "box_gap": gap(got["box_deltas"], want["box_deltas"]),
            "mask_gap": gap(got["mask_logits"], want["mask_logits"])}


def detection_picks(model: mm.MaskRCNN, proposals: torch.Tensor,
                    proposal_valid: torch.Tensor, class_logits: torch.Tensor,
                    box_deltas: torch.Tensor):
    """The reference forward's detection assembly and NMS on the given
    proposals and box head outputs: the picks' boxes and classes before the
    score threshold, and which picks pass it."""
    cfg = model.cfg
    probs = torch.softmax(class_logits, -1)
    best_cls = torch.argmax(probs[:, 1:], -1) + 1
    best_score = probs.gather(1, best_cls[:, None])[:, 0]
    best_score = torch.where(proposal_valid, best_score, 0.0)
    det_deltas = box_deltas[torch.arange(box_deltas.shape[0],
                                         device=box_deltas.device), best_cls]
    det_boxes = torch.clamp(mm.apply_deltas(proposals, det_deltas
                                            * model.bbox_std), 0.0, 1.0)
    sel, valid = mm.nms_fixed(det_boxes, best_score, cfg.max_detections,
                              cfg.detection_nms_threshold)
    return (det_boxes[sel], best_cls[sel],
            valid & (best_score[sel] >= cfg.score_threshold))


def nms_flips(model: mm.MaskRCNN, out: Dict[str, torch.Tensor]
              ) -> Dict[str, float]:
    """``proposal_flips``: the program's proposals (box or validity) that
    the reference's proposal stage on the program's RPN outputs does not
    give; ``pick_flips``: the program's detection picks (box, class, or
    whether it passes the score threshold) that the reference's detection
    stage on the program's proposals and box head outputs does not give."""
    props = ref_train.proposal_flips(
        model, [(out["rpn_logits"][0], out["rpn_deltas"][0])],
        [(out["proposals"], out["proposal_valid"])])
    with torch.no_grad():
        boxes, classes, valid = detection_picks(
            model, out["proposals"], out["proposal_valid"],
            out["class_logits"], out["box_deltas"])
        picks = int(((boxes != out["pick_boxes"]).any(-1)
                     | (classes != out["pick_classes"])
                     | (valid != out["detection_valid"])).sum())
    return {"proposal_flips": float(props), "pick_flips": float(picks)}
