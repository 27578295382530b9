"""Burn class-name labels and bounding boxes into result frames.

Port of ``maskfusion_tpu/tools/sequence_add_bbox_labels.py``, the
equivalent of Tools/sequence_add_bbox_labels.cpp (80 LoC standalone
utility): reads Color####.png frames and Mask####.png.txt class/ROI files
and writes annotated frames.

Usage:
  python -m maskfusion_tpu_torch.tools.sequence_add_bbox_labels \
      -dir <frames> -maskdir <masks> -o <outdir> [--toml config.toml]
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    p = argparse.ArgumentParser("sequence_add_bbox_labels")
    p.add_argument("-dir", dest="dir", required=True)
    p.add_argument("-maskdir", dest="maskdir")
    p.add_argument("-o", dest="out", required=True)
    p.add_argument("--colorprefix", default="Color")
    p.add_argument("--maskprefix", default="Mask")
    p.add_argument("--toml", dest="toml_config")
    args = p.parse_args(argv)

    import cv2
    import numpy as np

    from maskfusion_tpu_torch.io.image_reader import _load_mask_ids
    from maskfusion_tpu_torch.maskrcnn.inference import COCO_CLASS_NAMES
    from maskfusion_tpu_torch.viewer import LABEL_COLORS

    class_names = COCO_CLASS_NAMES
    if args.toml_config:
        from maskfusion_tpu_torch.maskrcnn.inference import load_toml_config

        class_names = load_toml_config(args.toml_config)["class_names"]

    maskdir = args.maskdir or args.dir
    os.makedirs(args.out, exist_ok=True)
    count = 0
    for name in sorted(os.listdir(args.dir)):
        base, ext = os.path.splitext(name)
        if ext.lower() != ".png" or not base.startswith(args.colorprefix):
            continue
        idx = base[len(args.colorprefix):]
        txt = os.path.join(maskdir, f"{args.maskprefix}{idx}.png.txt")
        img = cv2.imread(os.path.join(args.dir, name))
        if img is None:
            continue
        if os.path.exists(txt):
            class_ids, rois = _load_mask_ids(txt)
            for inst, roi in enumerate(rois, start=1):
                y0, x0, y1, x1 = roi
                color = tuple(int(c) for c in LABEL_COLORS[inst % 31][::-1])
                cv2.rectangle(img, (x0, y0), (x1, y1), color, 2)
                cid = class_ids[inst] if inst < len(class_ids) else 0
                label = (class_names[cid]
                         if 0 <= cid < len(class_names) else str(cid))
                cv2.putText(img, label, (x0 + 2, max(y0 - 4, 10)),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.45, color, 1,
                            cv2.LINE_AA)
        cv2.imwrite(os.path.join(args.out, name), img)
        count += 1
    print(f"annotated {count} frames -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
