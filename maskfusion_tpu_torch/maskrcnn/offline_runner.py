"""Offline mask generation.

Port of ``maskfusion_tpu/maskrcnn/offline_runner.py`` (the reference's
Core/Segmentation/MaskRCNN/offline_runner.py): run Mask R-CNN over a
directory of colour images and write Mask####.png id-images +
Mask####.png.txt class/ROI files compatible with `-maskdir`
(ImageLogReader), plus optional visualisations.  This doubles as the
determinism seam: freeze the stochastic NN output to files once, then SLAM
runs are reproducible.

Usage:
  python -m maskfusion_tpu_torch.maskrcnn.offline_runner -i <indir> -o <outdir>
         [--prefix Color] [--viz] [--filter 1,2,3] [--threshold 0.55]
         [--params weights.npz]

``--params`` reads the JAX package's parameter tree pickled in an .npz
(``params`` entry, as the JAX runner reads it) with numpy, or a flax
``.msgpack`` file with the port's own reader (no flax, no msgpack).
OpenCV is needed for the PNG and JPEG files only.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None, device=None):
    p = argparse.ArgumentParser("offline_runner")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--prefix", default="Color")
    p.add_argument("--outprefix", default="Mask")
    p.add_argument("--threshold", type=float, default=0.55)
    p.add_argument("--filter", default="",
                   help="comma-separated class ids to keep")
    p.add_argument("--viz", action="store_true")
    p.add_argument("--params", help="npz/msgpack checkpoint of weights")
    args = p.parse_args(argv)

    import numpy as np

    from maskfusion_tpu_torch.frame import FrameData
    from maskfusion_tpu_torch.maskrcnn.inference import MaskRCNNInference
    from maskfusion_tpu_torch.maskrcnn.model import MaskRCNNConfig

    filt = [int(c) for c in args.filter.split(",") if c] or None
    cfg = MaskRCNNConfig(score_threshold=args.threshold)
    params = load_params(args.params) if args.params else None
    inference = MaskRCNNInference(cfg, params=params, filter_classes=filt,
                                  device=device)

    os.makedirs(args.output, exist_ok=True)
    names = sorted(
        n for n in os.listdir(args.input)
        if n.startswith(args.prefix)
        and os.path.splitext(n)[1].lower() in (".png", ".jpg", ".jpeg")
    )
    for n, name in enumerate(names):
        idx = "".join(c for c in os.path.splitext(name)[0] if c.isdigit())
        rgb = read_rgb(os.path.join(args.input, name))
        frame = FrameData(rgb=rgb,
                          depth=np.zeros(rgb.shape[:2], np.float32))
        inference.execute(frame)
        out_png = os.path.join(args.output, f"{args.outprefix}{idx}.png")
        write_png(out_png, frame.mask)
        with open(out_png + ".txt", "w") as f:
            f.write(" ".join(str(c) for c in (frame.class_ids or [0])[1:]))
            f.write("\n")
            for roi in frame.rois or []:
                f.write(" ".join(str(v) for v in roi) + "\n")
        if args.viz:
            from maskfusion_tpu_torch.io.export import export_label_image

            export_label_image(args.output, int(idx or n), frame.mask)
        print(f"[{n + 1}/{len(names)}] {name}: "
              f"{len(frame.class_ids or [0]) - 1} instances", flush=True)
    return 0


def read_rgb(path: str):
    import cv2

    bgr = cv2.imread(path)
    if bgr is None:
        raise OSError(f"cannot read {path}")
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def write_png(path: str, image) -> None:
    import cv2

    if not cv2.imwrite(path, image):
        raise OSError(f"cannot write {path}")


def load_params(path: str):
    """The parameter tree of a flax ``.msgpack`` file, or of an .npz (its
    pickled ``params`` entry)."""
    import numpy as np

    if path.endswith(".msgpack"):
        from maskfusion_tpu_torch.maskrcnn.checkpoint_io import load_msgpack

        return load_msgpack(path)
    with np.load(path, allow_pickle=True) as z:
        return z["params"].item()


if __name__ == "__main__":
    sys.exit(main())
