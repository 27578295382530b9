"""Evaluation harness: ATE RMSE + segmentation IoU.

Copy of ``maskfusion_tpu/tools/evaluate.py`` for the PyTorch port (numpy;
OpenCV only where mask images are read).

The reference delegates evaluation to external repos (README "Dataset and
evaluation tools": martinruenz/dataset-tools evaluate_segmentation + the TUM
ATE scripts).  Having them in-tree makes parity claims reproducible:

  python -m maskfusion_tpu_torch.tools.evaluate ate <estimated.txt> <groundtruth.txt>
  python -m maskfusion_tpu_torch.tools.evaluate iou <est_mask_dir> <gt_mask_dir>
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Tuple

import numpy as np


def load_tum(path: str) -> Dict[float, np.ndarray]:
    """timestamp -> (8,) [t(3), q(4)] rows from a TUM trajectory file."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.replace(",", " ").split()]
            if len(vals) >= 8:
                out[vals[0]] = np.array(vals[1:8])
    return out


def associate(est: Dict, gt: Dict, max_dt: float = 0.02):
    """Greedy timestamp association (TUM associate.py semantics)."""
    pairs = []
    gt_times = np.array(sorted(gt))
    used = set()
    for t in sorted(est):
        i = int(np.argmin(np.abs(gt_times - t)))
        tg = gt_times[i]
        if abs(tg - t) <= max_dt and tg not in used:
            used.add(tg)
            pairs.append((t, tg))
    return pairs


def _umeyama(src: np.ndarray, dst: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Least-squares rigid alignment dst ~ R src + t (no scale)."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    cov = (dst - mu_d).T @ (src - mu_s) / len(src)
    u, _, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u @ vt) < 0:
        s[2, 2] = -1
    R = u @ s @ vt
    return R, mu_d - R @ mu_s


def ate_rmse(est_path: str, gt_path: str, max_dt: float = 0.02,
             align: bool = True) -> dict:
    """Absolute trajectory error RMSE after rigid alignment (the TUM
    evaluate_ate.py metric)."""
    est = load_tum(est_path)
    gt = load_tum(gt_path)
    pairs = associate(est, gt, max_dt)
    if len(pairs) < 2:
        raise ValueError(f"only {len(pairs)} associated pose pairs")
    p_est = np.stack([est[a][:3] for a, _ in pairs])
    p_gt = np.stack([gt[b][:3] for _, b in pairs])
    if align:
        R, t = _umeyama(p_est, p_gt)
        p_est = p_est @ R.T + t
    err = np.linalg.norm(p_est - p_gt, axis=1)
    return {
        "rmse": float(np.sqrt(np.mean(err ** 2))),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "max": float(err.max()),
        "pairs": len(pairs),
    }


def segmentation_iou(est_dir: str, gt_dir: str,
                     ignore_label: int = 255,
                     est_offset: int = 0) -> dict:
    """Per-sequence intersection-over-union between estimated and
    ground-truth label images with best label matching per frame
    (evaluate_segmentation semantics: labels are instance ids whose
    numbering may differ)."""
    import cv2

    def masks_of(d):
        return sorted(n for n in os.listdir(d) if n.endswith(".png"))

    def frame_no(name):
        digits = "".join(ch for ch in os.path.splitext(name)[0]
                         if ch.isdigit())
        return int(digits) if digits else -1

    # index ground truth by frame number: exporters write unpadded
    # tick-based names (Segmentation5.png, ticks start at 1) while dataset
    # masks are zero-padded frame-based (Mask0004.png)
    gt_by_no = {frame_no(n): os.path.join(gt_dir, n)
                for n in masks_of(gt_dir)}
    est_names = masks_of(est_dir)
    ious = []
    matched_frames = 0
    for name in est_names:
        no = frame_no(name) + est_offset
        gt_path = os.path.join(gt_dir, name)
        if not os.path.exists(gt_path):
            gt_path = gt_by_no.get(no, "")
        if not gt_path or not os.path.exists(gt_path):
            continue
        est = cv2.imread(os.path.join(est_dir, name), cv2.IMREAD_GRAYSCALE)
        gt = cv2.imread(gt_path, cv2.IMREAD_GRAYSCALE)
        if est is None or gt is None or est.shape != gt.shape:
            continue
        matched_frames += 1
        valid = (gt != ignore_label) & (est != ignore_label)
        for g in np.unique(gt[valid]):
            if g == 0:
                continue
            gmask = (gt == g) & valid
            best = 0.0
            for e in np.unique(est[gmask]):
                if e == 0:
                    continue
                emask = (est == e) & valid
                inter = (gmask & emask).sum()
                union = (gmask | emask).sum()
                if union:
                    best = max(best, inter / union)
            ious.append(best)
    return {
        "mean_iou": float(np.mean(ious)) if ious else 0.0,
        "instances": len(ious),
        "frames": matched_frames,
    }


def main(argv=None):
    p = argparse.ArgumentParser("evaluate")
    sub = p.add_subparsers(dest="cmd", required=True)
    a = sub.add_parser("ate")
    a.add_argument("estimated")
    a.add_argument("groundtruth")
    a.add_argument("--max-dt", type=float, default=0.02)
    a.add_argument("--no-align", action="store_true")
    i = sub.add_parser("iou")
    i.add_argument("estimated_dir")
    i.add_argument("groundtruth_dir")
    args = p.parse_args(argv)
    if args.cmd == "ate":
        res = ate_rmse(args.estimated, args.groundtruth, args.max_dt,
                       align=not args.no_align)
    else:
        res = segmentation_iou(args.estimated_dir, args.groundtruth_dir)
    import json

    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
