"""Synthetic RGB-D sequence generator in the reader's on-disk layout.

Copy of ``maskfusion_tpu/tools/make_sequence.py`` for the PyTorch port
(numpy; OpenCV only where images are written).

The reference evaluates on TUM fr1/fr3 and the Co-Fusion sequences (README
"Dataset and evaluation tools"); this box has no network access, so parity
runs use generated sequences with the same structure instead: an aggressive
SE(3) camera loop over a wavy textured scene, an independently moving
object, Color####.png / Depth####.png (uint16 mm) / Mask####.png(.txt) in
ImageLogReader's conventions (image_reader.py:42-75), TUM-format camera and
object ground-truth trajectories, and per-frame ground-truth mask PNGs for
segmentation IoU.

    python -m maskfusion_tpu_torch.tools.make_sequence out_dir \
        --frames 200 --width 640 --height 480

Citations: trajectory/evaluation flow mirrors MaskFusion.cpp:850-879 pose
export + the external evaluate_segmentation tool's directory convention.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def _rot(rvec):
    th = np.linalg.norm(rvec)
    if th < 1e-12:
        return np.eye(3)
    k = np.asarray(rvec) / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _quat(R):
    # wxyz -> TUM qx qy qz qw
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
        q = [0.0, 0.0, 0.0, 0.0]
        q[i] = 0.25 * s
        q[3] = (R[k, j] - R[j, k]) / s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        x, y, z, w = q[0], q[1], q[2], q[3]
    return x, y, z, w


def camera_pose(s: float) -> np.ndarray:
    """Aggressive smooth loop: returns to the start for loop-closure tests."""
    w = 2 * np.pi * s
    t = np.array([0.22 * np.sin(w), 0.15 * np.sin(2 * w + 1.0),
                  0.10 * np.sin(w)])
    rvec = np.array([0.10 * np.sin(w + 0.5), 0.24 * np.sin(w),
                     0.08 * np.sin(2 * w)])
    T = np.eye(4, dtype=np.float64)
    T[:3, :3] = _rot(rvec)
    T[:3, 3] = t
    return T


def object_offset(s: float) -> np.ndarray:
    """Object translation path (out and back along x, slight y)."""
    w = 2 * np.pi * s
    return np.array([0.12 * np.sin(w), 0.04 * np.sin(2 * w), 0.0])


def make_points(width, seed=0):
    """Dense wavy background + textured object patch, ~6 pts/px at VGA."""
    rng = np.random.default_rng(seed)
    n_u = int(width * 3.4)
    n_v = int(n_u * 0.8)
    x = np.linspace(-1.35, 1.35, n_u)
    y = np.linspace(-1.05, 1.05, n_v)
    X, Y = np.meshgrid(x, y)
    Z = 2.0 + 0.22 * np.sin(2.3 * X) * np.cos(1.9 * Y) + 0.06 * np.sin(7 * X)
    pts_bg = np.stack([X, Y, Z], -1).reshape(-1, 3).astype(np.float32)
    r = 127.5 + 90 * np.sin(9 * X) + 30 * np.cos(17 * Y)
    g = 127.5 + 90 * np.cos(7 * Y) + 25 * np.sin(13 * X)
    b = 127.5 + 80 * np.sin(5 * (X + Y))
    cols_bg = np.stack([r, g, b], -1).reshape(-1, 3).clip(0, 255).astype(np.uint8)

    n = int(width * 1.6)
    ox = np.linspace(-0.28, 0.28, n)
    oy = np.linspace(-0.21, 0.21, int(n * 0.75))
    OX, OY = np.meshgrid(ox, oy)
    OZ = 1.45 + 0.10 * np.sin(4.5 * OX) + 0.08 * np.cos(5.5 * OY)
    pts_obj = np.stack([OX + 0.12, OY - 0.06, OZ], -1).reshape(-1, 3).astype(np.float32)
    orr = 127.5 + 110 * np.sin(15 * OX)
    og = 127.5 + 110 * np.cos(12 * OY)
    ob = np.full_like(orr, 70.0)
    cols_obj = np.stack([orr, og, ob], -1).reshape(-1, 3).clip(0, 255).astype(np.uint8)

    labels = np.concatenate([np.zeros(len(pts_bg), np.uint8),
                             np.ones(len(pts_obj), np.uint8)])
    return pts_bg, cols_bg, pts_obj, cols_obj, labels


def render(pts_w, cols, pose_c2w, fx, fy, cx, cy, w, h, labels=None):
    T = np.asarray(pose_c2w, np.float64)
    R = T[:3, :3]
    t = T[:3, 3]
    p_cam = (pts_w - t) @ R
    z = p_cam[:, 2]
    front = z > 0.05
    uf = p_cam[:, 0] * fx / z + cx
    vf = p_cam[:, 1] * fy / z + cy
    u = np.round(uf).astype(np.int64)
    v = np.round(vf).astype(np.int64)
    ok = front & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    lin = v[ok] * w + u[ok]
    zok = z[ok].astype(np.float32)
    zbuf = np.full(h * w, np.inf, np.float32)
    np.minimum.at(zbuf, lin, zok)
    near = zok <= zbuf[lin] * (1 + 5e-3)
    du = uf[ok] - np.round(uf[ok])
    dv = vf[ok] - np.round(vf[ok])
    cd = np.where(near, (du * du + dv * dv).astype(np.float32), np.inf)
    best = np.full(h * w, np.inf, np.float32)
    np.minimum.at(best, lin, cd)
    win = near & (cd <= best[lin])
    rgb = np.zeros((h * w, 3), np.uint8)
    rgb[lin[win]] = cols[ok][win]
    depth = np.zeros(h * w, np.float32)
    depth[lin[win]] = zok[win]
    out = [rgb.reshape(h, w, 3), depth.reshape(h, w)]
    if labels is not None:
        lab = np.zeros(h * w, np.uint8)
        lab[lin[win]] = labels[ok][win]
        out.append(lab.reshape(h, w))
    return out


def generate(out_dir, frames=200, width=640, height=480, seed=0,
             with_object=True, object_class=7, rate_hz=24.0):
    import cv2

    os.makedirs(out_dir, exist_ok=True)
    gt_mask_dir = os.path.join(out_dir, "gt_masks")
    os.makedirs(gt_mask_dir, exist_ok=True)
    fx = fy = 0.825 * width
    cx, cy = width / 2.0, height / 2.0

    pts_bg, cols_bg, pts_obj, cols_obj, labels = make_points(width, seed)
    cam_lines = []
    obj_lines = []
    for i in range(frames):
        s = i / max(frames - 1, 1)
        T = camera_pose(s)
        off = object_offset(s) if with_object else np.zeros(3)
        pts = np.concatenate([pts_bg, pts_obj + off.astype(np.float32)])
        cols = np.concatenate([cols_bg, cols_obj])
        rgb, depth, lab = render(pts, cols, T, fx, fy, cx, cy,
                                 width, height, labels)
        cv2.imwrite(os.path.join(out_dir, f"Color{i:04d}.png"),
                    cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
        d16 = np.clip(depth * 1000.0, 0, 65535).astype(np.uint16)
        cv2.imwrite(os.path.join(out_dir, f"Depth{i:04d}.png"), d16)
        if with_object:
            cv2.imwrite(os.path.join(out_dir, f"Mask{i:04d}.png"), lab)
            with open(os.path.join(out_dir, f"Mask{i:04d}.png.txt"), "w") as f:
                f.write(f"{object_class}\n")
            cv2.imwrite(os.path.join(gt_mask_dir, f"Mask{i:04d}.png"), lab)
        ts = i * 1000.0 / rate_hz
        qx, qy, qz, qw = _quat(T[:3, :3])
        cam_lines.append(
            f"{ts:.6f} {T[0,3]:.6f} {T[1,3]:.6f} {T[2,3]:.6f} "
            f"{qx:.6f} {qy:.6f} {qz:.6f} {qw:.6f}")
        obj_lines.append(
            f"{ts:.6f} {off[0]:.6f} {off[1]:.6f} {off[2]:.6f} 0 0 0 1")
    with open(os.path.join(out_dir, "groundtruth.txt"), "w") as f:
        f.write("\n".join(cam_lines) + "\n")
    if with_object:
        with open(os.path.join(out_dir, "object_groundtruth.txt"), "w") as f:
            f.write("\n".join(obj_lines) + "\n")
    with open(os.path.join(out_dir, "calibration.txt"), "w") as f:
        f.write(f"{fx} {fy} {cx} {cy}\n")
    return out_dir


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("out_dir")
    p.add_argument("--frames", type=int, default=200)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-object", action="store_true")
    args = p.parse_args(argv)
    generate(args.out_dir, args.frames, args.width, args.height, args.seed,
             with_object=not args.no_object)
    print(f"wrote {args.frames} frames to {args.out_dir}")


if __name__ == "__main__":
    main()
