"""Result exporters.

Equivalents of the reference's export paths:
  - save_ply:      per-model binary PLY with confidence filtering
                   (MaskFusion::savePly, MaskFusion.cpp:733-848)
  - export_poses:  TUM-format pose logs, poses-<id>.txt
                   (MaskFusion::exportPoses, :850-879)
  - segmentation / label / normal image dumps (-es/-el/-en,
    MaskFusion.cpp:299-303, MainController.cpp:468-481)

Copy of ``maskfusion_tpu/io/export.py`` for the PyTorch port, with the same
bytes out for the same inputs.  The engine's pose log holds device tensors;
export_poses copies each to the host.  OpenCV is imported only by the PNG
exporters.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch


def save_ply(path: str, surfels: Dict[str, np.ndarray],
             conf_threshold: float = 0.0):
    """Binary little-endian PLY: x y z | nx ny nz | r g b | radius, filtered
    by confidence (the reference writes the same attribute set)."""
    keep = surfels["conf"] > conf_threshold
    pos = surfels["pos"][keep].astype("<f4")
    nrm = surfels["normal"][keep].astype("<f4")
    col = np.clip(surfels["color"][keep], 0, 255).astype(np.uint8)
    rad = surfels["radius"][keep].astype("<f4")
    n = len(pos)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property float nx\nproperty float ny\nproperty float nz\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "property float radius\n"
        "end_header\n"
    )
    rec = np.zeros(n, dtype=[("p", "<f4", 3), ("n", "<f4", 3),
                             ("c", "u1", 3), ("r", "<f4")])
    rec["p"] = pos
    rec["n"] = nrm
    rec["c"] = col
    rec["r"] = rad
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(rec.tobytes())
    return n


def load_ply(path: str) -> Dict[str, np.ndarray]:
    """Read back the PLYs written by save_ply (for tests/tools)."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            header += f.readline()
        n = int([l for l in header.decode().splitlines()
                 if l.startswith("element vertex")][0].split()[-1])
        rec = np.frombuffer(
            f.read(), dtype=[("p", "<f4", 3), ("n", "<f4", 3),
                             ("c", "u1", 3), ("r", "<f4")], count=n,
        )
    return {"pos": rec["p"].copy(), "normal": rec["n"].copy(),
            "color": rec["c"].astype(np.float32), "radius": rec["r"].copy()}


def _mat_to_quat(R: np.ndarray):
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 0)) * 2
        q = np.zeros(4)
        q[i] = 0.25 * s
        q[3] = (R[k, j] - R[j, k]) / s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        qx, qy, qz, qw = q
    return qx, qy, qz, qw


def export_poses(export_dir: str, models: List, use_ticks: bool = False):
    """poses-<id>.txt per model: 'timestamp tx ty tz qx qy qz qw' lines
    (TUM format, MaskFusion.cpp:850-879; LOG_TICKS switch :22)."""
    os.makedirs(export_dir, exist_ok=True)
    paths = []
    for model in models:
        path = os.path.join(export_dir, f"poses-{model.model_id}.txt")
        with open(path, "w") as f:
            for entry in model.pose_log:
                T = entry["pose"]
                T = (T.detach().cpu().numpy() if isinstance(T, torch.Tensor)
                     else np.asarray(T))
                t = T[:3, 3]
                qx, qy, qz, qw = _mat_to_quat(T[:3, :3])
                stamp = entry["tick"] if use_ticks else entry["timestamp"]
                f.write(f"{stamp} {t[0]} {t[1]} {t[2]} "
                        f"{qx} {qy} {qz} {qw}\n")
        paths.append(path)
    return paths


def export_segmentation_png(export_dir: str, tick: int, seg: np.ndarray):
    """Segmentation####.png with 255 (ignore) zeroed, matching the
    reference's THRESH_TOZERO_INV export (MaskFusion.cpp:299-303)."""
    import cv2

    os.makedirs(export_dir, exist_ok=True)
    out = np.where(seg == 255, 0, seg).astype(np.uint8)
    path = os.path.join(export_dir, f"Segmentation{tick}.png")
    cv2.imwrite(path, out)
    return path


def export_normal_image(export_dir: str, tick: int, nmap: np.ndarray):
    import cv2

    os.makedirs(export_dir, exist_ok=True)
    vis = np.zeros((*nmap.shape[:2], 3), np.uint8)
    ok = np.isfinite(nmap[..., 0])
    vis[ok] = ((nmap[ok] * 0.5 + 0.5) * 255).astype(np.uint8)
    path = os.path.join(export_dir, f"Normals{tick}.png")
    cv2.imwrite(path, cv2.cvtColor(vis, cv2.COLOR_RGB2BGR))
    return path


def export_label_image(export_dir: str, tick: int, seg: np.ndarray):
    """Colorised label image (-el; color table from color_table.glsl)."""
    import cv2

    colors = np.array(
        [[0, 0, 0], [0, 0, 255], [255, 0, 0], [0, 255, 0], [255, 26, 184],
         [255, 211, 0], [0, 131, 246], [0, 140, 70], [167, 96, 61],
         [79, 0, 105], [0, 255, 246], [61, 123, 140], [237, 167, 255],
         [211, 255, 149], [184, 79, 255], [228, 26, 87], [131, 131, 0],
         [0, 255, 149], [96, 0, 43], [246, 131, 17], [202, 255, 0],
         [43, 61, 0], [0, 52, 193], [255, 202, 131], [0, 43, 96],
         [158, 114, 140], [79, 184, 17], [158, 193, 255], [149, 158, 123],
         [255, 123, 175], [158, 8, 0]], np.uint8)
    os.makedirs(export_dir, exist_ok=True)
    vis = colors[seg % 31]
    vis[seg == 255] = 255
    path = os.path.join(export_dir, f"Labels{tick}.png")
    cv2.imwrite(path, cv2.cvtColor(vis, cv2.COLOR_RGB2BGR))
    return path
