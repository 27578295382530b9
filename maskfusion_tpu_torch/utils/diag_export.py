"""Offline diagnostic surface.

Port of ``maskfusion_tpu/utils/diag_export.py``.  Headless equivalent of the
reference GUI's live diagnostics: the ICP-error / inlier plots and per-model
error textures shown every frame (GUI/MainController.cpp:500-515, 911-921;
Model.cpp:313-345 binds the odometry error textures for display).  Instead
of rendering to screen, a DiagnosticExporter appends one CSV row per frame
(per-stage milliseconds, tracking errors, surfel counts) and writes
per-model alignment-error images every `interval` frames.

Enabled with Config.diag_export_dir (CLI: -diagdir)."""

from __future__ import annotations

import csv
import os
from typing import Optional

import numpy as np
import torch

_STAGES = ("Preprocess", "odom", "projection", "segmentation", "fuse", "Run")


def _alignment_error_image(pred_vmap: torch.Tensor, pred_nmap: torch.Tensor,
                           frame_vmap: torch.Tensor) -> torch.Tensor:
    """Per-pixel point-to-plane alignment residual |n . (v_pred - v_frame)|
    between the model's current prediction and the frame's vertices (both
    camera frame), on the maps' device — the offline stand-in for the GUI's
    ICP error texture.  NaN where any of the three is missing."""
    diff = pred_vmap - frame_vmap
    r = torch.abs(torch.sum(pred_nmap * diff, dim=-1))
    valid = (torch.isfinite(pred_vmap[..., 0])
             & torch.isfinite(frame_vmap[..., 0])
             & torch.isfinite(pred_nmap[..., 0]))
    return torch.where(valid, r, torch.full_like(r, float("nan")))


class DiagnosticExporter:
    def __init__(self, out_dir: str, interval: int = 1,
                 error_images: bool = True):
        self.out_dir = out_dir
        self.interval = max(1, interval)
        self.error_images = error_images
        os.makedirs(out_dir, exist_ok=True)
        self._csv_path = os.path.join(out_dir, "metrics.csv")
        self._csv_file = open(self._csv_path, "w", newline="")
        self._writer: Optional[csv.DictWriter] = None

    def close(self):
        if self._csv_file is not None:
            self._csv_file.close()
            self._csv_file = None

    def record(self, engine, diag: dict, frame_vmap=None):
        """Append a metrics row (every frame) and, on interval frames,
        write each model's alignment-error image."""
        tick = engine.tick
        row = {"tick": tick,
               "n_models": len(engine.models),
               "surfels": diag.get("surfels", ""),
               "tracking_ok": int(bool(diag.get("tracking_ok", True))),
               "icp_error": diag.get("icp_error", ""),
               "icp_count": diag.get("icp_count", "")}
        for s in _STAGES:
            row[f"ms_{s}"] = round(engine.stopwatch.last_ms.get(s, 0.0), 3)
        if self._writer is None:
            self._writer = csv.DictWriter(self._csv_file,
                                          fieldnames=list(row.keys()))
            self._writer.writeheader()
        self._writer.writerow(row)
        self._csv_file.flush()

        if not self.error_images or frame_vmap is None:
            return
        if tick % self.interval:
            return
        for model in engine.models:
            # on the model's device (a device of the models mesh)
            pv = model.state.pred_vmap
            err = _alignment_error_image(
                pv, model.state.pred_nmap,
                frame_vmap.to(pv.device)).cpu().numpy()
            self._save_error_png(err, tick, model.model_id)

    def _save_error_png(self, err: np.ndarray, tick: int, model_id: int):
        import cv2

        # 0..2 cm residual mapped to 0..255; NaN (no data) -> 0
        vis = np.clip(np.nan_to_num(err, nan=0.0) / 0.02, 0.0, 1.0)
        img = (vis * 255).astype(np.uint8)
        cv2.imwrite(os.path.join(
            self.out_dir, f"icp_error_{tick:05d}_m{model_id}.png"), img)
