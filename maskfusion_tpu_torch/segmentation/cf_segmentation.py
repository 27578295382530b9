"""Co-Fusion motion segmentation (-method cofusion).

Port of ``maskfusion_tpu/segmentation/cf_segmentation.py``, the
re-implementation of Core/Segmentation/CfSegmentation.cpp: SLIC superpixels
(16 px) -> per-superpixel unaries from each model's alignment error and
prediction confidence (:108-228) -> fully-connected CRF with Potts
smoothness + appearance (x, y, RGB, depth) kernels (:366-401) -> argmax ->
connected components with keep-largest / size suppression (:414-498).

At superpixel resolution (40x30 = 1200 nodes at 640x480) the dense pairwise
kernel is small, so mean-field runs exactly, as matmuls.  SLIC, the
superpixel reductions and the CRF run on the segmenter's device (the
engine's); the unaries, the dilation and the post-processing run on the
host, as in the JAX package, and connected components take the native
``mfcore`` (``components``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from scipy import ndimage

from maskfusion_tpu_torch import default_device
from maskfusion_tpu_torch.config import Config
from maskfusion_tpu_torch.frame import FrameData
from maskfusion_tpu_torch.ops import slic as slic_ops
from maskfusion_tpu_torch.segmentation import components as cc
from maskfusion_tpu_torch.segmentation.result import (ModelData,
                                                      SegmentationResult)

MAX_DEPTH = 100.0


def dense_crf_meanfield(
    unary: torch.Tensor,       # (L, N) energies (higher = worse)
    feats_app: torch.Tensor,   # (N, F) appearance features
    feats_pos: torch.Tensor,   # (N, 2) smoothness features
    weight_appearance: float = 40.0,
    weight_smoothness: float = 3.0,
    iterations: int = 10,
) -> torch.Tensor:
    """Exact dense mean-field with Potts compatibility over (N, N) kernel
    matrices.  Returns the (L, N) marginals."""
    def kernel(feats):
        d2 = ((feats[:, None, :] - feats[None, :, :]) ** 2).sum(-1)
        k = torch.exp(-0.5 * d2)
        return k - torch.diag(torch.diag(k))      # no self-potential

    k_app = kernel(feats_app)
    k_pos = kernel(feats_pos)
    q = torch.softmax(-unary, 0)
    for _ in range(iterations):
        msg = (weight_appearance * (q @ k_app.T)
               + weight_smoothness * (q @ k_pos.T))
        # Potts: penalty for agreeing with OTHER labels' mass
        q = torch.softmax(-unary - (msg.sum(0, keepdim=True) - msg), 0)
    return q


class CfSegmentation:
    # the engine builds per-model alignment-error / confidence views for
    # the CRF unaries (engine._cf_model_views); without them the
    # projected-id fallback below cannot reach the new-label threshold
    wants_model_views = True

    def __init__(self, config: Config, resolution, intrinsics, device=None):
        self.cfg = config
        self.res = resolution
        self.device = (torch.device(device) if device is not None
                       else default_device())
        self.spacing = 16
        # reference defaults (CfSegmentation.h:29-42)
        self.crf_iterations = 10
        self.unary_threshold_new = 5.0
        self.unary_k_error = 0.01
        self.unary_weight_error = 40.0
        self.weight_appearance = 40.0
        self.weight_smoothness = 3.0
        self.scale_pos = 0.1
        self.scale_rgb = 1.0 / 30.0
        self.scale_depth = 1.0
        self.min_segment_size = 50   # suppression on the low grid scale

    def _to_dev(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def perform(
        self,
        frame: FrameData,
        vmap,
        nmap,
        projected_ids: np.ndarray,
        models: Sequence,
        next_model_id: int,
        allow_new: bool,
        model_views: Optional[Sequence[dict]] = None,
    ) -> SegmentationResult:
        """`model_views`: per model, a dict with 'error' (H, W alignment
        error) and 'conf' (H, W prediction confidence); when absent they
        are derived from the projected-id map (prediction coverage) — the
        engine passes real per-model views."""
        H, W = frame.depth.shape[:2]
        depth = self._to_dev(frame.host_depth())
        rgb = self._to_dev(frame.host_rgb())
        n_models = len(models)
        n_labels = n_models + (1 if allow_new else 0)

        s = slic_ops.slic(rgb, spacing=self.spacing)
        gh, gw = s.grid_hw
        n_spx = gh * gw

        def low(a) -> np.ndarray:
            return slic_ops.downsample(self._to_dev(a), s.labels,
                                       n_spx).cpu().numpy()

        depth_np = slic_ops.downsample(depth, s.labels, n_spx).cpu().numpy()
        finite = depth_np[(depth_np > 0) & np.isfinite(depth_np)]
        depth_range = float(finite.max() - finite.min()) if len(finite) \
            else 1.0
        depth_range = max(depth_range, 1e-3)

        # --- unaries (CfSegmentation.cpp:168-222) ---
        unary = np.zeros((n_labels, n_spx), np.float32)
        for i, model in enumerate(models):
            if model_views is not None and i < len(model_views):
                err = low(model_views[i]["error"])
                conf = low(model_views[i]["conf"])
            else:
                owned = (projected_ids ==
                         getattr(model, "model_id", 0)).astype(np.float32)
                conf = low(owned)
                err = (1.0 - conf) * depth_range * 0.05
            err = np.nan_to_num(err, nan=depth_range)
            conf = np.nan_to_num(conf, nan=0.0)
            if i == 0:
                # the global model is the default owner: unexplored pixels
                # (no prediction yet) are cheap for it, so fresh territory
                # maps into the background rather than spawning
                err = np.where(conf < 0.3, depth_range * 0.01, err)
            else:
                # an object label has evidence only where it predicts:
                # cheap within ~3 superpixels of its prediction (its
                # motion-lag band), priced out far away (the JAX package's
                # measurements of a flat fallback either way are in its
                # cf_segmentation.py:163-178)
                on = (conf > 0.4).reshape(gh, gw)
                near = ndimage.binary_dilation(on, iterations=3).reshape(-1)
                err = np.where(conf > 0.4, err,
                               np.where(near, depth_range * 0.05,
                                        depth_range * 0.5))
            unary[i] = self.unary_weight_error * (err / depth_range)

        if allow_new:
            lowest = unary[:n_models].min(axis=0) / max(
                self.unary_weight_error, 1e-6)
            unary[n_models] = np.maximum(
                self.unary_threshold_new
                - self.unary_weight_error * lowest, 0.01)

        # --- exact dense CRF on superpixels (:366-401) ---
        mean_pos = s.mean_pos.cpu().numpy()
        feats_app = np.concatenate([
            mean_pos * self.scale_pos,
            s.mean_rgb.cpu().numpy() * self.scale_rgb,
            np.clip(depth_np, 0, MAX_DEPTH)[:, None] * self.scale_depth,
        ], axis=1).astype(np.float32)
        feats_pos = mean_pos / 2.0   # sigma 2 on the grid
        q = dense_crf_meanfield(
            self._to_dev(unary), self._to_dev(feats_app),
            self._to_dev(feats_pos), self.weight_appearance,
            self.weight_smoothness, self.crf_iterations)
        low_labels = torch.argmax(q, 0).cpu().numpy().astype(np.int32)

        # --- upsample + post-processing (:414-498) ---
        label_ids = [getattr(m, "model_id", 0) for m in models]
        if allow_new:
            label_ids.append(next_model_id)
        pixel_lab = low_labels[s.labels.cpu().numpy()]

        result = SegmentationResult(
            full_segmentation=np.zeros((H, W), np.uint8))
        for m in models:
            result.model_data.append(
                ModelData(getattr(m, "model_id", 0),
                          class_id=getattr(m, "class_id", -1)))

        seg = np.zeros((H, W), np.uint8)
        has_new = False
        for li in range(1, n_labels):
            sel = pixel_lab == li
            if not sel.any():
                continue
            comp = cc.connected_components(sel)
            if comp.count <= 1:
                continue
            largest = int(np.argmax(comp.sizes[1:])) + 1
            keep = comp.labels == largest   # keep-largest (:414-498)
            if keep.sum() < max(self.min_segment_size, 0.003 * H * W):
                continue
            # border suppression: components hugging the frame border are
            # unreliable (:475-489)
            ys, xs = np.where(keep)
            border_frac = (
                ((ys < 2) | (ys >= H - 2) | (xs < 2) | (xs >= W - 2)).mean())
            if border_frac > 0.2:
                continue
            mid = label_ids[li]
            if li == n_models:   # the "new label" slot
                rel = keep.sum() / (H * W)
                if not (self.cfg.seg_min_new_rel < rel
                        < self.cfg.seg_max_new_rel) or has_new:
                    continue
                has_new = True
                result.has_new_label = True
                result.model_data.append(ModelData(
                    next_model_id, is_empty=False,
                    pixel_count=int(keep.sum())))
            seg[keep] = mid

        result.full_segmentation = seg
        d = frame.host_depth()
        for md in result.model_data:
            selm = (seg == md.model_id) & (d > 0)
            if selm.any():
                md.is_empty = False
                md.pixel_count = int(selm.sum())
                md.depth_mean = float(d[selm].mean())
                md.depth_std = float(d[selm].std())
        return result
