"""The MaskFusion segmentation method.

Port of ``maskfusion_tpu/segmentation/mf_segmentation.py`` (ref
MfSegmentation, Core/Segmentation/MfSegmentation.cpp): fuse instance masks
with geometric edge segmentation and the projected model-ID map into a
per-pixel model-ID image.

Split of labour (the reference's GPU/CPU split):
  device (torch): geometric edge map (kernel 3) -> threshold -> morphology
                                                               (ops/seg_ops)
  host (numpy):   connected components, edge reassignment, overlap
                  bookkeeping, mask->model assignment          (this file)
The host histograms take the native library (``maskfusion_tpu_torch.cpp``,
mfcore) where the JAX module takes its own; inside ``cpp.disabled()`` they
take the JAX module's bincount paths, their plain version.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from maskfusion_tpu_torch import cpp as native
from maskfusion_tpu_torch.config import Config
from maskfusion_tpu_torch.frame import FrameData
from maskfusion_tpu_torch.ops import seg_ops
from maskfusion_tpu_torch.segmentation import components as cc
from maskfusion_tpu_torch.segmentation.result import (ModelData,
                                                      SegmentationResult)


@dataclasses.dataclass
class ModelInfo:
    """What the segmenter needs to know about a live model."""
    model_id: int
    class_id: int = -1


class MfSegmentation:
    def __init__(self, config: Config, resolution, intrinsics):
        self.cfg = config
        self.res = resolution
        H, W = resolution.height, resolution.width
        self.semantic_ignore = np.zeros((H, W), np.uint8)
        self._ignore_any = False

    def edge_binary(self, vmap: torch.Tensor, nmap: torch.Tensor):
        """Device part: (edge strength, non-edge binary), both (H, W)."""
        cfg = self.cfg
        edge = seg_ops.geometric_edge_map(vmap, nmap, cfg.seg_weight_distance,
                                          cfg.seg_weight_concavity)
        binary = seg_ops.threshold_map(edge, cfg.seg_threshold)
        if cfg.seg_morph_edge_iterations > 0:
            binary = seg_ops.morph_binary(binary, cfg.seg_morph_edge_radius,
                                          cfg.seg_morph_edge_iterations)
        return edge, ~binary          # inverted: True = non-edge

    def perform(
        self,
        frame: FrameData,
        vmap,                       # (H, W, 3) filtered level-0 vertex map
        nmap,
        projected_ids: np.ndarray,  # (H, W) uint8 from global projection
        models: Sequence[ModelInfo],
        next_model_id: int,
        allow_new: bool,
        nonedge=None,
    ) -> SegmentationResult:
        """`nonedge`, when given, is a precomputed non-edge binary (numpy or
        a tensor) and the edge map is not run."""
        cfg = self.cfg
        H, W = self.res.height, self.res.width
        total = H * W
        mask = frame.mask if frame.mask is not None else np.zeros((H, W),
                                                                   np.uint8)
        class_ids = list(frame.class_ids or [])
        n_masks = len(class_ids)
        depth = frame.host_depth()

        # ---- device part: edge map -> non-edge binary ----
        if nonedge is None:
            _edge, nonedge = self.edge_binary(vmap, nmap)
        if isinstance(nonedge, torch.Tensor):
            nonedge = nonedge.cpu().numpy()
        nonedge = np.asarray(nonedge)

        # ---- person-ignore map (MfSegmentation.cpp:221-235) ----
        if n_masks:
            if cfg.person_class_id in class_ids:
                mask_classes = np.zeros(256, np.int32)
                mask_classes[: len(class_ids)] = class_ids
                is_person = mask_classes[mask] == cfg.person_class_id
                self.semantic_ignore = np.where(
                    is_person, 255, 0).astype(np.uint8)
                self._ignore_any = bool(is_person.any())
                nonedge = nonedge & ~is_person
            elif self._ignore_any:
                self.semantic_ignore = np.zeros((H, W), np.uint8)
                self._ignore_any = False
        elif self._ignore_any:
            nonedge = nonedge & (self.semantic_ignore == 0)

        # ---- connected components + edge reassignment (:239-291) ----
        comp = cc.connected_components(nonedge)
        labels = comp.labels
        if cfg.seg_remove_edges:
            labels = cc.reassign_edge_pixels(
                comp, depth,
                iterations=cfg.seg_edge_reassign_iters,
                depth_delta=cfg.seg_edge_reassign_depth_delta,
                small_threshold=cfg.seg_small_component_threshold,
            )

        n_comp = comp.count
        result = SegmentationResult(
            full_segmentation=np.zeros((H, W), np.uint8))

        model_ids = [m.model_id for m in models]
        id_to_index = np.zeros(256, np.int32)
        for i, mid in enumerate(model_ids):
            id_to_index[mid] = i
        n_models = len(models)
        for m in models:
            result.model_data.append(ModelData(m.model_id,
                                               class_id=m.class_id))

        # component-model overlap (:306-308): one native pass fills both
        # per-component histograms; the plain version is flat bincounts
        # over the label image
        lib = native.active()
        lab_flat = np.ascontiguousarray(labels, np.int32).ravel()
        proj_flat = np.ascontiguousarray(projected_ids, np.uint8).ravel()
        mask_flat = np.ascontiguousarray(mask, np.uint8).ravel()
        nm = max(n_models, 1)
        overlap = None
        if lib is not None:
            comp_model = np.zeros((n_comp, nm), np.int32)
            if n_masks > 1:
                overlap = np.zeros((n_comp, n_masks), np.int32)
            lib.mf_label_stats(
                lab_flat, proj_flat, id_to_index, mask_flat,
                lab_flat.size, nm, n_masks, comp_model.reshape(-1),
                (overlap if overlap is not None
                 else np.zeros(1, np.int32)).reshape(-1))
        else:
            comp_model = np.bincount(
                lab_flat * np.int32(nm) + id_to_index[proj_flat],
                minlength=n_comp * nm).reshape(n_comp, nm)
            if n_masks > 1:
                overlap = np.bincount(
                    lab_flat * np.int32(n_masks)
                    + mask_flat.clip(0, n_masks - 1).astype(np.int32),
                    minlength=n_comp * n_masks).reshape(n_comp, n_masks)
        csizes = comp_model.sum(1)

        # ---- component <-> mask overlap, 0.65 rule (:310-344) ----
        map_comp_to_mask = np.zeros(n_comp, np.int32)
        mask_pixels = np.zeros(max(n_masks, 1), np.int64)
        if n_masks > 1:
            # at most ONE mask can hold > 65% of a component, so the
            # first-hit of the reference loop == the argmax here
            cand = overlap[:, 1:]
            best_mi = cand.argmax(1).astype(np.int32) + 1
            best_ov = np.take_along_axis(
                cand, (best_mi - 1)[:, None], 1)[:, 0]
            elig = ((csizes > cfg.seg_min_mapped_component_size)
                    & (best_ov > 0.65 * csizes))
            elig[0] = False
            map_comp_to_mask = np.where(elig, best_mi, 0).astype(np.int32)
            mask_pixels = np.bincount(
                map_comp_to_mask, weights=csizes.astype(np.float64),
                minlength=max(n_masks, 1)).astype(np.int64)
            mask_pixels[0] = 0

        seg = map_comp_to_mask[labels].astype(np.uint8)
        if self._ignore_any:
            seg[self.semantic_ignore > 0] = 255

        if n_masks:
            # morphological closing of masks (:424-426)
            if cfg.seg_morph_mask_iterations > 0:
                from scipy import ndimage

                r = cfg.seg_morph_mask_radius
                y, x = np.ogrid[-r:r + 1, -r:r + 1]
                el = (x * x + y * y) <= r * r
                for _ in range(cfg.seg_morph_mask_iterations):
                    seg = ndimage.grey_dilation(seg, footprint=el)
                    seg = ndimage.grey_erosion(seg, footprint=el)

            # ---- mask -> model assignment (:432-494) ----
            mask_to_id = np.zeros(256, np.uint8)
            mask_to_id[255] = 255   # keep semantic-ignore pixels ignored
            for mi in range(1, n_masks):
                if class_ids[mi] == cfg.person_class_id:
                    mask_to_id[mi] = 255

            # overlap of segmentation labels with projected model ids;
            # ids of non-live models map to row 0, which the loop below
            # never reads (j starts at 1)
            if lib is not None:
                model_mask_overlap = np.zeros((n_models, 256), np.int32)
                lib.mf_model_seg_overlap(
                    np.ascontiguousarray(seg).ravel(), proj_flat,
                    id_to_index, seg.size, model_mask_overlap.reshape(-1))
            else:
                model_mask_overlap = np.bincount(
                    id_to_index[proj_flat] * np.int32(256) + seg.ravel(),
                    minlength=n_models * 256).reshape(n_models, 256)

            min_new = cfg.seg_min_new_rel * total
            max_new = cfg.seg_max_new_rel * total
            for mi in range(1, n_masks):
                if mask_to_id[mi] == 255:
                    continue
                best_idx, best_overlap = 0, 0
                for j in range(1, n_models):
                    ov = model_mask_overlap[j, mi]
                    if ov > best_overlap:
                        best_overlap, best_idx = ov, j
                best_matches_class = (
                    best_idx != 0
                    and models[best_idx].class_id == class_ids[mi])
                if (best_overlap
                        < cfg.seg_min_mask_model_overlap * mask_pixels[mi]):
                    best_idx = 0
                if best_idx != 0 and best_matches_class:
                    mask_to_id[mi] = models[best_idx].model_id
                    md = result.model_data[best_idx]
                    md.is_empty = False
                    md.pixel_count = int(mask_pixels[mi])
                elif (not result.has_new_label and allow_new
                      and min_new < mask_pixels[mi] < max_new
                      and best_idx == 0):
                    mask_to_id[mi] = next_model_id
                    result.has_new_label = True
                    result.new_model_class_id = class_ids[mi]
                    result.model_data.append(ModelData(
                        next_model_id, is_empty=False,
                        pixel_count=int(mask_pixels[mi]),
                        class_id=class_ids[mi]))
                else:
                    mask_to_id[mi] = 255

            seg = mask_to_id[seg]

        # ---- leftover components -> models by 0.6 overlap (:496-522) ----
        if n_models:
            midx = comp_model.argmax(1)
            ov = np.take_along_axis(comp_model, midx[:, None], 1)[:, 0]
            mid_arr = np.asarray(model_ids, np.uint8)[midx]
            take = ((map_comp_to_mask == 0) & (mid_arr > 0)
                    & (ov > 0.6 * csizes))
            take[0] = False
            comp_override = np.where(take, mid_arr, 0).astype(np.uint8)
            if comp_override.any():
                ov_img = comp_override[labels]
                seg = np.where(ov_img > 0, ov_img, seg)

        result.full_segmentation = seg

        # per-model depth statistics (SegmentationResult::ModelData) as
        # label-bincount moments
        if lib is not None:
            cnt = np.zeros(256, np.int64)
            s1 = np.zeros(256, np.float64)
            s2 = np.zeros(256, np.float64)
            lib.mf_depth_moments(
                np.ascontiguousarray(seg).ravel(),
                np.ascontiguousarray(depth, np.float32).ravel(), seg.size,
                cnt, s1, s2)
        else:
            dvalid = depth > 0
            seg_v = seg[dvalid].astype(np.int64)
            d_v = depth[dvalid].astype(np.float64)
            cnt = np.bincount(seg_v, minlength=256)
            s1 = np.bincount(seg_v, weights=d_v, minlength=256)
            s2 = np.bincount(seg_v, weights=d_v * d_v, minlength=256)
        for md in result.model_data:
            n_px = int(cnt[md.model_id])
            if n_px:
                mean = s1[md.model_id] / n_px
                var = max(s2[md.model_id] / n_px - mean * mean, 0.0)
                md.depth_mean = float(mean)
                md.depth_std = float(np.sqrt(var))
                md.pixel_count = n_px
                md.is_empty = False
        return result
