"""The plain reference of the MaskFusion segmentation's host stage.

A frozen copy of ``MfSegmentation.perform``
(``maskfusion_tpu_torch/segmentation/mf_segmentation.py``; MaskFusion's
MfSegmentation.cpp:221-522) on its plain paths: the numpy bincounts where
the program takes its native host library, and the frozen plain connected
components beside this file.  It fuses the instance masks with the non-edge
binary's connected components and the projected model ids into a per-pixel
model-id image.  Nothing of the program is imported.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from mfbench.reference import seg_components as cc
from mfbench.reference.seg_result import ModelData, SegmentationResult


class ModelInfo:
    def __init__(self, model_id: int, class_id: int = -1):
        self.model_id = model_id
        self.class_id = class_id


def perform(cfg: Dict, mask: np.ndarray, class_ids: Sequence[int],
            depth: np.ndarray, nonedge: np.ndarray,
            projected_ids: np.ndarray, models: Sequence[Tuple[int, int]],
            next_model_id: int, allow_new: bool, state: Dict
            ) -> SegmentationResult:
    """``models`` the live models' (id, class); ``depth`` metric float32;
    ``state`` the segmenter's ``semantic_ignore`` and ``ignore_any``
    before the call (updated in place, as the program's)."""
    models = [ModelInfo(i, c) for i, c in models]
    H, W = nonedge.shape
    total = H * W
    class_ids = list(class_ids)
    n_masks = len(class_ids)
    nonedge = np.asarray(nonedge)

    # ---- person-ignore map (MfSegmentation.cpp:221-235) ----
    if n_masks:
        if cfg["person_class_id"] in class_ids:
            mask_classes = np.zeros(256, np.int32)
            mask_classes[: len(class_ids)] = class_ids
            is_person = mask_classes[mask] == cfg["person_class_id"]
            state['semantic_ignore'] = np.where(
                is_person, 255, 0).astype(np.uint8)
            state['ignore_any'] = bool(is_person.any())
            nonedge = nonedge & ~is_person
        elif state['ignore_any']:
            state['semantic_ignore'] = np.zeros((H, W), np.uint8)
            state['ignore_any'] = False
    elif state['ignore_any']:
        nonedge = nonedge & (state['semantic_ignore'] == 0)

    # ---- connected components + edge reassignment (:239-291) ----
    comp = cc.connected_components(nonedge)
    labels = comp.labels
    if cfg["seg_remove_edges"]:
        labels = cc.reassign_edge_pixels(
            comp, depth,
            iterations=cfg["seg_edge_reassign_iters"],
            depth_delta=cfg["seg_edge_reassign_depth_delta"],
            small_threshold=cfg["seg_small_component_threshold"],
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

    # component-model overlap (:306-308): flat bincounts over the label
    # image
    lab_flat = np.ascontiguousarray(labels, np.int32).ravel()
    proj_flat = np.ascontiguousarray(projected_ids, np.uint8).ravel()
    mask_flat = np.ascontiguousarray(mask, np.uint8).ravel()
    nm = max(n_models, 1)
    overlap = None
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
        elig = ((csizes > cfg["seg_min_mapped_component_size"])
                & (best_ov > 0.65 * csizes))
        elig[0] = False
        map_comp_to_mask = np.where(elig, best_mi, 0).astype(np.int32)
        mask_pixels = np.bincount(
            map_comp_to_mask, weights=csizes.astype(np.float64),
            minlength=max(n_masks, 1)).astype(np.int64)
        mask_pixels[0] = 0

    seg = map_comp_to_mask[labels].astype(np.uint8)
    if state['ignore_any']:
        seg[state['semantic_ignore'] > 0] = 255

    if n_masks:
        # morphological closing of masks (:424-426)
        if cfg["seg_morph_mask_iterations"] > 0:
            from scipy import ndimage

            r = cfg["seg_morph_mask_radius"]
            y, x = np.ogrid[-r:r + 1, -r:r + 1]
            el = (x * x + y * y) <= r * r
            for _ in range(cfg["seg_morph_mask_iterations"]):
                seg = ndimage.grey_dilation(seg, footprint=el)
                seg = ndimage.grey_erosion(seg, footprint=el)

        # ---- mask -> model assignment (:432-494) ----
        mask_to_id = np.zeros(256, np.uint8)
        mask_to_id[255] = 255   # keep semantic-ignore pixels ignored
        for mi in range(1, n_masks):
            if class_ids[mi] == cfg["person_class_id"]:
                mask_to_id[mi] = 255

        # overlap of segmentation labels with projected model ids;
        # ids of non-live models map to row 0, which the loop below
        # never reads (j starts at 1)
        model_mask_overlap = np.bincount(
            id_to_index[proj_flat] * np.int32(256) + seg.ravel(),
            minlength=n_models * 256).reshape(n_models, 256)

        min_new = cfg["seg_min_new_rel"] * total
        max_new = cfg["seg_max_new_rel"] * total
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
                    < cfg["seg_min_mask_model_overlap"] * mask_pixels[mi]):
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
