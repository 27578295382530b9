"""Precomputed-mask segmentation (ref: Core/Segmentation/PreSegmentation.cpp).

Maps mask-file label values to model IDs with a persistent label->model
mapping across frames (PreSegmentation.cpp:40-96): the first time a label is
seen it is assigned to a (possibly new) model; labels keep their model for
the rest of the run.  This is the deterministic CI/testing seam — no NN
required (`-method precomputed`).

Copy of ``maskfusion_tpu/segmentation/pre_segmentation.py`` for the PyTorch
port: host-only numpy."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from maskfusion_tpu_torch.frame import FrameData
from maskfusion_tpu_torch.segmentation.result import ModelData, SegmentationResult


class PreSegmentation:
    def __init__(self, config):
        self.cfg = config
        self.label_to_model: Dict[int, int] = {0: 0}
        self._tentative = None

    def remap_new_label(self, tentative_id: int, actual_id: int):
        """The engine redetected an inactive model for this frame's new
        label — keep the persistent mapping pointing at the real model."""
        for lab, mid in list(self.label_to_model.items()):
            if mid == tentative_id:
                self.label_to_model[lab] = actual_id

    def perform(
        self,
        frame: FrameData,
        vmap=None,
        nmap=None,
        projected_ids=None,
        models: Sequence = (),
        next_model_id: int = 1,
        allow_new: bool = True,
    ) -> SegmentationResult:
        H, W = frame.depth.shape
        mask = frame.mask if frame.mask is not None else np.zeros((H, W), np.uint8)
        result = SegmentationResult(full_segmentation=np.zeros((H, W), np.uint8))
        model_ids = {m.model_id for m in models} | {0}

        for md in models:
            result.model_data.append(ModelData(md.model_id, class_id=md.class_id))

        labels = np.unique(mask)
        class_ids = list(frame.class_ids or [])
        out = np.zeros((H, W), np.uint8)
        for lab in labels:
            lab = int(lab)
            if lab == 0:
                continue
            if lab == 255:
                out[mask == lab] = 255
                continue
            if (lab in self.label_to_model
                    and self.label_to_model[lab] not in model_ids):
                # the mapped model was deactivated; re-offer the label as new
                # so the engine can redetect/reactivate or spawn fresh
                del self.label_to_model[lab]
            if lab not in self.label_to_model:
                if allow_new and not result.has_new_label:
                    self.label_to_model[lab] = next_model_id
                    cid = class_ids[lab] if lab < len(class_ids) else -1
                    result.has_new_label = True
                    result.new_model_class_id = cid
                    result.model_data.append(ModelData(
                        next_model_id, is_empty=False, class_id=cid,
                    ))
                else:
                    out[mask == lab] = 255
                    continue
            mid = self.label_to_model[lab]
            if mid in model_ids or (result.has_new_label and mid == next_model_id):
                out[mask == lab] = mid
            else:
                out[mask == lab] = 255

        result.full_segmentation = out
        self._tentative = next_model_id if result.has_new_label else None
        depth = frame.host_depth()
        for md in result.model_data:
            sel = (out == md.model_id) & (depth > 0)
            if sel.any():
                md.is_empty = False
                md.pixel_count = int(sel.sum())
                md.depth_mean = float(depth[sel].mean())
                md.depth_std = float(depth[sel].std())
        return result
