"""Inactive-model redetection interface.

Port of ``maskfusion_tpu/mapping/model_matching.py`` (host numpy; a model's
prediction and pose are fetched from the device once, when its description
is built or it is detected).

Parity with Core/Model/ModelMatching.h:34: the reference declares an
IModelMatcher strategy (Drost point-pair-feature matching) whose
implementation was removed upstream (Model.cpp:135-139,
MaskFusion::redetectModels gutted at MaskFusion.cpp:686-689).  The interface
exists here with the same surface plus a working baseline matcher based on
fern codes, so redetection can actually be enabled
(Config: enable_redetection)."""

from __future__ import annotations

import abc
import dataclasses
from typing import Optional

import numpy as np


def _host(a) -> np.ndarray:
    """A device tensor or an array, as a host array."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclasses.dataclass
class ModelDetectionResult:
    """Equivalent of the reference's detection result: found pose + model."""
    model_id: int
    pose: np.ndarray
    confidence: float


class IModelMatcher(abc.ABC):
    """Strategy interface (ModelMatching.h)."""

    @abc.abstractmethod
    def build_model_description(self, model) -> bool:
        """Precompute a matchable description of an (inactive) model."""

    @abc.abstractmethod
    def detect_in_region(self, frame, roi, inactive_models
                         ) -> Optional[ModelDetectionResult]:
        """Try to re-detect one of the inactive models inside frame ROI."""


class FernModelMatcher(IModelMatcher):
    """Baseline matcher: encodes each inactive model's last prediction with
    random ferns and compares against the frame crop — cheap and sufficient
    to re-activate recently lost objects (the reference ships no matcher at
    all)."""

    def __init__(self, num_ferns: int = 200, seed: int = 7,
                 accept_threshold: float = 0.55):
        rng = np.random.default_rng(seed)
        self.n = num_ferns
        self.pos = rng.random((num_ferns, 2))       # relative (y, x) in ROI
        self.thresh = rng.integers(0, 256, (num_ferns, 3))
        self.accept_threshold = accept_threshold
        self.descriptions = {}

    def _encode(self, rgb_crop: np.ndarray) -> np.ndarray:
        h, w = rgb_crop.shape[:2]
        ys = (self.pos[:, 0] * (h - 1)).astype(int)
        xs = (self.pos[:, 1] * (w - 1)).astype(int)
        px = rgb_crop[ys, xs]
        return (
            ((px[:, 0] > self.thresh[:, 0]).astype(np.uint8) << 2)
            | ((px[:, 1] > self.thresh[:, 1]).astype(np.uint8) << 1)
            | (px[:, 2] > self.thresh[:, 2]).astype(np.uint8)
        )

    def build_model_description(self, model) -> bool:
        rgb = _host(model.state.pred_rgb)
        ok = np.isfinite(rgb).all(-1) & (rgb.sum(-1) > 0)
        if ok.sum() < 64:
            return False
        ys, xs = np.where(ok)
        crop = np.clip(rgb[ys.min():ys.max() + 1, xs.min():xs.max() + 1],
                       0, 255).astype(np.uint8)
        self.descriptions[model.model_id] = (self._encode(crop), model)
        return True

    def detect_in_region(self, frame, roi, inactive_models
                         ) -> Optional[ModelDetectionResult]:
        y0, x0, y1, x1 = roi
        crop = frame.host_rgb()[y0:y1, x0:x1]
        if crop.size == 0:
            return None
        code = self._encode(crop)
        best = None
        for mid, (desc, model) in self.descriptions.items():
            if not any(m.model_id == mid for m in inactive_models):
                continue
            score = float((code == desc).mean())
            if score >= self.accept_threshold and (
                    best is None or score > best[0]):
                best = (score, model)
        if best is None:
            return None
        return ModelDetectionResult(
            model_id=best[1].model_id,
            pose=_host(best[1].state.pose),
            confidence=best[0],
        )
