"""Segmentation output containers (ref: Core/Segmentation/SegmentationResult.h).

A frozen copy of ``maskfusion_tpu_torch/segmentation/result.py``
(imports rewritten to this folder; nothing of the program is imported).

Copy of ``maskfusion_tpu/segmentation/result.py`` for the PyTorch port."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class ModelData:
    """Per-model statistics attached to a segmentation result
    (SegmentationResult.h:30-60)."""
    model_id: int
    is_empty: bool = True
    pixel_count: int = 0
    depth_mean: float = 30.0
    depth_std: float = 30.0
    class_id: int = -1
    top: int = 0
    left: int = 0
    bottom: int = 0
    right: int = 0


@dataclasses.dataclass
class SegmentationResult:
    """full_segmentation: (H, W) uint8 image of model IDs; 255 = ignore
    (SegmentationResult.h:62-72)."""
    full_segmentation: np.ndarray
    model_data: List[ModelData] = dataclasses.field(default_factory=list)
    has_new_label: bool = False
    new_model_class_id: int = -1

    def data_for(self, model_id: int) -> Optional[ModelData]:
        for md in self.model_data:
            if md.model_id == model_id:
                return md
        return None
