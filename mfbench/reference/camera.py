"""Frozen copy of ``maskfusion_tpu_torch/camera.py``,
the plain PyTorch version the benchmark judges the program against
(imports rewritten to this folder; nothing of the program is imported).

Camera intrinsics / resolution registry.

Copy of ``maskfusion_tpu/camera.py`` for the PyTorch port (the port imports
nothing of the JAX package).  Equivalent of the reference's ``CameraModel``
(Core/Cuda/types.cuh:84-99) and the ``Resolution``/``Intrinsics`` singletons
selected by CLI presets (GUI/MainController.cpp:117-128).  Pure static data.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CameraIntrinsics:
    """Pinhole intrinsics. ``level(i)`` halves focal/center per pyramid level,
    matching CameraModel::operator()(level) (types.cuh:94-98)."""

    fx: float
    fy: float
    cx: float
    cy: float

    def level(self, i: int) -> "CameraIntrinsics":
        s = 1.0 / (1 << i)
        return CameraIntrinsics(self.fx * s, self.fy * s, self.cx * s, self.cy * s)

    @property
    def k(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float64,
        )

    @property
    def k_inv(self) -> np.ndarray:
        return np.linalg.inv(self.k)

    def as_tuple(self) -> Tuple[float, float, float, float]:
        return (self.fx, self.fy, self.cx, self.cy)


@dataclasses.dataclass(frozen=True)
class Resolution:
    width: int
    height: int

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    def level(self, i: int) -> "Resolution":
        return Resolution(self.width >> i, self.height >> i)


# Presets mirroring GUI/MainController.cpp:117-126.
PRESETS = {
    # default 640x480 (TUM fr1/fr2-style)
    "default": (Resolution(640, 480), CameraIntrinsics(528.0, 528.0, 320.0, 240.0)),
    # -tum3 (TUM fr3)
    "tum3": (Resolution(640, 480), CameraIntrinsics(535.4, 539.2, 320.1, 247.6)),
    # -v2 (Kinect v2)
    "v2": (Resolution(512, 424), CameraIntrinsics(363.58, 363.53, 250.32, 212.55)),
}


def get_preset(name: str) -> Tuple[Resolution, CameraIntrinsics]:
    return PRESETS[name]
