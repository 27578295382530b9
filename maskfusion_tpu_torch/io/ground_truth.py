"""TUM-format ground-truth trajectory provider (ref: GUI/Tools/
GroundTruthOdometry.{h,cpp}): loads 'ts tx ty tz qx qy qz qw' lines and
serves camera poses by (closest) timestamp for the -p flag path
(MainController.cpp:208-210, 458-462).

Copy of ``maskfusion_tpu/io/ground_truth.py`` for the PyTorch port."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _quat_to_mat(qx, qy, qz, qw) -> np.ndarray:
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    return np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
    ])


class GroundTruthOdometry:
    def __init__(self, trajectory_file: str):
        self.poses: Dict[float, np.ndarray] = {}
        with open(trajectory_file) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                vals = [float(v) for v in line.replace(",", " ").split()]
                if len(vals) < 8:
                    continue
                ts, tx, ty, tz, qx, qy, qz, qw = vals[:8]
                T = np.eye(4, dtype=np.float32)
                T[:3, :3] = _quat_to_mat(qx, qy, qz, qw)
                T[:3, 3] = (tx, ty, tz)
                self.poses[ts] = T
        self._times = np.array(sorted(self.poses))
        self._first_inv: Optional[np.ndarray] = None

    def get_pose(self, timestamp: float, relative_to_first: bool = True
                 ) -> Optional[np.ndarray]:
        if len(self._times) == 0:
            return None
        idx = int(np.argmin(np.abs(self._times - timestamp)))
        T = self.poses[self._times[idx]]
        if relative_to_first:
            if self._first_inv is None:
                self._first_inv = np.linalg.inv(self.poses[self._times[0]])
            return (self._first_inv @ T).astype(np.float32)
        return T
