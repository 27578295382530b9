"""Frame containers.

Copy of ``maskfusion_tpu/frame.py`` for the PyTorch port.  Equivalent of
Core/FrameData.h:25-48: per-frame rgb (H,W,3 uint8), metric depth (H,W
float32, metres), optional instance mask (H,W uint8 label image) with
per-instance class ids and bounding boxes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class FrameData:
    rgb: np.ndarray                      # (H, W, 3) uint8, RGB order
    depth: np.ndarray                    # (H, W) float32 metres, or uint16
                                         # millimetres (device converts; 0 =
                                         # invalid either way)
    timestamp: float = 0.0
    index: int = -1
    mask: Optional[np.ndarray] = None    # (H, W) uint8 instance-id image
    class_ids: Optional[List[int]] = None
    rois: Optional[List[Tuple[int, int, int, int]]] = None  # (y0,x0,y1,x1)
    # host mirrors kept by engine.upload_frame when rgb/depth are staged to
    # device memory: host-side stages read these, never the device tensors
    rgb_host: Optional[np.ndarray] = None
    depth_host: Optional[np.ndarray] = None
    # kept so both packages accept the same FrameData; the port's
    # upload_frame stages synchronously-enqueued copies and leaves it None
    staged_future: Optional[object] = None

    def host_depth(self) -> np.ndarray:
        """Metric float32 depth on the host.  `depth` itself may be staged
        as RAW uint16 millimetres (engine.upload_frame keeps the wire
        format); this accessor always converts."""
        d = self.depth_host if self.depth_host is not None else self.depth
        d = np.asarray(d)
        if d.dtype == np.uint16:
            d = d.astype(np.float32) * np.float32(1e-3)
        elif d.dtype != np.float32:
            d = d.astype(np.float32)
        return d

    def host_rgb(self) -> np.ndarray:
        r = self.rgb_host if self.rgb_host is not None else self.rgb
        return np.asarray(r)

    @property
    def height(self) -> int:
        return int(self.rgb.shape[0])

    @property
    def width(self) -> int:
        return int(self.rgb.shape[1])

    def flip_colors(self) -> "FrameData":
        """-f flag: swap RGB/BGR (FrameData.h:40-46)."""
        return dataclasses.replace(self, rgb=self.rgb[..., ::-1].copy())
