"""Frozen copy of the plain (numpy / scipy) versions of the program's
connected components with stats and edge-pixel reassignment
(``maskfusion_tpu_torch/segmentation/components.py``; MaskFusion's
cv::connectedComponentsWithStats at MfSegmentation.cpp:239 and the
edge-reassignment loop at :243-291).  The program runs them in its native
host library.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
from scipy import ndimage



class Components(NamedTuple):
    labels: np.ndarray       # (H, W) int32, 0 = background/edges
    sizes: np.ndarray        # (n,) pixel counts per label (index 0 = bg)
    bboxes: np.ndarray       # (n, 4) (top, left, bottom, right) inclusive
    count: int


_FOUR_CONN = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], dtype=bool)


def connected_components(binary: np.ndarray) -> Components:
    """4-connected components with stats (cv::connectedComponentsWithStats
    equivalent)."""
    labels, n = ndimage.label(binary, structure=_FOUR_CONN)
    labels = labels.astype(np.int32)
    sizes = np.bincount(labels.ravel(), minlength=n + 1)
    bboxes = np.zeros((n + 1, 4), np.int32)
    slices = ndimage.find_objects(labels)
    for i, sl in enumerate(slices, start=1):
        if sl is None:
            continue
        bboxes[i] = (sl[0].start, sl[1].start, sl[0].stop - 1, sl[1].stop - 1)
    return Components(labels=labels, sizes=sizes, bboxes=bboxes, count=n + 1)


_OFFS8 = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)]


def _shifted(arr: np.ndarray, dy: int, dx: int, fill) -> np.ndarray:
    H, W = arr.shape
    out = np.full_like(arr, fill)
    ys = slice(max(0, -dy), H - max(0, dy))
    xs = slice(max(0, -dx), W - max(0, dx))
    yd = slice(max(0, dy), H - max(0, -dy))
    xd = slice(max(0, dx), W - max(0, -dx))
    out[ys, xs] = arr[yd, xd]
    return out


def reassign_edge_pixels(comp: Components, depth: np.ndarray,
                         iterations: int = 5, depth_delta: float = 0.008,
                         small_threshold: int = 50) -> np.ndarray:
    """Grow components into edge pixels by depth continuity
    (MfSegmentation.cpp:243-291): for `iterations` synchronous rounds, every
    pixel labelled 0 (edge) or belonging to a tiny component adopts the first
    8-neighbour (fixed priority order) whose component is big enough and
    whose depth is within `depth_delta`."""
    labels = comp.labels.copy()
    sizes = comp.sizes
    H, W = labels.shape
    interior = np.zeros((H, W), bool)
    interior[1:-1, 1:-1] = True

    for _ in range(iterations):
        needs = (labels == 0) | (sizes[labels] < small_threshold)
        needs &= interior
        if not needs.any():
            break
        new_labels = labels.copy()
        unassigned = needs.copy()
        for dy, dx in _OFFS8:
            nl = _shifted(labels, dy, dx, 0)
            ndepth = _shifted(depth, dy, dx, np.inf)
            ok = (unassigned & (nl != 0)
                  & (np.abs(ndepth - depth) < depth_delta)
                  & (sizes[nl] > small_threshold))
            new_labels[ok] = nl[ok]
            unassigned &= ~ok
        labels = new_labels
    return labels
