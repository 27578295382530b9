"""Connected components + stats and the edge-pixel reassignment pass.

Port of ``maskfusion_tpu/segmentation/components.py`` (the reference also
runs this on the CPU: cv::connectedComponentsWithStats at
MfSegmentation.cpp:239 and the edge-reassignment loop at :243-291).  Both
take the native library (``maskfusion_tpu_torch.cpp``, mfcore) unless it is
``disabled()``; the numpy / scipy code is their plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
from scipy import ndimage

from maskfusion_tpu_torch import cpp as native


class Components(NamedTuple):
    labels: np.ndarray       # (H, W) int32, 0 = background/edges
    sizes: np.ndarray        # (n,) pixel counts per label (index 0 = bg)
    bboxes: np.ndarray       # (n, 4) (top, left, bottom, right) inclusive
    count: int


_FOUR_CONN = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], dtype=bool)


def connected_components(binary: np.ndarray) -> Components:
    """4-connected components with stats (cv::connectedComponentsWithStats
    equivalent)."""
    lib = native.active()
    if lib is not None:
        h, w = binary.shape
        b = np.ascontiguousarray(binary.astype(np.uint8))
        labels = np.empty((h, w), np.int32)
        # retry ladder: fragmented scenes (hole-ridden depth) can exceed
        # 16k components; the worst case is a checkerboard at h*w/4 + bg
        for max_comp in (16384, h * w // 4 + 2):
            sizes = np.empty(max_comp, np.int32)
            bboxes = np.empty((max_comp, 4), np.int32)
            n = lib.mf_connected_components(
                b, h, w, labels.reshape(-1), sizes, bboxes.reshape(-1),
                max_comp)
            if n >= 0:
                return Components(labels=labels, sizes=sizes[:n].copy(),
                                  bboxes=bboxes[:n].copy(), count=int(n))
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
    lib = native.active()
    if lib is not None:
        labels = np.ascontiguousarray(comp.labels, np.int32).copy()
        sizes = np.ascontiguousarray(comp.sizes, np.int32)
        d = np.ascontiguousarray(depth, np.float32)
        lib.mf_reassign_edges(labels.reshape(-1), d, sizes,
                              labels.shape[0], labels.shape[1],
                              iterations, depth_delta, small_threshold)
        return labels
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
