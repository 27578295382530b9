"""Geometric segmentation stencils (device side).

Port of the parts of ``maskfusion_tpu/ops/seg_ops.py`` that the
multi-object frame runs (ref Core/Cuda/segmentation.cu):
  - `geometric_edge_map`  (computeGeometricSegmentation_Kernel, :122-177):
    the hand-written kernel ops/kernels.geometric_edge_map, whose plain
    version is the JAX package's tap loop;
  - `morph_binary`        (dilate/erode uchar, :217-255, :334-354);
  - `threshold_map`       (:257-269);
  - `joint_bilateral_filter` (bilateralFilter_Kernel, :23-94), which no
    code path calls: the reference runs it only when the segmentation
    front-end filters its own depth (REUSE_FILTERED_MAPS=false,
    MfSegmentation.cpp:56,154).  A stencil of torch ops, no kernel.
"""

from __future__ import annotations

import torch

from maskfusion_tpu_torch.ops import kernels
from maskfusion_tpu_torch.ops.kernels import shift


def geometric_edge_map(vmap: torch.Tensor, nmap: torch.Tensor,
                       weight_distance: float,
                       weight_concavity: float) -> torch.Tensor:
    """Per-pixel edginess in [0, 1]: max(wC * concavity, wD * distance
    discontinuity) over the 8-neighbourhood; border pixels and invalid
    depth are 1.  vmap, nmap: (H, W, 3) f32 with NaN for invalid."""
    return kernels.geometric_edge_map(
        vmap.to(torch.float32).contiguous(),
        nmap.to(torch.float32).contiguous(),
        weight_distance, weight_concavity)


def _window_extreme(img: torch.Tensor, radius: int, is_max: bool,
                    include_center: bool) -> torch.Tensor:
    fill = -float("inf") if is_max else float("inf")
    out = img if include_center else torch.full_like(img, fill)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dy == 0 and dx == 0 and not include_center:
                continue
            nb = shift(img, dy, dx, fill)
            out = torch.maximum(out, nb) if is_max else torch.minimum(out, nb)
    return out


def morph_binary(mask: torch.Tensor, radius: int,
                 iterations: int) -> torch.Tensor:
    """Binary closing: `iterations` rounds of dilate-then-erode over a
    (2r+1)^2 window, centre excluded like the reference kernels."""
    m = mask
    for _ in range(iterations):
        d = _window_extreme(m.to(torch.float32), radius, True, False) > 0
        m = _window_extreme(d.to(torch.float32), radius, False, False) > 0
    return m


def threshold_map(edge: torch.Tensor, threshold: float) -> torch.Tensor:
    return edge > threshold


def joint_bilateral_filter(rgb: torch.Tensor, depth: torch.Tensor,
                           radius: int = 8, sigma_depth: float = 0.1,
                           sigma_color: float = 40.0,
                           sigma_location: float = 5.0) -> torch.Tensor:
    """Joint color/depth/space bilateral depth filter (segmentation.cu:
    23-76); the defaults are the GUI's operative values (GUI.h:362-365).
    Depth pads with inf and colour with 0; the taps accumulate in row-major
    offset order, as the JAX package's scan does, so the sums round alike."""
    isd = 0.5 / (sigma_depth * sigma_depth)
    isc = 0.5 / (sigma_color * sigma_color)
    isl = 0.5 / (sigma_location * sigma_location)
    depth = depth.to(torch.float32)
    rgbf = rgb.to(torch.float32)
    sum_v = torch.zeros_like(depth)
    sum_w = torch.zeros_like(depth)
    inf = float("inf")
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            nd = shift(depth, dy, dx, inf)
            dc = rgbf - shift(rgbf, dy, dx, 0.0)
            # the squared offset as an f32 scalar, scaled in f32 as in the
            # JAX package's scan body
            loc = torch.tensor(float(dy * dy + dx * dx),
                               dtype=torch.float32, device=depth.device)
            col2 = dc[..., 0] ** 2 + dc[..., 1] ** 2 + dc[..., 2] ** 2
            dep2 = (depth - nd) ** 2
            w = torch.exp(-loc * isl - dep2 * isd - col2 * isc)
            fin = torch.isfinite(nd)
            w = torch.where(fin, w, 0.0)
            sum_v = sum_v + torch.where(fin, nd, 0.0) * w
            sum_w = sum_w + w
    return sum_v / torch.clamp(sum_w, min=1e-20)
