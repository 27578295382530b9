"""SLIC superpixels in PyTorch.

Port of ``maskfusion_tpu/ops/slic.py``, the equivalent of the reference's
gSLICr wrapper (Core/Segmentation/Slic.{h,cpp}, 16-px spacing): grid-seeded
local k-means over (colour, position) with the 3x3-neighbourhood
assignment restriction, plus the down/upsampling helpers CfSegmentation
uses.  Segment sums are the port's ``sort_utils.segment_sum_dense`` (a
scatter-add), where the JAX package differences one float32 cumsum: the
centroids differ in their last bits, so an assignment on a knife edge can
flip (tests/test_torch_cfseg.py bounds the share).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from maskfusion_tpu_torch.ops import sort_utils


class SlicResult(NamedTuple):
    labels: torch.Tensor       # (H, W) int64 superpixel id
    grid_hw: Tuple[int, int]   # (gh, gw) superpixel grid shape
    mean_rgb: torch.Tensor     # (gh*gw, 3)
    mean_pos: torch.Tensor     # (gh*gw, 2) y, x
    counts: torch.Tensor       # (gh*gw,)


def _segment_means(labels, f, pos, n: int):
    """Per-superpixel sums of colour and position, and the pixel count."""
    HW = labels.numel()
    ones = torch.ones(HW, dtype=torch.float32, device=f.device)
    return sort_utils.segment_sum_dense(
        labels.reshape(-1), torch.ones(HW, dtype=torch.bool, device=f.device),
        [f.reshape(-1, 3), pos.reshape(-1, 2), ones], n)


def slic(rgb: torch.Tensor, spacing: int = 16, iterations: int = 4,
         compactness: float = 0.1) -> SlicResult:
    H, W = rgb.shape[:2]
    dev = rgb.device
    gh, gw = H // spacing, W // spacing
    n = gh * gw
    f = rgb.to(torch.float32) / 255.0
    yy = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(
        H, W)
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(
        H, W)
    pos = torch.stack([yy, xx], -1)
    # the pixel's grid cell; the initial assignment is the regular grid
    base_gy = torch.clamp((yy / spacing).to(torch.int64), 0, gh - 1)
    base_gx = torch.clamp((xx / spacing).to(torch.int64), 0, gw - 1)
    labels = base_gy * gw + base_gx
    m2 = (compactness / spacing) ** 2

    for _ in range(iterations):
        s_rgb, s_pos, s_cnt = _segment_means(labels, f, pos, n)
        inv = 1.0 / torch.clamp(s_cnt, min=1.0)
        c_rgb = (s_rgb * inv[:, None]).reshape(gh, gw, 3)
        c_pos = (s_pos * inv[:, None]).reshape(gh, gw, 2)
        # assignment: the best of the 3x3 clusters around the pixel's cell,
        # the first of equal distances in (dy, dx) order
        best_d = torch.full((H, W), float("inf"), device=dev)
        best_l = labels
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                cy = torch.clamp(base_gy + dy, 0, gh - 1)
                cx = torch.clamp(base_gx + dx, 0, gw - 1)
                cr = c_rgb[cy, cx]
                cp = c_pos[cy, cx]
                d = (((f - cr) ** 2).sum(-1)
                     + m2 * ((yy - cp[..., 0]) ** 2
                             + (xx - cp[..., 1]) ** 2))
                upd = d < best_d
                best_d = torch.where(upd, d, best_d)
                best_l = torch.where(upd, cy * gw + cx, best_l)
        labels = best_l

    s_rgb, s_pos, s_cnt = _segment_means(labels, f, pos, n)
    inv = 1.0 / torch.clamp(s_cnt, min=1.0)
    return SlicResult(labels=labels, grid_hw=(gh, gw),
                      mean_rgb=s_rgb * inv[:, None] * 255.0,
                      mean_pos=s_pos * inv[:, None], counts=s_cnt)


def downsample(values: torch.Tensor, labels: torch.Tensor, n: int
               ) -> torch.Tensor:
    """Per-superpixel mean of a (H, W[, C]) map over its finite pixels
    (Slic::downsample)."""
    H, W = values.shape[:2]
    v = values.reshape(H * W, -1).to(torch.float32)
    valid = torch.isfinite(v).all(dim=1)
    v = torch.where(valid[:, None], v, 0.0)
    s, c = sort_utils.segment_sum_dense(
        labels.reshape(-1), valid,
        [v, torch.ones(H * W, dtype=torch.float32, device=v.device)], n)
    out = s / torch.clamp(c[:, None], min=1.0)
    return out if values.dim() == 3 else out[:, 0]


def upsample(per_spx: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Superpixel values back to pixels (Slic::upsample)."""
    return per_spx[labels]
