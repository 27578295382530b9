"""Frozen copies of the plain versions of the program's three CUDA kernels'
neighbours: ``shift``, ``bilateral_depth_plain`` and
``geometric_edge_map_plain`` (``maskfusion_tpu_torch/ops/kernels.py``) and
the edge binary's closing (``maskfusion_tpu_torch/ops/seg_ops.py``).
"""

from __future__ import annotations

import torch

def shift(img: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """img sampled at (y+dy, x+dx) with constant fill outside (leading dims
    H, W).  The plain versions' tap; ops/preprocess re-exports it."""
    H, W = img.shape[:2]
    pad = [0, 0] * (img.dim() - 2) + [max(0, -dx), max(0, dx),
                                      max(0, -dy), max(0, dy)]
    p = torch.nn.functional.pad(img, pad, value=fill)
    return p[max(0, dy):max(0, dy) + H, max(0, dx):max(0, dx) + W]


def bilateral_depth_plain(depth: torch.Tensor, radius: int,
                          sigma_space2_inv_half: float,
                          sigma_color2_inv_half: float,
                          min_valid_depth: float) -> torch.Tensor:
    """Plain PyTorch version: the (2R+1)^2 tap loop over a +inf-padded
    image, as maskfusion_tpu/ops/preprocess.py:66-86."""
    H, W = depth.shape
    padded = torch.nn.functional.pad(depth[None], (radius,) * 4,
                                     value=float("inf"))[0]
    sum1 = torch.zeros_like(depth)
    sum2 = torch.zeros_like(depth)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            nb = padded[radius + dy:radius + dy + H,
                        radius + dx:radius + dx + W]
            space2 = float(dy * dy + dx * dx)
            color2 = (depth - nb) ** 2
            w = torch.exp(-(space2 * sigma_space2_inv_half
                            + color2 * sigma_color2_inv_half))
            ok = torch.isfinite(nb)
            sum1 = sum1 + torch.where(ok, nb * w, 0.0)
            sum2 = sum2 + torch.where(ok, w, 0.0)
    out = sum1 / torch.clamp(sum2, min=1e-20)
    return torch.where(depth <= min_valid_depth, 0.0, out)


_OFFS8 = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)]


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b over the last axis of 3, summed ((a0 b0 + a1 b1) + a2 b2) as
    the twin's sum rounds on the CPU; torch's CUDA reduction over that axis
    sums in another order."""
    return ((a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1])
            + a[..., 2] * b[..., 2])


def geometric_edge_map_plain(vmap: torch.Tensor, nmap: torch.Tensor,
                             weight_distance: float,
                             weight_concavity: float) -> torch.Tensor:
    """Plain PyTorch version: the 8-neighbour tap loop of
    maskfusion_tpu/ops/seg_ops.py:30-67."""
    H, W = vmap.shape[:2]
    dev = vmap.device
    nan = float("nan")
    c_term = torch.zeros((H, W), dtype=torch.float32, device=dev)
    d_term = torch.zeros((H, W), dtype=torch.float32, device=dev)
    for dy, dx in _OFFS8:
        v_n = shift(vmap, dy, dx, nan)
        n_n = shift(nmap, dy, dx, nan)
        # concavity (getConcavityTerm): 0 on the convex side
        side = _dot3(v_n - vmap, nmap)
        conc = 1.0 - _dot3(n_n, nmap)
        conc = torch.where(side < 0, 0.0, conc)
        c_term = torch.maximum(c_term, torch.nan_to_num(conc, nan=0.0))
        # distance discontinuity (getDistanceTerm)
        d_term = torch.maximum(d_term, torch.nan_to_num(side.abs(), nan=0.0))
    edge = torch.clamp(torch.maximum(c_term * weight_concavity,
                                     d_term * weight_distance), max=1.0)
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    border = (xx < 1) | (xx >= W - 1) | (yy < 1) | (yy >= H - 1)
    invalid = ~torch.isfinite(vmap[..., 0]) | (vmap[..., 2] <= 0)
    return torch.where(border | invalid, 1.0, edge)


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


bilateral_depth = bilateral_depth_plain


def predict_l0_scan_plain(pos, normal, radius, live, fx, fy, cx, cy,
                          max_depth, window: int = 2
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the shifted-pad tap loop of
    maskfusion_tpu/ops/splat.py:304-342."""
    H, W = radius.shape
    dev = radius.device
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    lx = (u - cx) / fx
    ly = (v - cy) / fy
    lnorm = torch.sqrt(lx * lx + ly * ly + 1.0)
    l = torch.stack([lx / lnorm, ly / lnorm, 1.0 / lnorm], dim=-1)
    yy = torch.arange(H, device=dev)[:, None].expand(H, W)
    xx = torch.arange(W, device=dev)[None, :].expand(H, W)

    best_z = torch.full((H, W), float("inf"), device=dev)
    best_src = torch.full((H, W), -1, dtype=torch.int32, device=dev)
    packed = torch.cat([pos, normal, radius[..., None],
                        live.to(torch.float32)[..., None]], dim=-1)
    for dy in range(-window, window + 1):
        for dx in range(-window, window + 1):
            t = shift(packed, dy, dx, 0.0)
            cp = t[..., 0:3]
            cn = t[..., 3:6]
            crad = t[..., 6]
            alive = t[..., 7] > 0
            denom = (l * cn).sum(-1)
            z_star = (cp * cn).sum(-1) / torch.where(
                denom.abs() > 1e-12, denom, 1e-12)
            hit = l * z_star[..., None]
            z_cam = hit[..., 2]
            miss2 = ((hit - cp) ** 2).sum(-1)
            ok = (alive & (miss2 <= crad * crad) & (z_cam > 0)
                  & (z_cam <= max_depth) & (z_cam < best_z))
            best_z = torch.where(ok, z_cam, best_z)
            src = ((yy + dy).clamp(0, H - 1) * W
                   + (xx + dx).clamp(0, W - 1)).to(torch.int32)
            best_src = torch.where(ok, src, best_src)
    return best_z, best_src
