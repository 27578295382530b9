"""Frozen copy of ``maskfusion_tpu_torch/ops/reduce.py``,
the plain PyTorch version the benchmark judges the program against
(imports rewritten to this folder; nothing of the program is imported).

Gauss-Newton reduction ops for camera tracking.

Port of ``maskfusion_tpu/ops/reduce.py`` (ref Core/Cuda/reduce.cu): each op
builds a masked (P, k) row matrix and contracts it in one f32 matmul —
``A = J^T J`` and ``b = J^T r`` fall out of the same product.  Everything
stays on the device; the 6x6 solve is done by the caller.

Ops:
  icp_associate / icp_term_from_assoc / icp_step
                       — point-to-plane projective ICP term (reduce.cu:259-525)
  compute_rgb_residual — dense photometric correspondences (reduce.cu:774-997)
  rgb_step             — photometric GN term               (reduce.cu:529-713)
  so3_step             — rotation-only image alignment     (reduce.cu:999-1202)

Each op also takes its model-side inputs with a leading slot axis (one
object model a slot; poses (N, 3, 3) / (N, 3), model images (N, H, W, ...),
mask ids shaped to broadcast against the frame's images) and returns one
term per slot.  The frame-side inputs are either shared, (H, W, ...), every
slot reading the same frame images, broadcast, never copied; or one crop a
slot, (N, h, w, ...), as the windowed object tracker gives them, with the
intrinsics' principal point then an (N, 1) tensor (each window's own).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from mfbench.reference.camera import CameraIntrinsics
from mfbench.reference.preprocess import _grid


def _rowwise_jtj(rows: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Masked ([N,] P, k) rows -> ([N,] k, k) Gram matrices.  With a slot
    axis the slots' rows stand side by side in ONE (P, N k) product, whose
    diagonal blocks are the slots' Gram matrices: on the card a batched
    matmul of N (k, P) x (P, k) products gets no split over P, and took
    5.25 ms against this product's 0.09 ms for two slots at P = 307,200
    (tests/torch_slot_axis_probe.py)."""
    rows = torch.where(valid[..., None], rows, 0.0)
    if rows.dim() == 2:
        return rows.T @ rows
    n, p, k = rows.shape
    side = rows.permute(1, 0, 2).reshape(p, n * k)
    gram = (side.T @ side).reshape(n, k, n, k)
    return gram.diagonal(dim1=0, dim2=2).permute(2, 0, 1)


def _gather2d(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor):
    """img[..., y, x, :] with clipped indices (the caller masks validity).
    A (H, W, C) image takes indices of any shape; a (N, H, W, C) image one
    index array a slot, (N, ...)."""
    H, W, C = img.shape[-3:]
    idx = y.clamp(0, H - 1) * W + x.clamp(0, W - 1)
    lead = img.shape[:-3]
    flat = img.reshape(lead + (H * W, C))
    if not lead:
        return flat[idx]
    gi = idx.reshape(lead + (-1, 1)).expand(lead + (-1, C))
    return torch.gather(flat, len(lead), gi).reshape(idx.shape + (C,))


def _shift(img: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """(..., H, W) image sampled at (y+dy, x+dx), `fill` outside."""
    H, W = img.shape[-2:]
    p = F.pad(img, (max(0, -dx), max(0, dx), max(0, -dy), max(0, dy)),
              value=fill)
    return p[..., max(0, dy):max(0, dy) + H, max(0, dx):max(0, dx) + W]


def _finite_rows(rows: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(rows).all(-1, keepdim=True), rows, 0.0)


def pack_model_maps(vmap_g_prev: torch.Tensor,
                    nmap_g_prev: torch.Tensor) -> torch.Tensor:
    """(H, W, 6) model vertex+normal table for icp_associate (iteration-
    invariant; built once per pyramid level)."""
    return torch.cat([vmap_g_prev, nmap_g_prev], dim=-1)


def _erode4(valid: torch.Tensor, fill: bool) -> torch.Tensor:
    """True where the 4x4 neighbourhood rows [i-2, i+2), cols [j-2, j+2) is
    all True (reduce.cu:829-841); `fill` outside the image."""
    H, W = valid.shape[-2:]
    pad = F.pad(valid.to(torch.uint8), (2, 2, 2, 2), value=int(fill)) > 0
    ok = torch.ones_like(valid)
    for dy in (-2, -1, 0, 1):
        for dx in (-2, -1, 0, 1):
            ok = ok & pad[..., 2 + dy:2 + dy + H, 2 + dx:2 + dx + W]
    return ok


def rgb_static_valid(next_image, next_depth, didx, didy, min_scale: float,
                     next_mask: Optional[torch.Tensor] = None,
                     mask_id=None) -> torch.Tensor:
    """Iteration-invariant part of the RGB correspondence gates: 4x4
    erosion, gradient, interior and depth validity (reduce.cu:823-858).
    A slot axis enters through `mask_id` shaped (N, 1, 1)."""
    H, W = next_image.shape[-2:]
    nz = next_image > 0
    if next_mask is not None and mask_id is not None:
        nz = nz & (next_mask == mask_id)
    x, y = _grid(H, W, next_image.device)
    interior = (x < W - 5) & (y < H - 1)
    has_grad = (didx * didx + didy * didy) >= min_scale
    return (_erode4(nz, True) & interior & has_grad
            & torch.isfinite(next_depth))


def rgb_last_valid(last_image: torch.Tensor) -> torch.Tensor:
    """Model-side 4x4 validity erosion of the LAST image (the JAX package's
    mirror of the reference's next-side erosion; see
    maskfusion_tpu/ops/reduce.py:296-303)."""
    return _erode4(last_image > 0, False)


class GNTerm(NamedTuple):
    """One system, or one a slot with a leading (N,) axis on each field."""
    A: torch.Tensor            # (6,6) or (3,3)
    b: torch.Tensor            # (6,) or (3,)
    residual_sq: torch.Tensor  # scalar: sum of squared residuals
    count: torch.Tensor        # scalar: inlier count (float32)


class ICPAssociation(NamedTuple):
    """Frozen projective association: the gathered model rows and every
    gate evaluated at association time (the inlier set freezes with it)."""
    vn: torch.Tensor           # ([N,] P, 6) gathered model vertex+normal
    found: torch.Tensor        # ([N,] P) bool


def icp_associate(R_curr, t_curr, vmap_curr, nmap_curr, R_prev_inv, t_prev,
                  intr: CameraIntrinsics, vn_packed, dist_thresh: float,
                  angle_thresh_sine: float, mask=None,
                  mask_id=None) -> ICPAssociation:
    """Projective correspondence search (ICPReduction::search,
    reduce.cu:292-366) with the dist/sine gates at this pose.  A slot
    axis enters through the poses, `vn_packed` and `mask_id` ((N, 1))."""
    lead = vmap_curr.shape[:-3]
    v = vmap_curr.reshape(lead + (-1, 3))
    n = nmap_curr.reshape(lead + (-1, 3))
    H, W = vmap_curr.shape[-3:-1]
    v_g = v @ R_curr.mT + t_curr[..., None, :]
    v_cp = (v_g - t_prev[..., None, :]) @ R_prev_inv.mT
    z = v_cp[..., 2]
    u_proj = torch.round(v_cp[..., 0] * intr.fx / z + intr.cx)
    v_proj = torch.round(v_cp[..., 1] * intr.fy / z + intr.cy)
    # f32 -> int32 of a non-finite or huge value is implementation-defined;
    # clamp first (the JAX package's out-of-range casts saturate the same way)
    u_proj = torch.nan_to_num(u_proj, nan=-1.0).clamp(-1, W).to(torch.int32)
    v_proj = torch.nan_to_num(v_proj, nan=-1.0).clamp(-1, H).to(torch.int32)
    in_bounds = ((u_proj >= 0) & (v_proj >= 0) & (u_proj < W) & (v_proj < H)
                 & (z >= 0))
    vn = _gather2d(vn_packed, v_proj, u_proj)
    vprev_g = vn[..., 0:3]
    nprev_g = vn[..., 3:6]
    n_g = n @ R_curr.mT
    dist = torch.linalg.vector_norm(vprev_g - v_g, dim=-1)
    sine = torch.linalg.vector_norm(
        torch.linalg.cross(n_g, nprev_g, dim=-1), dim=-1)
    found = (in_bounds & (sine < angle_thresh_sine) & (dist <= dist_thresh)
             & torch.isfinite(n[..., 0]) & torch.isfinite(vn[..., 3])
             & torch.isfinite(v[..., 0]))
    if mask is not None and mask_id is not None:
        found = found & (mask.reshape(lead + (-1,)) == mask_id)
    return ICPAssociation(vn=vn, found=found)


def icp_term_from_assoc(R_curr, t_curr, vmap_curr, nmap_curr, R_prev_inv,
                        t_prev, assoc: ICPAssociation) -> GNTerm:
    """Point-to-plane GN term against an existing association
    (ICPReduction::getProducts, reduce.cu:367-415)."""
    v = vmap_curr.reshape(vmap_curr.shape[:-3] + (-1, 3))
    t_prev = t_prev[..., None, :]
    v_g = v @ R_curr.mT + t_curr[..., None, :]
    s_cp = (v_g - t_prev) @ R_prev_inv.mT
    d_cp = (assoc.vn[..., 0:3] - t_prev) @ R_prev_inv.mT
    n_cp = assoc.vn[..., 3:6] @ R_prev_inv.mT
    resid = (n_cp * (s_cp - d_cp)).sum(-1)
    rows = _finite_rows(torch.cat(
        [n_cp, torch.linalg.cross(s_cp, n_cp, dim=-1), resid[..., None]],
        dim=-1))
    jtj = _rowwise_jtj(rows, assoc.found)
    return GNTerm(A=jtj[..., :6, :6], b=jtj[..., :6, 6],
                  residual_sq=jtj[..., 6, 6],
                  count=assoc.found.to(torch.float32).sum(-1))


def icp_step(R_curr, t_curr, vmap_curr, nmap_curr, R_prev_inv, t_prev,
             intr: CameraIntrinsics, vmap_g_prev, nmap_g_prev,
             dist_thresh: float, angle_thresh_sine: float, mask=None,
             mask_id=None, vn_packed=None) -> GNTerm:
    """Point-to-plane projective ICP GN term = associate + products."""
    if vn_packed is None:
        vn_packed = pack_model_maps(vmap_g_prev, nmap_g_prev)
    assoc = icp_associate(R_curr, t_curr, vmap_curr, nmap_curr, R_prev_inv,
                          t_prev, intr, vn_packed, dist_thresh,
                          angle_thresh_sine, mask, mask_id)
    return icp_term_from_assoc(R_curr, t_curr, vmap_curr, nmap_curr,
                               R_prev_inv, t_prev, assoc)


class RGBCorrespondences(NamedTuple):
    """Per pixel, or ([N,] H, W) with a slot axis."""
    valid: torch.Tensor      # (H, W) bool
    u0: torch.Tensor         # (H, W) int32 — matched pixel in last image
    v0: torch.Tensor         # (H, W) int32
    d0: torch.Tensor         # (H, W) float32 — last depth at the match
    diff: torch.Tensor       # (H, W) float32 — next - last intensity
    sigma_sum: torch.Tensor  # scalar sum of diff^2 over valid
    count: torch.Tensor      # scalar valid count (float32)


def _round_to_int(a: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    return torch.nan_to_num(torch.round(a), nan=float(lo)).clamp(
        lo, hi).to(torch.int32)


def compute_rgb_residual(didx, didy, last_depth, next_depth, last_image,
                         next_image, krk_inv, kt, min_scale: float,
                         max_depth_delta: float, next_mask=None, mask_id=None,
                         static_valid=None,
                         last_valid=None) -> RGBCorrespondences:
    """Dense photometric correspondence search (RGBResidual,
    reduce.cu:811-891): warp every gradient-carrying next pixel by the
    current inverse increment with its depth and accept depth-consistent
    matches whose last-image 4x4 neighbourhood is valid.  A slot axis
    enters through `krk_inv` (N, 3, 3), `kt` (N, 3) and the last images
    (N, H, W)."""
    H, W = next_image.shape[-2:]
    if static_valid is None:
        static_valid = rgb_static_valid(next_image, next_depth, didx, didy,
                                        min_scale, next_mask, mask_id)
    x, y = _grid(H, W, next_image.device)
    d1 = next_depth
    k = krk_inv[..., None, None]          # each entry (..., 1, 1)
    kt = kt[..., None, None]
    td1 = d1 * (k[..., 2, 0, :, :] * x + k[..., 2, 1, :, :] * y
                + k[..., 2, 2, :, :]) + kt[..., 2, :, :]
    u0f = (d1 * (k[..., 0, 0, :, :] * x + k[..., 0, 1, :, :] * y
                 + k[..., 0, 2, :, :]) + kt[..., 0, :, :]) / td1
    v0f = (d1 * (k[..., 1, 0, :, :] * x + k[..., 1, 1, :, :] * y
                 + k[..., 1, 2, :, :]) + kt[..., 1, :, :]) / td1
    u0 = _round_to_int(u0f, -1, W)
    v0 = _round_to_int(v0f, -1, H)
    in_b = (u0 >= 0) & (v0 >= 0) & (u0 < W) & (v0 < H)
    if last_valid is None:
        last_valid = rgb_last_valid(last_image)
    di_packed = torch.stack([last_depth, last_image.to(torch.float32),
                             last_valid.to(torch.float32)], dim=-1)
    di = _gather2d(di_packed, v0, u0)
    d0 = di[..., 0]
    li = di[..., 1]
    depth_ok = ((d0 > 0) & ((td1 - d0).abs() <= max_depth_delta)
                & (di[..., 2] > 0.5))
    valid = static_valid & in_b & depth_ok
    diff = torch.where(valid, next_image.to(torch.float32) - li, 0.0)
    return RGBCorrespondences(
        valid=valid, u0=u0, v0=v0, d0=torch.where(valid, d0, 0.0),
        diff=diff, sigma_sum=(diff * diff).sum((-2, -1)),
        count=valid.to(torch.float32).sum((-2, -1)))


def rgb_step(corres: RGBCorrespondences, sigma: torch.Tensor,
             intr: CameraIntrinsics, didx, didy, sobel_scale: float) -> GNTerm:
    """Photometric GN term from correspondences (RGBReduction,
    reduce.cu:547-630); the matched cloud point is back-projected from the
    gathered depth.  With a slot axis `sigma` is (N,)."""
    fx, fy = intr.fx, intr.fy
    flat = corres.valid.shape[:-2] + (-1,)
    valid = corres.valid.reshape(flat)
    diff = corres.diff.reshape(flat)
    sigma = sigma[..., None]
    w = sigma + diff.abs()
    w = torch.where(w > 1.1920929e-07, 1.0 / w, 1.0)
    w = torch.where(sigma == -1.0, 1.0, w)
    u0 = corres.u0.reshape(flat).to(torch.float32)
    v0 = corres.v0.reshape(flat).to(torch.float32)
    z = corres.d0.reshape(flat)
    cp0 = (u0 - intr.cx) * z / fx
    cp1 = (v0 - intr.cy) * z / fy
    invz = torch.where(z != 0, 1.0 / z, 0.0)
    gx = w * sobel_scale * didx.reshape(didx.shape[:-2] + (-1,))
    gy = w * sobel_scale * didy.reshape(didy.shape[:-2] + (-1,))
    r0 = gx * fx * invz
    r1 = gy * fy * invz
    r2 = -(r0 * cp0 + r1 * cp1) * invz
    r3 = -z * r1 + cp1 * r2
    r4 = z * r0 - cp0 * r2
    r5 = -cp1 * r0 + cp0 * r1
    r6 = -w * diff
    rows = _finite_rows(torch.stack([r0, r1, r2, r3, r4, r5, r6], dim=-1))
    jtj = _rowwise_jtj(rows, valid)
    return GNTerm(A=jtj[..., :6, :6], b=jtj[..., :6, 6],
                  residual_sq=jtj[..., 6, 6],
                  count=valid.to(torch.float32).sum(-1))


def so3_step(last_image, next_image, image_basis, k_inv, krlr) -> GNTerm:
    """Rotation-only photometric alignment on the coarsest pyramid level
    (SO3Reduction, reduce.cu:999-1137): a 3x3 GN term over the rotation.
    A slot axis enters through `last_image` (N, H, W), `image_basis` and
    `krlr` (N, 3, 3); with per-slot crops also through `next_image`
    (N, H, W) and `k_inv` (N, 3, 3)."""
    H, W = next_image.shape[-2:]
    lastf = last_image.to(torch.float32)
    nextf = next_image.to(torch.float32)
    x, y = _grid(H, W, next_image.device)
    p = torch.stack([x, y, torch.ones_like(x)], dim=-1)       # (H, W, 3)
    if image_basis.dim() > 2:
        image_basis = image_basis[..., None, :, :]
    warped = p @ image_basis.mT
    wx = _round_to_int(warped[..., 0] / warped[..., 2], -1, W)
    wy = _round_to_int(warped[..., 1] / warped[..., 2], -1, H)
    found = ((wx >= 1) & (wx < W - 1) & (wy >= 1) & (wy < H - 1)
             & (x >= 1) & (x < W - 1) & (y >= 1) & (y < H - 1))

    # getGradient: (back - fore) / 2 at integer pixels
    glx = (_shift(lastf, 0, -1, 0.0) - _shift(lastf, 0, 1, 0.0)) * 0.5
    gly = (_shift(lastf, -1, 0, 0.0) - _shift(lastf, 1, 0, 0.0)) * 0.5
    packed = torch.stack([_shift(nextf, 0, -1, 0.0),
                          _shift(nextf, 0, 1, 0.0),
                          _shift(nextf, -1, 0, 0.0),
                          _shift(nextf, 1, 0, 0.0), nextf], dim=-1)
    taps = _gather2d(packed, wy, wx)
    gx = ((taps[..., 0] - taps[..., 1]) * 0.5 + glx) * 0.5
    gy = ((taps[..., 2] - taps[..., 3]) * 0.5 + gly) * 0.5

    if k_inv.dim() > 2:
        k_inv = k_inv[..., None, :, :]
    point = p @ k_inv.mT
    pz = point[..., 2]
    z2 = pz * pz
    k = krlr[..., None, None]             # each entry (..., 1, 1)
    a, b_, c = k[..., 0, 0, :, :], k[..., 0, 1, :, :], k[..., 0, 2, :, :]
    d, e, f = k[..., 1, 0, :, :], k[..., 1, 1, :, :], k[..., 1, 2, :, :]
    g, h, i_ = k[..., 2, 0, :, :], k[..., 2, 1, :, :], k[..., 2, 2, :, :]
    lp0 = (pz * (d * gy + a * gx) - gy * g * y - gx * g * x) / z2
    lp1 = (pz * (e * gy + b_ * gx) - gy * h * y - gx * h * x) / z2
    lp2 = (pz * (f * gy + c * gx) - gy * i_ * y - gx * i_ * x) / z2
    lp = torch.stack([lp0, lp1, lp2], dim=-1)
    jac = torch.linalg.cross(lp, point.expand(lp.shape), dim=-1)
    resid = -(taps[..., 4] - lastf)
    flat = found.shape[:-2] + (-1,)
    rows = _finite_rows(torch.cat([jac, resid[..., None]], dim=-1)
                        .reshape(flat + (4,)))
    jtj = _rowwise_jtj(rows, found.reshape(flat))
    return GNTerm(A=jtj[..., :3, :3], b=jtj[..., :3, 3],
                  residual_sq=jtj[..., 3, 3],
                  count=found.to(torch.float32).sum((-2, -1)))
