"""Surfel fusion: per-pixel data association + weighted map update.

Port of ``maskfusion_tpu/ops/fuse.py`` (ref Model::fuse, Model.cpp:466-647):
pass 1 searches the 3x3 texel neighbourhood of each eligible pixel in the
index map for the best matching surfel (data.vert:79-194); pass 2 averages
all matched pixels per surfel, weighted by confidence (the JAX package's
deterministic replacement of the reference's arbitrary single pixel,
update.vert:38-111), and appends the unmatched pixels as new unstable
surfels.  With the checkerboard subsample and a known frame parity, pass 2
runs on the [parity::2, parity::2] subgrid.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from maskfusion_tpu_torch import se3
from maskfusion_tpu_torch.camera import CameraIntrinsics
from maskfusion_tpu_torch.mapping import surfel_map as sm
from maskfusion_tpu_torch.mapping.surfel_map import SurfelMap
from maskfusion_tpu_torch.ops import preprocess as pp
from maskfusion_tpu_torch.ops import sort_utils
from maskfusion_tpu_torch.ops.splat import IndexMap


def half_pixel_taps_unique(x: torch.Tensor, y: torch.Tensor):
    """The reference's 16 half-pixel samples (offsets {-1, -0.5, 0, +0.5}
    with floor lookup, data.vert:139-161) touch 3 texels per axis, around
    floor(x) with multiplicities (2,2,0) when frac < 0.5 else (1,2,1).
    Returns 9 (ty, tx, multiplicity) taps."""
    kx = torch.floor(x).to(torch.int32)
    ky = torch.floor(y).to(torch.int32)
    fx_lo = (x - torch.floor(x)) < 0.5
    fy_lo = (y - torch.floor(y)) < 0.5

    def mult(lo, like):
        two = torch.full_like(like, 2)
        return [torch.where(lo, 2, 1).to(like.dtype), two,
                torch.where(lo, 0, 1).to(like.dtype)]

    mx, my = mult(fx_lo, kx), mult(fy_lo, ky)
    return [(ky + dy, kx + dx, my[iy] * mx[ix])
            for iy, dy in enumerate((-1, 0, 1))
            for ix, dx in enumerate((-1, 0, 1))]


class FuseResult(NamedTuple):
    map: SurfelMap
    matched_pixels: torch.Tensor   # (H, W) bool — merged into a surfel
    new_pixels: torch.Tensor       # (H, W) bool — became new unstables


def compute_fusion_weight(last_delta: torch.Tensor,
                          weight_multiplier) -> torch.Tensor:
    """Velocity-adaptive fusion weight (Model::computeFusionWeight,
    Model.cpp:449-464): fast motion down-weights new measurements."""
    t_norm = torch.linalg.vector_norm(last_delta[:3, 3])
    r_norm = torch.linalg.vector_norm(se3.so3_log(last_delta[:3, :3]))
    weighting = torch.clamp(torch.maximum(t_norm, r_norm), max=0.01)
    return torch.clamp(1.0 - weighting / 0.01, min=0.5) * weight_multiplier


def fuse(m: SurfelMap, index_map: IndexMap, vmap_raw, vmap_filt, nmap_filt,
         rgb, mask, mask_id, pose, intr: CameraIntrinsics, time, weighting,
         max_depth, *, checkerboard: bool = True, parity=None,
         merge_z_thresh: float = 0.05,
         radius_merge_factor: float = 1.5) -> FuseResult:
    """One fusion step: merged surfels updated, unmatched pixels appended as
    unstables with last_seen = -2 (finalised by clean).  `parity` is the
    frame's checkerboard parity (tick % 2) when known on the host; None
    derives it from `time` on the device.  `time`, `mask_id`, `max_depth`,
    `weighting` and the principal point may be host numbers or 0-d device
    tensors (a graphed pass's, tracking/graphs)."""
    H, W = vmap_raw.shape[:2]
    dev = vmap_raw.device
    if m.capacity >= (1 << 24):
        raise ValueError(
            f"surfel capacity {m.capacity} >= 2^24: the packed f32 slot "
            "lane in fuse's tap table cannot represent it exactly")
    R = pose[:3, :3]
    t = pose[:3, 3]
    u, v = pp._grid(H, W, dev)
    z_raw = vmap_raw[..., 2]
    valid_v = torch.isfinite(vmap_raw[..., 0]) & (z_raw > 0) & (
        z_raw <= max_depth)
    # 4-neighbour depth check (data.vert checkNeighbours:52-71)
    nbr_ok = ((pp.shift(z_raw, 0, -1, 0.0) > 0) & (pp.shift(z_raw, 0, 1, 0.0) > 0)
              & (pp.shift(z_raw, -1, 0, 0.0) > 0)
              & (pp.shift(z_raw, 1, 0, 0.0) > 0))
    eligible = valid_v & nbr_ok & (mask == mask_id)
    if checkerboard and parity is None:
        tpar = (time.to(torch.int32) if isinstance(time, torch.Tensor)
                else int(time)) % 2
        eligible = eligible & (u.to(torch.int32) % 2 == tpar) & (
            v.to(torch.int32) % 2 == tpar)

    # pixel ray + lambda (data.vert:131-137)
    xl = (u - intr.cx) / intr.fx
    yl = (v - intr.cy) / intr.fy
    lam = torch.sqrt(xl * xl + yl * yl + 1.0)
    ray = torch.stack([xl, yl, torch.ones_like(xl)], dim=-1)

    # association over the 3x3 texel window; slots ride +1 so that the zero
    # padding reads as "none"
    best_dist = torch.full((H, W), 1.0e6, device=dev)
    best_slot = torch.full((H, W), -1, dtype=torch.int32, device=dev)
    packed = torch.cat([
        index_map.pos, index_map.normal,
        torch.where(index_map.index >= 0, index_map.index + 1,
                    0).to(torch.float32)[..., None]], dim=-1)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            tap = pp.shift(packed, dy, dx, 0.0)
            c_pos = tap[..., 0:3]
            c_nr = tap[..., 3:6]
            slot1 = tap[..., 6]
            z_ok = ((c_pos[..., 2] - z_raw) * lam).abs() < merge_z_thresh
            cr = torch.linalg.cross(ray, c_pos, dim=-1)
            dist2 = (cr * cr).sum(-1)
            # angleBetween < 0.5 rad == cos > cos(0.5) for unit normals
            cosang = (c_nr * nmap_filt).sum(-1)
            norm_ok = (c_nr[..., 2].abs() < 0.75) | (cosang > 0.8775826)
            ok = (slot1 > 0) & z_ok & norm_ok & (dist2 < best_dist)
            best_dist = torch.where(ok, dist2, best_dist)
            best_slot = torch.where(ok, slot1.to(torch.int32) - 1, best_slot)

    matched = eligible & (best_slot >= 0)
    new_pix = eligible & (best_slot < 0)

    # per-pixel measurement attributes (data.vert:88-108)
    conf_px = sm.pixel_confidence(H, W, intr, 1.0, dev) * weighting
    rad_px = sm.radius_from_depth(vmap_filt[..., 2], nmap_filt[..., 2], intr)
    pos_w = vmap_raw @ R.T + t
    norm_w = nmap_filt @ R.T
    col = rgb.to(torch.float32)

    if checkerboard and parity is not None:
        def rows(a):
            return a[parity::2, parity::2].reshape((-1,) + a.shape[2:])
    else:
        def rows(a):
            return a.reshape((-1,) + a.shape[2:])

    a_px = rows(conf_px)
    cap = m.capacity
    sum_a, sum_pos, sum_col, sum_norm, sum_rad = sort_utils.segment_sum_dense(
        rows(best_slot), rows(matched),
        [a_px, rows(pos_w) * a_px[:, None], rows(col) * a_px[:, None],
         rows(norm_w) * a_px[:, None], rows(rad_px) * a_px], cap)

    has_update = sum_a > 0
    inv_a = torch.where(has_update, 1.0 / torch.clamp(sum_a, min=1e-20), 0.0)
    c_k = m.conf
    tot = c_k + sum_a
    inv_tot = torch.where(has_update, 1.0 / torch.clamp(tot, min=1e-20), 0.0)
    new_rad_meas = sum_rad * inv_a
    # radius gate (update.vert:76)
    geom_ok = has_update & (new_rad_meas < radius_merge_factor * m.radius)

    def blend3(old, meas_sum):
        merged = (old * c_k[:, None] + (meas_sum * inv_a[:, None])
                  * sum_a[:, None]) * inv_tot[:, None]
        return torch.where(geom_ok[:, None], merged, old)

    merged_norm = blend3(m.normal, sum_norm)
    merged_norm = merged_norm / torch.clamp(
        torch.linalg.vector_norm(merged_norm, dim=-1, keepdim=True),
        min=1e-20)
    updated = SurfelMap(
        pos=blend3(m.pos, sum_pos),
        conf=torch.where(has_update, tot, m.conf),
        color=blend3(m.color, sum_col),
        # a copy: compact_into below appends into these tensors in place,
        # and m's may be views of the engine's full map
        init_time=m.init_time.clone(),
        last_seen=torch.where(has_update, sm.host_or_device(time),
                              m.last_seen),
        normal=merged_norm,
        radius=torch.where(
            geom_ok, (m.radius * c_k + new_rad_meas * sum_a) * inv_tot,
            m.radius),
        count=m.count,
    )

    # new unstable surfels (data.geom route -> newUnstableBuffer)
    cand_new = rows(new_pix)
    n_cand = cand_new.shape[0]
    updated = sm.compact_into(
        updated, cand_new, rows(pos_w), rows(conf_px), rows(col),
        sm.stamp(n_cand, time, dev),
        torch.full((n_cand,), -2.0, device=dev),
        rows(norm_w), rows(rad_px))
    if checkerboard and parity is not None:
        pm = (u.to(torch.int32) % 2 == parity) & (v.to(torch.int32) % 2
                                                  == parity)
        matched = matched & pm
        new_pix = new_pix & pm
    return FuseResult(map=updated, matched_pixels=matched,
                      new_pixels=new_pix)
