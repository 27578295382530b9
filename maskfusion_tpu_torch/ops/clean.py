"""Surfel map cleaning: free-space culling, stability timeout, mask penalty.

Port of ``maskfusion_tpu/ops/clean.py`` (ref copy_unstable.vert:53-160 +
Model::clean, Model.cpp:649-772).  Every surfel is tested against the
post-fuse index map and the current frame, penalised where the frame's mask
disagrees with its model, and survivors are kept — stream-compacted, or
killed in place with `compact=False`.  `erase_error_geometry` is the spawn
subtraction that carves a new object's surface out of the global map.

The JAX package packs the 3x3 index-map neighbourhood into an f16 hi/lo
table because TPU row gathers scale with row bytes.  The port gathers the
f32 fields directly, so its free-space test sees exact depths where the JAX
package sees ~2e-5 m reconstructions; parity is counted in surfels kept.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from maskfusion_tpu_torch.camera import CameraIntrinsics
from maskfusion_tpu_torch.mapping import surfel_map as sm
from maskfusion_tpu_torch.mapping.surfel_map import SurfelMap
from maskfusion_tpu_torch.ops.fuse import half_pixel_taps_unique
from maskfusion_tpu_torch.ops.splat import IndexMap


class CleanResult(NamedTuple):
    map: SurfelMap
    removed: torch.Tensor    # () int32 — surfels culled this pass
    keep: torch.Tensor       # (capacity,) bool, PRE-compaction slot space
    conf: torch.Tensor       # (capacity,) PRE-compaction penalised conf
    last_seen: torch.Tensor  # (capacity,) PRE-compaction finalised last_seen


def clean(m: SurfelMap, index_map: IndexMap, depth_input, mask, mask_id,
          pose_inv, intr: CameraIntrinsics, time, time_delta,
          conf_threshold, max_depth, outlier_coeff, *,
          unstable_time_limit: float = 20.0,
          compact: bool = True) -> CleanResult:
    """`time`, `mask_id`, `conf_threshold` and the principal point may be
    host numbers or 0-d device tensors (a graphed pass's,
    tracking/graphs)."""
    H, W = depth_input.shape
    R = pose_inv[:3, :3]
    lp = m.pos @ R.T + pose_inv[:3, 3]                    # local position
    ln = m.normal @ R.T
    ln = ln / torch.clamp(torch.linalg.vector_norm(ln, dim=-1, keepdim=True),
                          min=1e-20)
    lz = lp[:, 2]
    safe_z = torch.where(lz != 0, lz, 1.0)
    x = intr.fx * lp[:, 0] / safe_z + intr.cx
    y = intr.fy * lp[:, 1] / safe_z + intr.cy
    time = sm.host_or_device(time)
    in_view = (((time - m.last_seen) < time_delta) & (lz > 0) & (x > 0)
               & (y > 0) & (x < W) & (y < H))

    # --- free-space violation counts over the 3x3 texel window
    #     (copy_unstable.vert:87-115); the taps' multiplicities reproduce
    #     the reference's duplicate-counted 16 half-pixel samples.  Surfels
    #     out of view (NaN or far coordinates) are masked by in_view; their
    #     taps are clamped only to stay valid gather indices ---
    finite = torch.isfinite(x) & torch.isfinite(y)
    taps = half_pixel_taps_unique(
        torch.where(finite, x, 0.0).clamp(-2.0, W + 1.0),
        torch.where(finite, y, 0.0).clamp(-2.0, H + 1.0))

    c_z = index_map.pos[..., 2]
    table = torch.stack([
        c_z, index_map.pos[..., 0], index_map.pos[..., 1],
        index_map.init_time,
        ((index_map.index >= 0) & (index_map.conf > conf_threshold)
         ).to(torch.float32),
        (index_map.last_seen == time).to(torch.float32),
    ], dim=-1).reshape(H * W, 6)

    count = torch.zeros_like(taps[0][2])
    zcount = torch.zeros_like(count)
    steep = ln[:, 2].abs() > 0.85
    for ty, tx, mult in taps:
        inside = (ty >= 0) & (ty < H) & (tx >= 0) & (tx < W)
        rows = table[(ty.clamp(0, H - 1) * W + tx.clamp(0, W - 1))]
        cz, cx_, cy_, cit = rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3]
        base = in_view & inside & (rows[:, 4] > 0) & (cz > lz)
        xy_dist2 = (cx_ - lp[:, 0]) ** 2 + (cy_ - lp[:, 1]) ** 2
        c1 = (base & (cit < m.init_time) & (cz - lz < 0.01)
              & (xy_dist2 < (m.radius * 1.4) ** 2))
        c2 = base & (rows[:, 5] > 0) & (cz - lz > 0.01) & steep
        count = count + torch.where(c1, mult, 0)
        zcount = zcount + torch.where(c2, mult, 0)
    keep = ~((count > 8) | (zcount > 4))

    # --- new unstable finalisation + stability timeout
    #     (copy_unstable.vert:130-137) ---
    last_seen = torch.where(m.last_seen == -2.0, time, m.last_seen)
    unstable_drop = ((time - last_seen) > unstable_time_limit) & (
        m.conf < conf_threshold)
    keep = keep & ~unstable_drop
    # surfels outside the time window are always kept (:137)
    keep = keep | ((last_seen > 0) & ((time - last_seen) > time_delta))

    # --- mask-vs-model confidence penalty (copy_unstable.vert:150-156) ---
    ky, kx = taps[4][0], taps[4][1]
    centre = ky.clamp(0, H - 1) * W + kx.clamp(0, W - 1)
    w_depth = depth_input.reshape(-1)[centre]
    mask_val = mask.reshape(-1)[centre].to(torch.int32)
    depth_close = (w_depth > lz - 0.05) & (w_depth < lz + 0.05)
    soft = 0.5 + 0.5 * (1.0 - outlier_coeff / 10.0)
    if isinstance(mask_id, torch.Tensor):     # a graphed pass's
        mask_id_i = mask_id.to(torch.int32)
        other = torch.where(mask_id_i == 0, 0.25 * soft, soft)
    else:
        mask_id_i = int(mask_id)
        other = 0.25 * soft if mask_id_i == 0 else soft
    disagree = in_view & (mask_val != mask_id_i) & (mask_val < 255) & \
        depth_close
    penalty = torch.where(mask_val == 0, soft, other)
    conf = torch.where(disagree, m.conf * penalty, m.conf)

    keep = keep & m.slot_mask() & torch.isfinite(m.pos).all(-1)

    if compact:
        cleaned = m._replace(conf=conf, last_seen=last_seen)
        out = sm.compact_self(cleaned, keep)
        return CleanResult(map=out, removed=m.count - out.count, keep=keep,
                           conf=conf, last_seen=last_seen)

    # kill in place: culled surfels are zeroed where they stand (pos=0
    # fails the z>0 gates, radius=0 marks the hole); a compacting frame
    # every few frames reclaims the holes
    alive = m.radius > 0
    kill = alive & ~keep
    k3 = keep[:, None]
    out = SurfelMap(
        pos=torch.where(k3, m.pos, 0.0),
        conf=torch.where(keep, conf, 0.0),
        color=torch.where(k3, m.color, 0.0),
        init_time=torch.where(keep, m.init_time, 0.0),
        last_seen=torch.where(keep, last_seen, 0.0),
        normal=torch.where(k3, m.normal, 0.0),
        radius=torch.where(keep, m.radius, 0.0),
        count=m.count,
    )
    return CleanResult(map=out, removed=kill.sum(dtype=torch.int32),
                       keep=keep, conf=conf, last_seen=last_seen)


def erase_error_geometry(m: SurfelMap, mask: torch.Tensor, mask_id,
                         depth_input: torch.Tensor, pose_inv: torch.Tensor,
                         intr: CameraIntrinsics, depth_window: float = 0.05):
    """Spawn subtraction (Model::eraseErrorGeometry, Model.cpp:774-887; call
    site MaskFusion.cpp:355-358): remove from the global map the surfels
    that project into the freshly spawned object's mask at a depth within
    `depth_window` of the frame's (maskfusion_tpu/ops/clean.py:264-299).
    Returns (carved map, removed count)."""
    H, W = depth_input.shape
    R = pose_inv[:3, :3]
    lp = m.pos @ R.T + pose_inv[:3, 3]
    lz = lp[:, 2]
    safe_z = torch.where(lz != 0, lz, 1.0)
    x = intr.fx * lp[:, 0] / safe_z + intr.cx
    y = intr.fy * lp[:, 1] / safe_z + intr.cy
    # out-of-view (or non-finite) coordinates are masked by in_view; they
    # are clamped only to stay valid gather indices
    xi = torch.round(torch.nan_to_num(x)).clamp(0, W - 1).long()
    yi = torch.round(torch.nan_to_num(y)).clamp(0, H - 1).long()
    in_view = (lz > 0) & (x >= 0) & (y >= 0) & (x < W) & (y < H)
    lin = yi * W + xi
    d = depth_input.reshape(-1)[lin]
    on_object = in_view & (mask.reshape(-1)[lin].to(torch.int32)
                           == int(mask_id))
    erase = on_object & (d > 0) & ((lz - d).abs() < depth_window)
    out = sm.compact_self(m, m.slot_mask() & ~erase)
    return out, m.count - out.count
