"""Surfel rendering: index maps and view prediction.

Port of ``maskfusion_tpu/ops/splat.py``:

- `render_index_map` (index_map.vert:38-63, ModelProjection::predictIndices):
  one surfel per pixel with nearest-depth visibility, ties to the lowest
  slot (ops/sort_utils.zbuffer_render).
- `patch_index_map`: the JAX package's incremental post-fuse index map.
- `combined_predict` (splat.vert:54-88 + combo_splat.frag:37-65): each pixel
  ray intersects the index-map surfels of its +-window (the level-0 scan is
  the hand-written kernel ops/kernels.predict_l0_scan), optionally widened by
  a coarse index map re-validated with the true pixel ray, then the winner's
  attributes are fetched with one packed row gather.
- `synthesize_depth`: the prediction's depth image.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from maskfusion_tpu_torch.camera import CameraIntrinsics
from maskfusion_tpu_torch.mapping.surfel_map import SurfelMap, host_or_device
from maskfusion_tpu_torch.ops import kernels
from maskfusion_tpu_torch.ops import preprocess as pp
from maskfusion_tpu_torch.ops import sort_utils

_NAN = float("nan")
_INF = float("inf")


class IndexMap(NamedTuple):
    index: torch.Tensor      # (H, W) int32 surfel slot, -1 = empty
    pos: torch.Tensor        # (H, W, 3) camera-frame surfel position
    conf: torch.Tensor       # (H, W)
    color: torch.Tensor      # (H, W, 3)
    init_time: torch.Tensor  # (H, W)
    last_seen: torch.Tensor  # (H, W)
    normal: torch.Tensor     # (H, W, 3) camera-frame surfel normal
    radius: torch.Tensor     # (H, W)
    depth: torch.Tensor      # (H, W) float32, inf = empty


def _fields_from_rows(rows: torch.Tensor, slices, H: int, W: int):
    """Unpack the packed winner rows of [pos, conf, color, init_time,
    last_seen, normal, radius] into (H, W[, 3]) images."""
    out = []
    for a in sort_utils.unpack_columns(rows, slices):
        out.append(a.reshape(H, W) if a.dim() == 1 else a.reshape(H, W, 3))
    return out


def _camera_rows(m: SurfelMap, pose_inv: torch.Tensor):
    R = pose_inv[:3, :3]
    p_cam = m.pos @ R.T + pose_inv[:3, 3]
    n_cam = m.normal @ R.T
    packed, slices = sort_utils.pack_columns(
        [p_cam, m.conf, m.color, m.init_time, m.last_seen, n_cam, m.radius])
    return p_cam, packed, slices


def render_index_map(m: SurfelMap, pose_inv: torch.Tensor,
                     intr: CameraIntrinsics, height: int, width: int, time,
                     time_delta, max_depth, conf_threshold=None,
                     max_time=None) -> IndexMap:
    """Single-pixel surfel render with nearest-depth visibility; gates
    follow index_map.vert:44-49 (z in (0, maxDepth], active time window).
    `conf_threshold` / `max_time` add the splat.vert:57 gates where given
    (the global id projection renders at confidence 12)."""
    p_cam, packed, slices = _camera_rows(m, pose_inv)
    z = p_cam[:, 2]
    safe_z = torch.where(z != 0, z, 1.0)
    ui = torch.round(p_cam[:, 0] * intr.fx / safe_z + intr.cx)
    vi = torch.round(p_cam[:, 1] * intr.fy / safe_z + intr.cy)
    ok = (m.slot_mask() & ((time - m.last_seen) <= time_delta) & (z > 0)
          & (z <= max_depth) & (ui >= 0) & (ui < width) & (vi >= 0)
          & (vi < height))
    if conf_threshold is not None:
        ok = ok & (m.conf >= conf_threshold)
    if max_time is not None:
        ok = ok & (m.last_seen <= max_time)
    lin = torch.where(ok, vi * width + ui, 0.0).to(torch.int64)

    idx, win_z = sort_utils.zbuffer_render(lin, z, ok, height * width)
    empty = idx < 0
    rows = torch.where(empty[:, None], 0.0,
                       packed[torch.where(empty, 0, idx).long()])
    pos_w, conf_w, col_w, it_w, ls_w, n_w, rad_w = _fields_from_rows(
        rows, slices, height, width)
    return IndexMap(index=idx.reshape(height, width), pos=pos_w, conf=conf_w,
                    color=col_w, init_time=it_w, last_seen=ls_w, normal=n_w,
                    radius=rad_w, depth=win_z.reshape(height, width))


def pack_index_fields(im: IndexMap) -> torch.Tensor:
    """(H*W, 12) row table [pos(3), normal(3), conf, radius, init_time,
    last_seen, slot_index, pad] (the slot index rides as f32, exact below
    2^24)."""
    H, W = im.index.shape
    n = H * W
    return torch.cat([
        im.pos.reshape(n, 3), im.normal.reshape(n, 3),
        im.conf.reshape(n, 1), im.radius.reshape(n, 1),
        im.init_time.reshape(n, 1), im.last_seen.reshape(n, 1),
        im.index.reshape(n, 1).to(torch.float32),
        torch.zeros((n, 1), dtype=torch.float32, device=im.index.device),
    ], dim=1)


def patch_index_map(im1: IndexMap, m: SurfelMap, new_pix, vmap_raw,
                    nmap_filt, conf_px, rgb, rad_px, pose_inv, time,
                    count_before) -> IndexMap:
    """Incremental post-fuse index map (maskfusion_tpu/ops/splat.py:148-225):
    refresh every im1 winner from the post-fuse map, then insert each
    appended unstable at its own pixel, z-tested against the refreshed
    winner; append slots follow compact_into's row-major order."""
    H, W = new_pix.shape
    idx = im1.index
    empty = idx < 0
    _, packed, slices = _camera_rows(m, pose_inv)
    rows = torch.where(empty.reshape(-1)[:, None], 0.0,
                       packed[torch.where(empty, 0, idx).reshape(-1).long()])
    pos_w, conf_w, col_w, it_w, ls_w, n_w, rad_w = _fields_from_rows(
        rows, slices, H, W)
    r_depth = torch.where(empty, _INF, pos_w[..., 2])

    rank = torch.cumsum(new_pix.reshape(-1).to(torch.int32), 0,
                        dtype=torch.int32).reshape(H, W)
    slot_new = count_before + rank - 1
    valid_new = new_pix & (slot_new < m.capacity)
    z_new = vmap_raw[..., 2]
    take = valid_new & (z_new > 0) & (z_new < r_depth)
    tk3 = take[..., None]
    return IndexMap(
        index=torch.where(take, slot_new, torch.where(empty, -1, idx)),
        pos=torch.where(tk3, vmap_raw, pos_w),
        conf=torch.where(take, conf_px, conf_w),
        color=torch.where(tk3, rgb.to(torch.float32), col_w),
        init_time=torch.where(take, host_or_device(time), it_w),
        last_seen=torch.where(take, -2.0, ls_w),
        normal=torch.where(tk3, nmap_filt, n_w),
        radius=torch.where(take, rad_px, rad_w),
        depth=torch.where(take, z_new, r_depth),
    )


class Prediction(NamedTuple):
    vmap: torch.Tensor    # (H, W, 3) camera-frame corrected vertices, NaN holes
    nmap: torch.Tensor    # (H, W, 3)
    rgb: torch.Tensor     # (H, W, 3) float32 0..255
    conf: torch.Tensor    # (H, W)
    time: torch.Tensor    # (H, W) surfel init_time
    depth: torch.Tensor   # (H, W) 0 = hole


def _rays(H: int, W: int, intr: CameraIntrinsics, device) -> torch.Tensor:
    """(H, W, 3) unit pixel rays on the integer pixel grid."""
    u, v = pp._grid(H, W, device)
    lx = (u - intr.cx) / intr.fx
    ly = (v - intr.cy) / intr.fy
    lnorm = torch.sqrt(lx * lx + ly * ly + 1.0)
    return torch.stack([lx / lnorm, ly / lnorm, 1.0 / lnorm], dim=-1)


def _ray_disk(l, cp, cn):
    """Ray-disk hit of rays l with disks (cp, cn): (z_cam, miss2)."""
    denom = (l * cn).sum(-1)
    z_star = (cp * cn).sum(-1) / torch.where(denom.abs() > 1e-12, denom,
                                             1e-12)
    hit = l * z_star[..., None]
    return hit[..., 2], ((hit - cp) ** 2).sum(-1)


def combined_predict(index_map: IndexMap, intr: CameraIntrinsics, max_depth,
                     window: int = 2, coarse=None) -> Prediction:
    """Per-pixel gather splatting over the index map
    (maskfusion_tpu/ops/splat.py:237-465).  `coarse` = (index map at
    1/2**k resolution, k) widens the candidate set for large projected
    footprints; its winners are re-validated with the true pixel ray."""
    H, W = index_map.index.shape
    dev = index_map.index.device
    l = _rays(H, W, intr, dev)

    # level-0 scan (kernel 2): only (best_z, best_src) — the winner's
    # attributes are fetched once in phase 2
    best_z, best_src = kernels.predict_l0_scan(
        index_map.pos.contiguous(), index_map.normal.contiguous(),
        index_map.radius.contiguous(), index_map.index >= 0,
        kernels.intrinsics(intr, dev), float(max_depth), window)

    tables = [index_map]
    if coarse is not None:
        cim, klog = coarse
        tables.append(cim)
        factor = 1 << klog
        ch, cw = cim.index.shape
        cl = _rays(ch, cw, intr.level(klog), dev)
        cz = torch.full((ch, cw), _INF, device=dev)
        csrc = torch.full((ch, cw), -1, dtype=torch.int64, device=dev)
        cyy = torch.arange(ch, device=dev)[:, None].expand(ch, cw)
        cxx = torch.arange(cw, device=dev)[None, :].expand(ch, cw)
        packedc = torch.cat([cim.pos, cim.normal, cim.radius[..., None],
                             (cim.index >= 0).to(torch.float32)[..., None]],
                            dim=-1)
        for dy in range(-window, window + 1):
            for dx in range(-window, window + 1):
                t = pp.shift(packedc, dy, dx, 0.0)
                z_cam, miss2 = _ray_disk(cl, t[..., 0:3], t[..., 3:6])
                # generous selection radius: the texel ray is up to one
                # texel off the true pixel ray; rank by 5 cm depth band,
                # then by ray miss
                slack = t[..., 6] + factor * z_cam / abs(intr.fx)
                score = (torch.floor(z_cam * 20.0) * 1e3
                         + miss2 / torch.clamp(slack * slack, min=1e-12))
                ok = ((t[..., 7] > 0) & (miss2 <= slack * slack)
                      & (z_cam > 0) & (z_cam <= max_depth) & (score < cz))
                cz = torch.where(ok, score, cz)
                src = (H * W + (cyy + dy).clamp(0, ch - 1) * cw
                       + (cxx + dx).clamp(0, cw - 1))
                csrc = torch.where(ok, src, csrc)

        # exact re-validation under every full-res pixel
        geom = torch.cat([torch.cat([t.pos.reshape(-1, 3),
                                     t.normal.reshape(-1, 3),
                                     t.radius.reshape(-1, 1)], dim=1)
                          for t in tables], dim=0)
        yy = torch.arange(H, device=dev)[:, None]
        xx = torch.arange(W, device=dev)[None, :]
        lin = ((yy >> klog) * cw + (xx >> klog)).reshape(-1)
        src = csrc.reshape(-1)[lin]
        rows = geom[src.clamp(min=0)]
        z_cam, miss2 = _ray_disk(l, rows[:, 0:3].reshape(H, W, 3),
                                 rows[:, 3:6].reshape(H, W, 3))
        crad = rows[:, 6].reshape(H, W)
        ok = ((src >= 0).reshape(H, W) & (miss2 <= crad * crad)
              & (z_cam > 0) & (z_cam <= max_depth) & (z_cam < best_z))
        best_z = torch.where(ok, z_cam, best_z)
        best_src = torch.where(ok, src.reshape(H, W).to(torch.int32),
                               best_src)

    # phase 2: the winner's normal and appearance in one packed row gather
    attr = torch.cat([torch.cat([t.normal.reshape(-1, 3),
                                 t.color.reshape(-1, 3),
                                 t.conf.reshape(-1, 1),
                                 t.init_time.reshape(-1, 1)], dim=1)
                      for t in tables], dim=0)
    flat_src = best_src.reshape(-1)
    rows = torch.where((flat_src >= 0)[:, None],
                       attr[flat_src.clamp(min=0).long()], 0.0)
    holes = torch.isinf(best_z)
    hit_pos = l * torch.where(holes, 0.0, best_z)[..., None] / l[..., 2:3]
    return Prediction(
        vmap=torch.where(holes[..., None], _NAN, hit_pos),
        nmap=torch.where(holes[..., None], _NAN,
                         rows[:, 0:3].reshape(H, W, 3)),
        rgb=rows[:, 3:6].reshape(H, W, 3),
        conf=torch.where(holes, 0.0, rows[:, 6].reshape(H, W)),
        time=rows[:, 7].reshape(H, W),
        depth=torch.where(holes, 0.0, best_z),
    )


def synthesize_depth(pred: Prediction) -> torch.Tensor:
    """Depth-only output (ModelProjection::synthesizeDepth,
    depth_splat.frag)."""
    return pred.depth
