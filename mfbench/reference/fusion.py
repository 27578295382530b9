"""The plain reference of the SLAM frame's fuse, clean and predict stage,
and of the (depth, id) projection that guards it.

Frozen copies of the program's plain code
(``maskfusion_tpu_torch/engine.py``: ``_fuse_core``,
``fuse_clean_predict``, ``fuse_clean_predict_obj_win``, ``fuse_stage``,
``project_ids``, ``project_ids_obj_win`` and ``combine_ids``), over the
frozen mapping operations beside this file (``surfel_map``, ``splat`` with
the plain level-0 scan in place of the CUDA kernel, ``fuse``, ``clean``,
``fill_in``).  The configuration is the file's ``engine`` group, a dict.
Nothing of the program is imported.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from mfbench.reference import clean as clean_ops
from mfbench.reference import fill_in as fill_ops
from mfbench.reference import fuse as fuse_ops
from mfbench.reference import se3
from mfbench.reference import splat as splat_ops
from mfbench.reference import surfel_map as sm
from mfbench.reference.camera import CameraIntrinsics


def time_delta(cfg: Dict) -> int:
    return (1 << 30) if cfg["open_loop"] else int(cfg["time_delta"])


def shifted(intr: CameraIntrinsics, oy: int, ox: int) -> CameraIntrinsics:
    """The intrinsics of a window at (oy, ox)."""
    return CameraIntrinsics(intr.fx, intr.fy, intr.cx - ox, intr.cy - oy)


def _gated(gate, new: tuple, old: tuple) -> tuple:
    if gate is None:
        return new
    return tuple(torch.where(gate, a, b) for a, b in zip(new, old))


def fuse_core(cfg: Dict, state: Dict, vmap_raw, vmap0, nmap0, filt, rgb,
              seg_mask, time: float, mask_id: int, conf_threshold: float,
              max_depth: float, weight_multiplier: float, bucket: int,
              parity: Optional[int], compact: bool, intr: CameraIntrinsics,
              gate=None):
    """Render, fuse, patch the index map, clean and predict one model.
    ``state``: ``map`` (the model's map, at least ``bucket`` long),
    ``pose`` and ``last_delta``.  Returns (the new map prefix, the unfilled
    prediction, the inverse pose)."""
    H, W = filt.shape
    td = time_delta(cfg)
    pose = state["pose"]
    pose_inv = se3.pose_inverse(pose)
    if cfg["velocity_fusion_weight"]:
        weighting = fuse_ops.compute_fusion_weight(state["last_delta"],
                                                   weight_multiplier)
    else:
        weighting = weight_multiplier
    work = sm.prefix_view(state["map"], bucket)
    cutoff = cfg["depth_cutoff"]
    im1 = splat_ops.render_index_map(work, pose_inv, intr, H, W, time, td,
                                     cutoff)
    fres = fuse_ops.fuse(
        work, im1, vmap_raw, vmap0, nmap0, rgb, seg_mask, mask_id, pose,
        intr, time, weighting, max_depth,
        checkerboard=cfg["fuse_subsample_checkerboard"], parity=parity,
        merge_z_thresh=cfg["surfel_merge_z_thresh"])
    if cfg["incremental_im2"]:
        conf_px = sm.pixel_confidence(H, W, intr, 1.0,
                                      vmap0.device) * weighting
        rad_px = sm.radius_from_depth(vmap0[..., 2], nmap0[..., 2], intr)
        im2 = splat_ops.patch_index_map(
            im1, fres.map, fres.new_pixels, vmap_raw, nmap0, conf_px, rgb,
            rad_px, pose_inv, time, work.count)
    else:
        im2 = splat_ops.render_index_map(fres.map, pose_inv, intr, H, W,
                                         time, td, cutoff)
    cres = clean_ops.clean(
        fres.map, im2, filt, seg_mask, mask_id, pose_inv, intr, time, td,
        conf_threshold, max_depth, cfg["outlier_coefficient"],
        unstable_time_limit=cfg["unstable_time_limit"], compact=compact)
    new_map = cres.map
    if gate is not None:
        new_map = sm.SurfelMap(*(torch.where(gate, a, b)
                                 for a, b in zip(cres.map, work)))
    idx = im2.index
    keep_img = torch.where(idx >= 0, cres.keep[idx.clamp(min=0).long()],
                           False)
    im2_gated = im2._replace(index=torch.where(keep_img, idx, -1))
    im_coarse = splat_ops.render_index_map(
        cres.map, pose_inv, intr.level(2), H >> 2, W >> 2, time, td, cutoff)
    pred = splat_ops.combined_predict(im2_gated, intr, cutoff,
                                      coarse=(im_coarse, 2))
    return new_map, pred, pose_inv


def fuse_global(cfg: Dict, state: Dict, frame: Dict, seg_mask,
                time: float, bucket: int, parity, gate) -> Dict:
    """The global model's fuse, clean and predict with fill-in: the new
    map prefix and predictions."""
    new_map, pred, _ = fuse_core(
        cfg, state, frame["vmap_raw"], frame["vmap"], frame["nmap"],
        frame["filt"], frame["rgb"], seg_mask, time, 0,
        cfg["conf_threshold_global"], cfg["depth_cutoff"],
        cfg["weight_multiplier"], bucket, parity, True, frame["intr"], gate)
    filled = fill_ops.fill_in(pred, frame["rgb"], frame["vmap"],
                              frame["nmap"])
    pv, pn = filled.vmap, filled.nmap
    pv, pn = _gated(gate, (pv, pn), (state["pred_vmap"], state["pred_nmap"]))
    return {"map": new_map, "pred_vmap": pv, "pred_nmap": pn}


def fuse_object(cfg: Dict, state: Dict, frame: Dict, seg_mask, time: float,
                row: Sequence[float], bucket: int, parity, windowed: bool,
                window: int, gate) -> Dict:
    """One live object slot's fuse, clean and predict: in its (window,
    window) crop with the shifted principal point when ``windowed``, else on
    the full frame without fill-in; ``row`` is [mask_id, conf_t,
    max_depth, weight_mult, oy, ox]."""
    mid, conf_t, max_d, wm, oy, ox = (float(x) for x in row)
    mid, oy, ox = int(mid), int(oy), int(ox)
    intr = frame["intr"]
    H, W = frame["filt"].shape
    if windowed:
        win = (slice(oy, oy + window), slice(ox, ox + window))
        new_map, pred, _ = fuse_core(
            cfg, state, frame["vmap_raw"][win], frame["vmap"][win],
            frame["nmap"][win], frame["filt"][win], frame["rgb"][win],
            seg_mask[win], time, mid, conf_t, max_d, wm, bucket, parity,
            True, shifted(intr, oy, ox), gate)
        dev = frame["filt"].device
        pv = torch.full((H, W, 3), float("nan"), device=dev)
        pn = torch.full((H, W, 3), float("nan"), device=dev)
        pv[win] = pred.vmap
        pn[win] = pred.nmap
    else:
        new_map, pred, _ = fuse_core(
            cfg, state, frame["vmap_raw"], frame["vmap"], frame["nmap"],
            frame["filt"], frame["rgb"], seg_mask, time, mid, conf_t, max_d,
            wm, bucket, parity, True, intr, gate)
        pv, pn = pred.vmap, pred.nmap
    pv, pn = _gated(gate, (pv, pn), (state["pred_vmap"], state["pred_nmap"]))
    return {"map": new_map, "pred_vmap": pv, "pred_nmap": pn}


def guarded(seg_mask: torch.Tensor, ids_guard: torch.Tensor) -> torch.Tensor:
    """The segmentation where the id projection agrees with it or shows
    nothing, 255 (no model fuses it) elsewhere."""
    return torch.where((seg_mask == ids_guard) | (ids_guard == 0), seg_mask,
                       255).to(torch.uint8)


def project_depth(cfg: Dict, m: sm.SurfelMap, pose, time: float, bucket: int,
                  intr: CameraIntrinsics, H: int, W: int,
                  window: Optional[Tuple[int, int, int]] = None):
    """One model's depth in the (depth, id) projection, +inf where it shows
    nothing; ``window`` (oy, ox, size) renders a windowed object on its
    crop and pastes it into the full frame."""
    cutoff = cfg["depth_cutoff"]
    if window is None:
        h, w, wintr = H, W, intr
    else:
        oy, ox, size = window
        h = w = size
        wintr = shifted(intr, oy, ox)
    im = splat_ops.render_index_map(
        sm.prefix_view(m, bucket), se3.pose_inverse(pose), wintr, h, w, time,
        time_delta(cfg), cutoff, conf_threshold=12.0)
    pred = splat_ops.combined_predict(im, wintr, cutoff)
    d = torch.where(pred.depth > 0, pred.depth, float("inf"))
    if window is None:
        return d
    out = torch.full((H, W), float("inf"), device=d.device)
    out[oy:oy + size, ox:ox + size] = d
    return out


def combine_ids(depths: List[torch.Tensor], ids: Sequence[int]):
    """The nearest model's id a pixel, 0 where none shows."""
    stack = torch.stack(depths)
    nearest, arg = stack.min(0)
    vec = torch.tensor(list(ids), dtype=torch.int32, device=stack.device)
    return torch.where(torch.isfinite(nearest), vec[arg], 0).to(torch.uint8)
