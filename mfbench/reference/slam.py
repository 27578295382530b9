"""The plain reference of the SLAM frame's stages, in float32 torch.

It recomputes, from the benchmark's own raw frame and the configuration's
file, what the program's device stage produced for one frame:

- ``preprocess``: the raw depth to metres, the bilateral filter, the
  intensity, the three-level pyramids with their vertex and normal maps,
  and the odometry's frame pyramids (the engine's ``preprocess``);
- ``edge_map``: the geometric edge strength and the non-edge binary of the
  segmentation (``MfSegmentation.edge_binary``);
- ``track``: the global model's tracking solve (the engine's ``track``),
  from the model's prediction that the program held before the frame;
- ``track_objects``: the object models' one batched solve, each slot on
  its window of both pyramid sides where the frame is windowed (the
  engine's ``track_objects_win``, ``track_objects`` and one-object
  ``track``), from their predictions before the frame.

Its pieces are the frozen copies beside this file.  Nothing of the program
is imported.
"""

from __future__ import annotations

from typing import Dict

import torch

from mfbench.reference import kernels, se3
from mfbench.reference import reduce as red
from mfbench.reference import odometry as odo
from mfbench.reference import preprocess as pp
from mfbench.reference.camera import CameraIntrinsics


def _rounded(low):
    """Rounding through ``low`` (the control's precision), or none."""
    if low is None:
        return lambda x: x
    return lambda x: x.to(low).to(x.dtype)


def preprocess(rgb: torch.Tensor, depth_mm: torch.Tensor, cfg: Dict,
               intr: CameraIntrinsics, prev_seg: torch.Tensor,
               low=None) -> Dict:
    """rgb (H, W, 3) uint8, depth_mm (H, W) integer millimetres.  With
    ``low`` (the control) the depth and every stage's maps are rounded
    through that dtype."""
    q = _rounded(low)
    H, W = depth_mm.shape
    depth = q(depth_mm.to(torch.float32) * 1e-3)
    scale = W / 640.0
    radius = max(1, int(round(cfg["bilateral_radius"] * scale)))
    filt = q(pp.bilateral_filter_depth(
        depth, radius=radius,
        sigma_space2_inv_half=0.024691358 / (scale * scale)))
    gray = pp.rgb_to_intensity(rgb)
    levels = pp.build_frame_pyramids(filt, gray, prev_seg, intr,
                                     cfg["depth_cutoff"],
                                     cfg["num_pyr_levels"])
    levels = tuple(dict(lv, depth=q(lv["depth"]), vmap=q(lv["vmap"]),
                        nmap=q(lv["nmap"])) for lv in levels)
    if cfg["icl_nuim"]:
        levels = tuple(dict(lv, nmap=-lv["nmap"]) for lv in levels)
    frame_pyr = odo.build_frame_pyramids_for_odometry(
        levels, rgb, cfg["max_depth_rgb"])
    return {"filt": filt, "levels": levels, "frame_pyr": frame_pyr}


def edge_map(vmap: torch.Tensor, nmap: torch.Tensor, cfg: Dict, low=None):
    """(edge strength, non-edge binary), each (H, W); with ``low`` the
    strength is rounded through that dtype before the threshold."""
    edge = _rounded(low)(kernels.geometric_edge_map_plain(
        vmap.to(torch.float32), nmap.to(torch.float32),
        cfg["seg_weight_distance"], cfg["seg_weight_concavity"]))
    binary = edge > cfg["seg_threshold"]
    if cfg["seg_morph_edge_iterations"] > 0:
        binary = kernels.morph_binary(binary, cfg["seg_morph_edge_radius"],
                                      cfg["seg_morph_edge_iterations"])
    return edge, ~binary


def _solve(cfg: Dict, pose, model, so3_intensity, mask_id, frame_pyr,
           is_object: bool, intr, system: bool = False):
    """The engine's ``_solve`` (no warm start): the new pose(s), and with
    ``system`` also the final Gauss-Newton system A (6x6 a slot)."""
    if cfg["object_warm_start"]:
        raise NotImplementedError("the reference has no warm start")
    L = cfg["num_pyr_levels"]
    so3_pyr = [None] * (L - 1) + [so3_intensity]
    res = odo.get_incremental_transformation(
        pose[..., :3, 3], pose[..., :3, :3], frame_pyr, model,
        tuple(so3_pyr), intr, rgb_only=cfg["rgb_only"],
        icp_weight=(cfg["object_icp_weight"] if is_object
                    else cfg["icp_weight"]),
        gn_damping=cfg["object_gn_damping"] if is_object else 0.0,
        rgb_finest_only=is_object and cfg["object_rgb_finest_only"],
        pyramid=cfg["pyramid"], fast_odom=cfg["fast_odom"],
        use_so3=cfg["use_so3"], mask_id=mask_id,
        use_mask_rgb=cfg["mask_rgb_residual"],
        use_mask_icp=cfg["mask_icp_residual"],
        dist_thresh=cfg["dist_threshold"],
        angle_thresh_sine=cfg["angle_threshold_sine"],
        max_depth_delta_rgb=cfg["max_depth_delta_rgb"],
        sobel_scale=cfg["sobel_scale"],
        min_grad_magnitudes=tuple(cfg["min_grad_magnitudes"]),
        translation_jump_limit=cfg["translation_jump_limit"],
        num_levels=L, assoc_period=cfg["assoc_period"],
        gn_step_eps=cfg["gn_step_eps"])
    pose = se3.make_pose(res.R, res.t)
    return (pose, res.A) if system else pose


def _model_pyramids(cfg: Dict, pose, vmap, nmap, rgb):
    return odo.build_model_pyramids(vmap, nmap, rgb, pose,
                                    cfg["num_pyr_levels"],
                                    cfg["max_depth_rgb"])


def track(pose, pred_vmap, pred_nmap, pred_rgb, so3_intensity,
          frame_pyr, cfg: Dict, intr: CameraIntrinsics):
    """The global model's solve from its state before the frame: the new
    camera pose (4, 4) and whether tracking is good enough to fuse, the
    largest of the solve's covariance diagonal within the engine's
    threshold (a device bool)."""
    new_pose, A = _solve(cfg, pose, _model_pyramids(
        cfg, pose, pred_vmap, pred_nmap, pred_rgb), so3_intensity, 0,
        frame_pyr, False, intr, True)
    H, W = pred_vmap.shape[:2]
    cov = torch.diagonal(odo.covariance(A)).max()
    return new_pose, cov <= 1e-4 * max(1.0, (640.0 * 480.0) / (W * H))


def window_size(cfg: Dict, H: int, W: int) -> int:
    """The static object-window size (0: windowing off)."""
    ow = int(cfg["object_window"])
    return 0 if ow <= 0 or ow > min(H, W) or ow % 8 else ow


def halo_crop(a: torch.Tensor, oy: int, ox: int, size: int, halo: int,
              fill: float) -> torch.Tensor:
    """The (size, size) crop of an (H, W, C) image from (oy - halo,
    ox - halo), ``fill`` past the image."""
    H, W = a.shape[:2]
    out = torch.full((size, size) + a.shape[2:], fill, dtype=a.dtype,
                     device=a.device)
    y0, x0 = oy - halo, ox - halo
    ys, ye = max(0, y0), min(H, y0 + size)
    xs, xe = max(0, x0), min(W, x0 + size)
    out[ys - y0:ye - y0, xs - x0:xe - x0] = a[ys:ye, xs:xe]
    return out


def track_objects(states, mask_ids, windows, windowed: bool, frame_pyr,
                  cfg: Dict, intr: CameraIntrinsics, H: int, W: int):
    """The live object slots' new poses (N, 4, 4) and their solves' final
    Gauss-Newton systems (N, 6, 6).  ``states``: a dict a slot (pose,
    pred_vmap, pred_nmap, pred_rgb, so3) before the frame; ``mask_ids``
    the slots' model ids; ``windows`` their (oy, ox)."""
    dev = states[0]["pose"].device
    ids = torch.tensor(mask_ids, dtype=torch.int32, device=dev)
    pose = torch.stack([st["pose"] for st in states])
    if not windowed:
        if len(states) == 1:
            st = states[0]
            pose1, A1 = _solve(cfg, st["pose"], _model_pyramids(
                cfg, st["pose"], st["pred_vmap"], st["pred_nmap"],
                st["pred_rgb"]), st["so3"], int(mask_ids[0]), frame_pyr,
                True, intr, True)
            return pose1[None], A1[None]
        stk = {f: torch.stack([st[f] for st in states])
               for f in ("pred_vmap", "pred_nmap", "pred_rgb", "so3")}
        return _solve(cfg, pose, _model_pyramids(
            cfg, pose, stk["pred_vmap"], stk["pred_nmap"], stk["pred_rgb"]),
            stk["so3"], ids, frame_pyr, True, intr, True)
    OW = window_size(cfg, H, W)
    L = cfg["num_pyr_levels"]
    P = 32

    def crop(a, lv):
        n = OW >> lv
        return torch.stack([a[oy >> lv:(oy >> lv) + n,
                              ox >> lv:(ox >> lv) + n] for oy, ox in windows])

    frame = odo.FramePyramids(*(tuple(crop(a, lv) for lv, a in enumerate(f))
                                for f in frame_pyr))

    def halo(field, fill):
        return torch.stack([halo_crop(st[field], oy, ox, OW + 2 * P, P, fill)
                            for st, (oy, ox) in zip(states, windows)])

    padded = _model_pyramids(cfg, pose, halo("pred_vmap", float("nan")),
                             halo("pred_nmap", float("nan")),
                             halo("pred_rgb", 0.0))

    def trim(a, lv):
        p, n = P >> lv, OW >> lv
        return a[:, p:p + n, p:p + n]

    model = odo.ModelPyramids(
        *(tuple(trim(a, lv) for lv, a in enumerate(f)) for f in padded[:4]),
        last_valids=tuple(trim(red.rgb_last_valid(g), lv)
                          for lv, g in enumerate(padded.intensities)))
    so3 = torch.stack([st["so3"] for st in states])
    lc = L - 1
    so3 = torch.stack([so3[k, oy >> lc:(oy >> lc) + (OW >> lc),
                           ox >> lc:(ox >> lc) + (OW >> lc)]
                       for k, (oy, ox) in enumerate(windows)])
    origins = torch.tensor(windows, dtype=torch.float32, device=dev)
    wintr = CameraIntrinsics(intr.fx, intr.fy, intr.cx - origins[:, 1:2],
                             intr.cy - origins[:, 0:1])
    return _solve(cfg, pose, model, so3, ids, frame, True, wintr, True)
