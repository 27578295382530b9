"""The MaskFusion engine, -static slice.

Port of the static-mode subset of ``maskfusion_tpu/engine.py`` (ref
Core/MaskFusion.{h,cpp}): one global surfel map, and per frame
preprocess -> track -> fuse -> clean -> predict (`fused_static_step`,
engine.py:605-636 of the JAX package).  The multi-object path, ground-truth
pose injection and relocalisation come with later slices; asking for them
raises NotImplementedError.

The JAX package jits each stage, donates the map buffers and prewarms its
compile cache.  PyTorch runs eagerly, so none of that has a counterpart
here: the map's buffers are updated in place instead of donated.  No stage
waits on the device; diagnostics stay on it until `flush_diagnostics`.

Pose convention (as the reference): model 0's `pose` is camera->world.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from maskfusion_tpu_torch import default_device, se3
from maskfusion_tpu_torch.camera import CameraIntrinsics, Resolution
from maskfusion_tpu_torch.config import Config
from maskfusion_tpu_torch.frame import FrameData
from maskfusion_tpu_torch.mapping import surfel_map as sm
from maskfusion_tpu_torch.ops import clean as clean_ops
from maskfusion_tpu_torch.ops import fill_in as fill_ops
from maskfusion_tpu_torch.ops import fuse as fuse_ops
from maskfusion_tpu_torch.ops import preprocess as pp
from maskfusion_tpu_torch.ops import splat as splat_ops
from maskfusion_tpu_torch.tracking import odometry as odo
from maskfusion_tpu_torch.utils.tuning import get_tuning


class MapState(NamedTuple):
    """Device-resident per-model state."""
    map: sm.SurfelMap
    pose: torch.Tensor           # (4,4) camera pose in model frame
    last_delta: torch.Tensor     # (4,4) last frame's motion (fusion weight)
    pred_vmap: torch.Tensor      # filled prediction (camera frame)
    pred_nmap: torch.Tensor
    pred_rgb: torch.Tensor       # float32
    so3_intensity: torch.Tensor  # coarsest-level intensity of previous frame


class TrackResult(NamedTuple):
    pose: torch.Tensor
    delta: torch.Tensor
    icp_error: torch.Tensor
    icp_count: torch.Tensor
    rgb_error: torch.Tensor
    rgb_count: torch.Tensor
    cov_diag: torch.Tensor


class Preprocessed(NamedTuple):
    filt_depth: torch.Tensor
    intensity: torch.Tensor
    levels: tuple
    frame_pyr: odo.FramePyramids
    vmap_raw: torch.Tensor     # vertices from RAW depth — the fusion
                               # geometry source (data.vert:85-90)


@dataclasses.dataclass
class Model:
    """Host-side model record (Model.h:240-320)."""
    model_id: int
    state: MapState
    age: int = 0
    pose_log: List = dataclasses.field(default_factory=list)
    last_bucket: int = 0      # shrink-hysteresis input for choose_bucket

    @property
    def surfel_count(self) -> int:
        return int(self.state.map.count)


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """A frame image as a host tensor.  uint16 millimetres travel as their
    int16 bit pattern (torch's uint16 support is thin) and are unwrapped on
    the device (MaskFusion.preprocess); other depths become float32."""
    if a.dtype == np.uint16:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16))
    if a.ndim == 2 and a.dtype != np.float32:
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a))


class MaskFusion:
    """Host-side engine with the public surface of the JAX package's
    MaskFusion, for Config(static_mode=True)."""

    def __init__(self, resolution: Resolution, intr: CameraIntrinsics,
                 config: Optional[Config] = None, device=None):
        self.res = resolution
        self.intr = intr
        self.cfg = config or Config()
        if not self.cfg.static_mode:
            raise NotImplementedError(
                "the PyTorch port runs Config(static_mode=True) only; the "
                "multi-object path comes with the multi-object slice")
        if self.cfg.relocalisation or self.cfg.close_loops:
            raise NotImplementedError(
                "relocalisation and loop closure are not ported yet")
        self.device = torch.device(device) if device is not None \
            else default_device()
        self._tuning = get_tuning(self.device)
        self.DIAG_INTERVAL = self._tuning.diag_interval
        self.tick = 0
        self.models: List[Model] = []
        self._last_count = 0
        # bucket sizing works from a count ESTIMATE refreshed every
        # DIAG_INTERVAL frames, extrapolated with the observed append rate
        self._frames_since_flush = 0
        self._append_rate = 8192.0
        H, W = resolution.height, resolution.width
        self._cov_thresh = 1e-4 * max(1.0, (640.0 * 480.0) / (W * H))
        self._last_tracking_ok = True
        self._pending_diag = None
        self._zero_mask = torch.zeros((H, W), dtype=torch.uint8,
                                      device=self.device)
        # the bilateral's metric footprint stays constant across
        # resolutions: pixel radius and spatial sigma scale with width
        bl_scale = W / 640.0
        self._bl_radius = max(1, int(round(self.cfg.bilateral_radius
                                           * bl_scale)))
        self._bl_sigma_space = 0.024691358 / (bl_scale * bl_scale)
        # optional stage instrumentation: called with a stage name at each
        # stage boundary of fused_static_step (chip_smoke.py records CUDA
        # events there); None costs nothing
        self.stage_hook: Optional[Callable[[str], None]] = None

    def _mark(self, name: str) -> None:
        if self.stage_hook is not None:
            self.stage_hook(name)

    # ------------------------------------------------------------ stages
    def preprocess(self, rgb: torch.Tensor, depth: torch.Tensor,
                   prev_seg: torch.Tensor) -> Preprocessed:
        """engine.py:241-268 of the JAX package."""
        cfg = self.cfg
        if depth.dtype == torch.int16:      # uint16 mm bit pattern
            depth = (depth.to(torch.int32) & 0xFFFF).to(torch.float32) * 1e-3
        depth = depth.to(torch.float32)
        filt = pp.bilateral_filter_depth(
            depth, radius=self._bl_radius,
            sigma_space2_inv_half=self._bl_sigma_space)
        gray = pp.rgb_to_intensity(rgb)
        levels = pp.build_frame_pyramids(filt, gray, prev_seg, self.intr,
                                         cfg.depth_cutoff, cfg.num_pyr_levels)
        if cfg.icl_nuim:
            # -icl: ICL-NUIM's negative focal length flips normals
            levels = tuple(dict(l, nmap=-l["nmap"]) for l in levels)
        frame_pyr = odo.build_frame_pyramids_for_odometry(
            levels, rgb, cfg.max_depth_rgb)
        vmap_raw = pp.create_vmap(depth, self.intr, cfg.depth_cutoff)
        return Preprocessed(filt, gray, levels, frame_pyr, vmap_raw)

    def track(self, state: MapState, prep: Preprocessed,
              mask_id: int = 0) -> TrackResult:
        """engine.py:272-316 of the JAX package (global model)."""
        cfg = self.cfg
        model_pyr = odo.build_model_pyramids(
            state.pred_vmap, state.pred_nmap, state.pred_rgb, state.pose,
            cfg.num_pyr_levels, cfg.max_depth_rgb)
        so3_pyr = [None] * cfg.num_pyr_levels
        so3_pyr[-1] = state.so3_intensity
        res = odo.get_incremental_transformation(
            state.pose[:3, 3], state.pose[:3, :3], prep.frame_pyr, model_pyr,
            tuple(so3_pyr), self.intr,
            rgb_only=cfg.rgb_only, icp_weight=cfg.icp_weight,
            pyramid=cfg.pyramid, fast_odom=cfg.fast_odom,
            use_so3=cfg.use_so3, mask_id=mask_id,
            use_mask_rgb=cfg.mask_rgb_residual,
            use_mask_icp=cfg.mask_icp_residual,
            dist_thresh=cfg.dist_threshold,
            angle_thresh_sine=cfg.angle_threshold_sine,
            max_depth_delta_rgb=cfg.max_depth_delta_rgb,
            sobel_scale=cfg.sobel_scale,
            min_grad_magnitudes=cfg.min_grad_magnitudes,
            translation_jump_limit=cfg.translation_jump_limit,
            num_levels=cfg.num_pyr_levels,
            assoc_period=cfg.assoc_period,
            gn_step_eps=cfg.gn_step_eps)
        return TrackResult(
            pose=se3.make_pose(res.R, res.t), delta=res.delta,
            icp_error=res.icp_error, icp_count=res.icp_count,
            rgb_error=res.rgb_error, rgb_count=res.rgb_count,
            cov_diag=torch.diagonal(odo.covariance(res.A)))

    def init_map(self, prep: Preprocessed, rgb, seg_mask, mask_id: int,
                 pose: torch.Tensor, time: float, capacity: int) -> MapState:
        """engine.py:843-864 of the JAX package."""
        H, W = self.res.height, self.res.width
        cutoff = self.cfg.depth_cutoff
        m = sm.init_from_frame(capacity, prep.vmap_raw,
                               prep.levels[0]["vmap"], prep.levels[0]["nmap"],
                               rgb, seg_mask, mask_id, pose, self.intr, time)
        im = splat_ops.render_index_map(
            m, se3.pose_inverse(pose), self.intr, H, W, time,
            self.cfg.effective_time_delta(), cutoff)
        pred = splat_ops.combined_predict(im, self.intr, cutoff)
        filled = fill_ops.fill_in(pred, rgb, prep.levels[0]["vmap"],
                                  prep.levels[0]["nmap"])
        return MapState(
            map=m, pose=pose,
            last_delta=torch.eye(4, dtype=torch.float32, device=pose.device),
            pred_vmap=filled.vmap, pred_nmap=filled.nmap,
            pred_rgb=filled.rgb,
            so3_intensity=prep.frame_pyr.intensities[-1])

    def fuse_clean_predict(self, state: MapState, prep: Preprocessed, rgb,
                           seg_mask, prev_pose, time: float, mask_id: int,
                           conf_threshold: float, max_depth: float,
                           weight_multiplier: float, allow_fill_in: bool,
                           bucket: int, parity: Optional[int] = None,
                           compact: bool = True):
        """engine.py:472-598 of the JAX package.  Updates state.map's
        tensors in place (prefix write-back)."""
        cfg, intr = self.cfg, self.intr
        H, W = self.res.height, self.res.width
        time_delta = cfg.effective_time_delta()
        pose = state.pose
        pose_inv = se3.pose_inverse(pose)
        if cfg.velocity_fusion_weight:
            weighting = fuse_ops.compute_fusion_weight(state.last_delta,
                                                       weight_multiplier)
        else:
            weighting = weight_multiplier
        full_map = state.map
        work = sm.prefix_view(full_map, bucket)
        # the render uses the GLOBAL depth cutoff; the per-model max depth
        # gates only which pixels may fuse (MaskFusion.cpp:527, 541)
        im1 = splat_ops.render_index_map(work, pose_inv, intr, H, W, time,
                                         time_delta, cfg.depth_cutoff)
        fres = fuse_ops.fuse(
            work, im1, prep.vmap_raw, prep.levels[0]["vmap"],
            prep.levels[0]["nmap"], rgb, seg_mask, mask_id, pose, intr, time,
            weighting, max_depth,
            checkerboard=cfg.fuse_subsample_checkerboard, parity=parity,
            merge_z_thresh=cfg.surfel_merge_z_thresh)
        if cfg.incremental_im2:
            conf_px = sm.pixel_confidence(H, W, intr, 1.0,
                                          self.device) * weighting
            rad_px = sm.radius_from_depth(prep.levels[0]["vmap"][..., 2],
                                          prep.levels[0]["nmap"][..., 2],
                                          intr)
            im2 = splat_ops.patch_index_map(
                im1, fres.map, fres.new_pixels, prep.vmap_raw,
                prep.levels[0]["nmap"], conf_px, rgb, rad_px, pose_inv, time,
                work.count)
        else:
            im2 = splat_ops.render_index_map(fres.map, pose_inv, intr, H, W,
                                             time, time_delta,
                                             cfg.depth_cutoff)
        cres = clean_ops.clean(
            fres.map, im2, prep.filt_depth, seg_mask, mask_id, pose_inv,
            intr, time, time_delta, conf_threshold, max_depth,
            cfg.outlier_coefficient,
            unstable_time_limit=cfg.unstable_time_limit, compact=compact)
        appended = fres.map.count - work.count
        final_map = sm.write_back(full_map, cres.map)
        # prediction reuses the post-fuse index map gated by clean's keep
        idx = im2.index
        keep_img = torch.where(idx >= 0, cres.keep[idx.clamp(min=0).long()],
                               False)
        im2_gated = im2._replace(index=torch.where(keep_img, idx, -1))
        # quarter-resolution render feeds the multiscale predictor
        im_coarse = splat_ops.render_index_map(
            cres.map, pose_inv, intr.level(2), H >> 2, W >> 2, time,
            time_delta, cfg.depth_cutoff)
        pred = splat_ops.combined_predict(im2_gated, intr, cfg.depth_cutoff,
                                          coarse=(im_coarse, 2))
        if allow_fill_in:
            filled = fill_ops.fill_in(pred, rgb, prep.levels[0]["vmap"],
                                      prep.levels[0]["nmap"])
            pv, pn, pc = filled.vmap, filled.nmap, filled.rgb
            if cfg.frame_to_frame_rgb:
                pc = rgb.to(torch.float32)
        else:
            pv, pn, pc = pred.vmap, pred.nmap, pred.rgb
        new_state = MapState(
            map=final_map, pose=pose, last_delta=pose_inv @ prev_pose,
            pred_vmap=pv, pred_nmap=pn, pred_rgb=pc,
            so3_intensity=prep.frame_pyr.intensities[-1])
        return new_state, cres.removed, appended

    def fused_static_step(self, state: MapState, rgb, depth, time: float,
                          bucket: int, parity: Optional[int],
                          compact: bool = True):
        """preprocess + track + fuse + clean + predict of one -static frame
        (engine.py:605-631 of the JAX package).  Returns the new state, the
        diagnostics as ONE device tensor [icp_error, icp_count, rgb_count,
        max cov diag, surfel count, removed, appended], and the pose."""
        # the JAX package jits this step and donates `state`; eager
        # PyTorch needs neither (the map is updated in place)
        cfg = self.cfg
        self._mark("start")
        prep = self.preprocess(rgb, depth, self._zero_mask)
        self._mark("preprocess")
        tr = self.track(state, prep, 0)
        self._mark("track")
        prev_pose = state.pose
        state = state._replace(pose=tr.pose)
        new_state, removed, appended = self.fuse_clean_predict(
            state, prep, rgb, self._zero_mask, prev_pose, time, 0,
            cfg.conf_threshold_global, cfg.depth_cutoff,
            cfg.weight_multiplier, True, bucket, parity, compact)
        self._mark("fuse_clean_predict")
        diag = torch.stack([
            tr.icp_error, tr.icp_count, tr.rgb_count, tr.cov_diag.max(),
            new_state.map.count.to(torch.float32),
            removed.to(torch.float32), appended.to(torch.float32)])
        return new_state, diag, tr.pose.clone()

    # --------------------------------------------------------- frame API
    def upload_frame(self, frame: FrameData) -> FrameData:
        """Stage a frame's images in device memory: a pinned host copy and
        a non-blocking transfer, so the copy overlaps device work."""
        def up(a: np.ndarray) -> torch.Tensor:
            t = _host_tensor(a)
            if self.device.type == "cuda":
                t = t.pin_memory()
            return t.to(self.device, non_blocking=True)

        return dataclasses.replace(frame, rgb=up(frame.rgb),
                                   depth=up(frame.depth), rgb_host=frame.rgb,
                                   depth_host=frame.host_depth())

    def _device_frame(self, frame: FrameData):
        """The frame's images on the device (already there after
        upload_frame)."""
        return tuple(a if isinstance(a, torch.Tensor)
                     else _host_tensor(a).to(self.device)
                     for a in (frame.rgb, frame.depth))

    def load_state(self, state: MapState, tick: int) -> None:
        """Start the engine from a given global-model state (e.g. one
        carried over from the JAX engine by convert.map_state_from_numpy),
        as if `tick` frames had been processed."""
        self.models = [Model(model_id=0, state=state)]
        self.tick = tick
        self._last_count = self.models[0].surfel_count
        self._frames_since_flush = 0

    def process_frame(self, frame: FrameData,
                      gt_pose: Optional[np.ndarray] = None) -> Dict:
        self.tick += 1
        cfg = self.cfg
        rgb, depth = self._device_frame(frame)
        if not self.models:
            prep = self.preprocess(rgb, depth, self._zero_mask)
            pose0 = torch.as_tensor(
                (gt_pose if gt_pose is not None else np.eye(4))
                .astype(np.float32), device=self.device)
            state = self.init_map(prep, rgb, self._zero_mask, 0, pose0,
                                  float(self.tick),
                                  cfg.global_surfel_capacity)
            self.models.append(Model(model_id=0, state=state))
            self._last_count = self.models[0].surfel_count
            self._log_poses(frame)
            return {"tick": self.tick, "surfels": self._last_count,
                    "tracking_ok": True, "n_models": 1}
        if gt_pose is not None:
            raise NotImplementedError(
                "ground-truth pose injection is not ported yet")

        # -static fast path: one step, no per-frame host sync
        glob = self.models[0]
        est = min(self._last_count
                  + int(self._append_rate * (self._frames_since_flush + 1)),
                  glob.state.map.capacity)
        self._frames_since_flush += 1
        bucket = sm.choose_bucket(est, glob.state.map.capacity,
                                  current=glob.last_bucket)
        glob.last_bucket = bucket
        # no prewarm of the next bucket's compile: nothing is compiled here
        glob.state, diag, pose_out = self.fused_static_step(
            glob.state, rgb, depth, float(self.tick), bucket=bucket,
            parity=(self.tick % 2 if cfg.fuse_subsample_checkerboard
                    else None),
            compact=(self.tick % self.DIAG_INTERVAL == 0))
        glob.pose_log.append({"timestamp": frame.timestamp
                              or float(self.tick),
                              "tick": self.tick, "pose": pose_out})
        glob.age += 1
        self._pending_diag = diag
        out = {"tick": self.tick, "surfels": self._last_count,
               "n_models": 1, "tracking_ok": self._last_tracking_ok}
        if self.tick % self.DIAG_INTERVAL == 0:
            out.update(self.flush_diagnostics())
        return out

    def flush_diagnostics(self) -> Dict:
        """Fetch the most recent step's diagnostics (one device->host copy)
        and refresh the bucket estimate (engine.py:2433-2462 of the JAX
        package)."""
        if self._pending_diag is None:
            return {}
        (icp_err, icp_cnt, rgb_cnt, cov_max, count, removed,
         appended) = self._pending_diag.cpu().tolist()
        self._pending_diag = None
        self._last_count = int(count)
        self._append_rate = max(float(appended) * 1.5, 4096.0)
        self._frames_since_flush = 0
        glob = self.models[0] if self.models else None
        if glob is not None and glob.last_bucket and (
                self._last_count + self._tuning.headroom_global
                > glob.last_bucket):
            glob.last_bucket = sm.choose_bucket(
                self._last_count + 131072, glob.state.map.capacity,
                current=glob.last_bucket)
        self._last_tracking_ok = bool(cov_max <= self._cov_thresh)
        return {"surfels": int(count), "icp_error": float(icp_err),
                "icp_count": float(icp_cnt), "rgb_count": float(rgb_cnt),
                "removed": int(removed),
                "tracking_ok": self._last_tracking_ok}

    def _log_poses(self, frame: FrameData) -> None:
        """TUM-convention pose log entries hold device tensors (copies);
        exporters convert lazily."""
        self.models[0].pose_log.append({
            "timestamp": frame.timestamp or float(self.tick),
            "tick": self.tick, "pose": self.models[0].state.pose.clone()})

    # ----------------------------------------------------------- exports
    @property
    def global_model(self) -> Model:
        return self.models[0]

    @property
    def current_pose(self) -> np.ndarray:
        return self.models[0].state.pose.cpu().numpy()

    def pose_log_numpy(self) -> List[np.ndarray]:
        """The global model's logged poses as host arrays."""
        return [e["pose"].cpu().numpy() for e in self.models[0].pose_log]

    def download_map(self, model_index: int = 0):
        return sm.download(self.models[model_index].state.map)
