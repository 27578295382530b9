"""The MaskFusion engine: the -static frame and the synchronous
multi-object frame.

Port of ``maskfusion_tpu/engine.py`` (ref Core/MaskFusion.{h,cpp}):

- ``Config(static_mode=True)``: one global surfel map, and per frame
  preprocess -> track -> fuse -> clean -> predict (`fused_static_step`,
  engine.py:605-636 of the JAX package).  No stage waits on the device;
  diagnostics stay on it until `flush_diagnostics`.
- ``Config(static_mode=False)``: the synchronous multi-object schedule
  (engine.py:1236-1377): preprocess with the last segmentation, track the
  global model then the object models, project all models' ids, segment
  (edge map on the device, label rules on the host), spawn / inactivate
  models, choose each object's processing window, then fuse, clean and
  predict every model.
- The object passes (engine.py:318-356, 636-1041, 1539-1613, 1806-1911):
  with ``batch_object_tracking`` (the default) two or more objects track in
  one solve over a leading slot axis (`track_objects`), their id
  projections share one bucket, and every model fuses through `fuse_stage`
  (the global model, then each object slot, in its (OW, OW) window where
  every live object has one: `fuse_clean_predict_obj_win`).  With
  ``batch_object_tracking=False`` each model tracks and fuses in turn.
- ``process_frame(frame, gt_pose=...)`` in either mode: the same general
  step with the global pose set to the given ground-truth pose in place of
  its track (objects are still tracked); in static mode it skips the
  segmentation.

The stopwatch times the host's dispatch of each stage (``Preprocess``,
``odom``, ``segmentation``, ``fuse``, ``Run``; the -static fast path records
only ``Run``), and ``Config.diag_export_dir`` writes the per-frame metrics
CSV and alignment-error images (utils/diag_export).

The pipelined multi-object schedule (with its windowed object tracker and
windowed id projection), the Co-Fusion segmenter, redetection and
relocalisation come with later slices; asking for them raises
NotImplementedError.

The JAX package jits each stage, donates the map buffers and prewarms its
compile cache.  PyTorch runs eagerly, so none of that has a counterpart
here: the map's buffers are updated in place instead of donated.

Pose conventions (as the reference): every model's `pose` is the camera
pose in that model's frame; model 0's is camera->world, and an object's
object->world pose is global_pose @ inverse(object_pose).
"""

from __future__ import annotations

import dataclasses
import time as _time
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
from maskfusion_tpu_torch.segmentation import create_segmenter
from maskfusion_tpu_torch.segmentation.mf_segmentation import ModelInfo
from maskfusion_tpu_torch.tracking import odometry as odo
from maskfusion_tpu_torch.utils.stopwatch import Stopwatch
from maskfusion_tpu_torch.utils.tuning import get_tuning

# Model ids are uint8 mask labels.  255 is the semantic-ignore label and 254
# the JAX package's dead padding-slot sentinel of its batched object passes;
# id assignment skips both, so neither ever names a live model.
DEAD_SLOT_ID = 254


def _slot_class(n_live: int, floor: int) -> int:
    """Object-axis size class: the next power of two >= max(n_live, floor);
    0 only when both are 0 (engine.py:59-69 of the JAX package)."""
    n = max(n_live, floor)
    if n <= 0:
        return 0
    c = 1
    while c < n:
        c <<= 1
    return c


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
    class_id: int = -1
    age: int = 0
    unseen_count: int = 0
    is_static: bool = True
    initial_c2w_inv: Optional[np.ndarray] = None
    conf_threshold: float = 10.0
    max_depth: float = 100.0
    prev_pose: Optional[torch.Tensor] = None   # pose before this frame's track
    pose_log: List = dataclasses.field(default_factory=list)
    last_bucket: int = 0      # shrink-hysteresis input for choose_bucket
    count_est: int = -1       # last fetched surfel count (-1: unknown)
    window: Optional[tuple] = None  # (oy, ox) object-window origin, or None
                                    # when the mask does not fit the window
    fused_once: bool = False  # first-fuse weight boost applied yet?

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


def _window_size(cfg: Config, H: int, W: int) -> int:
    """The JAX package's static object-window size (0: windowing off),
    engine.py:663-667."""
    ow = int(cfg.object_window)
    return 0 if ow <= 0 or ow > min(H, W) or ow % 8 else ow


def _check_supported(cfg: Config) -> None:
    """Raise NotImplementedError for what the port does not run yet, naming
    the ROADMAP item that brings it."""
    if cfg.relocalisation or cfg.close_loops:
        raise NotImplementedError(
            "relocalisation and loop closure are not ported yet (ROADMAP "
            "queue 1 item 12)")
    if cfg.static_mode:
        return
    if cfg.seg_method in ("cofusion", "co_fusion"):
        raise NotImplementedError(
            "seg_method='cofusion' is not ported yet (ROADMAP queue 1 item "
            "11)")
    # the JAX engine runs its pipelined schedule only with a device edge
    # map, i.e. for the maskfusion segmenter (engine.py:1149-1153)
    if cfg.pipelined_multiobject and cfg.seg_method in ("maskfusion",
                                                        "mask_fusion"):
        raise NotImplementedError(
            "pipelined_multiobject=True: the pipelined and prefused "
            "multi-object schedules are not ported yet (ROADMAP queue 1 "
            "item 9); pass pipelined_multiobject=False for the synchronous "
            "schedule")
    if cfg.enable_redetection:
        raise NotImplementedError(
            "enable_redetection: model redetection needs the fern model "
            "matcher, ported with relocalisation (ROADMAP queue 1 item 12)")


class MaskFusion:
    """Host-side engine with the public surface of the JAX package's
    MaskFusion, for the -static and the synchronous multi-object frame."""

    def __init__(self, resolution: Resolution, intr: CameraIntrinsics,
                 config: Optional[Config] = None, device=None):
        self.res = resolution
        self.intr = intr
        self.cfg = config or Config()
        H, W = resolution.height, resolution.width
        _check_supported(self.cfg)
        self.device = torch.device(device) if device is not None \
            else default_device()
        self._tuning = get_tuning(self.device)
        self.DIAG_INTERVAL = self._tuning.diag_interval
        self.tick = 0
        self.models: List[Model] = []          # [0] = global model
        self.inactive_models: List[Model] = []
        self.next_id = 1
        self.spawn_offset = self.cfg.model_spawn_offset
        self.last_segmentation: Optional[np.ndarray] = None
        self.lost = False
        self.new_model_listeners: List[Callable] = []
        self.inactive_model_listeners: List[Callable] = []
        # (expiry tick, model id, spawn mask): phantom re-spawn claims, see
        # _segment_and_update_models
        self._recent_spawns: List = []
        self.stopwatch = Stopwatch()
        self._diag_exporter = None
        if self.cfg.diag_export_dir:
            from maskfusion_tpu_torch.utils.diag_export import \
                DiagnosticExporter

            self._diag_exporter = DiagnosticExporter(
                self.cfg.diag_export_dir,
                interval=self.cfg.diag_export_interval)
        self.segmenter = None
        if not self.cfg.static_mode:
            self.segmenter = create_segmenter(self.cfg.seg_method, self.cfg,
                                              resolution, intr)
        self._last_count = 0
        # bucket sizing works from a count ESTIMATE refreshed every
        # DIAG_INTERVAL frames, extrapolated with the observed append rate
        self._frames_since_flush = 0
        self._append_rate = 8192.0
        self._cov_thresh = 1e-4 * max(1.0, (640.0 * 480.0) / (W * H))
        self._last_tracking_ok = True
        self._pending_diag = None
        self._zero_mask = torch.zeros((H, W), dtype=torch.uint8,
                                      device=self.device)
        self._obj_window = _window_size(self.cfg, H, W)
        # (capacity, slot) -> dead padding-slot state (_dummy_obj_state)
        self._dummy_state_cache: Dict = {}
        # frames whose object models fused in their windows
        self.windowed_fuses = 0
        # the bilateral's metric footprint stays constant across
        # resolutions: pixel radius and spatial sigma scale with width
        bl_scale = W / 640.0
        self._bl_radius = max(1, int(round(self.cfg.bilateral_radius
                                           * bl_scale)))
        self._bl_sigma_space = 0.024691358 / (bl_scale * bl_scale)
        # optional stage instrumentation: called with a stage name at each
        # stage boundary of a frame (chip_smoke.py records CUDA events
        # there); None costs nothing
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

    def track(self, state: MapState, prep: Preprocessed, mask_id: int = 0,
              is_object: bool = False,
              warm: Optional[torch.Tensor] = None) -> TrackResult:
        """engine.py:272-316 of the JAX package.  An object model
        (`is_object`) tracks with the object weights and damping; `warm`,
        the camera's world motion from the global track, starts its solve
        from "world-static" (Config.object_warm_start)."""
        res = self._solve(state.pose, state.pred_vmap, state.pred_nmap,
                          state.pred_rgb, state.so3_intensity, mask_id, prep,
                          is_object, warm)
        return TrackResult(
            pose=se3.make_pose(res.R, res.t), delta=res.delta,
            icp_error=res.icp_error, icp_count=res.icp_count,
            rgb_error=res.rgb_error, rgb_count=res.rgb_count,
            cov_diag=torch.diagonal(odo.covariance(res.A)))

    def track_objects(self, states: List[MapState], mask_ids: List[int],
                      prep: Preprocessed,
                      warm: Optional[torch.Tensor] = None):
        """Every object model in ONE solve over a leading slot axis
        (engine.py:318-356 of the JAX package, a jax.vmap over objects; the
        reference tracks them in turn, MaskFusion.cpp:246-278).  Each slot
        has its own pose, model pyramids, SO(3) intensity and mask id; all
        share the frame pyramids.  Returns the new poses (N, 4, 4) and each
        slot's translation jump (N,), on the device."""
        res = self._solve(
            *(torch.stack([getattr(s, f) for s in states])
              for f in ("pose", "pred_vmap", "pred_nmap", "pred_rgb",
                        "so3_intensity")),
            self._upload(np.asarray(mask_ids, np.int32)), prep, True, warm)
        return (se3.make_pose(res.R, res.t),
                torch.linalg.vector_norm(res.delta[:, :3, 3], dim=-1))

    def _solve(self, pose, pred_vmap, pred_nmap, pred_rgb, so3_intensity,
               mask_id, prep: Preprocessed, is_object: bool,
               warm: Optional[torch.Tensor]) -> odo.OdometryResult:
        """The tracking solve of one model, or of N models stacked on a
        leading slot axis (an (N,) tensor of mask ids)."""
        cfg = self.cfg
        model_pyr = odo.build_model_pyramids(
            pred_vmap, pred_nmap, pred_rgb, pose, cfg.num_pyr_levels,
            cfg.max_depth_rgb)
        pose0 = pose if warm is None else pose @ warm
        so3_pyr = [None] * (cfg.num_pyr_levels - 1) + [so3_intensity]
        return odo.get_incremental_transformation(
            pose0[..., :3, 3], pose0[..., :3, :3], prep.frame_pyr, model_pyr,
            tuple(so3_pyr), self.intr,
            rgb_only=cfg.rgb_only,
            icp_weight=(cfg.object_icp_weight if is_object
                        else cfg.icp_weight),
            gn_damping=(cfg.object_gn_damping if is_object else 0.0),
            rgb_finest_only=(is_object and cfg.object_rgb_finest_only),
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

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A small host array on the device without waiting for the
        device's queue: a pinned copy, sent non-blocking."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def init_map(self, prep: Preprocessed, rgb, seg_mask, mask_id: int,
                 pose: torch.Tensor, time: float, capacity: int,
                 weighting: float = 1.0) -> MapState:
        """engine.py:843-864 of the JAX package.  A spawned object starts
        with `weighting` 100, the first-fuse boost."""
        H, W = self.res.height, self.res.width
        cutoff = self.cfg.depth_cutoff
        m = sm.init_from_frame(capacity, prep.vmap_raw,
                               prep.levels[0]["vmap"], prep.levels[0]["nmap"],
                               rgb, seg_mask, mask_id, pose, self.intr, time,
                               weighting)
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

    def _fuse_core(self, state: MapState, vmap_raw, vmap0, nmap0, filt, rgb,
                   seg_mask, time: float, mask_id: int,
                   conf_threshold: float, max_depth: float,
                   weight_multiplier: float, bucket: int,
                   parity: Optional[int], compact: bool,
                   intr: CameraIntrinsics):
        """Render, fuse, patch the index map, clean and predict one model
        on an image of the inputs' size seen through `intr`: the full frame,
        or an object's window with its shifted principal point.  Updates
        state.map's tensors in place (prefix write-back) and returns the
        map, the unfilled prediction, the removed and appended counts and
        the inverse pose."""
        cfg = self.cfg
        H, W = filt.shape
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
            work, im1, vmap_raw, vmap0, nmap0, rgb, seg_mask, mask_id, pose,
            intr, time, weighting, max_depth,
            checkerboard=cfg.fuse_subsample_checkerboard, parity=parity,
            merge_z_thresh=cfg.surfel_merge_z_thresh)
        if cfg.incremental_im2:
            # confidence and radius depend on the distance from the
            # principal point: a window's shifted one
            conf_px = sm.pixel_confidence(H, W, intr, 1.0,
                                          self.device) * weighting
            rad_px = sm.radius_from_depth(vmap0[..., 2], nmap0[..., 2], intr)
            im2 = splat_ops.patch_index_map(
                im1, fres.map, fres.new_pixels, vmap_raw, nmap0, conf_px,
                rgb, rad_px, pose_inv, time, work.count)
        else:
            im2 = splat_ops.render_index_map(fres.map, pose_inv, intr, H, W,
                                             time, time_delta,
                                             cfg.depth_cutoff)
        cres = clean_ops.clean(
            fres.map, im2, filt, seg_mask, mask_id, pose_inv, intr, time,
            time_delta, conf_threshold, max_depth, cfg.outlier_coefficient,
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
        return final_map, pred, cres.removed, appended, pose_inv

    def fuse_clean_predict(self, state: MapState, prep: Preprocessed, rgb,
                           seg_mask, prev_pose, time: float, mask_id: int,
                           conf_threshold: float, max_depth: float,
                           weight_multiplier: float, allow_fill_in: bool,
                           bucket: int, parity: Optional[int] = None,
                           compact: bool = True):
        """engine.py:472-598 of the JAX package.  Updates state.map's
        tensors in place (prefix write-back)."""
        cfg = self.cfg
        lv0 = prep.levels[0]
        final_map, pred, removed, appended, pose_inv = self._fuse_core(
            state, prep.vmap_raw, lv0["vmap"], lv0["nmap"], prep.filt_depth,
            rgb, seg_mask, time, mask_id, conf_threshold, max_depth,
            weight_multiplier, bucket, parity, compact, self.intr)
        if allow_fill_in:
            filled = fill_ops.fill_in(pred, rgb, lv0["vmap"], lv0["nmap"])
            pv, pn, pc = filled.vmap, filled.nmap, filled.rgb
            if cfg.frame_to_frame_rgb:
                pc = rgb.to(torch.float32)
        else:
            pv, pn, pc = pred.vmap, pred.nmap, pred.rgb
        new_state = MapState(
            map=final_map, pose=state.pose, last_delta=pose_inv @ prev_pose,
            pred_vmap=pv, pred_nmap=pn, pred_rgb=pc,
            so3_intensity=prep.frame_pyr.intensities[-1])
        return new_state, removed, appended

    def _intr_shift(self, oy: int, ox: int) -> CameraIntrinsics:
        """Intrinsics with the principal point moved into a window's
        coordinates (engine.py:669-676 of the JAX package).  The origin is
        a host int, so cx - ox is exact; nothing is cached by these
        intrinsics (windows move every frame)."""
        i = self.intr
        return CameraIntrinsics(i.fx, i.fy, i.cx - ox, i.cy - oy)

    def fuse_clean_predict_obj_win(self, state: MapState, prep: Preprocessed,
                                   rgb, seg_mask, prev_pose, time: float,
                                   mask_id: int, conf_threshold: float,
                                   max_depth: float, weight_multiplier: float,
                                   oy: int, ox: int, bucket: int,
                                   parity: Optional[int]) -> MapState:
        """An object's fuse + clean + predict on its (OW, OW) window at
        (oy, ox) (engine.py:678-775 of the JAX package): every image-side
        pass runs on the crop with the shifted principal point; the window
        holds the object's mask and margin, so everything inside it sees
        the full-frame pass's pixels.  The prediction is pasted into a NaN
        canvas (zeros for rgb); objects never fill in."""
        H, W = self.res.height, self.res.width
        OW = self._obj_window
        win = (slice(oy, oy + OW), slice(ox, ox + OW))
        lv0 = prep.levels[0]
        final_map, pred, _removed, _appended, pose_inv = self._fuse_core(
            state, prep.vmap_raw[win], lv0["vmap"][win], lv0["nmap"][win],
            prep.filt_depth[win], rgb[win], seg_mask[win], time, mask_id,
            conf_threshold, max_depth, weight_multiplier, bucket, parity,
            True, self._intr_shift(oy, ox))
        pv = torch.full((H, W, 3), float("nan"), device=self.device)
        pn = torch.full((H, W, 3), float("nan"), device=self.device)
        pc = torch.zeros((H, W, 3), device=self.device)
        pv[win] = pred.vmap
        pn[win] = pred.nmap
        pc[win] = pred.rgb
        return MapState(
            map=final_map, pose=state.pose, last_delta=pose_inv @ prev_pose,
            pred_vmap=pv, pred_nmap=pn, pred_rgb=pc,
            so3_intensity=prep.frame_pyr.intensities[-1])

    def fuse_stage(self, glob_state: MapState, obj_states, prep: Preprocessed,
                   rgb, seg_mask, prev_poses: torch.Tensor, time: float,
                   obj_params: np.ndarray, glob_bucket: int, obj_bucket: int,
                   parity: Optional[int], windowed: bool = False):
        """Every model's fuse + clean + predict (pipelined_fuse_stage,
        engine.py:957-1041 of the JAX package, as its synchronous schedule
        calls it: no tracking gate, no ids guard).  The global model first
        (fill-in, compaction), then each object slot, in its window when
        `windowed`.  `prev_poses` stacks the pre-track poses (row 0 global,
        then one a slot); `obj_params` holds one host row a slot,
        [mask_id, conf_t, max_depth, weight_mult, oy, ox].  A dead slot
        (mask id DEAD_SLOT_ID) would fuse no pixel, so it is skipped and
        comes back as it went in.  Returns (global state, object states)."""
        new_glob, _removed, _app = self.fuse_clean_predict(
            glob_state, prep, rgb, seg_mask, prev_poses[0], time, 0,
            self.cfg.conf_threshold_global, self.cfg.depth_cutoff,
            self.cfg.weight_multiplier, True, glob_bucket, parity, True)
        new_objs = []
        for k, (state, row) in enumerate(zip(obj_states, obj_params)):
            mid, conf_t, max_d, wm, oy, ox = row.tolist()
            if int(mid) == DEAD_SLOT_ID:
                new_objs.append(state)
            elif windowed:
                new_objs.append(self.fuse_clean_predict_obj_win(
                    state, prep, rgb, seg_mask, prev_poses[k + 1], time,
                    int(mid), conf_t, max_d, wm, int(oy), int(ox),
                    obj_bucket, parity))
            else:
                new_objs.append(self.fuse_clean_predict(
                    state, prep, rgb, seg_mask, prev_poses[k + 1], time,
                    int(mid), conf_t, max_d, wm, False, obj_bucket, parity,
                    True)[0])
        return new_glob, tuple(new_objs)

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

    def project_ids(self, m: sm.SurfelMap, pose: torch.Tensor, time: float,
                    max_depth: float, bucket: int) -> torch.Tensor:
        """One model's depth in the global (depth, id) projection, +inf
        where it shows nothing (GlobalProjection::project, confidence 12
        hardcoded at GlobalProjection.cpp:61; engine.py:791-802 of the JAX
        package)."""
        H, W = self.res.height, self.res.width
        im = splat_ops.render_index_map(
            sm.prefix_view(m, bucket), se3.pose_inverse(pose), self.intr, H,
            W, time, self.cfg.effective_time_delta(), max_depth,
            conf_threshold=12.0)
        pred = splat_ops.combined_predict(im, self.intr, max_depth)
        return torch.where(pred.depth > 0, pred.depth, float("inf"))

    def project_ids_batched(self, maps: List[sm.SurfelMap],
                            poses: List[torch.Tensor], time: float,
                            max_depth: float, bucket: int):
        """The object models' projections with one shared bucket
        (project_ids_batched, engine.py:807-816 of the JAX package, a vmap
        over the models; here one model after another)."""
        return [self.project_ids(m, p, time, max_depth, bucket)
                for m, p in zip(maps, poses)]

    @staticmethod
    def combine_ids(depths: List[torch.Tensor],
                    ids_vec: torch.Tensor) -> torch.Tensor:
        """argmin over the models' depths -> (H, W) uint8 id image, 0 where
        no model shows (engine.py:832-839 of the JAX package)."""
        stack = torch.stack(depths)
        nearest, arg = stack.min(0)
        return torch.where(torch.isfinite(nearest), ids_vec[arg],
                           0).to(torch.uint8)

    def erase_error(self, m: sm.SurfelMap, seg_mask: torch.Tensor,
                    mask_id: int, depth: torch.Tensor, pose: torch.Tensor,
                    bucket: int):
        """Spawn subtraction on the global map (eraseErrorGeometry,
        MaskFusion.cpp:355-358; engine.py:818-827 of the JAX package)."""
        out, removed = clean_ops.erase_error_geometry(
            sm.prefix_view(m, bucket), seg_mask, mask_id, depth,
            se3.pose_inverse(pose), self.intr,
            self.cfg.spawn_subtraction_window)
        return sm.write_back(m, out), removed

    # ------------------------------------------------------------ lifecycle
    def _get_next_model_id(self, assign: bool) -> int:
        """The next free uint8 model id; ids 254 and 255 are never handed
        out (engine.py:1058-1075 of the JAX package)."""
        nxt = self.next_id
        if assign:
            if len(self.models) >= self.cfg.max_models:
                raise RuntimeError("maximum number of models (256) in use")
            used = {m.model_id for m in self.models}
            if self.cfg.keep_all_models:
                # a kept inactive model's id stays reserved
                used |= {m.model_id for m in self.inactive_models}
            while True:
                self.next_id = (self.next_id + 1) % 256 or 1
                if self.next_id not in used and self.next_id < DEAD_SLOT_ID:
                    break
        return nxt

    def _inactivate_model(self, model: Model, reason: str) -> None:
        """Smart delete (MaskFusion::inactivateModel, :699-713): a model
        with enough confident surfels is kept as inactive."""
        keep = self.cfg.keep_all_models or (
            model.surfel_count >= self.cfg.min_surfels_keep
            and model.conf_threshold > self.cfg.min_conf_keep)
        if keep:
            self.inactive_models.append(model)
        for cb in self.inactive_model_listeners:
            cb(model)
        self.models.remove(model)

    def _bucket_for(self, model: Model) -> int:
        """A model's per-frame processing bucket: pow2 steps, with the
        object floor and headroom for object models (engine.py:1388-1416
        of the JAX package).  The count is fetched from the device."""
        tun = self._tuning
        if model.model_id == 0:
            minimum, headroom = tun.min_bucket_global, tun.headroom_global
        else:
            minimum, headroom = tun.min_bucket_object, tun.headroom_object
        count = model.surfel_count
        model.count_est = count
        b = sm.choose_bucket(count, model.state.map.capacity,
                             headroom=headroom, minimum=minimum,
                             current=model.last_bucket, pow2_steps=True)
        model.last_bucket = b
        return b

    def _dummy_obj_state(self, capacity: int, slot: int) -> MapState:
        """Dead padding-slot state (engine.py:1418-1441 of the JAX
        package): an empty map, identity pose, all-invalid predictions.  It
        fuses no pixel (mask DEAD_SLOT_ID), never enters `models` and adds
        nothing to a live model's result.  Cached per slot.  The JAX package
        re-caches each slot after every fuse because its fuse stage donates
        its inputs (_refresh_dummies); the port donates nothing and skips
        dead slots, so the cached state stays valid as it is."""
        key = (capacity, slot)
        st = self._dummy_state_cache.get(key)
        if st is None:
            g = self.models[0].state
            eye = torch.eye(4, dtype=torch.float32, device=self.device)
            st = MapState(
                map=sm.empty(capacity, self.device), pose=eye,
                last_delta=eye.clone(),
                pred_vmap=torch.full_like(g.pred_vmap, float("nan")),
                pred_nmap=torch.full_like(g.pred_nmap, float("nan")),
                pred_rgb=torch.zeros_like(g.pred_rgb),
                so3_intensity=torch.zeros_like(g.so3_intensity))
            self._dummy_state_cache[key] = st
        return st

    def _padded_obj_states(self, objs: List[Model], n_slots: int):
        """The object slots of the fuse stage: live models first, then dead
        states up to the size class (engine.py:1443-1454 of the JAX
        package)."""
        states = tuple(m.state for m in objs)
        cap = (objs[0].state.map.capacity if objs
               else self.cfg.object_surfel_capacity)
        return states + tuple(self._dummy_obj_state(cap, len(objs) + k)
                              for k in range(n_slots - len(objs)))

    # ------------------------------------------------------------ windows
    def _window_from_bbox(self, y0: int, x0: int, y1: int, x1: int):
        """The (oy, ox) origin of an (OW, OW) window around a bounding box
        and its margin, snapped to a multiple of 8 and clipped into the
        frame; None when box and margin do not fit (engine.py:1539-1547 of
        the JAX package)."""
        OW = self._obj_window
        H, W = self.res.height, self.res.width
        m = self.cfg.object_window_margin
        if (y1 - y0 + 1) + 2 * m > OW or (x1 - x0 + 1) + 2 * m > OW:
            return None
        oy = int(np.clip((y0 + y1 + 1 - OW) // 2, 0, H - OW)) & ~7
        ox = int(np.clip((x0 + x1 + 1 - OW) // 2, 0, W - OW)) & ~7
        return (oy, ox)

    def _object_window(self, model: Model, seg: np.ndarray):
        """A model's window from its current mask (engine.py:1549-1564 of
        the JAX package): an absent label keeps the previous window (the
        object is briefly unseen; its surfels still project near it)."""
        if not self._obj_window:
            return None
        sel = seg == model.model_id
        ys = sel.any(axis=1)
        if not ys.any():
            return model.window
        xs = sel.any(axis=0)
        y0, y1 = np.flatnonzero(ys)[[0, -1]]
        x0, x1 = np.flatnonzero(xs)[[0, -1]]
        return self._window_from_bbox(y0, x0, y1, x1)

    def _update_windows(self, seg: np.ndarray) -> None:
        """Every object model's window from the frame's segmentation
        (engine.py:1566-1585 of the JAX package, its numpy path; the native
        bounding-box pass comes with mfcore)."""
        if not self._obj_window:
            return
        for model in self.models[1:]:
            model.window = self._object_window(model, seg)

    def _project_ids_all(self, time: float) -> torch.Tensor:
        """All models' (depth, id) projections combined into one uint8 id
        image on the device (GlobalProjection.cpp:48-75; engine.py:1597-1621
        of the JAX package).  Every model renders with the global depth
        cutoff (GlobalProjection.cpp:60); two or more objects of one
        capacity share the largest of their buckets."""
        cutoff = self.cfg.depth_cutoff
        glob = self.models[0]
        depths = [self.project_ids(glob.state.map, glob.state.pose, time,
                                   cutoff, bucket=self._bucket_for(glob))]
        objs = self.models[1:]
        if len(objs) >= 2 and len({m.state.map.capacity
                                   for m in objs}) == 1:
            bucket = max(self._bucket_for(m) for m in objs)
            depths += self.project_ids_batched(
                [m.state.map for m in objs], [m.state.pose for m in objs],
                time, cutoff, bucket)
        else:
            depths += [self.project_ids(m.state.map, m.state.pose, time,
                                        cutoff, bucket=self._bucket_for(m))
                       for m in objs]
        ids_vec = torch.tensor([m.model_id for m in self.models],
                               dtype=torch.int32, device=self.device)
        return self.combine_ids(depths, ids_vec)

    def _segment_and_update_models(self, frame: FrameData, prep, rgb,
                                   ids: np.ndarray) -> np.ndarray:
        """Host segmentation + model lifecycle for one frame
        (MaskFusion.cpp:289-374; engine.py:1623-1804 of the JAX package):
        segmenter, phantom re-spawn claims, spawning (with optional spawn
        subtraction), per-model maxDepth / confidence ramp.  Returns the full
        segmentation mask."""
        cfg = self.cfg
        glob = self.models[0]
        tick = self.tick
        if self.spawn_offset < cfg.model_spawn_offset:
            self.spawn_offset += 1
        allow_new = (
            self.spawn_offset >= cfg.model_spawn_offset
            and len(self.models) < cfg.max_active_models
            and (cfg.mask_cutoff_frame is None
                 or tick <= cfg.mask_cutoff_frame))
        infos = [ModelInfo(m.model_id, m.class_id) for m in self.models]
        vmap, nmap = prep.levels[0]["vmap"], prep.levels[0]["nmap"]
        kw = {}
        if hasattr(self.segmenter, "edge_binary"):
            # the device part: edge map (kernel 3) -> non-edge binary
            kw["nonedge"] = self.segmenter.edge_binary(vmap, nmap)[1].cpu()
            self._mark("segment_device")
        seg_result = self.segmenter.perform(
            frame, vmap, nmap, ids, infos, self._get_next_model_id(False),
            allow_new, **kw)
        self._mark("segment_host")
        seg_mask_np = seg_result.full_segmentation
        self.last_segmentation = seg_mask_np

        # -------- claim phantom re-spawns --------
        # a would-be-new component that overlaps a recently spawned model's
        # spawn-time mask IS that model: remap the label instead of
        # spawning (engine.py:1654-1692 of the JAX package)
        if seg_result.has_new_label and self._recent_spawns:
            md = seg_result.model_data[-1]
            sel = seg_result.full_segmentation == md.model_id
            sel_n = int(np.count_nonzero(sel))
            live_ids = {m.model_id for m in self.models}
            claimed = None
            for exp_tick, rid, rmask in self._recent_spawns:
                if tick > exp_tick or rid not in live_ids:
                    continue
                inter = int(np.count_nonzero(sel & rmask))
                if (inter > 0.3 * max(sel_n, 1)
                        or inter > 0.3 * max(int(np.count_nonzero(rmask)),
                                             1)):
                    claimed = rid
                    break
            if claimed is not None:
                seg_result.full_segmentation = np.where(
                    sel, claimed,
                    seg_result.full_segmentation).astype(np.uint8)
                seg_mask_np = seg_result.full_segmentation
                self.last_segmentation = seg_mask_np
                if hasattr(self.segmenter, "remap_new_label"):
                    self.segmenter.remap_new_label(md.model_id, claimed)
                seg_result.has_new_label = False
                nd = seg_result.model_data.pop()
                cd = seg_result.data_for(claimed)
                if cd is not None:
                    cd.is_empty = False
                    cd.pixel_count = nd.pixel_count
        self._recent_spawns = [
            (e, r, m) for (e, r, m) in self._recent_spawns if tick <= e]

        # -------- spawn a new model (:314-332) --------
        if seg_result.has_new_label:
            new_id = self._get_next_model_id(True)
            md = seg_result.model_data[-1]
            # the newborn starts at the camera pose, initialised from the
            # spawn frame's masked pixels with the first-fuse weight 100
            gp = glob.state.pose
            seg_dev = torch.from_numpy(seg_mask_np).to(self.device)
            new_state = self.init_map(
                prep, rgb, seg_dev, new_id, gp.clone(), float(tick),
                cfg.object_surfel_capacity, weighting=100.0)
            new_model = Model(
                model_id=new_id, state=new_state, class_id=md.class_id,
                conf_threshold=cfg.conf_threshold_object,
                max_depth=md.depth_mean + 1.2 * md.depth_std,
                is_static=True,
                initial_c2w_inv=np.eye(4, dtype=np.float32),
                count_est=int(md.pixel_count or 0))
            new_model.prev_pose = gp.clone()
            self.models.append(new_model)
            for cb in self.new_model_listeners:
                cb(new_model)
            self.spawn_offset = 0
            self._recent_spawns.append(
                (tick + int(cfg.pipeline_depth) + 2, new_id,
                 seg_mask_np == new_id))
            if cfg.spawn_subtraction:
                gmap, _erased = self.erase_error(
                    glob.state.map, seg_dev, new_id, prep.filt_depth, gp,
                    bucket=self._bucket_for(glob))
                glob.state = glob.state._replace(map=gmap)

        # per-model maxDepth + confidence ramp (:334-374)
        for model in self.models[1:]:
            md = seg_result.data_for(model.model_id)
            if md is not None and not md.is_empty:
                model.max_depth = md.depth_mean + 1.2 * md.depth_std
                model.unseen_count = 0
            else:
                model.unseen_count += 1
            model.conf_threshold = min(4.5, model.age / 25.0)
        self._update_windows(seg_mask_np)
        return seg_mask_np

    def _dispatch_fuse(self, prep, rgb, seg_mask_np: np.ndarray, tick: int,
                       do_fuse: bool) -> None:
        """fuse + clean + predict for every model (MaskFusion.cpp:539-569;
        engine.py:1806-1911 of the JAX package).  With
        batch_object_tracking, all through `fuse_stage`: the object slots
        padded to _slot_class(objects, min_object_slots), one shared object
        bucket, windowed when every live object has a window.  Otherwise
        (or, in principle, for objects of different capacities, which no
        path creates: every object map is made with
        cfg.object_surfel_capacity) each model in turn.  Objects never fill
        in, and a model's first fuse weighs 100."""
        cfg = self.cfg
        if not do_fuse:
            return
        seg_mask = torch.from_numpy(seg_mask_np).to(self.device)
        parity = tick % 2 if cfg.fuse_subsample_checkerboard else None
        glob, objs = self.models[0], self.models[1:]
        if cfg.batch_object_tracking and len(
                {m.state.map.capacity for m in objs}) <= 1:
            obj_bucket = max((self._bucket_for(m) for m in objs),
                             default=self._tuning.min_bucket_object)
            windowed = (bool(self._obj_window)
                        and bool(objs or cfg.min_object_slots)
                        and all(m.window is not None for m in objs))
            n_slots = _slot_class(len(objs), cfg.min_object_slots)
            pad = n_slots - len(objs)
            eye = torch.eye(4, dtype=torch.float32, device=self.device)
            prev_poses = torch.stack([glob.prev_pose]
                                     + [m.prev_pose for m in objs]
                                     + [eye] * pad)
            obj_params = np.asarray(
                [[m.model_id, m.conf_threshold,
                  min(cfg.depth_cutoff, m.max_depth),
                  100.0 if not m.fused_once else cfg.weight_multiplier,
                  *(m.window or (0, 0))] for m in objs]
                + [[DEAD_SLOT_ID, 1.0, cfg.depth_cutoff, 1.0, 0, 0]] * pad,
                np.float32).reshape(n_slots, 6)
            glob.state, new_objs = self.fuse_stage(
                glob.state, self._padded_obj_states(objs, n_slots), prep,
                rgb, seg_mask, prev_poses, float(tick), obj_params,
                glob_bucket=self._bucket_for(glob), obj_bucket=obj_bucket,
                parity=parity, windowed=windowed)
            for m, st in zip(objs, new_objs):
                m.state = st
                m.fused_once = True
            self.windowed_fuses += int(windowed and bool(objs))
            return
        for model in list(self.models):
            is_glob = model.model_id == 0
            wm = (100.0 if not model.fused_once and not is_glob
                  else cfg.weight_multiplier)
            conf_t = (cfg.conf_threshold_global if is_glob
                      else model.conf_threshold)
            max_d = (cfg.depth_cutoff if is_glob
                     else min(cfg.depth_cutoff, model.max_depth))
            model.state, _removed, _appended = self.fuse_clean_predict(
                model.state, prep, rgb, seg_mask, model.prev_pose,
                float(tick), model.model_id, float(conf_t), float(max_d),
                float(wm), allow_fill_in=is_glob,
                bucket=self._bucket_for(model), parity=parity)
            model.fused_once = True

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
        self.models = [Model(model_id=0, state=state,
                             conf_threshold=self.cfg.conf_threshold_global,
                             max_depth=self.cfg.depth_cutoff,
                             is_static=False)]
        self.tick = tick
        self._last_count = self.models[0].surfel_count
        self._frames_since_flush = 0

    def _prev_seg(self) -> torch.Tensor:
        if self.last_segmentation is None:
            return self._zero_mask
        return torch.from_numpy(self.last_segmentation).to(self.device)

    def process_frame(self, frame: FrameData,
                      gt_pose: Optional[np.ndarray] = None) -> Dict:
        """One frame.  `gt_pose` (camera->world, e.g. from
        io.ground_truth) replaces the global track (the -p flag,
        MainController.cpp:458-462)."""
        self.tick += 1
        t0 = _time.perf_counter()
        cfg = self.cfg
        rgb, depth = self._device_frame(frame)
        if not self.models:
            prev_seg = self._prev_seg()
            with self.stopwatch.scope("Preprocess"):
                prep = self.preprocess(rgb, depth, prev_seg)
            pose0 = torch.as_tensor(
                (gt_pose if gt_pose is not None else np.eye(4))
                .astype(np.float32), device=self.device)
            state = self.init_map(prep, rgb, prev_seg, 0, pose0,
                                  float(self.tick),
                                  cfg.global_surfel_capacity)
            self.models.append(Model(
                model_id=0, state=state,
                conf_threshold=cfg.conf_threshold_global,
                max_depth=cfg.depth_cutoff, is_static=False))
            self._last_count = self.models[0].surfel_count
            self._log_poses(frame)
            return {"tick": self.tick, "surfels": self._last_count,
                    "tracking_ok": True, "n_models": 1}
        if gt_pose is not None or not cfg.static_mode:
            return self._general_step(frame, rgb, depth, gt_pose, t0)

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
        self.stopwatch.record("Run", (_time.perf_counter() - t0) * 1000)
        if self._diag_exporter:
            self._diag_exporter.record(self, out)
        return out

    def _general_step(self, frame: FrameData, rgb, depth,
                      gt_pose: Optional[np.ndarray], t0: float) -> Dict:
        """The synchronous multi-object frame, and any frame with a
        ground-truth pose (engine.py:1154-1165, 1236-1377 of the JAX
        package).  In static mode there are no object models and the
        segmentation is skipped: the frame fuses with an all-zero mask."""
        cfg = self.cfg
        H, W = self.res.height, self.res.width
        self._mark("start")
        with self.stopwatch.scope("Preprocess"):
            prep = self.preprocess(rgb, depth, self._prev_seg())
        self._mark("preprocess")

        # ---------------- tracking (MaskFusion.cpp:240-278) ----------------
        diag: Dict = {"tick": self.tick}
        glob = self.models[0]
        for model in self.models:
            model.prev_pose = model.state.pose
        with self.stopwatch.scope("odom"):
            glob_prev_pose = glob.state.pose
            if gt_pose is None:
                tr = self.track(glob.state, prep, 0)
                new_pose = tr.pose
                cov_max, icp_error, icp_count = torch.stack(
                    [tr.cov_diag.max(), tr.icp_error, tr.icp_count]).tolist()
                tracking_ok = cov_max <= self._cov_thresh
                diag.update(icp_error=icp_error, icp_count=icp_count)
            else:
                new_pose = torch.as_tensor(
                    np.asarray(gt_pose, np.float32), device=self.device)
                tracking_ok = True
            glob.state = glob.state._replace(pose=new_pose)
            warm = (se3.pose_inverse(glob_prev_pose) @ new_pose
                    if cfg.object_warm_start else None)

            trackable = cfg.trackable_classes
            tracked = []
            for model in list(self.models[1:]):
                if trackable and model.class_id not in trackable:
                    # an untracked object mirrors the camera
                    # (Model.h:263-268)
                    model.state = model.state._replace(pose=torch.as_tensor(
                        model.initial_c2w_inv, device=self.device)
                        @ new_pose)
                else:
                    tracked.append(model)
            jumps = []
            if len(tracked) >= 2 and cfg.batch_object_tracking:
                # one solve for all objects (engine.py:1284-1296 of the JAX
                # package)
                poses, norms = self.track_objects(
                    [m.state for m in tracked],
                    [m.model_id for m in tracked], prep, warm)
                for i, model in enumerate(tracked):
                    model.state = model.state._replace(pose=poses[i])
                    jumps.append((model, norms[i]))
            else:
                for model in tracked:
                    trm = self.track(model.state, prep, model.model_id,
                                     is_object=True, warm=warm)
                    model.state = model.state._replace(pose=trm.pose)
                    jumps.append((model, torch.linalg.vector_norm(
                        trm.delta[:3, 3])))
            if jumps:
                # one host sync for all jump checks (MaskFusion.cpp:267-272)
                norms = torch.stack([j for _, j in jumps]).tolist()
                for (model, _), jump in zip(jumps, norms):
                    if jump > cfg.model_deactivate_jump:
                        self._inactivate_model(model, "movement")
        self._mark("track")

        if cfg.static_mode:
            seg_mask_np = np.zeros((H, W), np.uint8)
            self.last_segmentation = seg_mask_np
        else:
            # -------- global projection + segmentation (:289-296) --------
            with self.stopwatch.scope("segmentation"):
                ids = self._project_ids_all(float(self.tick)).cpu().numpy()
                self._mark("project")
                seg_mask_np = self._segment_and_update_models(frame, prep,
                                                              rgb, ids)
            self._mark("lifecycle")

        # ---------------- fuse / clean / predict (:539-569) ----------------
        do_fuse = tracking_ok and not self.lost and not cfg.rgb_only
        with self.stopwatch.scope("fuse"):
            self._dispatch_fuse(prep, rgb, seg_mask_np, self.tick, do_fuse)
        self._mark("fuse")

        self._log_poses(frame)
        for model in self.models:
            model.age += 1
        diag.update(surfels=glob.surfel_count, n_models=len(self.models),
                    model_ids=[m.model_id for m in self.models],
                    tracking_ok=tracking_ok, lost=self.lost)
        # a later -static fast-path frame sizes its bucket from this count
        self._last_count = diag["surfels"]
        self._frames_since_flush = 0
        self.stopwatch.record("Run", (_time.perf_counter() - t0) * 1000)
        if self._diag_exporter:
            self._diag_exporter.record(self, diag, prep.levels[0]["vmap"])
        return diag

    def flush_diagnostics(self) -> Dict:
        """Fetch the most recent -static step's diagnostics (one
        device->host copy) and refresh the bucket estimate (engine.py:
        2433-2462 of the JAX package).  The multi-object frame returns its
        diagnostics directly and leaves nothing pending."""
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
        """TUM-convention pose log entries (MaskFusion.cpp:578-602) hold
        device tensors; exporters convert lazily.  An object's logged pose
        is object->world = global_pose @ inverse(object_pose)."""
        glob_pose = self.models[0].state.pose
        for i, model in enumerate(self.models):
            pose = (glob_pose.clone() if i == 0
                    else glob_pose @ se3.pose_inverse(model.state.pose))
            model.pose_log.append({
                "timestamp": frame.timestamp or float(self.tick),
                "tick": self.tick, "pose": pose})

    # ----------------------------------------------------------- exports
    @property
    def global_model(self) -> Model:
        return self.models[0]

    @property
    def current_pose(self) -> np.ndarray:
        return self.models[0].state.pose.cpu().numpy()

    def pose_log_numpy(self, model_index: int = 0) -> List[np.ndarray]:
        """A model's logged poses as host arrays."""
        return [e["pose"].cpu().numpy()
                for e in self.models[model_index].pose_log]

    def download_map(self, model_index: int = 0):
        return sm.download(self.models[model_index].state.map)

    def all_models(self) -> List[Model]:
        return self.models + self.inactive_models
