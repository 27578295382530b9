"""The MaskFusion engine: the -static frame and the multi-object frame,
synchronous or pipelined.

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
- ``Config(pipelined_multiobject=True)`` (the default) with the
  MaskFusion segmenter: the pipelined schedules (engine.py:876-1041,
  1913-2312).  A frame's device work -- preprocess, every model's track
  (objects in one solve, in their windows where each has one:
  `track_objects_win`), the id projection (`project_ids_obj_win` for
  windowed objects) and the edge map -- is queued as one stage
  (`pipelined_device_stage`); its host-bound numbers come back as one
  packed `hostvec`, copied asynchronously into pinned memory with the id
  image and the non-edge binary, and the host stage (`_finish_one`:
  segmentation, lifecycle) runs once those copies have landed.  With
  ``fuse_mask_lag=True`` ("prefused") frame t's fuse is queued right behind
  its device stage, gated on the device by the frame's tracking covariance
  and fed the newest segmentation under the ids-guard; host stages drain
  as they become ready, forced only beyond ``pipeline_depth`` frames in
  flight.  With ``fuse_mask_lag=False`` ("exact") the pipeline is one frame
  deep and keeps the reference's dataflow.  Untrackable classes (or
  unequal object capacities) take the lagfuse fallback
  (`_track_models_device`).  In steady state no prefused frame waits on
  the device.
- ``process_frame(frame, gt_pose=...)`` in either mode: the same general
  step with the global pose set to the given ground-truth pose in place of
  its track (objects are still tracked); in static mode it skips the
  segmentation.

The stopwatch times the host's dispatch of each stage (``Preprocess``,
``odom``, ``segmentation``, ``fuse``, ``Run``; the -static fast path records
only ``Run``), and ``Config.diag_export_dir`` writes the per-frame metrics
CSV and alignment-error images (utils/diag_export).  While a torch profiler
runs, the stopwatch's scopes and these spans enter the span log
(utils/stopwatch), each with the tick of the frame it works for:
``process_frame`` (the root); inside ``odom``, ``track_global`` (the global
track) and ``track_objects`` (the objects' warm start and solve); inside
``fuse``, ``fuse_global`` and ``fuse_objects`` (the live slots' loop);
``host_stage`` (a pending frame's host stage, around ``fetch``,
``fetch_ids`` and ``segmentation``); ``frame_to_pose``, from a frame's
``process_frame`` call to its world pose read on the host.

With the Co-Fusion segmenter (``seg_method="cofusion"``) every frame runs
the synchronous step, whatever ``pipelined_multiobject`` says: the
pipelined schedules need the device edge map, which only the maskfusion
segmenter has (engine.py:1147-1153 of the JAX package); its host
segmentation reads every model's prediction each frame
(``_cf_model_views``).

Relocalisation and loop closure (``relocalisation`` / ``close_loops``,
engine.py:1304-1361, 2464-2521 of the JAX package): a fern database
(reloc/ferns) is kept, and every such frame runs the synchronous step,
the -static one included (the pipelined and the -static fast-path gates
both require ``ferns is None``, as in the JAX package).  After tracking,
the tracking-loss bookkeeping sets ``lost`` after more than 10 frames
whose tracking failed; under ``close_loops`` the fern search runs each
frame and either recovers a lost camera's pose or, when not lost, closes
the loop through a deformation graph (reloc/deformation) that deforms the
global map on the device.  A frame that is not lost adds its 1/8-scale
views to the database after fusion.  As in the JAX package, only the fern
search ends a loss, so ``relocalisation`` without ``close_loops`` (the
CLI's ``-rl``) stays lost once lost.  Redetection (``enable_redetection``,
engine.py:1077-1104, 1694-1725): a model made inactive gets a fern
description (mapping/model_matching); a new mask component that matches
one reactivates that model instead of spawning, in either schedule.

The object models split over devices (``mesh=ModelMesh(devices)``,
parallel.multimodel; engine.py:136-155, 899-907, 1010-1012, 1049-1055 of
the JAX package).  The JAX engine puts a GSPMD sharding constraint on the
stacked object axis of its pipelined tracking and fuse graphs; one process
drives every device.  The port keeps that single controller and places the
work: `_shard_model_axis` splits the padded object slots into contiguous
blocks, one a device of the mesh's models axis (none where the count does
not tile the axis, as GSPMD's no-op), and `pipelined_device_stage` and
`fuse_stage` run each block's solve, id projection and fuse on its device.
The blocks' states stay on their devices between frames and move when the
plan changes; each frame's inputs are copied to each device once; the
global model, the hostvec and the id image stay on the engine's device.
The synchronous frame tracks on the engine's device (its fuse splits).

The JAX package jits each stage, donates the map buffers and prewarms its
compile cache (`prewarm_next_buckets`, `_note_prewarm`).  PyTorch runs
eagerly: the map's buffers are updated in place instead of donated, and
nothing is compiled ahead.  On a card two chains replay CUDA graphs
(tracking/graphs), one for each shape of their inputs, captured the first
time it is met: the tracking solves (`track`, `track_objects`,
`track_objects_win`: the model pyramids and the Gauss-Newton solve;
`track_graph_captures`, `track_graph_replays`, the counter
``track_graph`` in the span log) and each model's fuse, clean and predict
(`_fuse`: from the bucket's prefix through the quarter-resolution render
and `combined_predict` to the new predictions, the global model's fill-in
and the gate's selections; `fuse_graph_captures`, `fuse_graph_replays`,
the counter ``fuse_graph``).  The frame values a fuse reads (the time, the
mask id, the thresholds, a window's principal point) enter its graph as
device values filled on each replay; the map prefix is copied into the
graph's buffers and the cleaned prefix back, so the object slots of one
bucket share one graph.  A window's crops of the frame and the paste of
its prediction, whose offsets are host numbers, stay eager.  On the CPU
everything runs eagerly.

Pose conventions (as the reference): every model's `pose` is the camera
pose in that model's frame; model 0's is camera->world, and an object's
object->world pose is global_pose @ inverse(object_pose).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import time as _time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from maskfusion_tpu_torch import cpp as native
from maskfusion_tpu_torch import default_device, se3
from maskfusion_tpu_torch.camera import CameraIntrinsics, Resolution
from maskfusion_tpu_torch.config import Config
from maskfusion_tpu_torch.frame import FrameData
from maskfusion_tpu_torch.mapping import surfel_map as sm
from maskfusion_tpu_torch.ops import clean as clean_ops
from maskfusion_tpu_torch.ops import fill_in as fill_ops
from maskfusion_tpu_torch.ops import fuse as fuse_ops
from maskfusion_tpu_torch.ops import kernels
from maskfusion_tpu_torch.ops import preprocess as pp
from maskfusion_tpu_torch.ops import reduce as red
from maskfusion_tpu_torch.ops import splat as splat_ops
from maskfusion_tpu_torch.parallel import multimodel
from maskfusion_tpu_torch.segmentation import create_segmenter
from maskfusion_tpu_torch.segmentation.mf_segmentation import ModelInfo
from maskfusion_tpu_torch.tracking import graphs
from maskfusion_tpu_torch.tracking import odometry as odo
from maskfusion_tpu_torch.utils.stopwatch import (Stopwatch, count, span,
                                                  span_since)
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


def _halo_crop(a: torch.Tensor, oy: int, ox: int, size: int, halo: int,
               fill: float) -> torch.Tensor:
    """The (size, size) crop of an (H, W, C) image starting at
    (oy - halo, ox - halo), `fill` where it reaches past the image: the
    crop of the image padded by `halo` on every side, without padding the
    whole image."""
    H, W = a.shape[:2]
    out = torch.full((size, size) + a.shape[2:], fill, dtype=a.dtype,
                     device=a.device)
    y0, x0 = oy - halo, ox - halo
    ys, ye = max(0, y0), min(H, y0 + size)
    xs, xe = max(0, x0), min(W, x0 + size)
    out[ys - y0:ye - y0, xs - x0:xe - x0] = a[ys:ye, xs:xe]
    return out


def _moved(x, dev: torch.device):
    """`x` -- a tensor, or a (named) tuple, list or dict of them -- on
    `dev`: each tensor copied there, or itself where it already is.  A
    copy to a card does not wait for the host; one to the CPU does, since
    the host reads it at once."""
    if isinstance(x, torch.Tensor):
        return x.to(dev, non_blocking=dev.type == "cuda")
    if isinstance(x, dict):
        return {k: _moved(v, dev) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_moved(v, dev) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_moved(v, dev) for v in x)
    return x


def _on_device(dev: torch.device):
    """The context that work for `dev` runs in: a card made current, since
    the hand-written kernels launch on the current card."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _gated(gate: Optional[torch.Tensor], new: tuple, state) -> tuple:
    """The predictions (vmap, nmap, rgb) `new` where the device bool `gate`
    holds, the state's previous ones where it does not (a frame whose
    tracking failed keeps its predictions, engine.py:585-590 of the JAX
    package); `new` itself without a gate."""
    if gate is None:
        return new
    return tuple(torch.where(gate, a, b) for a, b in zip(
        new, (state.pred_vmap, state.pred_nmap, state.pred_rgb)))


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
    prev_pose: Optional[torch.Tensor] = None   # pose before this frame's
                                               # track (a host array when
                                               # unpacked from a hostvec)
    pose_log: List = dataclasses.field(default_factory=list)
    last_bucket: int = 0      # shrink-hysteresis input for choose_bucket
    count_est: int = -1       # last fetched surfel count (-1: unknown);
                              # the pipelined schedules size buckets from
                              # it without fetching
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


def _flat(pyr: odo.FramePyramids) -> tuple:
    """A frame's pyramids as one tuple of tensors, field by field."""
    return tuple(a for field in pyr for a in field)


def _frame_pyramids(flat, levels: int) -> odo.FramePyramids:
    """The inverse of `_flat`."""
    return odo.FramePyramids(*(tuple(flat[i:i + levels])
                               for i in range(0, len(flat), levels)))


def _window_size(cfg: Config, H: int, W: int) -> int:
    """The JAX package's static object-window size (0: windowing off),
    engine.py:663-667."""
    ow = int(cfg.object_window)
    return 0 if ow <= 0 or ow > min(H, W) or ow % 8 else ow


class MaskFusion:
    """Host-side engine with the public surface of the JAX package's
    MaskFusion, for the -static and the multi-object frame."""

    def __init__(self, resolution: Resolution, intr: CameraIntrinsics,
                 config: Optional[Config] = None, device=None,
                 mesh: Optional[multimodel.ModelMesh] = None,
                 model_axis: str = "models"):
        self.res = resolution
        self.intr = intr
        self.cfg = config or Config()
        H, W = resolution.height, resolution.width
        self.device = torch.device(device) if device is not None \
            else default_device()
        # the object models split over the devices of a models mesh
        # (parallel.multimodel; engine.py:146-153 of the JAX package): the
        # pipelined device stage and the fuse stage run each block of
        # object slots on its device; None keeps every model here
        self._model_mesh = mesh
        self._model_axis = model_axis
        # (Preprocessed, its copy) by device: a frame's inputs copied once
        # to each device of the plan
        self._frame_copies: Dict = {}
        self._tuning = get_tuning(self.device)
        self.DIAG_INTERVAL = self._tuning.diag_interval
        self.tick = 0
        self.models: List[Model] = []          # [0] = global model
        self.inactive_models: List[Model] = []
        self.next_id = 1
        self.spawn_offset = self.cfg.model_spawn_offset
        self.last_segmentation: Optional[np.ndarray] = None
        # relocalisation: the fern database and the tracking-loss
        # bookkeeping (engine.py:165, 186-197 of the JAX package)
        self.lost = False
        self.last_frame_recovery = False
        self.bad_tracking_streak = 0
        self.ferns = None
        if self.cfg.relocalisation or self.cfg.close_loops:
            from maskfusion_tpu_torch.reloc.ferns import Ferns

            self.ferns = Ferns(
                self.cfg.num_ferns, resolution, intr,
                max_depth=self.cfg.depth_cutoff,
                photo_thresh=self.cfg.photometric_thresh,
                factor=1 << self.cfg.fern_pyramid_level, device=self.device)
        self._matcher = None      # redetection's FernModelMatcher, made
                                  # when a model first goes inactive
        self.new_model_listeners: List[Callable] = []
        self.inactive_model_listeners: List[Callable] = []
        # (expiry tick, model id, spawn mask): phantom re-spawn claims, see
        # _segment_and_update_models
        self._recent_spawns: List = []
        # the pipelined schedules: frames whose host stage is pending, the
        # finished frame's global pose while its host stage runs, and the
        # newest segmentation on the device as (tick, tensor)
        self._pending: collections.deque = collections.deque()
        self._pipelined_active = False
        self._np_glob_pose: Optional[np.ndarray] = None
        self._seg_dev = None
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
                                              resolution, intr, self.device)
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
        # frames whose object models fused in their windows (in the
        # pipelined schedules: also tracked and projected in them)
        self.windowed_fuses = 0
        # host stages that had to wait for their frame's device results
        # (the pipelined schedules' only synchronise: a forced drain, or a
        # drain asked for)
        self.forced_waits = 0
        # the tracking solves' CUDA graphs (tracking/graphs), the graphed
        # calls (each replays a graph, a capturing one too) and those that
        # captured one
        self._track_graphs = graphs.SolveGraphs()
        self.track_graph_replays = 0
        self.track_graph_captures = 0
        # each model's fuse, clean and predict as CUDA graphs, in the
        # tracks' memory pool (one a card); the graphed calls and those
        # that captured a graph
        self._fuse_graphs = graphs.SolveGraphs(share=self._track_graphs)
        self.fuse_graph_replays = 0
        self.fuse_graph_captures = 0
        # the bilateral's metric footprint stays constant across
        # resolutions: pixel radius and spatial sigma scale with width
        bl_scale = W / 640.0
        self._bl_radius = max(1, int(round(self.cfg.bilateral_radius
                                           * bl_scale)))
        self._bl_sigma_space = 0.024691358 / (bl_scale * bl_scale)

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
        L = self.cfg.num_pyr_levels

        def solve(pose, pv, pn, pc, so3, warm, mask_id, *frame):
            res = self._solve(pose, self._model_pyramids(pose, pv, pn, pc),
                              so3, mask_id, _frame_pyramids(frame, L),
                              is_object, warm, self.intr)
            return (se3.make_pose(res.R, res.t), res.delta, res.icp_error,
                    res.icp_count, res.rgb_error, res.rgb_count,
                    torch.diagonal(odo.covariance(res.A)))

        return TrackResult(*self._graphed(
            "track", is_object, solve,
            (state.pose, state.pred_vmap, state.pred_nmap, state.pred_rgb,
             state.so3_intensity, warm, int(mask_id)) + _flat(prep.frame_pyr),
            slots=1))

    def track_objects(self, states: List[MapState], mask_ids,
                      prep: Preprocessed,
                      warm: Optional[torch.Tensor] = None):
        """Every object model in ONE solve over a leading slot axis
        (engine.py:318-356 of the JAX package, a jax.vmap over objects; the
        reference tracks them in turn, MaskFusion.cpp:246-278).  Each slot
        has its own pose, model pyramids, SO(3) intensity and mask id (a
        host list, or an (N,) device tensor); all share the frame
        pyramids.  Returns the new poses (N, 4, 4) and each slot's
        translation jump (N,), on the device."""
        pose, pv, pn, pc, so3 = (torch.stack([getattr(s, f) for s in states])
                                 for f in ("pose", "pred_vmap", "pred_nmap",
                                           "pred_rgb", "so3_intensity"))
        if not isinstance(mask_ids, torch.Tensor):
            mask_ids = self._upload(np.asarray(mask_ids, np.int32))
        L = self.cfg.num_pyr_levels

        def solve(pose, pv, pn, pc, so3, mask_ids, warm, *frame):
            res = self._solve(pose, self._model_pyramids(pose, pv, pn, pc),
                              so3, mask_ids, _frame_pyramids(frame, L), True,
                              warm, self.intr)
            return (se3.make_pose(res.R, res.t),
                    torch.linalg.vector_norm(res.delta[:, :3, 3], dim=-1))

        return tuple(self._graphed(
            "track_objects", True, solve,
            (pose, pv, pn, pc, so3, mask_ids, warm) + _flat(prep.frame_pyr),
            slots=len(states)))

    def track_objects_win(self, states: List[MapState],
                          mask_ids: torch.Tensor, windows,
                          origins: torch.Tensor, prep: Preprocessed,
                          warm: Optional[torch.Tensor] = None):
        """Windowed object tracking (track_objects_win, engine.py:358-470
        of the JAX package): the one solve of `track_objects`, each slot on
        its (OW, OW) window of both pyramid sides.  `windows` holds each
        slot's host (oy, ox); `origins` the same as an (N, 2) float32
        device tensor, from which each slot's shifted principal point
        (cx - ox, cy - oy) is computed in float32 on the device.  Every
        frame level is cropped at (oy >> lv, ox >> lv); the model side is
        built on a crop with a 32-pixel halo (NaN vertices and normals,
        black colour) and trimmed per level, its photometric erosion
        computed on the halo image before the trim; the SO(3) intensity is
        cropped at the coarsest level.  Model pixels projecting out of the
        window drop out of the solve (the JAX package's documented
        deviation from the full-frame reference path).  The crops, whose
        offsets are host numbers, run before the (graphed) solve."""
        cfg = self.cfg
        OW = self._obj_window
        L = cfg.num_pyr_levels
        P = 32

        def crop(a, lv):
            n = OW >> lv
            return torch.stack([a[oy >> lv:(oy >> lv) + n,
                                  ox >> lv:(ox >> lv) + n]
                                for oy, ox in windows])

        frame = odo.FramePyramids(*(tuple(crop(a, lv)
                                          for lv, a in enumerate(f))
                                    for f in prep.frame_pyr))

        def halo(field: str, fill: float):
            return torch.stack([_halo_crop(getattr(st, field), oy, ox,
                                           OW + 2 * P, P, fill)
                                for st, (oy, ox) in zip(states, windows)])

        pose = torch.stack([st.pose for st in states])
        so3 = torch.stack([st.so3_intensity for st in states])
        lc = L - 1
        so3 = torch.stack([so3[k, oy >> lc:(oy >> lc) + (OW >> lc),
                               ox >> lc:(ox >> lc) + (OW >> lc)]
                           for k, (oy, ox) in enumerate(windows)])

        def trim(a, lv):
            p, n = P >> lv, OW >> lv
            return a[:, p:p + n, p:p + n]

        def solve(pose, pv, pn, pc, so3, mask_ids, origins, warm, *frame):
            padded = self._model_pyramids(pose, pv, pn, pc)
            model = odo.ModelPyramids(
                *(tuple(trim(a, lv) for lv, a in enumerate(f))
                  for f in padded[:4]),
                last_valids=tuple(trim(red.rgb_last_valid(g), lv)
                                  for lv, g in enumerate(padded.intensities)))
            i = self.intr
            intr = CameraIntrinsics(i.fx, i.fy, i.cx - origins[:, 1:2],
                                    i.cy - origins[:, 0:1])
            res = self._solve(pose, model, so3, mask_ids,
                              _frame_pyramids(frame, L), True, warm, intr)
            return (se3.make_pose(res.R, res.t),
                    torch.linalg.vector_norm(res.delta[:, :3, 3], dim=-1))

        return tuple(self._graphed(
            "track_objects_win", True, solve,
            (pose, halo("pred_vmap", float("nan")),
             halo("pred_nmap", float("nan")), halo("pred_rgb", 0.0), so3,
             mask_ids, origins, warm) + _flat(frame),
            slots=len(states)))

    def _graphed(self, path: str, is_object: bool, fn, inputs: tuple,
                 slots: int):
        """`fn(*inputs)`, the tracking solve of `path`: run as it is for
        tensors on the CPU; on a card, the replay of its CUDA graph
        (tracking/graphs), captured at the first call of its key
        (`_graph_key`).  Counts the calls (`track_graph_replays`) and the
        captures, and records each call as the counter ``track_graph``
        (`captured`, `slots`) while a profiler runs."""
        dev = inputs[0].device
        if dev.type != "cuda":
            return fn(*inputs)

        def keep():
            # the levels' K and K^-1, cached by odometry, live as long as
            # the graph that reads them
            return tuple(odo._k_matrices(self.intr, lv, dev)
                         for lv in range(self.cfg.num_pyr_levels))

        with torch.cuda.device(dev):
            out, captured = self._track_graphs.run(
                self._graph_key(path, is_object, inputs), fn, inputs, keep)
        self.track_graph_replays += 1
        self.track_graph_captures += int(captured)
        count("track_graph", captured=int(captured), slots=slots)
        return out

    def _graph_key(self, path: str, is_object: bool, inputs: tuple
                   ) -> tuple:
        """The key of a graph of the solve of `path`: what it bakes in
        (the path, whether an object tracks, the intrinsics, the window,
        the pyramid, every option of the solve) and its inputs'
        signatures (shapes and dtypes; a host int, a mask id, by its
        type alone: it enters the graph as a device value)."""
        opts = self._solve_options(is_object)
        return graphs.graph_key(
            (path, is_object, self.intr, self._obj_window,
             self.cfg.num_pyr_levels, self.cfg.max_depth_rgb,
             tuple((k, tuple(v) if isinstance(v, list) else v)
                   for k, v in sorted(opts.items()))), inputs)

    def _model_pyramids(self, pose, pred_vmap, pred_nmap, pred_rgb):
        return odo.build_model_pyramids(
            pred_vmap, pred_nmap, pred_rgb, pose, self.cfg.num_pyr_levels,
            self.cfg.max_depth_rgb)

    def _solve_options(self, is_object: bool) -> dict:
        """The options of a model's tracking solve, from the Config."""
        cfg = self.cfg
        return dict(
            rgb_only=cfg.rgb_only,
            icp_weight=(cfg.object_icp_weight if is_object
                        else cfg.icp_weight),
            gn_damping=(cfg.object_gn_damping if is_object else 0.0),
            rgb_finest_only=(is_object and cfg.object_rgb_finest_only),
            pyramid=cfg.pyramid, fast_odom=cfg.fast_odom,
            use_so3=cfg.use_so3,
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

    def _solve(self, pose, model_pyr: odo.ModelPyramids, so3_intensity,
               mask_id, frame_pyr: odo.FramePyramids, is_object: bool,
               warm: Optional[torch.Tensor],
               intr: CameraIntrinsics) -> odo.OdometryResult:
        """The tracking solve of one model, or of N models stacked on a
        leading slot axis (an (N,) tensor of mask ids)."""
        pose0 = pose if warm is None else pose @ warm
        so3_pyr = [None] * (self.cfg.num_pyr_levels - 1) + [so3_intensity]
        return odo.get_incremental_transformation(
            pose0[..., :3, 3], pose0[..., :3, :3], frame_pyr, model_pyr,
            tuple(so3_pyr), intr, mask_id=mask_id,
            **self._solve_options(is_object))

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the device without waiting for the device's
        queue."""
        return self._send(torch.from_numpy(np.ascontiguousarray(a)))

    def _send(self, t: torch.Tensor) -> torch.Tensor:
        """A host tensor on the device: a pinned copy, sent non-blocking
        (a copy from pageable memory would wait for the device)."""
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

    def _fuse_unit(self, parity: Optional[int], compact: bool,
                   fill_in: bool, pos, conf, color, init_time, last_seen,
                   normal, radius, count, pose, last_delta, prev_pose,
                   vmap_raw, vmap0, nmap0, filt, rgb, seg_mask, ids_guard,
                   gate, old_vmap, old_nmap, old_rgb, time, mask_id,
                   conf_threshold, max_depth, weight_multiplier, cx, cy):
        """Render, fuse, patch the index map, clean and predict one model:
        the unit that `_fuse` runs eagerly or replays as a CUDA graph.  The
        map prefix comes as its fields; the images (vmap_raw ... seg_mask)
        are the full frame, or an object's window seen through its shifted
        principal point (cx, cy).  The frame values (time ... cy) are host
        numbers or, in a graph, 0-d device tensors filled on each replay.
        `ids_guard`, the prefused schedule's id projection, first sets 255
        (semantic-ignore) where the lagging segmentation and the projection
        both claim a model and not the same one.  `gate`, a device bool
        (the prefused schedule's tracking-ok), selects the cleaned prefix
        against the one that came in and zeroes the counts where it is
        false, and selects the predictions against (old_vmap, old_nmap,
        old_rgb) where those are given.  Returns the cleaned prefix (not
        yet written back), the predictions (filled in with `fill_in`), the
        removed and appended counts and the new last_delta."""
        cfg = self.cfg
        H, W = filt.shape
        intr = CameraIntrinsics(self.intr.fx, self.intr.fy, cx, cy)
        if ids_guard is not None:
            seg_mask = torch.where((seg_mask == ids_guard) | (ids_guard == 0),
                                   seg_mask, 255).to(torch.uint8)
        time_delta = cfg.effective_time_delta()
        pose_inv = se3.pose_inverse(pose)
        if cfg.velocity_fusion_weight:
            weighting = fuse_ops.compute_fusion_weight(last_delta,
                                                       weight_multiplier)
        else:
            weighting = weight_multiplier
        work = sm.SurfelMap(pos, conf, color, init_time, last_seen, normal,
                            radius, count)
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
                                          vmap0.device) * weighting
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
        removed = cres.removed
        cres_map = cres.map
        if gate is not None:
            # fuse and clean leave `work` untouched: it is the prefix that
            # went in
            cres_map = sm.SurfelMap(*(torch.where(gate, a, b)
                                      for a, b in zip(cres.map, work)))
            removed = torch.where(gate, removed, 0)
            appended = torch.where(gate, appended, 0)
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
        if fill_in:
            filled = fill_ops.fill_in(pred, rgb, vmap0, nmap0)
            preds = (filled.vmap, filled.nmap, filled.rgb)
            if cfg.frame_to_frame_rgb:
                preds = preds[:2] + (rgb.to(torch.float32),)
        else:
            preds = (pred.vmap, pred.nmap, pred.rgb)
        if old_vmap is not None:
            preds = tuple(torch.where(gate, a, b) for a, b in zip(
                preds, (old_vmap, old_nmap, old_rgb)))
        return cres_map, preds, removed, appended, pose_inv @ prev_pose

    def _fuse(self, path: str, state: MapState, bucket: int, prev_pose,
              images: tuple, ids_guard, gate, old_preds: tuple, time,
              mask_id, conf_threshold, max_depth, weight_multiplier, cx, cy,
              parity: Optional[int], compact: bool, fill_in: bool):
        """One model's fuse, clean and predict (`_fuse_unit`) on its bucket
        of state.map.  Updates the map's tensors in place (the prefix
        write-back) and returns (the map, the predictions, the removed and
        appended counts, the new last_delta).  On a card, where the bucket
        is a prefix of the map, the replay of the unit's CUDA graph
        (`_fuse_graphed`); on the CPU, or where the bucket is the whole map
        (whose tensors are never copied whole), eagerly."""
        full = state.map
        work = sm.prefix_view(full, bucket)
        inputs = (*work[:7], work.count, state.pose, state.last_delta,
                  prev_pose, *images, ids_guard, gate, *old_preds,
                  float(time), int(mask_id), float(conf_threshold),
                  float(max_depth), float(weight_multiplier), float(cx),
                  float(cy))
        unit = functools.partial(self._fuse_unit, parity, compact, fill_in)
        if not self._replays(full, bucket):
            cres, preds, removed, appended, last_delta = unit(*inputs)
            return (sm.write_back(full, cres), preds, removed, appended,
                    last_delta)

        def fn(*args):
            cres, preds, removed, appended, last_delta = unit(*args)
            for dst, src in zip(args, cres[:7]):      # the write-back
                dst.copy_(src)
            return (cres.count, *preds, removed, appended, last_delta)

        new_count, pv, pn, pc, removed, appended, last_delta = \
            self._fuse_graphed(path, (parity, compact, fill_in), fn, inputs)
        return (full._replace(count=new_count), (pv, pn, pc), removed,
                appended, last_delta)

    @staticmethod
    def _replays(m: sm.SurfelMap, bucket: int) -> bool:
        """Whether a fuse over `bucket` of map `m` replays a CUDA graph: on
        a card, where the bucket is a prefix of the map."""
        return m.pos.device.type == "cuda" and bucket < m.capacity

    def _fuse_graphed(self, path: str, static: tuple, fn, inputs: tuple):
        """`fn(*inputs)`, a model's fuse on a card, as the replay of its
        CUDA graph (tracking/graphs), captured at the first call of its
        key (`_fuse_graph_key`); `fn` writes the cleaned prefix into the
        map prefix's fields (inputs 0-6), and so does the call.  Counts the
        calls (`fuse_graph_replays`) and the captures, and records each
        call as the counter ``fuse_graph`` (`captured`, `path`, `slots`:
        the models the replay fuses) while a profiler runs."""
        dev = inputs[0].device
        H, W = inputs[14].shape          # the filtered depth

        def keep():
            # the scan's live-tap weights, cached by the kernels' module
            return kernels.scan_constants(H, W, dev)

        with _on_device(dev):
            out, captured = self._fuse_graphs.run(
                self._fuse_graph_key(static, inputs), fn, inputs, keep,
                inout=range(7))
        self.fuse_graph_replays += 1
        self.fuse_graph_captures += int(captured)
        count("fuse_graph", captured=int(captured), path=path, slots=1)
        return out

    def _fuse_graph_key(self, static: tuple, inputs: tuple) -> tuple:
        """The key of a fuse graph: what it bakes in (the parity, the
        compaction, the fill-in, the intrinsics, every option of the
        passes) and its inputs' signatures: the bucket by the prefix's
        shapes, the frame or window size, whether a gate, an id guard and
        the predictions to gate against are there; a frame value (the
        time, the mask id, the thresholds, the principal point) by its
        type alone: it enters the graph as a device value."""
        cfg = self.cfg
        return graphs.graph_key(
            ("fuse",) + static + (
                self.intr, cfg.effective_time_delta(), cfg.depth_cutoff,
                cfg.fuse_subsample_checkerboard, cfg.surfel_merge_z_thresh,
                cfg.incremental_im2, cfg.velocity_fusion_weight,
                cfg.outlier_coefficient, cfg.unstable_time_limit,
                cfg.frame_to_frame_rgb), inputs)

    def fuse_clean_predict(self, state: MapState, prep: Preprocessed, rgb,
                           seg_mask, prev_pose, time: float, mask_id: int,
                           conf_threshold: float, max_depth: float,
                           weight_multiplier: float, allow_fill_in: bool,
                           bucket: int, parity: Optional[int] = None,
                           compact: bool = True,
                           gate: Optional[torch.Tensor] = None,
                           ids_guard: Optional[torch.Tensor] = None):
        """engine.py:472-598 of the JAX package.  Updates state.map's
        tensors in place (prefix write-back).  Where the device bool `gate`
        is false, the map, the predictions and the counts stay as they came
        in (last_delta is not gated, as in the JAX package).  `ids_guard`
        as in fuse_stage."""
        lv0 = prep.levels[0]
        old = ((state.pred_vmap, state.pred_nmap, state.pred_rgb)
               if gate is not None else (None,) * 3)
        final_map, (pv, pn, pc), removed, appended, last_delta = self._fuse(
            "global" if allow_fill_in else "object", state, bucket,
            prev_pose, (prep.vmap_raw, lv0["vmap"], lv0["nmap"],
                        prep.filt_depth, rgb, seg_mask),
            ids_guard, gate, old, time, mask_id, conf_threshold, max_depth,
            weight_multiplier, self.intr.cx, self.intr.cy, parity, compact,
            allow_fill_in)
        new_state = MapState(
            map=final_map, pose=state.pose, last_delta=last_delta,
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
                                   parity: Optional[int],
                                   gate: Optional[torch.Tensor] = None,
                                   ids_guard: Optional[torch.Tensor] = None
                                   ) -> MapState:
        """An object's fuse + clean + predict on its (OW, OW) window at
        (oy, ox) (engine.py:678-775 of the JAX package): every image-side
        pass runs on the crop with the shifted principal point; the window
        holds the object's mask and margin, so everything inside it sees
        the full-frame pass's pixels.  The prediction is pasted into a NaN
        canvas (zeros for rgb); objects never fill in.  `gate` and
        `ids_guard` as in fuse_clean_predict.  The crops and the paste,
        whose offsets are host numbers, run eagerly around the unit."""
        H, W = self.res.height, self.res.width
        OW = self._obj_window
        win = (slice(oy, oy + OW), slice(ox, ox + OW))
        lv0 = prep.levels[0]
        shifted = self._intr_shift(oy, ox)
        final_map, pred, _removed, _appended, last_delta = self._fuse(
            "window", state, bucket, prev_pose,
            (prep.vmap_raw[win], lv0["vmap"][win], lv0["nmap"][win],
             prep.filt_depth[win], rgb[win], seg_mask[win]),
            None if ids_guard is None else ids_guard[win], gate,
            (None,) * 3, time, mask_id, conf_threshold, max_depth,
            weight_multiplier, shifted.cx, shifted.cy, parity, True, False)
        dev = state.pose.device
        pv = torch.full((H, W, 3), float("nan"), device=dev)
        pn = torch.full((H, W, 3), float("nan"), device=dev)
        pc = torch.zeros((H, W, 3), device=dev)
        pv[win], pn[win], pc[win] = pred
        pv, pn, pc = _gated(gate, (pv, pn, pc), state)
        return MapState(
            map=final_map, pose=state.pose, last_delta=last_delta,
            pred_vmap=pv, pred_nmap=pn, pred_rgb=pc,
            so3_intensity=prep.frame_pyr.intensities[-1])

    def fuse_stage(self, glob_state: MapState, obj_states, prep: Preprocessed,
                   rgb, seg_mask, prev_poses: torch.Tensor, time: float,
                   obj_params: np.ndarray, glob_bucket: int, obj_bucket: int,
                   parity: Optional[int], windowed: bool = False,
                   gate: Optional[torch.Tensor] = None,
                   ids_guard: Optional[torch.Tensor] = None):
        """Every model's fuse + clean + predict (pipelined_fuse_stage,
        engine.py:957-1041 of the JAX package).  The global model first
        (fill-in, compaction), then each object slot, in its window when
        `windowed`.  `prev_poses` stacks the pre-track poses (row 0 global,
        then one a slot); `obj_params` holds one host row a slot,
        [mask_id, conf_t, max_depth, weight_mult, oy, ox].  A dead slot
        (mask id DEAD_SLOT_ID) would fuse no pixel, so it is skipped and
        comes back as it went in.  The prefused schedule passes `gate`, the
        same frame's device-side tracking-ok (a false gate selects every
        model's update away), and `ids_guard`, the same frame's id
        projection: a pixel where the lagging segmentation and the
        projection both claim a model, and not the same one, becomes 255
        (semantic-ignore: no model fuses it, no clean penalty fires); where
        the projection shows nothing the segmentation's label stays, so
        disocclusions fuse into the global map and a newborn object can
        bootstrap.  On a card each model's pass replays a CUDA graph
        (`_fuse`); slots of one bucket share one.  With a models mesh each
        block of the plan over the slots fuses its live slots on its
        device, from one copy a frame of the inputs there (engine.py:
        1010-1012 of the JAX package); the global model stays on the
        engine's device.  Returns (global state, object states)."""
        with span("fuse_global"):
            new_glob, _removed, _app = self.fuse_clean_predict(
                glob_state, prep, rgb, seg_mask, prev_poses[0], time, 0,
                self.cfg.conf_threshold_global, self.cfg.depth_cutoff,
                self.cfg.weight_multiplier, True, glob_bucket, parity, True,
                gate, ids_guard)
        new_objs = list(obj_states)
        for dev, a, b in self._slot_blocks(len(obj_states)):
            live = [k for k in range(a, b)
                    if int(obj_params[k][0]) != DEAD_SLOT_ID]
            if not live:
                continue
            with _on_device(dev), span("fuse_objects"):
                prep_d = self._frame_on(prep, dev)
                rgb_d, seg_d, prev_d, gate_d, guard_d = _moved(
                    (rgb, seg_mask, prev_poses, gate, ids_guard), dev)
                for k in live:
                    new_objs[k] = self._fuse_slot(
                        self._state_on(obj_states[k], dev), prep_d, rgb_d,
                        seg_d, prev_d[k + 1], time, obj_params[k],
                        obj_bucket, parity, windowed, gate_d, guard_d)
        return new_glob, tuple(new_objs)

    def _fuse_slot(self, state: MapState, prep: Preprocessed, rgb, seg_mask,
                   prev_pose, time: float, row, obj_bucket: int,
                   parity: Optional[int], windowed: bool,
                   gate: Optional[torch.Tensor],
                   ids_guard: Optional[torch.Tensor]) -> MapState:
        """One live object slot's fuse + clean + predict: in its window
        when `windowed`, else on the full frame without fill-in; `row` its
        host [mask_id, conf_t, max_depth, weight_mult, oy, ox]."""
        mid, conf_t, max_d, wm, oy, ox = row.tolist()
        if windowed:
            return self.fuse_clean_predict_obj_win(
                state, prep, rgb, seg_mask, prev_pose, time, int(mid),
                conf_t, max_d, wm, int(oy), int(ox), obj_bucket, parity,
                gate, ids_guard)
        return self.fuse_clean_predict(
            state, prep, rgb, seg_mask, prev_pose, time, int(mid), conf_t,
            max_d, wm, False, obj_bucket, parity, True, gate, ids_guard)[0]

    # ------------------------------------------------- the models mesh
    def _shard_model_axis(self, n: int):
        """The block plan of n stacked object slots over the models mesh,
        or None (engine.py:1049-1055 of the JAX package, which delegates
        likewise to parallel.multimodel)."""
        return multimodel.shard_model_axis(self._model_mesh,
                                           self._model_axis, n)

    def _slot_blocks(self, n: int):
        """(device, start, stop) of each block of the plan of n slots; one
        block on the engine's device without a plan."""
        plan = self._shard_model_axis(n)
        if plan is None:
            return [(self.device, 0, n)]
        return [(blk.device, blk.start, blk.stop) for blk in plan]

    def _state_on(self, state: MapState, dev: torch.device) -> MapState:
        """A slot's state on its block's device (itself without a mesh, or
        where it already is)."""
        if self._model_mesh is None:
            return state
        return _moved(state, dev)

    def _frame_on(self, prep: Preprocessed, dev: torch.device
                  ) -> Preprocessed:
        """The frame's preprocessed images on `dev`, copied once a frame:
        the device stage's copy serves the same frame's fuse."""
        if self._model_mesh is None:
            return prep
        held = self._frame_copies.get(dev)
        if held is None or held[0] is not prep:
            held = (prep, _moved(prep, dev))
            self._frame_copies[dev] = held
        return held[1]

    def _place_objects(self, objs: List[Model], n_slots: int = 0) -> None:
        """Each object's state on its slot's device in the plan of
        n_slots (none: the engine's device).  A state moves only where it
        is elsewhere: between frames of one plan nothing moves, and a
        spawn, a deactivation or a count that no longer tiles the mesh
        moves the states once.  The synchronous frame and the lagfuse
        fallback track every object on the engine's device."""
        if self._model_mesh is None:
            return
        blocks = self._slot_blocks(n_slots)
        for k, m in enumerate(objs):
            dev = next((d for d, a, b in blocks if a <= k < b), self.device)
            m.state = _moved(m.state, dev)

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
        prep = self.preprocess(rgb, depth, self._zero_mask)
        tr = self.track(state, prep, 0)
        prev_pose = state.pose
        state = state._replace(pose=tr.pose)
        new_state, removed, appended = self.fuse_clean_predict(
            state, prep, rgb, self._zero_mask, prev_pose, time, 0,
            cfg.conf_threshold_global, cfg.depth_cutoff,
            cfg.weight_multiplier, True, bucket, parity, compact)
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

    def project_ids_obj_win(self, m: sm.SurfelMap, pose: torch.Tensor,
                            time: float, max_depth: float, bucket: int,
                            oy: int, ox: int) -> torch.Tensor:
        """A windowed object's depth in the (depth, id) projection
        (engine.py:777-788 of the JAX package): render at confidence 12 and
        predict, without the coarse pass, on its (OW, OW) window with the
        shifted principal point, pasted into a +inf canvas."""
        H, W = self.res.height, self.res.width
        OW = self._obj_window
        intr = self._intr_shift(oy, ox)
        im = splat_ops.render_index_map(
            sm.prefix_view(m, bucket), se3.pose_inverse(pose), intr, OW, OW,
            time, self.cfg.effective_time_delta(), max_depth,
            conf_threshold=12.0)
        pred = splat_ops.combined_predict(im, intr, max_depth)
        out = torch.full((H, W), float("inf"), device=pose.device)
        out[oy:oy + OW, ox:ox + OW] = torch.where(pred.depth > 0, pred.depth,
                                                  float("inf"))
        return out

    def project_ids_obj_win_batched(self, maps: List[sm.SurfelMap],
                                    poses, time: float, max_depth: float,
                                    bucket: int, windows) -> list:
        """The windowed objects' projections with one shared bucket, one
        model after another (the JAX package's device stage projects each
        slot in turn, engine.py:930-936); `windows` holds each model's host
        (oy, ox)."""
        return [self.project_ids_obj_win(m, p, time, max_depth, bucket,
                                         oy, ox)
                for m, p, (oy, ox) in zip(maps, poses, windows)]

    def pipelined_device_stage(self, glob_state: MapState, obj_states,
                               obj_aux: np.ndarray, rgb, depth, prev_seg,
                               time: float, glob_bucket: int,
                               obj_bucket: int, windowed: bool = False):
        """A pipelined frame's device stage (pipelined_device_stage,
        engine.py:876-955 of the JAX package): preprocess, the global track,
        the objects' warm start and their one solve (in their windows when
        `windowed`), the (depth, id) projection at the new poses and the
        non-edge binary of the edge map.  Nothing here waits on the device.

        `obj_states` are the padded object slots, live models first;
        `obj_aux` one host row a slot, [mask_id, oy, ox] (DEAD_SLOT_ID on a
        dead slot), uploaded once.  A dead slot has an empty map and
        all-invalid predictions: it is neither solved nor projected, and
        keeps its pose with a zero jump (the JAX package solves it and
        selects its lane away).  Returns (prep, global pose, object poses,
        hostvec, ids, nonedge, prev_poses, okf): `hostvec` packs over the
        padded slot axis, as the JAX package packs it, every model's surfel
        count, the global covariance maximum, each slot's jump, the
        pre-track poses and the world poses (object->world = global @
        inverse(object)); `okf` is the device bool cov <= threshold.

        With a models mesh (``mesh=``) each block of the plan over the
        padded slots solves and projects its live slots on its device
        (engine.py:899-907 of the JAX package); the object poses come back
        on their blocks' devices, the depth images, hostvec and the rest on
        the engine's."""
        cfg = self.cfg
        n_slots = len(obj_states)
        n_live = int((obj_aux[:, 0] < DEAD_SLOT_ID).sum())
        live = obj_aux[:n_live]
        # the slot rows and the projection's id vector in one upload
        aux = self._upload(np.concatenate(
            [obj_aux.reshape(-1), [0.0], live[:, 0]]).astype(np.float32))
        rows = aux[:3 * n_slots].reshape(n_slots, 3)[:n_live]
        ids_vec = aux[3 * n_slots:].to(torch.int32)
        prep = self.preprocess(rgb, depth, prev_seg)
        with span("track_global"):
            tr = self.track(glob_state, prep, 0)
        with span("track_objects"):
            warm = (se3.pose_inverse(glob_state.pose) @ tr.pose
                    if cfg.object_warm_start else None)
        cov = tr.cov_diag.max()
        windows = [(int(oy), int(ox)) for _, oy, ox in live]
        cutoff = cfg.depth_cutoff
        depths = [self.project_ids(glob_state.map, tr.pose, time, cutoff,
                                   glob_bucket)]
        poses, norms = [], [torch.zeros((0,), device=self.device)]
        # the live slots of each block of the models mesh (one block
        # without one) solve and project on its device
        for dev, a, b in self._slot_blocks(n_slots):
            b = min(b, n_live)
            if a >= b:
                continue
            with _on_device(dev), span("track_objects"):
                states = [self._state_on(st, dev) for st in obj_states[a:b]]
                prep_d = self._frame_on(prep, dev)
                rows_d, warm_d = _moved((rows[a:b], warm), dev)
                if windowed:
                    p, nrm = self.track_objects_win(
                        states, rows_d[:, 0].to(torch.int32), windows[a:b],
                        rows_d[:, 1:], prep_d, warm_d)
                elif n_live == 1:
                    # one object on the full frame takes the one-model
                    # solve, as in the synchronous schedule (the same
                    # numbers as a one-slot batch up to rounding, which the
                    # object's solve amplifies)
                    trm = self.track(states[0], prep_d, int(live[0, 0]),
                                     is_object=True, warm=warm_d)
                    p = trm.pose[None]
                    nrm = torch.linalg.vector_norm(trm.delta[:3, 3])[None]
                else:
                    p, nrm = self.track_objects(
                        states, rows_d[:, 0].to(torch.int32), prep_d, warm_d)
            with _on_device(dev):
                maps = [st.map for st in states]
                if windowed:
                    d = self.project_ids_obj_win_batched(
                        maps, p, time, cutoff, obj_bucket, windows[a:b])
                else:
                    d = self.project_ids_batched(maps, p, time, cutoff,
                                                 obj_bucket)
            poses += list(p)
            norms.append(nrm)
            depths += d
        new_poses = poses + [st.pose for st in obj_states[n_live:]]
        jumps = torch.cat([_moved(x, self.device) for x in norms]
                          + [torch.zeros((n_slots - n_live,),
                                         device=self.device)])
        depths = [_moved(x, self.device) for x in depths]
        ids = self.combine_ids(depths, ids_vec)
        lv0 = prep.levels[0]
        _edge, nonedge = self.segmenter.edge_binary(lv0["vmap"], lv0["nmap"])
        counts = torch.stack([glob_state.map.count] + [
            _moved(st.map.count, self.device) for st in obj_states])
        prev_poses = torch.stack([glob_state.pose] + [
            _moved(st.pose, self.device) for st in obj_states])
        world_poses = torch.stack(
            [tr.pose] + [tr.pose @ se3.pose_inverse(_moved(p, self.device))
                         for p in new_poses])
        hostvec = torch.cat([counts.to(torch.float32), cov[None], jumps,
                             prev_poses.reshape(-1), world_poses.reshape(-1)])
        okf = cov <= self._cov_thresh
        return (prep, tr.pose, tuple(new_poses), hostvec, ids, nonedge,
                prev_poses, okf)

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
            if self.cfg.enable_redetection or self.cfg.keep_all_models:
                # a kept inactive model can be reactivated: its id stays
                # reserved
                used |= {m.model_id for m in self.inactive_models}
            while True:
                self.next_id = (self.next_id + 1) % 256 or 1
                if self.next_id not in used and self.next_id < DEAD_SLOT_ID:
                    break
        return nxt

    def _model_matcher(self):
        if self._matcher is None:
            from maskfusion_tpu_torch.mapping.model_matching import \
                FernModelMatcher

            self._matcher = FernModelMatcher()
        return self._matcher

    def _redetect(self, frame: FrameData, roi):
        """An inactive model found in `roi` of the frame, or None
        (engine.py:1077-1083 of the JAX package)."""
        return self._model_matcher().detect_in_region(frame, roi,
                                                      self.inactive_models)

    def _inactivate_model(self, model: Model, reason: str) -> None:
        """Smart delete (MaskFusion::inactivateModel, :699-713): a model
        with enough confident surfels is kept as inactive; with
        enable_redetection its prediction is described for the matcher
        (one fetch of the prediction)."""
        keep = self.cfg.keep_all_models or (
            model.surfel_count >= self.cfg.min_surfels_keep
            and model.conf_threshold > self.cfg.min_conf_keep)
        if keep:
            self.inactive_models.append(model)
            if self.cfg.enable_redetection:
                self._model_matcher().build_model_description(model)
        for cb in self.inactive_model_listeners:
            cb(model)
        self.models.remove(model)

    def _bucket_for(self, model: Model) -> int:
        """A model's per-frame processing bucket: pow2 steps, with the
        object floor and headroom for object models (engine.py:1388-1416
        of the JAX package).  The synchronous schedule fetches the count
        from the device; the pipelined ones read `count_est`, the count
        their last finished frame's hostvec brought back, and never wait
        (a bucket a few frames stale is safe: overflowing appends are
        dropped and re-apply on a later frame, and the bucket has
        headroom)."""
        tun = self._tuning
        if model.model_id == 0:
            minimum, headroom = tun.min_bucket_global, tun.headroom_global
        else:
            minimum, headroom = tun.min_bucket_object, tun.headroom_object
        if self._pipelined_active and model.count_est >= 0:
            count = model.count_est
        else:
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
        (engine.py:1566-1585 of the JAX package): one native pass over the
        label image (mfcore's mf_u8_bboxes) covers every model; the per-model
        numpy scan is its plain version."""
        if not self.models[1:] or not self._obj_window:
            return
        lib = native.active()
        if lib is None:
            for model in self.models[1:]:
                model.window = self._object_window(model, seg)
            return
        bb = np.empty((256, 4), np.int32)
        lib.mf_u8_bboxes(np.ascontiguousarray(seg, np.uint8).reshape(-1),
                         seg.shape[0], seg.shape[1], bb.reshape(-1))
        for model in self.models[1:]:
            y0, x0, y1, x1 = bb[model.model_id]
            if y1 < 0:                      # label absent: keep the window
                continue
            model.window = self._window_from_bbox(y0, x0, y1, x1)

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
        ids_vec = self._upload(np.asarray([m.model_id for m in self.models],
                                          np.int32))
        return self.combine_ids(depths, ids_vec)

    def _cf_model_views(self, frame: FrameData) -> List[dict]:
        """Per-model alignment-error + confidence views for the Co-Fusion
        CRF (engine.py:1465-1538 of the JAX package; the reference feeds
        per-model ICP-error/conf textures into its unaries,
        CfSegmentation.cpp:108-228).

        error = max(geometric, photometric) residual of the model's last
        prediction against the live frame, in metres-equivalent units:
          geometric   |predicted z - frame z| (out-of-plane motion);
          photometric |predicted gray - frame gray| / 255 * 0.5 * depth
                      range, both pooled over 8x8 blocks (in-plane motion
                      of textured objects, insensitive to the one-pose-stale
                      prediction's few-pixel shift);
        where the predicted surface lies more than 3 cm in front of the
        frame's depth (the trail a surface leaves as it moves away) and
        where the frame has no depth, the error is 0.  conf = prediction
        coverage (valid predicted depth).  Every model's predicted depth
        and colour come to the host in one fetch: the Co-Fusion frame waits
        for the card here."""
        d = frame.host_depth()
        gray = np.asarray(frame.host_rgb(), np.float32).mean(axis=-1)
        dr = float(np.nanmax(d) - np.nanmin(d[d > 0])) if (d > 0).any() \
            else 1.0
        dr = max(dr, 1e-3)
        B = 8
        H, W = gray.shape
        Hc, Wc = (H // B) * B, (W // B) * B

        def pool(a):
            return a[:Hc, :Wc].reshape(Hc // B, B, Wc // B, B).mean((1, 3))

        def unpool(a):
            out = np.zeros((H, W), a.dtype)
            out[:Hc, :Wc] = np.repeat(np.repeat(a, B, 0), B, 1)
            return out

        gray_p = pool(gray)
        preds = torch.stack([
            torch.cat([m.state.pred_vmap[..., 2:3], m.state.pred_rgb], -1)
            for m in self.models]).cpu().numpy()
        views = []
        for pred in preds:
            pz = pred[..., 0]
            pg = pred[..., 1:].astype(np.float32).mean(axis=-1)
            cov = np.isfinite(pz) & (pz > 0)
            covf = cov.astype(np.float32)
            trail = np.nan_to_num(pz) < (d - 0.03)
            both = cov & (d > 0) & ~trail
            geom = np.where(both, np.abs(np.nan_to_num(pz) - d), 0.0)
            den = pool(covf)
            pg_p = pool(np.nan_to_num(pg) * covf) / np.maximum(den, 1e-6)
            dI = np.where(den > 0.5, np.abs(pg_p - gray_p), 0.0)
            photo = np.where(both, unpool(dI) / 255.0 * 0.5 * dr, 0.0)
            views.append({"error": np.maximum(geom, photo).astype(np.float32),
                          "conf": covf})
        return views

    def _segment_and_update_models(self, frame: FrameData, prep, rgb,
                                   ids: np.ndarray, nonedge=None,
                                   tick: Optional[int] = None) -> np.ndarray:
        """Host segmentation + model lifecycle for one frame
        (MaskFusion.cpp:289-374; engine.py:1623-1804 of the JAX package):
        segmenter, phantom re-spawn claims, spawning (with optional spawn
        subtraction), per-model maxDepth / confidence ramp.  Returns the full
        segmentation mask.  The pipelined schedules pass the frame's
        prefetched non-edge binary (`nonedge`, a host array: the edge map
        does not run again) and its `tick`; a spawn there starts at the
        finished frame's global pose (`_np_glob_pose`), not the newest
        tracked one, which runs up to pipeline_depth frames ahead."""
        cfg = self.cfg
        glob = self.models[0]
        if tick is None:
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
        if nonedge is not None:
            kw["nonedge"] = nonedge
        elif hasattr(self.segmenter, "edge_binary"):
            # the device part: edge map (kernel 3) -> non-edge binary
            kw["nonedge"] = self.segmenter.edge_binary(vmap, nmap)[1].cpu()
        if getattr(self.segmenter, "wants_model_views", False):
            kw["model_views"] = self._cf_model_views(frame)
        seg_result = self.segmenter.perform(
            frame, vmap, nmap, ids, infos, self._get_next_model_id(False),
            allow_new, **kw)
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

        # -------- redetect inactive models (MaskFusion::redetectModels
        # interface, gutted in the reference :686-689; engine.py:1694-1725
        # of the JAX package): a new component that matches an inactive
        # model reactivates it at the camera pose instead of spawning
        if (cfg.enable_redetection and self.inactive_models
                and seg_result.has_new_label):
            md = seg_result.model_data[-1]
            sel = seg_result.full_segmentation == md.model_id
            if sel.any():
                ys, xs = np.where(sel)
                roi = (int(ys.min()), int(xs.min()),
                       int(ys.max()) + 1, int(xs.max()) + 1)
                det = self._redetect(frame, roi)
                if det is not None:
                    gp = (self._upload(self._np_glob_pose)
                          if self._np_glob_pose is not None
                          else glob.state.pose)
                    for m in list(self.inactive_models):
                        if m.model_id == det.model_id:
                            self.inactive_models.remove(m)
                            m.prev_pose = gp.clone()
                            m.state = m.state._replace(pose=gp.clone())
                            self.models.append(m)
                            if hasattr(self.segmenter, "remap_new_label"):
                                self.segmenter.remap_new_label(
                                    md.model_id, m.model_id)
                            seg_result.has_new_label = False
                            seg_result.full_segmentation = np.where(
                                sel, m.model_id,
                                seg_result.full_segmentation
                            ).astype(np.uint8)
                            seg_mask_np = seg_result.full_segmentation
                            self.last_segmentation = seg_mask_np
                            break

        # -------- spawn a new model (:314-332) --------
        if seg_result.has_new_label:
            new_id = self._get_next_model_id(True)
            md = seg_result.model_data[-1]
            # the newborn starts at the camera pose, initialised from the
            # spawn frame's masked pixels with the first-fuse weight 100
            gp = (self._upload(self._np_glob_pose)
                  if self._np_glob_pose is not None else glob.state.pose)
            seg_dev = self._upload(seg_mask_np)
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

    def _obj_params(self, objs: List[Model], n_slots: int) -> np.ndarray:
        """The fuse stage's host rows, one a slot: [mask_id, conf_t,
        max_depth, weight_mult, oy, ox], dead rows after the live ones (a
        model's first fuse weighs 100)."""
        cfg = self.cfg
        return np.asarray(
            [[m.model_id, m.conf_threshold,
              min(cfg.depth_cutoff, m.max_depth),
              100.0 if not m.fused_once else cfg.weight_multiplier,
              *(m.window or (0, 0))] for m in objs]
            + [[DEAD_SLOT_ID, 1.0, cfg.depth_cutoff, 1.0, 0, 0]]
            * (n_slots - len(objs)), np.float32).reshape(n_slots, 6)

    def _dev(self, a) -> torch.Tensor:
        """A pose on the engine's device: a host array (unpacked from a
        hostvec) is uploaded, a tensor on another device of the models mesh
        copied, without waiting."""
        if isinstance(a, torch.Tensor):
            return _moved(a, self.device)
        return self._upload(np.asarray(a, np.float32))

    def _stack_poses(self, poses) -> torch.Tensor:
        """(n, 4, 4) on the device: ONE upload when every pose is a host
        array, as it is in the pipelined schedules' steady state."""
        if all(isinstance(p, np.ndarray) for p in poses):
            return self._upload(np.stack(poses).astype(np.float32))
        return torch.stack([self._dev(p) for p in poses])

    def _dispatch_fuse(self, prep, rgb, seg_mask, tick: int, do_fuse: bool,
                       seg_tick: Optional[int] = None) -> None:
        """fuse + clean + predict for every model (MaskFusion.cpp:539-569;
        engine.py:1806-1911 of the JAX package).  With
        batch_object_tracking, all through `fuse_stage`: the object slots
        padded to _slot_class(objects, min_object_slots), one shared object
        bucket, windowed when every live object has a window.  Otherwise
        (or, in principle, for objects of different capacities, which no
        path creates: every object map is made with
        cfg.object_surfel_capacity) each model in turn.  Objects never fill
        in, and a model's first fuse weighs 100.  `seg_mask` is a host
        array or already on the device; `seg_tick` names the frame whose
        segmentation it is (one frame before `tick` in the lagfuse
        schedule), recorded with it as the newest device segmentation."""
        cfg = self.cfg
        if not do_fuse:
            return
        if not isinstance(seg_mask, torch.Tensor):
            seg_mask = self._upload(seg_mask)
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
            self._place_objects(objs, n_slots)
            eye = np.eye(4, dtype=np.float32)
            prev_poses = self._stack_poses(
                [glob.prev_pose] + [m.prev_pose for m in objs]
                + [eye] * (n_slots - len(objs)))
            glob.state, new_objs = self.fuse_stage(
                glob.state, self._padded_obj_states(objs, n_slots), prep,
                rgb, seg_mask, prev_poses, float(tick),
                self._obj_params(objs, n_slots),
                glob_bucket=self._bucket_for(glob), obj_bucket=obj_bucket,
                parity=parity, windowed=windowed)
            for m, st in zip(objs, new_objs):
                m.state = st
                m.fused_once = True
            self.windowed_fuses += int(windowed and bool(objs))
            self._seg_dev = (tick if seg_tick is None else seg_tick,
                             seg_mask)
            return
        self._place_objects(objs)
        for model in list(self.models):
            is_glob = model.model_id == 0
            wm = (100.0 if not model.fused_once and not is_glob
                  else cfg.weight_multiplier)
            conf_t = (cfg.conf_threshold_global if is_glob
                      else model.conf_threshold)
            max_d = (cfg.depth_cutoff if is_glob
                     else min(cfg.depth_cutoff, model.max_depth))
            model.state, _removed, _appended = self.fuse_clean_predict(
                model.state, prep, rgb, seg_mask, self._dev(model.prev_pose),
                float(tick), model.model_id, float(conf_t), float(max_d),
                float(wm), allow_fill_in=is_glob,
                bucket=self._bucket_for(model), parity=parity)
            model.fused_once = True

    def _dispatch_fuse_prefused(self, prep, rgb, seg_dev: torch.Tensor,
                                tick: int, prev_poses: torch.Tensor,
                                gate: torch.Tensor, glob: Model,
                                objs: List[Model], glob_bucket: int,
                                obj_bucket: int, windowed: bool,
                                ids_guard: torch.Tensor,
                                n_slots: int) -> List[Model]:
        """The prefused schedule's fuse (engine.py:1913-1966 of the JAX
        package), queued right behind the same frame's device stage: its
        pre-track poses, tracking-ok `gate` and id projection (the guard)
        are that stage's device outputs; the host supplies the per-model
        rows (lagged lifecycle state), uploaded once.  The JAX package then
        re-caches its dead slots' donated buffers (_refresh_dummies); the
        port donates nothing and skips dead slots, so it has no
        counterpart.  `fused_once` is set provisionally: the models whose
        first fuse this is come back, and _finish_one restores their flag
        if the frame's gate turns out closed."""
        parity = tick % 2 if self.cfg.fuse_subsample_checkerboard else None
        glob.state, new_objs = self.fuse_stage(
            glob.state, self._padded_obj_states(objs, n_slots), prep, rgb,
            seg_dev, prev_poses, float(tick), self._obj_params(objs, n_slots),
            glob_bucket=glob_bucket, obj_bucket=obj_bucket, parity=parity,
            windowed=windowed, gate=gate, ids_guard=ids_guard)
        first_fused = [m for m in objs if not m.fused_once]
        for m, st in zip(objs, new_objs):
            m.state = st
            m.fused_once = True
        self.windowed_fuses += int(windowed and bool(objs))
        return first_fused

    # ---------------------------------------------- pipelined multi-object
    def _track_models_device(self, prep: Preprocessed):
        """The tracking block of the lagfuse fallback with no host sync
        (engine.py:1968-2012 of the JAX package): returns the tracked
        models, their stacked jump norms (or None) and the global
        covariance maximum, on the device."""
        cfg = self.cfg
        glob = self.models[0]
        glob_prev_pose = glob.state.pose
        tr = self.track(glob.state, prep, 0)
        glob.state = glob.state._replace(pose=tr.pose)
        warm = (se3.pose_inverse(glob_prev_pose) @ tr.pose
                if cfg.object_warm_start else None)
        trackable = cfg.trackable_classes
        tracked = []
        for model in list(self.models[1:]):
            if (not trackable) or (model.class_id in trackable):
                tracked.append(model)
            else:
                # an untracked object mirrors the camera (Model.h:263-268)
                model.state = model.state._replace(
                    pose=self._dev(model.initial_c2w_inv) @ tr.pose)
        jump_stack = None
        if tracked and (len(tracked) == 1 or not cfg.batch_object_tracking):
            js = []
            for model in tracked:
                trm = self.track(model.state, prep, model.model_id,
                                 is_object=True, warm=warm)
                model.state = model.state._replace(pose=trm.pose)
                js.append(torch.linalg.vector_norm(trm.delta[:3, 3]))
            jump_stack = torch.stack(js)
        elif tracked:
            poses, jump_stack = self.track_objects(
                [m.state for m in tracked], [m.model_id for m in tracked],
                prep, warm)
            for i, model in enumerate(tracked):
                model.state = model.state._replace(pose=poses[i])
        return tracked, jump_stack, tr.cov_diag.max()

    def _start_async_copy(self, P: dict, **tensors) -> None:
        """Begin the device->host copies of a pending frame's results
        (engine.py:2014-2021 of the JAX package): on a card, each into a
        pinned host buffer of its own, non-blocking, followed by a recorded
        event; the record owns its buffers until _finish_one has read them
        (no buffer is shared with a later frame).  A copy into pageable
        memory would wait for the device.  On the CPU the tensors are
        already on the host."""
        cuda = self.device.type == "cuda"
        for k, x in tensors.items():
            if x is not None and cuda:
                host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                host.copy_(x, non_blocking=True)
                x = host
            P[k] = x
        if cuda:
            P["ready"] = torch.cuda.Event()
            P["ready"].record()

    @staticmethod
    def _record_ready(P: dict) -> bool:
        """True once every copy the record's host stage reads has landed
        (a poll; never waits).  Always true on the CPU."""
        ev = P.get("ready")
        return ev is None or ev.query()

    def _drain_ready_pipe(self) -> None:
        """Run the host stage of every pending frame whose results are on
        the host; wait for the oldest only when pipeline_depth frames are
        in flight (engine.py:2037-2046 of the JAX package)."""
        depth = max(1, int(self.cfg.pipeline_depth))
        while self._pending:
            if len(self._pending) < depth and not self._record_ready(
                    self._pending[0]):
                break
            self._finish_one(self._pending.popleft())

    def _pipelined_step(self, frame: FrameData, rgb, depth, t0: float,
                        t0_ns: int) -> Dict:
        """The pipelined multi-object frame (engine.py:2048-2206 of the JAX
        package), in either schedule (see the module docstring): first the
        host stages of finished frames (prefused: every one whose results
        have landed; exact: the previous frame's), then this frame's device
        stage, and in the prefused schedule its fuse right behind it.
        rgb_only forces the lagfuse schedule, whose host-side do_fuse
        honours it (the prefused fuse is gated by the covariance only).
        `t0_ns` (time.time_ns()) is the frame's process_frame call, where
        its span frame_to_pose starts."""
        cfg = self.cfg
        self._pipelined_active = True
        prefused = bool(cfg.fuse_mask_lag) and not cfg.rgb_only
        if prefused:
            self._drain_ready_pipe()
        elif self._pending:
            self._finish_one(self._pending.popleft())

        seg_cache = self._seg_dev
        if (seg_cache is not None and self.last_segmentation is not None
                and (prefused or seg_cache[0] == self.tick - 1)):
            # prefused: the host stages re-upload each new segmentation, so
            # the cache is the newest; exact: it must be seg(t-1)
            prev_seg = seg_cache[1]
        elif self.last_segmentation is not None:
            prev_seg = self._upload(self.last_segmentation)
            self._seg_dev = (self.tick - 1, prev_seg)
        else:
            prev_seg = self._zero_mask
        glob = self.models[0]
        objs = self.models[1:]
        trackable = cfg.trackable_classes
        fused_ok = (not trackable
                    or all(m.class_id in trackable for m in objs)) and len(
            {m.state.map.capacity for m in objs}) <= 1
        # a schedule change (e.g. an untrackable model appeared) drains
        # every pending frame first, so fuses stay in tick order and the
        # `time` that time-based cleaning reads never runs backwards
        new_kind = "prefused" if (prefused and fused_ok) else "lagfuse"
        if self._pending and self._pending[-1]["kind"] != new_kind:
            self.drain_pipeline()
        if fused_ok:
            glob_bucket = self._bucket_for(glob)
            obj_bucket = max((self._bucket_for(m) for m in objs),
                             default=self._tuning.min_bucket_object)
            n_slots = _slot_class(len(objs), cfg.min_object_slots)
            windowed = bool(n_slots and self._obj_window) and all(
                m.window is not None for m in objs)
            obj_aux = np.asarray(
                [[m.model_id, *(m.window or (0, 0))] for m in objs]
                + [[DEAD_SLOT_ID, 0, 0]] * (n_slots - len(objs)),
                np.float32).reshape(n_slots, 3)
            self._place_objects(objs, n_slots)
            with self.stopwatch.scope("odom"):
                (prep, gpose, oposes, hostvec, ids_dev, nonedge_dev,
                 prev_poses_dev, okf) = self.pipelined_device_stage(
                    glob.state, self._padded_obj_states(objs, n_slots),
                    obj_aux, rgb, depth, prev_seg, float(self.tick),
                    glob_bucket, obj_bucket, windowed)
            glob.state = glob.state._replace(pose=gpose)
            for m, p in zip(objs, oposes):
                m.state = m.state._replace(pose=p)
            P = dict(kind="prefused" if prefused else "lagfuse",
                     frame=frame, prep=prep, rgb=rgb, tracked=list(objs),
                     tick=self.tick, first_fused=[], n_slots=n_slots,
                     count_models=list(self.models), t0_ns=t0_ns)
            self._start_async_copy(P, ids=ids_dev, nonedge=nonedge_dev,
                                   hostvec=hostvec)
            if prefused:
                with self.stopwatch.scope("fuse"):
                    P["first_fused"] = self._dispatch_fuse_prefused(
                        prep, rgb, prev_seg, self.tick, prev_poses_dev, okf,
                        glob, objs, glob_bucket, obj_bucket, windowed,
                        ids_dev, n_slots)
            self._pending.append(P)
        else:
            self._place_objects(objs)
            for model in self.models:
                model.prev_pose = model.state.pose.clone()
            with self.stopwatch.scope("Preprocess"):
                prep = self.preprocess(rgb, depth, prev_seg)
            with self.stopwatch.scope("odom"):
                tracked, jump_stack, cov = self._track_models_device(prep)
            with self.stopwatch.scope("projection"):
                ids_dev = self._project_ids_all(float(self.tick))
                lv0 = prep.levels[0]
                _edge, nonedge_dev = self.segmenter.edge_binary(lv0["vmap"],
                                                                lv0["nmap"])
            counts = torch.stack([m.state.map.count for m in self.models])
            P = dict(kind="lagfuse", frame=frame, prep=prep, rgb=rgb,
                     tracked=tracked, tick=self.tick,
                     count_models=list(self.models))
            self._start_async_copy(P, ids=ids_dev, nonedge=nonedge_dev,
                                   cov=cov, jumps=jump_stack, counts=counts)
            self._pending.append(P)
            self._log_poses(frame)
        out = {"tick": self.tick, "n_models": len(self.models),
               "model_ids": [m.model_id for m in self.models],
               "tracking_ok": self._last_tracking_ok,
               "surfels": self._last_count, "pipelined": True}
        self.stopwatch.record("Run", (_time.perf_counter() - t0) * 1000)
        return out

    def _finish_one(self, P: dict) -> None:
        """A pending frame's host stage (`_host_stage`); while a profiler
        runs, the span `host_stage` with the frame's tick."""
        with span("host_stage", P["tick"]):
            self._host_stage(P)

    def _host_stage(self, P: dict) -> None:
        """The host stage of one pending frame (engine.py:2208-2305 of the
        JAX package): read its fetched results (waiting only if they have
        not landed), segment, update the lifecycle, and for a lagfuse
        record queue the fuse (a prefused record queued its own).  The
        hostvec unpacks into the models' counts, pre-track poses and logged
        world poses; a frame whose gate was closed gives its newborns back
        their first-fuse weight.  The frame's span frame_to_pose ends once
        its world pose is on the host."""
        cfg = self.cfg
        tick = P["tick"]
        models = P["count_models"]
        n = len(models)
        n_obj = n - 1
        ev = P.get("ready")
        if ev is not None and not ev.query():
            self.forced_waits += 1
            with self.stopwatch.scope("fetch"):
                ev.synchronize()
        if P.get("hostvec") is not None:
            with self.stopwatch.scope("fetch"):
                hv = P["hostvec"].numpy()
            span_since("frame_to_pose", tick, P["t0_ns"])
            # the layout follows the PADDED slot axis; only the live
            # prefix of each section is read
            N = 1 + P["n_slots"]
            counts = hv[:n]
            cov = float(hv[N])
            jumps = hv[N + 1:N + 1 + n_obj] if n_obj else None
            p0 = N + 1 + P["n_slots"]
            prev_poses = hv[p0:p0 + 16 * N].reshape(N, 4, 4)[:n]
            world_poses = hv[p0 + 16 * N:p0 + 32 * N].reshape(N, 4, 4)[:n]
            ts = P["frame"].timestamp or float(tick)
            for i, model in enumerate(models):
                model.prev_pose = prev_poses[i].copy()
                model.pose_log.append({
                    "timestamp": ts, "tick": tick,
                    "pose": torch.from_numpy(world_poses[i].copy())})
            self._np_glob_pose = world_poses[0].copy()
        else:
            with self.stopwatch.scope("fetch"):
                counts = P["counts"].numpy()
            cov = float(P["cov"])
            jumps = P["jumps"].numpy() if P["jumps"] is not None else None
        for model, c in zip(models, counts):
            model.count_est = int(c)
        if models:
            self._last_count = int(counts[0])
        tracking_ok = cov <= self._cov_thresh
        self._last_tracking_ok = tracking_ok
        if not tracking_ok:
            # this frame's prefused fuse was gated away on the device: a
            # newborn whose first fuse it carried keeps its boost
            for m in P.get("first_fused") or []:
                if m in self.models:
                    m.fused_once = False
        if jumps is not None:
            for model, jump in zip(P["tracked"], jumps):
                if (float(jump) > cfg.model_deactivate_jump
                        and model in self.models):
                    self._inactivate_model(model, "movement")
        prefused = P["kind"] == "prefused"
        do_fuse = tracking_ok and not self.lost and not cfg.rgb_only
        # lagfuse records of the prefused configuration: fuse(t) goes out
        # NOW with seg(t-1), so the device works while the host segments t
        lag = (not prefused and cfg.fuse_mask_lag
               and self.last_segmentation is not None)
        if lag:
            seg_for_fuse = self.last_segmentation
            sc = self._seg_dev
            if sc is not None and sc[0] == tick - 1:
                seg_for_fuse = sc[1]        # already on the device
            with self.stopwatch.scope("fuse"):
                self._dispatch_fuse(P["prep"], P["rgb"], seg_for_fuse, tick,
                                    do_fuse, seg_tick=tick - 1)
        with self.stopwatch.scope("fetch_ids"):
            ids = P["ids"].numpy()
        with self.stopwatch.scope("segmentation"):
            seg_mask_np = self._segment_and_update_models(
                P["frame"], P["prep"], P["rgb"], ids,
                nonedge=P["nonedge"].numpy(), tick=tick)
        if prefused:
            # the newest segmentation, staged for the next device stages
            # and fuses (a pinned, non-blocking upload)
            self._seg_dev = (tick, self._upload(seg_mask_np))
        elif not lag:
            with self.stopwatch.scope("fuse"):
                self._dispatch_fuse(P["prep"], P["rgb"], seg_mask_np, tick,
                                    do_fuse)
        self._np_glob_pose = None
        for model in self.models:
            model.age += 1
        if self._diag_exporter:
            self._diag_exporter.record(
                self, {"tracking_ok": tracking_ok,
                       "surfels": self.models[0].count_est},
                P["prep"].levels[0]["vmap"])

    def drain_pipeline(self) -> None:
        """Finish every pending pipelined frame (engine.py:2307-2312 of the
        JAX package): after a stream's last process_frame, and before
        reading the map state."""
        while self._pending:
            self._finish_one(self._pending.popleft())

    # --------------------------------------------------------- frame API
    def upload_frame(self, frame: FrameData) -> FrameData:
        """Stage a frame's images in device memory: a pinned host copy and
        a non-blocking transfer, so the copy overlaps device work."""
        return dataclasses.replace(
            frame, rgb=self._send(_host_tensor(frame.rgb)),
            depth=self._send(_host_tensor(frame.depth)), rgb_host=frame.rgb,
            depth_host=frame.host_depth())

    def _device_frame(self, frame: FrameData):
        """The frame's images on the device (already there after
        upload_frame; otherwise sent from pinned memory without waiting)."""
        return tuple(a if isinstance(a, torch.Tensor)
                     else self._send(_host_tensor(a))
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
        MainController.cpp:458-462).  While a profiler runs, the call is
        the span `process_frame`, the root of the frame's spans."""
        self.tick += 1
        with span("process_frame", self.tick):
            return self._process_frame(frame, gt_pose)

    def _process_frame(self, frame: FrameData,
                       gt_pose: Optional[np.ndarray]) -> Dict:
        t0 = _time.perf_counter()
        t0_ns = _time.time_ns()     # frame_to_pose's start
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
        # the pipelined schedules need the device edge map, i.e. the
        # maskfusion segmenter, and no fern database (engine.py:1147-1153
        # of the JAX package)
        if (not cfg.static_mode and gt_pose is None and self.ferns is None
                and cfg.pipelined_multiobject
                and hasattr(self.segmenter, "edge_binary")):
            return self._pipelined_step(frame, rgb, depth, t0, t0_ns)
        # the -static fast path too runs without ferns only
        # (engine.py:1188 of the JAX package)
        if (gt_pose is not None or not cfg.static_mode
                or self.ferns is not None):
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
        segmentation is skipped: the frame fuses with an all-zero mask.
        Every object tracks on the engine's device (the fuse stage then
        splits the objects over a models mesh, as the JAX engine's does)."""
        cfg = self.cfg
        self._place_objects(self.models[1:])
        H, W = self.res.height, self.res.width
        with self.stopwatch.scope("Preprocess"):
            prep = self.preprocess(rgb, depth, self._prev_seg())

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
        self._relocalise(glob, tracking_ok)

        if cfg.static_mode:
            seg_mask_np = np.zeros((H, W), np.uint8)
            self.last_segmentation = seg_mask_np
        else:
            # -------- global projection + segmentation (:289-296) --------
            with self.stopwatch.scope("segmentation"):
                ids = self._project_ids_all(float(self.tick)).cpu().numpy()
                seg_mask_np = self._segment_and_update_models(frame, prep,
                                                              rgb, ids)

        # ---------------- fuse / clean / predict (:539-569) ----------------
        do_fuse = tracking_ok and not self.lost and not cfg.rgb_only
        with self.stopwatch.scope("fuse"):
            self._dispatch_fuse(prep, rgb, seg_mask_np, self.tick, do_fuse)

        if self.ferns is not None and not self.lost:
            # the fern keyframe add (engine.py:1358-1361 of the JAX package)
            *small, pose = self._fern_views(glob)
            self.ferns.add_frame(*small, pose, self.tick,
                                 cfg.fern_threshold)

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

    # ------------------------------------------------------ relocalisation
    def _relocalise(self, glob: Model, tracking_ok: bool) -> None:
        """The tracking-loss bookkeeping (-rl; MaskFusion.cpp:377-414) and
        the fern search (MaskFusion.cpp:423-537) of a synchronous frame,
        after tracking (engine.py:1304-1341 of the JAX package).  A lost
        camera found in the database takes the fern's pose; a loop closure
        the deformation graph accepts deforms the map, and the camera takes
        the fern's pose too (MaskFusion.cpp:443-456)."""
        cfg = self.cfg
        if cfg.relocalisation:
            if not self.lost:
                if not tracking_ok:
                    self.bad_tracking_streak += 1
                    if self.bad_tracking_streak > 10:
                        self.lost = True
                else:
                    self.bad_tracking_streak = 0
            elif self.last_frame_recovery:
                if tracking_ok:
                    self.lost = False
                    self.bad_tracking_streak = 0
                self.last_frame_recovery = False
        if self.ferns is None or not cfg.close_loops:
            return
        self.last_frame_recovery = False
        *small, pose = self._fern_views(glob)
        res = self.ferns.find_frame(pose, *small, time=self.tick,
                                    lost=self.lost)
        if res.pose is None:
            return
        if self.lost:
            self.last_frame_recovery = True
        elif not self._apply_loop_closure(glob, res):
            return
        glob.state = glob.state._replace(pose=self._upload(
            res.pose.astype(np.float32)))

    def _fern_views(self, glob: Model):
        """The global model's 1/8-scale views for the fern database (the
        reference resizes its fill-in textures, MaskFusion.cpp:430-432,
        609-614; engine.py:2464-2483 of the JAX package) and its pose, in
        ONE fetch: the stride, clip and NaN-to-zero run on the device, and
        the uint8 colours, f32 vertices, normals and pose come back packed
        as bytes (about 130 KB at 640x480), never the full-size maps.
        Returns (rgb, verts, norms, pose) host arrays."""
        f = self.ferns.factor
        st = glob.state
        rgb = torch.clamp(st.pred_rgb[::f, ::f], 0, 255).to(torch.uint8)
        vm = torch.nan_to_num(st.pred_vmap[::f, ::f], nan=0.0)
        nm = torch.nan_to_num(st.pred_nmap[::f, ::f], nan=0.0)
        parts = (rgb, vm, nm, st.pose.to(torch.float32))
        packed = torch.cat([p.contiguous().reshape(-1).view(torch.uint8)
                            for p in parts]).cpu().numpy()
        out, off = [], 0
        for p in parts:
            nb = p.numel() * p.element_size()
            dt = np.uint8 if p.dtype == torch.uint8 else np.float32
            out.append(packed[off:off + nb].view(dt).reshape(p.shape))
            off += nb
        return tuple(out)

    def _apply_loop_closure(self, glob: Model, res) -> bool:
        """Local loop closure (engine.py:2485-2521 of the JAX package): a
        deformation graph over the fern constraints, accepted on the
        reference's thresholds (Deformation::constrain,
        Deformation.cpp:75-180: mean constraint error < 3e-4 and total
        < 0.12), then applied to the map on the device and to every fern
        frame's pose.  Nodes are sampled with the JAX package's systematic
        stride in init-time order (np.argsort as it calls it, so that both
        pick the same nodes); only init_time[:n] and the node positions
        come to the host, and only the (G, 24) node table goes back."""
        from maskfusion_tpu_torch.reloc.deformation import DeformationGraph

        n = glob.surfel_count
        if n < 100 or not res.constraints:
            return False
        m = glob.state.map
        times = m.init_time[:n].cpu().numpy()
        max_nodes = self.cfg.deformation_max_nodes
        order = np.argsort(times)
        step = max(1, n // max_nodes)
        idx = order[::step][:max_nodes]
        node_pos = m.pos[self._upload(idx.astype(np.int64))].cpu().numpy()
        graph = DeformationGraph(node_pos, times[idx], device=self.device)
        for c in res.constraints:
            graph.add_constraint(c.source_point, c.target_point)
        total, mean_cons = graph.optimise()
        if not (mean_cons < 0.0003 and total < 0.12):
            return False
        graph.apply_to_map_device(m.pos, m.normal, n)
        for fframe in self.ferns.frames:
            fframe.pose = graph.apply_to_pose(fframe.pose)
        return True

    def flush_diagnostics(self) -> Dict:
        """Fetch the most recent -static step's diagnostics (one
        device->host copy) and refresh the bucket estimate (engine.py:
        2433-2462 of the JAX package).  The pipelined schedules' pending
        frames are finished first; the synchronous multi-object frame
        returns its diagnostics directly and leaves nothing pending."""
        self.drain_pipeline()
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
        is object->world = global_pose @ inverse(object_pose), on the
        engine's device (an object's state may be on another device of
        the models mesh)."""
        glob_pose = self.models[0].state.pose
        for i, model in enumerate(self.models):
            pose = (glob_pose.clone() if i == 0 else glob_pose
                    @ se3.pose_inverse(self._dev(model.state.pose)))
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
        """A model's live surfels on the host, after the pipelined
        schedules' pending frames are finished."""
        self.drain_pipeline()
        return sm.download(self.models[model_index].state.map)

    def synchronize(self) -> None:
        """Until the device has run everything queued so far; pending
        pipelined frames stay pending."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def all_models(self) -> List[Model]:
        return self.models + self.inactive_models
