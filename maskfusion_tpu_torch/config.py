"""Runtime configuration.

Copy of ``maskfusion_tpu/config.py`` for the PyTorch port: every field is
kept so both packages accept the same configs.  Single dataclass covering the reference's four config layers (SURVEY.md §5.6):
CLI flags (GUI/MainController.cpp:34-97), the Pangolin GUI Vars synced every
loop (GUI/Tools/GUI.h:172-227, MainController.cpp:527-571), the toml Mask R-CNN
class config (config.toml.in), and the compile-time CMake capacity options
(Core/CMakeLists.txt:25-33).  Values here are the reference defaults.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass
class Config:
    # --- capacities (compile-time in the reference; static shapes here) ---
    # Reference defaults: 3072^2 = 9_437_184 global, 1024^2 = 1_048_576 object
    # (Core/CMakeLists.txt:27-28, Model.cpp:101-108). We default smaller and
    # power-of-two aligned; override for full-capacity runs.
    global_surfel_capacity: int = 1 << 22      # 4_194_304
    object_surfel_capacity: int = 1 << 19      # 524_288
    max_models: int = 256                      # uint8 model ids (MaskFusion.cpp:715-731)
    max_active_models: int = 8                 # tracked/fused simultaneously (batched axis)

    # --- tracking (RGBDOdometry) ---
    num_pyr_levels: int = 3                    # RGBDOdometry.h:81
    gn_iterations: Tuple[int, int, int] = (10, 5, 4)   # RGBDOdometry.cpp:327-329
    fast_odom: bool = False                    # -fo: {3,0,0}
    pyramid: bool = True
    use_so3: bool = True                       # -nso disables
    so3_iterations: int = 10
    icp_weight: float = 10.0                   # -i (CLI default 10; GUI shows 20)
    # Object models blend ICP + photometric at the same weight as the
    # global model (the reference uses one weight for all models,
    # RGBDOdometry.cpp:237).  ICP-ONLY object tracking (weight >= 100,
    # the round-2 default) is degenerate in-plane on near-planar objects:
    # the parity sequence's patch SLID ~1.3 cm/frame with only the patch
    # boundary resisting, and the outcome flipped with backend codegen
    # (object displacement error 107 cm on 1-device XLA:CPU vs 7 cm on
    # 8-device; 0.4 cm with the blend).  The (tx, ry) photometric
    # ambiguity that motivated ICP-only was an artefact of the
    # half-texel pyramid misregistration fixed in round 2.
    object_icp_weight: float = 10.0
    # Levenberg-style damping for OBJECT GN solves only (relative to
    # trace(A)/6): small objects routinely present ill-conditioned systems
    # (planar patches leave ICP's in-plane directions unconstrained; a
    # narrow effective FOV couples tx with ry photometrically), and the
    # undamped solve absorbs noise into exactly those directions.  0
    # disables (reference behaviour).
    object_gn_damping: float = 0.0
    # Photometric term at the FINEST pyramid level only for objects (a
    # small object's coarse photometric systems are few-pixel and
    # ill-conditioned — a 47-pixel level-2 term proposed 0.11 m from 4 mm
    # of true motion).  Off by default: sequence-level parity needs the
    # coarse levels' large-motion capture (object displacement error
    # 0.3 cm with them vs divergence without); enable for scenes
    # dominated by static objects under camera motion.
    object_rgb_finest_only: bool = False
    # Warm-start object GN at "world-static" (previous object pose
    # composed with the global camera delta, Model.h:264's makeStatic
    # geometry).  Cuts static-object drift ~6x but measurably lags truly
    # moving objects (parity displacement 0.3 -> 4.8 cm), so off by
    # default — the reference also starts from the model's own pose.
    object_warm_start: bool = False
    rgb_only: bool = False
    frame_to_frame_rgb: bool = False           # -ftf
    # Frozen-association GN: refresh the projective correspondence search
    # (the two random row-gathers of the ICP and RGB terms) only
    # every N iterations per pyramid level; the iterations in between
    # re-linearise against the frozen matches.  1 = reference behaviour
    # (re-search every iteration, reduce.cu:292-366).  Synthetic pose
    # recovery at period 5 is within 0.5% of period 1 (5.61 vs 5.59 mm)
    # while halving the search gathers that dominate tracking cost.
    assoc_period: int = 5
    # Gauss-Newton convergence cutoff: once an iteration's solved increment
    # max|x| drops below this (metres / radians — orders below sensor
    # noise), the level's remaining iterations leave the pose untouched.
    # The port evaluates them masked on the device, so the decision never
    # costs a host sync.  The reference runs its full (10,5,4) schedule
    # unconditionally (RGBDOdometry.cpp:327-497).  0 restores the fixed
    # schedule.
    gn_step_eps: float = 1e-6
    # Track all object models in one vmapped dispatch (vs the reference's
    # sequential per-model loop, MaskFusion.cpp:246-278).
    batch_object_tracking: bool = True
    # Software-pipelined multi-object frame loop: host segmentation for
    # frame t-1 runs while the device computes frame t; all device->host
    # reads (projected ids, edge maps, tracking diagnostics) are prefetched
    # asynchronously, so a frame never blocks on the device.  Preserves the
    # reference's dataflow (track(t) sees the map fused through t-1 either
    # way, MaskFusion.cpp:200-607); lifecycle decisions (spawn/deactivate)
    # land one frame later.  Falls back to the synchronous path when
    # relocalisation/close_loops are on or gt poses are supplied.
    pipelined_multiobject: bool = True
    # fuse frame t with the NEWEST segmentation already resident on device
    # so the device never idles while the host segments (the reference
    # tolerates mask lag by design: the Mask R-CNN delay queue budget is 30
    # frames, MainController.cpp:223).  With this on, the multi-object
    # pipeline runs prefused-deep: frame t's fuse is dispatched back to back
    # with its tracking (gated device-side by the tracking covariance), and
    # host stages (segmentation + lifecycle) drain lazily as their
    # prefetched device results become ready — zero blocking host syncs per
    # frame in steady state.  Off = fuse waits for the current frame's
    # segmentation (exact sequential dataflow; one-frame pipeline).
    fuse_mask_lag: bool = True
    # Prefused pipeline depth: max frames in flight (device results pending
    # host-side segmentation/lifecycle) before the host force-drains with a
    # blocking fetch.  On a local chip results are ready within ~a frame and
    # the queue stays at 1; on high-latency remote transports the depth
    # hides up to depth*frame_time of round-trip latency at the price of
    # lifecycle decisions (spawn/deactivate) landing that many frames late
    # (the reference's own NN masks lag up to 30 frames).
    pipeline_depth: int = 4
    # Object-slot padding floor for the pipelined multi-object graphs.  The
    # object axis of the two fused graphs is padded to the next power of two
    # >= max(n_live, min_object_slots) with masked dead slots, so model
    # spawns/deletions within a size class NEVER recompile (the reference
    # tolerates 256 models with zero recompiles, MaskFusion.cpp:715-731;
    # here each (bucket, n_slots, parity) graph variant is a 90-230 s remote
    # compile cold).  A floor > 0 additionally pins the class from frame 1
    # (e.g. 2 for a scene known to hold two objects) at the price of dead-
    # slot compute while fewer objects are live.
    min_object_slots: int = 0
    dist_threshold: float = 0.10               # m, RGBDOdometry.h:35
    angle_threshold_sine: float = 0.34202      # sin(20deg), RGBDOdometry.h:36
    max_depth_delta_rgb: float = 0.07          # RGBDOdometry.cpp:33
    max_depth_rgb: float = 6.0                 # RGBDOdometry.cpp:34
    # Gradient descale for the derivative images.  The reference uses
    # 1/2^sobelSize = 1/8 (RGBDOdometry.cpp:31-32), which normalises the
    # *standard* Sobel kernel — but its actual gsobel kernel
    # (cudafuncs.cu:691-697) has weight sum 1.83853 per side, so the
    # photometric Jacobian ends up 0.46x true and every GN step overshoots
    # ~2.17x (masked in the reference by the ICP blend).  We normalise the
    # kernel exactly: 1 / (2 * (2*0.52201 + 0.79451)).
    sobel_scale: float = 1.0 / (2.0 * (2.0 * 0.52201 + 0.79451))
    min_grad_magnitudes: Tuple[float, float, float] = (5.0, 3.0, 1.0)  # .cpp:102-105
    translation_jump_limit: float = 0.3        # RGBDOdometry.cpp:478
    mask_rgb_residual: bool = True             # reduce.cu:836 gate
    mask_icp_residual: bool = False            # reduce.cu:316 (compile-gated in ref)

    # --- depth preprocessing ---
    depth_cutoff: float = 5.0                  # -d (GUI default 4, CLI doc 5)
    bilateral_radius: int = 6                  # sigmas are the frag-shader
                                               # constants (preprocess.py)

    # --- fusion / mapping ---
    conf_threshold_global: float = 10.0        # -confG
    conf_threshold_object: float = 0.01        # -confO
    time_delta: int = 200                      # -t; INT_MAX/2 in open-loop mode
    open_loop: bool = True                     # -o (global loop closure stubbed in ref)
    outlier_coefficient: float = 3.0           # -or
    weight_multiplier: float = 1.0             # fusion weight scale
    velocity_fusion_weight: bool = True        # Model::computeFusionWeight
    fuse_subsample_checkerboard: bool = True   # data.vert:114 time-parity subsample
    surfel_merge_z_thresh: float = 0.05        # data.vert:141 |zdiff*lambda| gate
    unstable_time_limit: int = 20              # copy_unstable.vert:134
    icl_nuim: bool = False                     # -icl: flip normals

    # --- model lifecycle (MaskFusion.cpp) ---
    static_mode: bool = False                  # -static
    model_spawn_offset: int = 22               # GUI.h:347 (frames between spawns)
    # Spawn subtraction: carve global surfels inside a freshly spawned
    # object's mask region (Model::eraseErrorGeometry, Model.cpp:774-887).
    # The reference hardcodes enableSpawnSubtraction=false
    # (MaskFusion.cpp:355-358); same default here.
    spawn_subtraction: bool = False
    spawn_subtraction_window: float = 0.05     # depth agreement window (m)
    # Deformation-graph node budget (the reference's graph buffer holds
    # 1024 nodes, Deformation.cpp:26)
    deformation_max_nodes: int = 1024
    model_deactivate_jump: float = 0.2         # translation jump -> deactivate (:267-272)
    keep_all_models: bool = False              # -keep
    min_surfels_keep: int = 4000               # smart-delete (:699-713)
    min_conf_keep: float = 0.3
    preallocated_models: int = 0               # -a
    # Redetection of inactive models. The reference declares the interface
    # but ships no matcher (enableRedetection=false, MaskFusion.cpp:399,
    # redetectModels gutted :686-689); ours uses the fern baseline matcher.
    enable_redetection: bool = False

    # --- segmentation ---
    seg_method: str = "maskfusion"             # -method: maskfusion|cofusion|precomputed
    seg_min_new_rel: float = 0.015             # -segMinNew (GUI.h:345)
    seg_max_new_rel: float = 0.4               # -segMaxNew
    # Operative GUI defaults (GUI.h:361-375) — these override the
    # MfSegmentation.h header defaults every loop in the reference
    seg_threshold: float = 0.3                 # edge threshold
    seg_weight_distance: float = 150.0         # wD
    seg_weight_concavity: float = 2.8          # wC
    seg_morph_edge_iterations: int = 0
    seg_morph_edge_radius: int = 1
    seg_morph_mask_iterations: int = 0
    seg_morph_mask_radius: int = 2
    seg_remove_edges: bool = True
    seg_remove_edge_islands: bool = False
    seg_min_mapped_component_size: int = 160   # MfSegmentation.cpp:43
    seg_min_mask_model_overlap: float = 0.05
    seg_small_component_threshold: int = 50
    seg_edge_reassign_depth_delta: float = 0.008
    seg_overlap_component_mask: float = 0.65   # MfSegmentation.cpp:309-344
    seg_overlap_leftover: float = 0.6          # :501-522
    seg_edge_reassign_iters: int = 5           # :243-291
    person_class_id: int = 255
    frame_queue_size: int = 30                 # -frameQ
    mask_cutoff_frame: Optional[int] = None    # -nm
    trackable_classes: Optional[List[int]] = None  # config.toml trackable_classes
    score_threshold: float = 0.55              # Mask R-CNN score threshold
    filter_classes: Optional[List[int]] = None

    # --- relocalisation / ferns ---
    relocalisation: bool = False               # -rl
    close_loops: bool = False                  # fern loop closure + deformation
    fern_threshold: float = 0.3095             # -ft
    local_loop_residual_thresh: float = 5e-05  # -ie
    local_loop_inlier_thresh: float = 35000.0  # -ic
    covariance_thresh: float = 1e-05           # -cv
    photometric_thresh: float = 115.0          # -pt
    num_ferns: int = 500
    fern_pyramid_level: int = 3                # 1/8 scale frames

    # --- run control / io ---
    run_immediately: bool = True               # headless default; GUI starts paused
    quit_on_finish: bool = True                # -q
    start_frame: int = 0                       # -s
    end_frame: Optional[int] = None            # -e
    flip_colors: bool = False                  # -f
    rewind_loop: bool = False                  # -r
    frame_skip: bool = False                   # -fs real-time governor
    target_fps: float = 30.0                   # frameskip threshold (MainController:487)
    export_dir: Optional[str] = None           # -exportdir
    export_poses: bool = False                 # -ep
    export_models: bool = False                # -em
    export_segmentation: bool = False          # -es
    export_labels: bool = False                # -el
    export_normals: bool = False               # -en
    export_viewport: bool = False              # -ev
    # Offline diagnostic surface (-diagdir): per-frame metrics CSV + per-
    # model alignment-error images — the headless equivalent of the GUI's
    # live ICP-error plots/textures (MainController.cpp:500-515, 911-921).
    # Forces per-frame host syncs; leave unset for benchmark runs.
    diag_export_dir: Optional[str] = None
    diag_export_interval: int = 8              # error-image cadence (frames)

    # --- numerics / execution ---
    compute_dtype: str = "float32"
    # Object processing window: image-side fuse/clean/predict/projection
    # passes for OBJECT models run on a static (object_window)^2 crop
    # around the object's mask (dynamic offsets — no recompiles) instead of
    # the full frame.  0 disables; auto-disabled when the window doesn't
    # fit the frame.  The reference runs every model's passes at full
    # resolution (MaskFusion.cpp:539-569).
    object_window: int = 320
    object_window_margin: int = 32
    # Incremental post-fuse index map (ops/splat.patch_index_map): refresh
    # im1's winners from the fused map + insert the appended unstables at
    # their own pixels, instead of the reference's second full re-render
    # (MaskFusion.cpp:541-561).  Exact except that a surfel whose blended
    # position crosses a pixel boundary keeps its pre-fuse pixel for one
    # frame.  Saves a bucket-row sort render per model per frame.
    incremental_im2: bool = True
    # Pallas switch of the JAX package, kept so both packages accept the
    # same configs.  The port ignores it: its hand-written CUDA kernels run
    # whenever the tensors lie on a CUDA device, and their plain PyTorch
    # versions run on the CPU.
    use_pallas: str = "never"                  # "auto" | "never" | "always"

    def iterations(self) -> Tuple[int, int, int]:
        if self.fast_odom:
            return (3, 0, 0)
        if not self.pyramid:
            return (self.gn_iterations[0], 0, 0)
        return self.gn_iterations

    def effective_time_delta(self) -> int:
        # Open-loop mode widens the surfel active window to "forever"
        # (MainController.cpp:399 sets std::numeric_limits<int>::max()/2).
        return (1 << 30) if self.open_loop else self.time_delta
