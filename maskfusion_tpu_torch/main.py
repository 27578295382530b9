"""Command-line entry point of the PyTorch port.

Port of ``maskfusion_tpu/main.py``, the equivalent of GUI/MainController.
{h,cpp} + GUI/Main.cpp: flag parsing (MainController.cpp:34-97), intrinsics
presets (:117-126), reader selection (:139-204), the main frame loop with
the real-time frameskip governor (:423-607), and end-of-run exports
(:591-606), with the live viewer (-viewer, gui.LiveViewer: an offscreen
canvas where no display is set) and the viewport export (-ev).  The flags
are the JAX package's, and every one runs.  The engine runs on the first
CUDA card; ``main(argv, device="cpu")`` runs it on the CPU.

Usage examples (same surface as the reference):
  python -m maskfusion_tpu_torch.main -l log.klg -static -ep -em
  python -m maskfusion_tpu_torch.main -l log.klg -static -viewer -ev \\
      -exportdir out
  python -m maskfusion_tpu_torch.main -dir /data/sequence -static -q -ep
  python -m maskfusion_tpu_torch.main -dir seq -method precomputed \\
      --pipeline off -maskdir masks
  python -m maskfusion_tpu_torch.main -l log.klg --nn -frameQ 5 -ep
  python -m maskfusion_tpu_torch.main -l log.klg -rl -e 100 \
      --save-state ckpt
  python -m maskfusion_tpu_torch.main -l log.klg -rl -s 100 \
      --load-state ckpt -ep
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "maskfusion_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    # dataset / io (MainController.cpp:76-92)
    p.add_argument("-l", dest="log", help="process a .klg log file")
    p.add_argument("-dir", dest="dir", help="process a log directory")
    p.add_argument("-depthdir", dest="depthdir")
    p.add_argument("-maskdir", dest="maskdir")
    p.add_argument("-basedir", dest="basedir", default="")
    p.add_argument("-exportdir", dest="exportdir")
    p.add_argument("-diagdir", dest="diagdir", help=(
        "offline diagnostic surface: per-frame metrics CSV + per-model "
        "ICP-error images (the GUI's live plots/textures, "
        "MainController.cpp:500-515)"))
    p.add_argument("-colorprefix", dest="colorprefix", default="Color")
    p.add_argument("-depthprefix", dest="depthprefix", default="Depth")
    p.add_argument("-maskprefix", dest="maskprefix", default="Mask")
    p.add_argument("-indexW", dest="index_width", type=int, default=4)
    p.add_argument("-cal", dest="calibration",
                   help="calibration file: fx fy cx cy")
    p.add_argument("-p", dest="trajectory", help="ground-truth poses (TUM)")
    p.add_argument("-v2", action="store_true", help="Kinect v2 preset")
    p.add_argument("-tum3", action="store_true", help="TUM freiburg3 preset")
    # run control
    p.add_argument("-run", action="store_true", default=True)
    p.add_argument("-q", dest="quit_on_finish", action="store_true")
    p.add_argument("-s", dest="start_frame", type=int, default=0)
    p.add_argument("-e", dest="end_frame", type=int)
    p.add_argument("-f", dest="flip_colors", action="store_true")
    p.add_argument("-fs", dest="frame_skip", action="store_true")
    p.add_argument("-r", dest="rewind", action="store_true")
    p.add_argument("-nm", dest="mask_cutoff", type=int)
    # tracking
    p.add_argument("-d", dest="depth_cutoff", type=float, default=5.0)
    p.add_argument("-i", dest="icp_weight", type=float, default=10.0)
    p.add_argument("-or", dest="outlier_rejection", type=float, default=3.0)
    p.add_argument("-t", dest="time_window", type=int, default=200)
    p.add_argument("-fo", dest="fast_odom", action="store_true")
    p.add_argument("-nso", dest="no_so3", action="store_true")
    p.add_argument("-ftf", dest="frame_to_frame_rgb", action="store_true")
    p.add_argument("-o", dest="open_loop", action="store_true", default=True)
    p.add_argument("-rl", dest="relocalisation", action="store_true")
    p.add_argument("-icl", dest="icl_nuim", action="store_true")
    # loop closure / ferns
    p.add_argument("-ie", dest="loop_err_thresh", type=float, default=5e-5)
    p.add_argument("-ic", dest="loop_count_thresh", type=float, default=35000)
    p.add_argument("-cv", dest="cov_thresh", type=float, default=1e-5)
    p.add_argument("-pt", dest="photo_thresh", type=float, default=115)
    p.add_argument("-ft", dest="fern_thresh", type=float, default=0.3095)
    # multi-model
    p.add_argument("-static", dest="static_mode", action="store_true")
    p.add_argument("-method", dest="method", default="maskfusion",
                   choices=["maskfusion", "cofusion", "precomputed"])
    p.add_argument("-frameQ", dest="frame_queue", type=int, default=30)
    p.add_argument("-confO", dest="conf_object", type=float, default=0.01)
    p.add_argument("-confG", dest="conf_global", type=float, default=10.0)
    p.add_argument("-segMinNew", dest="seg_min_new", type=float, default=0.015)
    p.add_argument("-segMaxNew", dest="seg_max_new", type=float, default=0.4)
    p.add_argument("-offset", dest="model_spawn_offset", type=int, default=22)
    p.add_argument("-keep", dest="keep_all_models", action="store_true")
    p.add_argument("-spawnSubtract", dest="spawn_subtraction",
                   action="store_true",
                   help="carve global surfels inside a newly spawned "
                        "object's region (eraseErrorGeometry)")
    p.add_argument("-a", dest="preallocate", type=int, default=0)
    # exports
    p.add_argument("-ep", dest="export_poses", action="store_true")
    p.add_argument("-em", dest="export_models", action="store_true")
    p.add_argument("-es", dest="export_segmentation", action="store_true")
    p.add_argument("-el", dest="export_labels", action="store_true")
    p.add_argument("-en", dest="export_normals", action="store_true")
    p.add_argument("-ev", dest="export_viewport", action="store_true")
    p.add_argument("-viewer", dest="viewer", action="store_true",
                   help="live cv2 window: predicted RGB / shaded map / "
                        "depth / labels per frame with pause/step/quit "
                        "keys (offscreen canvas when no display)")
    # capacities: reference defaults (Core/CMakeLists.txt:27-28 ->
    # Model.cpp:101-108 — 9,437,184 global / 1,048,576 per-object surfels)
    p.add_argument("--global-capacity", type=int, default=9437184)
    p.add_argument("--object-capacity", type=int, default=1 << 20)
    p.add_argument("--max-frames", type=int, help="alias for -e")
    p.add_argument("--nn", dest="embedded_nn", action="store_true",
                   help="run the embedded Mask R-CNN (matterport's COCO "
                        "ResNet-101-FPN at 1024 px with frozen BatchNorm "
                        "and 6000/1000 proposals, seeded random weights) "
                        "on its own thread and CUDA stream for frames "
                        "without precomputed masks, through a -frameQ "
                        "delay queue")
    p.add_argument("--toml", dest="toml_config",
                   help="config.toml with class_names/filter_classes/"
                        "score_threshold/trackable_classes")
    p.add_argument("--pipeline", dest="pipeline", default="prefused",
                   choices=["prefused", "exact", "off"],
                   help="multi-object schedule: prefused = deep pipeline "
                        "(fuse rides the device queue gated by tracking "
                        "covariance, host drains lazily up to "
                        "--pipeline-depth frames late), exact = depth-1 "
                        "pipeline preserving the reference's sequential "
                        "dataflow, off = fully synchronous")
    p.add_argument("--pipeline-depth", dest="pipeline_depth", type=int,
                   default=4, help="max frames in flight before a blocking "
                                   "drain (prefused schedule only)")
    p.add_argument("--save-state", dest="save_state",
                   help="write an engine checkpoint here after the run")
    p.add_argument("--load-state", dest="load_state",
                   help="resume from an engine checkpoint before the run")
    return p


def make_config(args):
    from maskfusion_tpu_torch.config import Config

    return Config(
        pipelined_multiobject=args.pipeline != "off",
        fuse_mask_lag=args.pipeline == "prefused",
        pipeline_depth=args.pipeline_depth,
        global_surfel_capacity=args.global_capacity,
        object_surfel_capacity=args.object_capacity,
        depth_cutoff=args.depth_cutoff,
        icp_weight=args.icp_weight,
        outlier_coefficient=args.outlier_rejection,
        time_delta=args.time_window,
        fast_odom=args.fast_odom,
        use_so3=not args.no_so3,
        frame_to_frame_rgb=args.frame_to_frame_rgb,
        open_loop=args.open_loop,
        relocalisation=args.relocalisation,
        icl_nuim=args.icl_nuim,
        static_mode=args.static_mode,
        seg_method=args.method,
        frame_queue_size=args.frame_queue,
        conf_threshold_object=args.conf_object,
        conf_threshold_global=args.conf_global,
        seg_min_new_rel=args.seg_min_new,
        seg_max_new_rel=args.seg_max_new,
        model_spawn_offset=args.model_spawn_offset,
        keep_all_models=args.keep_all_models,
        spawn_subtraction=args.spawn_subtraction,
        preallocated_models=args.preallocate,
        mask_cutoff_frame=args.mask_cutoff,
        fern_threshold=args.fern_thresh,
        local_loop_residual_thresh=args.loop_err_thresh,
        local_loop_inlier_thresh=args.loop_count_thresh,
        covariance_thresh=args.cov_thresh,
        photometric_thresh=args.photo_thresh,
        flip_colors=args.flip_colors,
        frame_skip=args.frame_skip,
        start_frame=args.start_frame,
        end_frame=args.end_frame if args.end_frame else args.max_frames,
        export_dir=args.exportdir,
        diag_export_dir=args.diagdir,
        export_poses=args.export_poses,
        export_models=args.export_models,
        export_segmentation=args.export_segmentation,
        export_labels=args.export_labels,
        export_normals=args.export_normals,
        export_viewport=args.export_viewport,
    )


def make_reader(args, resolution):
    """The reader the flags ask for; only its module is imported (the image
    reader needs OpenCV, a raw KLG log does not)."""
    base = args.basedir or ""
    if args.log:
        from maskfusion_tpu_torch.io.klg_reader import KlgLogReader

        return KlgLogReader(os.path.join(base, args.log), resolution.width,
                            resolution.height, args.flip_colors)
    if args.dir:
        from maskfusion_tpu_torch.io.image_reader import ImageLogReader

        return ImageLogReader(
            os.path.join(base, args.dir),
            depth_dir=os.path.join(base, args.depthdir) if args.depthdir else None,
            mask_dir=os.path.join(base, args.maskdir) if args.maskdir else None,
            color_prefix=args.colorprefix,
            depth_prefix=args.depthprefix,
            mask_prefix=args.maskprefix,
            index_width=args.index_width,
            flip_colors=args.flip_colors,
            max_masks=args.mask_cutoff,
        )
    raise SystemExit("specify a dataset with -l <log.klg> or -dir <directory>")


def resolve_intrinsics(args):
    from maskfusion_tpu_torch.camera import CameraIntrinsics, get_preset

    if args.v2:
        res, intr = get_preset("v2")
    elif args.tum3:
        res, intr = get_preset("tum3")
    else:
        res, intr = get_preset("default")
    if args.calibration:
        with open(args.calibration) as f:
            fx, fy, cx, cy = [float(v) for v in f.read().split()[:4]]
        intr = CameraIntrinsics(fx, fy, cx, cy)
    return res, intr


def main(argv=None, device=None):
    """Run the CLI.  `device` is the engine's torch device (default: the
    first CUDA card; there is no fallback to the CPU)."""
    args = build_parser().parse_args(argv)
    res, intr = resolve_intrinsics(args)
    cfg = make_config(args)

    from maskfusion_tpu_torch.engine import MaskFusion
    from maskfusion_tpu_torch.io import export as ex
    from maskfusion_tpu_torch.io.ground_truth import GroundTruthOdometry
    from maskfusion_tpu_torch.mapping import surfel_map as sm

    reader = make_reader(args, res)
    gt = GroundTruthOdometry(args.trajectory) if args.trajectory else None

    # toml class config (MainController.cpp:269-287)
    if args.toml_config:
        from maskfusion_tpu_torch.maskrcnn.inference import load_toml_config

        tc = load_toml_config(args.toml_config)
        cfg.score_threshold = tc["score_threshold"]
        cfg.filter_classes = tc["filter_classes"] or None
        cfg.trackable_classes = tc["trackable_classes"] or None

    # async Mask R-CNN worker + frame delay-queue (MaskRCNN.cpp:178-208,
    # MaskFusion.cpp:206-209) for frames without precomputed masks
    nn_queue = nn_worker = None
    if args.embedded_nn and not reader.has_masks():
        from maskfusion_tpu_torch.maskrcnn.inference import (
            FrameQueue, MaskRCNNInference, MaskRCNNWorker)
        from maskfusion_tpu_torch.maskrcnn.model import (
            matterport_coco_config)

        inference = MaskRCNNInference(
            matterport_coco_config(cfg.score_threshold),
            filter_classes=cfg.filter_classes, device=device)
        nn_queue = FrameQueue(cfg.frame_queue_size)
        nn_worker = MaskRCNNWorker(inference, nn_queue)

    if args.start_frame:
        reader.fast_forward(args.start_frame)

    # peek the first frame; if its resolution differs from the preset, adapt
    # (the reference requires a matching preset — auto-detection is friendlier)
    first = reader.get_next()
    if first is None:
        raise SystemExit("dataset is empty")
    if (first.width, first.height) != (res.width, res.height):
        from maskfusion_tpu_torch.camera import CameraIntrinsics, Resolution

        sx = first.width / res.width
        sy = first.height / res.height
        if not args.calibration:
            intr = CameraIntrinsics(intr.fx * sx, intr.fy * sy,
                                    intr.cx * sx, intr.cy * sy)
        res = Resolution(first.width, first.height)
        print(f"auto-detected resolution {res.width}x{res.height}")

    engine = MaskFusion(res, intr, cfg, device=device)
    if args.load_state:
        from maskfusion_tpu_torch.io import checkpoint

        checkpoint.load(engine, args.load_state)
        print(f"resumed from {args.load_state} at tick {engine.tick}")

    live = None
    if args.viewer:
        from maskfusion_tpu_torch.gui import LiveViewer

        live = LiveViewer(engine, screenshot_dir=cfg.export_dir or ".")

    budget_ms = 1000.0 / cfg.target_fps
    n = 0
    t_start = time.perf_counter()
    pending = first
    while pending is not None:
        frame = pending
        pending = reader.get_next() if reader.has_more() else None
        if pending is None and args.rewind and reader.rewind():
            pending = reader.get_next()  # -r: loop the log forever
        if pending is not None and cfg.static_mode:
            # stage the next frame's device upload during this frame's
            # compute (host segmentation paths need numpy frames, so the
            # overlap is static-mode only)
            pending = engine.upload_frame(pending)
        if nn_queue is not None:
            # delay-queue semantics: consume frames only once labelled (or
            # the queue overflows).  Non-blocking: SLAM does not gate on the
            # NN lane; frames exit unlabelled when the worker falls more
            # than the queue's depth behind (MaskFusion.cpp:206-209)
            nn_worker.check()
            nn_queue.push(frame)
            frame = nn_queue.pop_ready()
            if frame is None:
                continue
        if cfg.end_frame is not None and frame.index >= cfg.end_frame:
            break
        gt_pose = gt.get_pose(frame.timestamp) if gt else None
        diag = engine.process_frame(frame, gt_pose=gt_pose)
        n += 1
        if live is not None and not live.update(diag):
            print("viewer quit")
            break
        if n % 25 == 0:
            print(f"[{n}] surfels={diag.get('surfels')} "
                  f"models={diag.get('n_models', 1)} "
                  f"ok={diag.get('tracking_ok')}", flush=True)
        if cfg.export_dir:
            if cfg.export_segmentation and engine.last_segmentation is not None:
                ex.export_segmentation_png(cfg.export_dir, engine.tick,
                                           engine.last_segmentation)
            if cfg.export_labels and engine.last_segmentation is not None:
                ex.export_label_image(cfg.export_dir, engine.tick,
                                      engine.last_segmentation)
            if cfg.export_normals:
                nmap = engine.models[0].state.pred_nmap.cpu().numpy()
                ex.export_normal_image(cfg.export_dir, engine.tick, nmap)
            if cfg.export_viewport:
                from maskfusion_tpu_torch import viewer

                viewer.save_viewport(
                    engine,
                    os.path.join(cfg.export_dir,
                                 f"Viewport{engine.tick}.png"))
        # real-time governor (-fs; MainController.cpp:487-489)
        if cfg.frame_skip:
            skip = engine.stopwatch.should_skip_frames(budget_ms)
            for _ in range(skip):
                if reader.has_more():
                    reader.get_next()

    if nn_queue is not None:
        # drain the queue at the end of the log: flush-pop, so an unlabelled
        # head (the worker labels newest-first) cannot starve the drain
        while len(nn_queue):
            frame = nn_queue.pop_ready(flush=True)
            if frame is not None:
                gt_pose = gt.get_pose(frame.timestamp) if gt else None
                engine.process_frame(frame, gt_pose=gt_pose)
                n += 1
        nn_worker.stop()
        print(f"Mask R-CNN labelled {nn_worker.labelled} frames")

    if live is not None:
        live.close()

    # the clock stops once the device has run every queued frame.  As in
    # the JAX CLI, the pipelined schedules' pending host stages are not
    # drained: the exports read what has been finished (a prefused run's
    # pose logs lack its last pending frames)
    engine.synchronize()
    elapsed = time.perf_counter() - t_start
    reader.close()
    fps = n / elapsed if elapsed > 0 else 0.0
    print(f"processed {n} frames in {elapsed:.1f}s ({fps:.2f} FPS)")
    print("timings(ms):", {k: round(v, 1)
                           for k, v in engine.stopwatch.summary().items()})

    if args.save_state:
        # not drained first, as in the JAX CLI (io/checkpoint.py)
        from maskfusion_tpu_torch.io import checkpoint

        checkpoint.save(engine, args.save_state)
        print(f"checkpoint written to {args.save_state}")

    if cfg.export_dir:
        if cfg.export_poses:
            paths = ex.export_poses(cfg.export_dir, engine.all_models())
            print("pose logs:", paths)
        if cfg.export_models:
            for model in engine.models:
                surfels = sm.download(model.state.map)
                thresh = (cfg.conf_threshold_global if model.model_id == 0
                          else model.conf_threshold)
                path = os.path.join(cfg.export_dir,
                                    f"cloud-{model.model_id}.ply")
                k = ex.save_ply(path, surfels, thresh)
                print(f"wrote {path} ({k} surfels)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
