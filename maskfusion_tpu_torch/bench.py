"""The port's benchmark: SLAM frames per second at 640x480 on one CUDA card.

    python -m maskfusion_tpu_torch.bench

The counterpart of the repository's root ``bench.py`` (which drives the JAX
package and stays as it is).  Four lines, each one JSON object in bench.py's
format (``metric``, ``value``, ``unit``, ``vs_baseline`` against the 30 FPS
real-time target, ``reps``), plus ``device``, the card's nvidia-smi name and
power limit:

- ``slam_fps_640x480_two_objects``: bench.py's two-object line as it runs
  it (bench.py:193-260): its configuration unchanged -- the pipelined,
  prefused schedule at the ``Config`` defaults (``fuse_mask_lag``,
  ``pipeline_depth`` 4), batched object tracking, 320-pixel object windows,
  two object slots -- and its drain schedule: 14 warm-up frames draining
  the pipeline after every 4th and at the end, then the median of 3
  windows of 12 frames, each window ending with a drain; with the live
  models after the warm-up (``n_models``, as bench.py) and at the end
  (``n_models_end``), and how many timed frames tracked, projected and
  fused their objects in their windows (``windowed_frames``);
- ``slam_fps_640x480_two_objects_sync``: the same in the synchronous
  schedule (``pipelined_multiobject=False``), with the same extras;
- ``slam_fps_640x480_nn_in_loop``: bench.py's SLAM-plus-NN line
  (bench.py:265-348), its configuration unchanged: the multi-object engine
  at the ``Config`` defaults (pipelined, prefused) with a 2^22-surfel
  global map on ``make_frames``' frames with no masks, labelled by the
  full-width Mask R-CNN (seeded random weights, score threshold 0.999) on
  its worker thread and CUDA stream through a 5-frame delay queue, pumped
  without blocking; 6 warm-up frames, then the median of 3 windows of 20,
  each ending with the queue's flush, a drain and a synchronise; with the
  frames that left the queue labelled (``nn_labelled``), the network's
  input size and classes (``nn_px``, ``nn_classes``) and the timed frames'
  host stages that waited on the card (``forced_waits``);
- ``slam_fps_640x480_static``, printed last: bench.py's headline, the
  -static frame with a 2^22-surfel map; 8 warm-up frames, then the median of
  5 windows of 20 frames (five rather than bench.py's three: one run's
  windows spread by up to 1.3x on the card).

In each timed window the next frame's upload is staged while the current
one runs (``upload_frame``), and the clock stops once the window's last
frame has come back (``flush_diagnostics``, which also finishes pending
pipelined frames, and a device synchronise).

The frame generators are bench.py's ``make_frames`` and
``make_two_object_frames``, with the parts of
``maskfusion_tpu/tools/make_sequence.py`` they use, giving the same arrays.
No failure is caught: any exception ends the run with a non-zero exit.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from maskfusion_tpu_torch.frame import FrameData

BASELINE_FPS = 30.0

VGA = (640, 480)
STATIC_INTRINSICS = (528.0, 528.0, 320.0, 240.0)
STATIC_WARM, STATIC_TIMED, STATIC_WINDOWS = 8, 20, 5
TWO_OBJECT_WARM, TWO_OBJECT_TIMED, TWO_OBJECT_WINDOWS = 14, 12, 3
STATIC_FRAMES = STATIC_WARM + STATIC_TIMED * STATIC_WINDOWS
TWO_OBJECT_FRAMES = TWO_OBJECT_WARM + TWO_OBJECT_TIMED * TWO_OBJECT_WINDOWS
NN_WARM, NN_TIMED, NN_WINDOWS, NN_QUEUE = 6, 20, 3, 5
NN_FRAMES = NN_WARM + NN_TIMED * NN_WINDOWS


# ---------------------------------------------------------------- frames
def make_frames(width: int, height: int, n: int) -> List[FrameData]:
    """bench.py's make_frames: a tilted wavy depth ramp as uint16
    millimetres (the sensor's wire format, uploaded raw) and a textured
    colour ramp, timestamped by index."""
    u, v = np.meshgrid(np.arange(width), np.arange(height))
    frames = []
    for i in range(n):
        depth = (
            1.5 + 0.0004 * u + 0.0003 * v
            + 0.08 * np.sin(u * 0.03 + i * 0.02) * np.cos(v * 0.04)
        ).astype(np.float32)
        depth_mm = np.round(depth * 1000.0).astype(np.uint16)
        rgb = np.stack(
            [(u * 3 + 5 * i) % 256, (v * 2) % 256, (u + v) % 256], -1
        ).astype(np.uint8)
        frames.append(FrameData(rgb=rgb, depth=depth_mm, timestamp=float(i)))
    return frames


def rodrigues(rvec) -> np.ndarray:
    """Rotation matrix of a rotation vector (make_sequence._rot)."""
    th = np.linalg.norm(rvec)
    if th < 1e-12:
        return np.eye(3)
    k = np.asarray(rvec) / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def camera_pose(s: float) -> np.ndarray:
    """make_sequence.camera_pose: an aggressive smooth loop over s in
    [0, 1]."""
    w = 2 * np.pi * s
    t = np.array([0.22 * np.sin(w), 0.15 * np.sin(2 * w + 1.0),
                  0.10 * np.sin(w)])
    rvec = np.array([0.10 * np.sin(w + 0.5), 0.24 * np.sin(w),
                     0.08 * np.sin(2 * w)])
    T = np.eye(4, dtype=np.float64)
    T[:3, :3] = rodrigues(rvec)
    T[:3, 3] = t
    return T


def make_points(width: int):
    """make_sequence.make_points: a dense wavy textured background and a
    textured object patch, ~6 points a pixel at VGA."""
    n_u = int(width * 3.4)
    n_v = int(n_u * 0.8)
    x = np.linspace(-1.35, 1.35, n_u)
    y = np.linspace(-1.05, 1.05, n_v)
    X, Y = np.meshgrid(x, y)
    Z = 2.0 + 0.22 * np.sin(2.3 * X) * np.cos(1.9 * Y) + 0.06 * np.sin(7 * X)
    pts_bg = np.stack([X, Y, Z], -1).reshape(-1, 3).astype(np.float32)
    r = 127.5 + 90 * np.sin(9 * X) + 30 * np.cos(17 * Y)
    g = 127.5 + 90 * np.cos(7 * Y) + 25 * np.sin(13 * X)
    b = 127.5 + 80 * np.sin(5 * (X + Y))
    cols_bg = np.stack([r, g, b], -1).reshape(-1, 3).clip(0, 255).astype(
        np.uint8)

    n = int(width * 1.6)
    ox = np.linspace(-0.28, 0.28, n)
    oy = np.linspace(-0.21, 0.21, int(n * 0.75))
    OX, OY = np.meshgrid(ox, oy)
    OZ = 1.45 + 0.10 * np.sin(4.5 * OX) + 0.08 * np.cos(5.5 * OY)
    pts_obj = np.stack([OX + 0.12, OY - 0.06, OZ], -1).reshape(-1, 3).astype(
        np.float32)
    orr = 127.5 + 110 * np.sin(15 * OX)
    og = 127.5 + 110 * np.cos(12 * OY)
    ob = np.full_like(orr, 70.0)
    cols_obj = np.stack([orr, og, ob], -1).reshape(-1, 3).clip(0, 255).astype(
        np.uint8)
    return pts_bg, cols_bg, pts_obj, cols_obj


def render_points(pts, cols, pose_c2w, fx, fy, cx, cy, w, h, labels=None):
    """make_sequence.render (and tests/synthetic.py's render): a z-buffer
    point render where, among the points within 0.5% of a pixel's nearest
    depth, the one projecting closest to the pixel centre wins.  Returns
    rgb uint8, metric depth (0 = empty)[, labels]."""
    T = np.asarray(pose_c2w, np.float64)
    p_cam = (pts - T[:3, 3]) @ T[:3, :3]
    z = p_cam[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        uf = p_cam[:, 0] * fx / z + cx
        vf = p_cam[:, 1] * fy / z + cy
        u = np.round(uf).astype(np.int64)
        v = np.round(vf).astype(np.int64)
    ok = (z > 0.05) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    lin = v[ok] * w + u[ok]
    zok = z[ok].astype(np.float32)
    zbuf = np.full(h * w, np.inf, np.float32)
    np.minimum.at(zbuf, lin, zok)
    near = zok <= zbuf[lin] * (1 + 5e-3)
    du = uf[ok] - np.round(uf[ok])
    dv = vf[ok] - np.round(vf[ok])
    key = np.where(near, (du * du + dv * dv).astype(np.float32), np.inf)
    best = np.full(h * w, np.inf, np.float32)
    np.minimum.at(best, lin, key)
    win = near & (key <= best[lin])
    rgb = np.zeros((h * w, 3), np.uint8)
    rgb[lin[win]] = cols[ok][win]
    depth = np.zeros(h * w, np.float32)
    depth[lin[win]] = zok[win]
    out = [rgb.reshape(h, w, 3), depth.reshape(h, w)]
    if labels is not None:
        lab = np.zeros(h * w, np.uint8)
        lab[lin[win]] = labels[ok][win]
        out.append(lab.reshape(h, w))
    return tuple(out)


def make_two_object_frames(width: int, height: int, n: int,
                           count: Optional[int] = None):
    """bench.py's make_two_object_frames: a textured wavy background and two
    independently moving textured patches under an aggressive camera loop,
    with uint16-millimetre depth, per-pixel labels and class ids [0, 7, 8].
    The motion spans `n` frames; the first `count` (all by default) are
    rendered.  Returns the frames and the intrinsics (fx, fy, cx, cy)."""
    pts_bg, cols_bg, pts_o1, cols_o1 = make_points(width)
    # second object: recoloured copy of the patch, offset in x/y
    pts_o2 = pts_o1 + np.array([-0.55, 0.18, 0.05], np.float32)
    cols_o2 = cols_o1[:, ::-1]
    labels = np.concatenate([
        np.zeros(len(pts_bg), np.uint8),
        np.full(len(pts_o1), 1, np.uint8),
        np.full(len(pts_o2), 2, np.uint8)])
    cols = np.concatenate([cols_bg, cols_o1, cols_o2])
    fx = fy = 0.825 * width
    cx, cy = width / 2.0, height / 2.0
    frames = []
    for i in range(n if count is None else count):
        s = i / max(n - 1, 1)
        cam = camera_pose(0.25 * s)
        off1 = np.array([0.10 * np.sin(2 * np.pi * s), 0.0, 0.0], np.float32)
        off2 = np.array([0.0, 0.06 * np.sin(2 * np.pi * s + 1.0), 0.0],
                        np.float32)
        pts = np.concatenate([pts_bg, pts_o1 + off1, pts_o2 + off2])
        rgb, depth, lab = render_points(pts, cols, cam, fx, fy, cx, cy,
                                        width, height, labels)
        depth_mm = np.round(depth * 1000.0).astype(np.uint16)
        frames.append(FrameData(rgb=rgb, depth=depth_mm, mask=lab,
                                class_ids=[0, 7, 8], timestamp=float(i)))
    return frames, (fx, fy, cx, cy)


# ------------------------------------------------------------ measuring
def device_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them; "cpu" for
    the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(device.index or 0)],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def _wait(engine) -> None:
    """Until the engine's queued work has come back."""
    engine.flush_diagnostics()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)


def warm_up(engine, frames: List[FrameData], drain_every: int = 0) -> None:
    """Run the untimed first frames (frames[0] initialises the map),
    finishing the pending pipelined frames after every `drain_every`-th
    (bench.py drains every 4th so spawns and windows settle before the
    clock starts)."""
    for i, f in enumerate(frames):
        engine.process_frame(f)
        if drain_every and i % drain_every == drain_every - 1:
            engine.drain_pipeline()
    _wait(engine)


def timed_windows(engine, frames: List[FrameData], n_timed: int,
                  n_windows: int) -> List[float]:
    """Frames per second of `n_windows` consecutive windows of `n_timed`
    frames each.  In a window each frame's upload is staged while the
    previous frame runs; its clock stops once the last frame has come
    back."""
    if len(frames) < n_timed * n_windows:
        raise ValueError(f"{len(frames)} frames given, "
                         f"{n_timed * n_windows} needed")
    fps = []
    for w in range(n_windows):
        window = frames[w * n_timed:(w + 1) * n_timed]
        t0 = time.perf_counter()
        staged = engine.upload_frame(window[0])
        for nxt in window[1:]:
            nxt_staged = engine.upload_frame(nxt)
            engine.process_frame(staged)
            staged = nxt_staged
        engine.process_frame(staged)
        _wait(engine)
        fps.append(n_timed / (time.perf_counter() - t0))
    return fps


def fps_line(metric: str, fps: List[float], device: str, **extra) -> dict:
    """One bench line: the median of the windows against the 30 FPS
    target."""
    value = float(np.median(fps))
    return {"metric": metric, "value": round(value, 3), "unit": "frames/s",
            "vs_baseline": round(value / BASELINE_FPS, 4),
            "reps": [round(f, 3) for f in fps], **extra, "device": device}


def static_config():
    from maskfusion_tpu_torch.config import Config

    return Config(static_mode=True, global_surfel_capacity=1 << 22)


def two_object_config(pipelined: bool = True):
    """bench.py's two-object configuration (bench.py:201-211), unchanged:
    the pipelined schedule with fuse_mask_lag and pipeline_depth at their
    defaults; batch_object_tracking and the 320-pixel object window stay at
    theirs.  `pipelined=False` switches only the schedule, to the
    synchronous one."""
    from maskfusion_tpu_torch.config import Config

    return Config(global_surfel_capacity=1 << 22,
                  object_surfel_capacity=1 << 19, seg_method="maskfusion",
                  model_spawn_offset=2, pipelined_multiobject=pipelined,
                  min_object_slots=2)


def bench_static(device="cuda",
                 frames: Optional[List[FrameData]] = None) -> dict:
    """The static headline line at 640x480 (bench.py's main)."""
    from maskfusion_tpu_torch.camera import CameraIntrinsics, Resolution
    from maskfusion_tpu_torch.engine import MaskFusion

    if frames is None:
        frames = make_frames(*VGA, STATIC_FRAMES)
    engine = MaskFusion(Resolution(*VGA), CameraIntrinsics(*STATIC_INTRINSICS),
                        static_config(), device=device)
    warm_up(engine, frames[:STATIC_WARM])
    fps = timed_windows(engine, frames[STATIC_WARM:], STATIC_TIMED,
                        STATIC_WINDOWS)
    return fps_line("slam_fps_640x480_static", fps, device_line(device))


def bench_two_objects(device="cuda", frames=None, intrinsics=None,
                      pipelined: bool = True) -> dict:
    """The two-object line at 640x480 (bench.py's bench_two_objects), or
    with `pipelined=False` its synchronous form.  `frames` and
    `intrinsics`, when given, are make_two_object_frames(640, 480,
    TWO_OBJECT_FRAMES)'s."""
    from maskfusion_tpu_torch.camera import CameraIntrinsics, Resolution
    from maskfusion_tpu_torch.engine import MaskFusion

    if frames is None:
        frames, intrinsics = make_two_object_frames(
            *VGA, TWO_OBJECT_FRAMES)
    engine = MaskFusion(Resolution(*VGA), CameraIntrinsics(*intrinsics),
                        two_object_config(pipelined), device=device)
    warm_up(engine, frames[:TWO_OBJECT_WARM], drain_every=4)
    n_models = len(engine.models)
    windowed = engine.windowed_fuses
    fps = timed_windows(engine, frames[TWO_OBJECT_WARM:], TWO_OBJECT_TIMED,
                        TWO_OBJECT_WINDOWS)
    # live models after the warm-up (bench.py's n_models) and at the end
    metric = "slam_fps_640x480_two_objects" + ("" if pipelined else "_sync")
    return fps_line(metric, fps, device_line(device), n_models=n_models,
                    n_models_end=len(engine.models),
                    windowed_frames=engine.windowed_fuses - windowed)


def nn_config():
    """bench.py's SLAM-plus-NN engine configuration (bench.py:286-287)."""
    from maskfusion_tpu_torch.config import Config

    return Config(global_surfel_capacity=1 << 22, seg_method="maskfusion",
                  pipelined_multiobject=True)


def bench_nn_in_loop(device="cuda", frames=None, intrinsics=None) -> dict:
    """SLAM and the asynchronous Mask R-CNN sharing the card
    (bench.py's bench_nn_in_loop): the reference's NN lane (the worker of
    MaskRCNN.cpp:178-208 behind the delay queue) inside the frame loop at
    the reference's scale (512 px, 81 classes).  `frames` default to
    make_frames(640, 480, NN_FRAMES) at bench.py's static intrinsics; their
    masks are dropped.  The network is the full-width one with seeded
    random weights (latency does not depend on the weights) at score
    threshold 0.999, so the noise detections leave the SLAM side on its
    static scene.  The queue holds 5 frames, not the production 30: the
    run is short, and a 30-slot queue would never overflow, gating SLAM on
    the network for every frame instead of exercising the reference's lag
    semantics (frames leave unlabelled when the network falls more than the
    queue's depth behind, MaskFusion.cpp:206-209)."""
    import dataclasses

    from maskfusion_tpu_torch.camera import CameraIntrinsics, Resolution
    from maskfusion_tpu_torch.engine import MaskFusion
    from maskfusion_tpu_torch.maskrcnn.inference import (
        FrameQueue, MaskRCNNInference, MaskRCNNWorker)
    from maskfusion_tpu_torch.maskrcnn.model import MaskRCNNConfig

    if frames is None:
        frames = make_frames(*VGA, NN_FRAMES)
        intrinsics = STATIC_INTRINSICS
    if len(frames) < NN_FRAMES:
        raise ValueError(f"{len(frames)} frames given, {NN_FRAMES} needed")
    frames = [dataclasses.replace(f, mask=None, class_ids=None)
              for f in frames[:NN_FRAMES]]
    h, w = frames[0].rgb.shape[:2]
    engine = MaskFusion(Resolution(w, h), CameraIntrinsics(*intrinsics),
                        nn_config(), device=device)
    inference = MaskRCNNInference(MaskRCNNConfig(score_threshold=0.999),
                                  device=device)
    queue = FrameQueue(NN_QUEUE)
    worker = MaskRCNNWorker(inference, queue)
    labelled = 0

    def consume(out):
        nonlocal labelled
        if out is not None:
            labelled += out.mask is not None
            engine.process_frame(out)

    def pump(frame):
        # non-blocking: push, then process whatever the delay queue
        # releases (a labelled head, or the head of a full queue)
        worker.check()
        queue.push(frame)
        consume(queue.pop_ready())

    def drain():
        # end of a window: the remaining frames leave unlabelled where the
        # network has not reached them, as a full queue would release them
        while len(queue):
            consume(queue.pop_ready(flush=True))
        engine.drain_pipeline()
        _wait(engine)

    fps, waits = [], 0
    try:
        for f in frames[:NN_WARM]:
            pump(f)
        drain()
        for k in range(NN_WINDOWS):
            window = frames[NN_WARM + k * NN_TIMED:
                            NN_WARM + (k + 1) * NN_TIMED]
            t0 = time.perf_counter()
            for f in window:
                w0 = engine.forced_waits
                pump(f)
                waits += engine.forced_waits - w0
            drain()
            fps.append(len(window) / (time.perf_counter() - t0))
    finally:
        worker.stop()
    # forced_waits: host stages of the timed frames that found their
    # frame's results not landed and waited (the windows' drains excluded)
    return fps_line("slam_fps_640x480_nn_in_loop", fps, device_line(device),
                    nn_labelled=labelled, nn_px=inference.cfg.image_size,
                    nn_classes=inference.cfg.num_classes,
                    forced_waits=waits)


def main() -> int:
    if not torch.cuda.is_available():
        print("maskfusion_tpu_torch.bench: no CUDA card (torch.cuda."
              "is_available() is false); the bench measures the card",
              file=sys.stderr)
        return 2
    print(json.dumps(bench_two_objects()), flush=True)
    print(json.dumps(bench_two_objects(pipelined=False)), flush=True)
    print(json.dumps(bench_nn_in_loop()), flush=True)
    print(json.dumps(bench_static()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
