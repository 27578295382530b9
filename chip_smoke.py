#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py [--vga-sequence]

Phases (each prints a progress line first, so a cut run shows where it
stopped; any failure raises and exits non-zero):
  0. the card: nvidia-smi name and power limit, torch's device name;
  1. build the hand-written kernels from maskfusion_tpu_torch/csrc;
  2. each kernel against its plain PyTorch version at the main path's
     shapes (640x480; the scan also on the 160x120 synthetic scene): depth
     agreement, the scan's winner ids (check_scan), kernel and plain times,
     the card's bound, and each kernel's registers, shared memory, spills
     (ptxas -v) and launch grid.  Each kernel is timed hot (the same inputs
     launch after launch, served from L2) and cold (time_ms_cold: a rotation
     of input copies larger than the L2, as the engine finds its inputs);
     the cold time is the one held against the bound;
  3. the -static engine at 640x480 with a 2^22-surfel map on bench.py's
     synthetic frames: 8 warm-up and 20 timed frames, FPS and the kernels'
     launch counts over that run; then per-stage device times (CUDA events,
     6 frames) and a torch.profiler view of 3 frames (device busy share,
     runtime calls per frame);
  4. 6 frames of a 160x120 synthetic trajectory through the port on the
     card and on the CPU (plain kernel versions): per-frame pose agreement
     and the trajectory error against ground truth;
  5. kernel 3 (the geometric edge map) against its plain version on the
     level-0 maps of bench.py's first two-object frame at 640x480 and on the
     120x160 synthetic maps, with a SHA-256 of the kernel's output on each
     (two builds that agree bit for bit print the same digests), timed as
     the others and beside one PyTorch call that only moves the same bytes
     (move_floor); then the host segmentation of the next frame on the
     native library (mfcore) and on its numpy versions, in turns;
  6. the synchronous multi-object engine at 640x480 in bench.py's
     two-object configuration (2^22 global and 2^19 object surfels, two
     object slots; objects tracked in one solve and fused in 320x320
     windows) on bench.py's two-object frames: 14 warm-up and 12 timed
     frames, FPS, the three kernels' launch counts over that run, the run
     reaching 3 models, the frames whose objects fused in their windows;
     kernel 2 on object 1's full-frame index map and on its window-shaped
     one (320x320, principal point shifted; live share, check_scan,
     times); then a torch.profiler view (2 frames) and one of the per-model
     loop (batch_object_tracking=False, the next 2 frames on the same
     engine): launches per frame of both forms side by side; then
     per-stage device and host times (4 frames);
  6b. the main path: the pipelined, prefused engine (the Config default) at
     640x480 in bench.py's two-object configuration verbatim, on phase 6's
     frames: 14 warm-up frames draining every 4th as bench.py does, then 12
     timed; FPS, the three kernels' launches over that run (every kernel
     record's `launches`), the models after the warm-up and at the end,
     the frames tracked, projected and fused in windows, and a
     torch.profiler view of 4 more frames (launches and synchronises a
     frame, device busy share) whose synchronises must all be forced
     drains;
  7. 7 frames of a 160x120 two-object scene through the multi-object engine
     on the CPU, and on the card from the CPU's state after both spawns, in
     three forms: the per-model loop, the batched windowed passes (a
     104-pixel window, margin 24, as tests/test_engine_pipelined.py), and
     the prefused schedule with the same window (each frame finished
     before the next, as the CPU finishes it): per frame the same model and
     class ids and the global pose within 1 mm / 0.05 deg; up to frame 4,
     object poses within 8 mm and surfel counts within 1% (the bounds of
     the port's lockstep test against the JAX engine); the later frames,
     each run's object error against the scene's motion and a card run
     from frame 0 are reported;
  8. the -static CLI (maskfusion_tpu_torch.main) on a raw KLG log of phase
     3's frames, as a user runs it and without OpenCV: one bilateral and
     one scan launch a frame, TUM poses within 1 mm / 0.05 deg of phase 3's
     direct run, a PLY cloud within 1% of its confident surfels; then again
     with those poses as ground truth (-p): logged poses equal to their
     inputs within 1e-5, the scan running on every frame; then `--nn` in
     the multi-object default on the log's first 12 frames with a 5-frame
     delay queue: the full-width Mask R-CNN (seeded random weights) labels
     at least one frame on its thread and stream, every frame is
     processed, the queue drains, poses and the FPS line are written;
  9. the port bench's four lines (maskfusion_tpu_torch.bench) on the
     frames rendered above: the two-object line in bench.py's pipelined
     configuration (phase 6b's) and in the synchronous one (phase 6's),
     each with its models and windowed frames, the SLAM-plus-NN line
     (labelling at least one frame), and the static headline, each the
     median of its timed windows;
 10a. the trained rich Mask R-CNN checkpoint (f32, carried by the port's
     converter) on the card against the port's CPU forward on 4 seeded
     scenes (the same detections and classes, box IoU >= 0.98, mask logits
     within 1e-3, id images equal on >= 99.5%), and its held-out quality on
     the card against tests/test_maskrcnn_train.py's floors;
 10b. the full-width network (ResNet-50-FPN, 512 px, 81 classes, bf16,
     seeded): the serving call's wall time and the card's busy time a
     forward, launches and synchronises a forward (none), the NMS loops' share of
     the launches, weights and peak memory, the MAC count and its bound at
     the bf16 peak; P2..P6 within 3e-2 (relative L2) of an f32 forward of
     the same weights, every output finite.
 11a. one train step (create_train_step) at micro_config(64) on the card
     and on the CPU from the same parameters, batch and draws: the loss
     within 1e-4 relative, each parameter's gradient within 1e-3 relative
     L2 (the whole within 1e-4);
 11b. the shapes recipe (train_shapes, 700 steps) on the card, ms a step,
     and its held-out quality on the card against the floors of
     tests/test_maskrcnn_train.py (det IoU 0.5, class accuracy 0.75, mask
     IoU 0.5, mean score 0.55) and the slow test's loss criterion;
 11c. the full-width train step (ResNet-50-FPN, 512 px, 81 classes, bf16
     over float32 parameters, batch 2 of make_batch), 10 steps on one
     batch: finite losses that fall, wall and card-busy ms a step,
     launches and synchronises a step (none), peak memory, MACs against
     the bf16 bound;
 12. -method cofusion: at 640x480 on bench.py's two-object frames without
     their masks (FPS over 12 timed frames, the models, the kernels'
     launches: no edge map; synchronises a frame); on the 160x120
     two-object scene card against CPU from a carried state (model ids,
     poses); through the CLI on a raw KLG log of phase 8's first 12
     frames;
 13a. the deformation graph at the CLI's default map size (9,437,184 slots,
     9,000,000 live surfels on the card): optimise() at 1024 nodes and
     which solver ran, apply_to_map_device over the whole map and
     apply_to_points on 100,000 points, timed; the device blend within
     1e-5 of the host blend on 100,000 rows, the dead rows bit-equal;
 13b. relocalisation at 640x480: the -static engine with ferns (the
     synchronous step) gets lost on blind frames and recovers the revisit
     within 2 cm, with its frame's launches and synchronises; then phase
     6's multi-object engine with relocalisation and loop closure (the
     synchronous frame): FPS, launches and synchronises a frame beside
     phase 6's, each kernel launching;
 13c. the 160x120 relocalisation scenario on the card and the CPU: the
     same lost / recovery verdicts and fern frames, poses within 1 mm /
     0.05 deg;
 13d. `-static -rl` through the CLI on phase 8's log, then the same run
     saved half way (--save-state) and resumed (--load-state): the resumed
     poses within 1e-5 m of the uninterrupted run's;
 15a. the viewer (viewer.render_map_view) at 160x120, card against CPU:
     a map the CPU -static engine built in two frames, carried to a card
     engine (convert), rendered from the live pose and from an orbit pose:
     depth within 1e-5 on all but 3e-3 of the pixels, ties (the winner
     differs) on at most fault 4's 3.09%, colour within one level off
     them; one scan launch a render;
 15b. the viewer at 640x480 at the CLI's default capacities (9,437,184
     global, 1<<20 object surfels) on the -static engine and on the
     prefused multi-object engine (its pending frames left pending):
     render_map_view's time over the engine's bucket (map_extent, which
     must bound the count) and over the whole capacity (CUDA events), the
     three kernels' launches in one LiveViewer frame and one viewport, the
     canvas with its model strip;
 15c. `-static -viewer -ev` through the CLI with no capacity flag on phase
     8's log: rc 0, poses within 1e-5 m of phase 8's run at 2^22 surfels,
     one Viewport*.png a frame, the launches, peak memory;
 15d. the soak (scripts/soak_capacity.py on the card): 150 wide-sweep
     frames through the -static engine at 9,437,184 slots; count, bucket
     and ms a frame every 10 frames, the buckets visited (at least two),
     FPS, peak memory, the first 120 frames' buckets beside the JAX run's
     (PARITY.md);
 15e. live capture: 20 of phase 3's frames through OpenNI2LiveReader over
     a fake `openni` binding that paces itself on the reader, into the
     -static engine: indices increasing, stop() joins, poses within 1e-5 m
     of the same frames fed directly, the launches of the live run alone;
 16a. the object models split over a models mesh (parallel.multimodel:
     every card, or cuda:0 twice on one card) at 640x480 in bench.py's
     two-object configuration (prefused) on phase 6b's first 12 frames,
     against the same engine without a mesh, each frame finished before
     the next: the same model ids, the global and object poses within
     1e-5 m up to frame 4 and within 1 mm / 0.05 deg and 8 mm after; both
     runs' ms a frame, the kernels' launches and peak MB per device; then
     one more prefused frame of the split engine profiled: launches,
     device busy time, synchronises (forced drains only).  Then a mesh of
     the card and the CPU (real copies between devices; the CPU block
     runs the kernels' plain versions) on phase 7's 160x120 scene, in the
     synchronous schedule and the prefused one, against the unsplit
     engine on the card: the same ids, the global pose at phase 7's
     bounds, objects within 0.1 mm and counts within 1% up to frame 3, the
     second slot's state left on the CPU;
 16b. the sharded train step (create_train_step(..., mesh=)) over NCCL at
     world size = the card count, spawned through parallel.launch: two
     micro_config(64) steps against the one-card step (after each step
     the loss within 1e-5 relative, the parameters within the CPU test's
     bounds); one full-width step at 512 px, batch 2: wall ms,
     synchronises (none), peak MB a card; with one card the multi-card
     branch is reported as not run;
 16c. parallel.dryrun.entry()'s forward on the card: finite outputs;
 14. with --vga-sequence only (about 110 s more; after phase 16): the
     sequence-level check at 640x480, make_sequence's 200 frames through
     the CLI with -method precomputed as scripts/parity_vga.py runs it: camera ATE-RMSE, object
     displacement RMSE and instance IoU, held within 2x of the JAX
     package's (PARITY.md).
The last lines are the four bench lines, the card's nvidia-smi line, one
JSON line of kernel records, and {"ok": true, "device": {...}}.

The script imports nothing of JAX or of the JAX package, and refuses to run
without a CUDA card or outside a checkout of the repository.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): the bound of a kernel is the
# larger of its bytes over the memory rate and its FP32 operations over the
# FP32 rate outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_BF16_S = 989e12         # dense tensor-core bf16 (phase 10b's bound)
L2_BYTES = 50 * 2 ** 20      # the H100's L2 (data sheet), where torch does
                             # not report it
COLD_L2_FACTOR = 1.5         # a cold rotation's copies hold 1.5x the L2

BILATERAL_OPS_PER_TAP = 9   # 2 sub/mul for the range term, 2 for space and
                            # sum, exp, 1 mul + 2 adds of the accumulation
SCAN_OPS_PER_PIXEL = 10     # the pixel ray
SCAN_OPS_PER_LIVE_TAP = 27  # two dots, divide, hit, miss^2, r^2, 4 compares
EDGE_OPS_PER_NEIGHBOUR = 17  # side: 3 sub, 3 mul, 2 add; concavity: 3 mul,
                             # 2 add, 1 sub; the gate, |side|, 2 maxima
EDGE_OPS_PER_PIXEL = 8 * EDGE_OPS_PER_NEIGHBOUR + 3   # 2 weights, the clamp


def log(msg: str) -> None:
    print(msg, flush=True)


_START = time.perf_counter()


def log_phase(msg: str) -> None:
    """A phase's header, with the seconds since the script started."""
    log(f"{msg} [{time.perf_counter() - _START:.1f} s]")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def time_ms(fn, reps: int, windows: int = 5, warm_s: float = 0.3):
    """Device time of fn() from CUDA events: after `warm_s` seconds of calls
    (the card's clocks ramp up under load), the mean over `reps` calls in
    each of `windows` windows.  Each window is queued behind a device-side
    sleep of at least twice the host's time to issue it, so its launches run
    back to back and it holds no host time.  Returns (median of the windows,
    the windows, whether every window's sleep outlasted its issue)."""
    import torch

    calls, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < warm_s:
        fn()
        torch.cuda.synchronize()
        calls += 1
    host_ms = (time.perf_counter() - t0) * 1e3 / calls
    sleep_cycles = int(2 * host_ms * reps * 2e6)   # 2 GHz: the top clock
    out, queued = [], True
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        queued = queued and not start.query()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return float(np.median(out)), out, queued


def cold_copies(nbytes: int, l2_bytes: int = L2_BYTES) -> int:
    """Copies of a kernel's inputs (`nbytes` each) that a cold rotation
    cycles through: together at least COLD_L2_FACTOR times the L2, so each
    launch finds its inputs evicted by the launches of the other copies."""
    return max(2, math.ceil(COLD_L2_FACTOR * l2_bytes / nbytes))


def tensor_bytes(args) -> int:
    """Bytes of the tensors among `args`."""
    import torch

    return sum(a.numel() * a.element_size() for a in args
               if isinstance(a, torch.Tensor))


def time_ms_cold(fn, args, reps: int = 50, windows: int = 5):
    """time_ms of fn(*args) with a cold L2, as the engine's caller finds
    the inputs: every launch takes the next of cold_copies(...) copies of the
    tensors among `args` (the other arguments shared), in rotation.  Returns
    (median of the windows, the windows, whether every window was queued,
    the number of copies)."""
    import torch

    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 0)
    n = cold_copies(tensor_bytes(args), l2 or L2_BYTES)
    turn = cold_rotation(args, n)
    ms, out, queued = time_ms(lambda: fn(*turn()), reps, windows)
    return ms, out, queued, n


def cold_rotation(args, n: int):
    """`n` copies of the tensors among `args` (the other arguments
    shared): each call of the returned function gives the next copy's
    arguments, in rotation."""
    import torch

    copies = [tuple(a.clone() if isinstance(a, torch.Tensor) else a
                    for a in args) for _ in range(n)]
    turn = itertools.cycle(copies)
    return lambda: next(turn)


def timing_fields(ms: float, ms_win, cold) -> dict:
    """A kernel record's times: the hot `ms` (inputs reused launch after
    launch, so they sit in L2) and the cold `ms_cold` (time_ms_cold)."""
    ms_cold, cold_win, cold_queued, n = cold
    return {"ms": ms, "ms_windows": ms_win, "ms_cold": ms_cold,
            "ms_cold_windows": cold_win, "cold_copies": n,
            "cold_windows_queued": cold_queued}


def hot_label(rec: dict) -> str:
    """'L2-resident' where the hot time is under the HBM byte bound, which
    only inputs served from L2 can beat: no share of the bound then."""
    if rec["ms"] < rec["bytes"] / PEAK_BYTES_S * 1e3:
        return "L2-resident"
    return f"{rec['bound_ms'] / rec['ms']:.0%} of the bound"


def log_times(name: str, rec: dict) -> None:
    log(f"  {name}: cold {rec['ms_cold'] * 1e3:.2f} us (windows "
        f"{', '.join(f'{w * 1e3:.2f}' for w in rec['ms_cold_windows'])}; "
        f"{rec['cold_copies']} input copies), "
        f"{rec['bound_ms'] / rec['ms_cold']:.0%} of the bound; hot "
        f"{rec['ms'] * 1e3:.2f} us (windows "
        f"{', '.join(f'{w * 1e3:.2f}' for w in rec['ms_windows'])}; "
        f"{hot_label(rec)}); plain {rec['plain_ms']:.2f} ms; bound "
        f"{rec['bound_ms'] * 1e3:.2f} us by {rec['bound_by']}")


def move_floor(vmap, nmap) -> dict:
    """Hot and cold times of one PyTorch call that moves the edge map's
    bytes and computes nothing of it: the z of both maps summed into one
    float a pixel reads every 32-byte sector of both interleaved maps and
    writes H x W floats.  A yardstick of what launching and moving those
    bytes costs under time_ms."""
    import torch

    def fn(v, n):
        return torch.add(v[..., 2], n[..., 2])

    ms, _, _ = time_ms(lambda: fn(vmap, nmap), 50)
    cold = time_ms_cold(fn, (vmap, nmap))
    return {"move_floor_ms": ms, "move_floor_ms_cold": cold[0]}


def digest(t) -> str:
    """SHA-256 of a tensor's bytes: the bit-for-bit evidence that two
    builds give the same output."""
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()


# ---------------------------------------------------------------- inputs
# bench.py's frame generators (make_frames, make_two_object_frames) and the
# point renderer live in maskfusion_tpu_torch.bench; the 160x120 scenes
# below are tests/synthetic.py's
def wavy_scene():
    """tests/synthetic.make_scene: a dense textured wavy surface ~2 m in
    front of the origin."""
    x = np.linspace(-1.6, 1.6, 700)
    y = np.linspace(-1.3, 1.3, 560)
    X, Y = np.meshgrid(x, y)
    Z = (2.0 + 0.25 * np.sin(2.2 * X) + 0.18 * np.cos(3.1 * Y)
         + 0.05 * np.sin(7 * X * Y))
    pts = np.stack([X, Y, Z], -1).reshape(-1, 3).astype(np.float32)
    r = 127.5 + 60 * np.sin(4.0 * X) * np.cos(3.0 * Y) + 60 * np.sin(45.0 * X)
    g = 127.5 + 60 * np.sin(2.5 * X + 1.0) + 60 * np.cos(38.0 * Y)
    b = 127.5 + 60 * np.cos(3.5 * Y + 0.5) + 60 * np.sin(30.0 * (X + Y))
    cols = np.stack([r, g, b], -1).reshape(-1, 3).clip(0, 255).astype(
        np.uint8)
    return pts, cols


SMALL = (130.0, 130.0, 80.0, 60.0, 160, 120)   # fx, fy, cx, cy, w, h


def synthetic_trajectory(n: int = 6):
    """The wavy textured scene and camera path of tests/synthetic.py and
    tests/test_engine_static.py at 160x120."""
    from maskfusion_tpu_torch.bench import render_points, rodrigues

    pts, cols = wavy_scene()
    poses = []
    for i in range(n):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = rodrigues(np.array([0.0, 0.003 * i, 0.0009 * i]))
        T[:3, 3] = [0.004 * i, 0.0, -0.002 * i]
        poses.append(T)
    frames = [render_points(pts, cols, T, *SMALL) for T in poses]
    return poses, frames, SMALL


def synthetic_two_objects(n: int = 7):
    """tests/synthetic.make_scene_with_two_objects at 160x120, the motion of
    tests/test_engine_multimodel.py:172-201 (static camera; object 1 moves
    along +x from frame 1, object 2 along -y from frame 2): rgb, metric
    depth and labels per frame."""
    from maskfusion_tpu_torch.bench import render_points

    pts_bg, cols_bg = wavy_scene()

    def patch(cx, cy, phase, off):
        x = np.linspace(-0.26, 0.26, 320)
        y = np.linspace(-0.20, 0.20, 240)
        X, Y = np.meshgrid(x, y)
        Z = 1.5 + 0.10 * np.sin(4.5 * X + phase) + 0.08 * np.cos(5.5 * Y)
        p = np.stack([X + cx, Y + cy, Z], -1).reshape(-1, 3).astype(
            np.float32) + off.astype(np.float32)
        r = 127.5 + 110 * np.sin(15 * X + phase)
        g = 127.5 + 110 * np.cos(11 * Y)
        c = np.stack([r, g, np.full_like(r, 90.0)], -1).reshape(-1, 3)
        return p, c.clip(0, 255).astype(np.uint8)

    frames = []
    for i in range(n):
        p1, c1 = patch(-0.34, -0.05, 0.0,
                       np.array([0.006 * max(0, i - 1), 0.0, 0.0]))
        p2, c2 = patch(0.38, 0.02, 1.3,
                       np.array([0.0, -0.006 * max(0, i - 2), 0.0]))
        labels = np.concatenate([np.zeros(len(pts_bg), np.uint8),
                                 np.full(len(p1), 1, np.uint8),
                                 np.full(len(p2), 2, np.uint8)])
        frames.append(render_points(
            np.concatenate([pts_bg, p1, p2]),
            np.concatenate([cols_bg, c1, c2]), np.eye(4), *SMALL,
            labels=labels))
    return frames


# depth-differing pixels stay under 3e-3 everywhere; winner ids flip on
# ties far more often on this smooth scene (each surfel rendered back at the
# pose it was made from) than on the VGA bench map, which keeps 3e-3
SYNTHETIC_SCAN_MAX_FLIPS = 5e-2


def synthetic_depth():
    """Frame 0 of synthetic_trajectory with a hole in its depth: rgb,
    metric depth and the intrinsics (fx, fy, cx, cy)."""
    _, frames, (fx, fy, cx, cy, _, _) = synthetic_trajectory(1)
    rgb, depth = frames[0]
    depth = depth.copy()
    depth[20:24, 30:40] = 0.0
    return rgb, depth, (fx, fy, cx, cy)


def synthetic_scan_args(device, h: int = 120, w: int = 160):
    """The scan's arguments on synthetic_depth's surfels rendered back at
    the identity pose, cropped to h x w: (pos, normal, radius, live, intr,
    max_depth), `intr` the (4,) float32 [fx, fy, cx, cy] on the device."""
    import torch

    from maskfusion_tpu_torch.camera import CameraIntrinsics
    from maskfusion_tpu_torch.mapping import surfel_map as sm
    from maskfusion_tpu_torch.ops import kernels
    from maskfusion_tpu_torch.ops import preprocess as pp
    from maskfusion_tpu_torch.ops import splat

    rgb, depth, k = synthetic_depth()
    intr = CameraIntrinsics(*k)
    rgb, depth = rgb[:h, :w].copy(), depth[:h, :w].copy()
    vmap = pp.create_vmap(torch.from_numpy(depth).to(device), intr, 5.0)
    nmap = pp.create_nmap(vmap)
    eye = torch.eye(4, device=device)
    m = sm.init_from_frame(1 << 16, vmap, vmap, nmap,
                           torch.from_numpy(rgb).to(device),
                           torch.zeros(depth.shape, dtype=torch.uint8,
                                       device=device), 0, eye, intr)
    im = splat.render_index_map(m, eye, intr, h, w, 1.0, 200, 5.0)
    return (im.pos.contiguous(), im.normal.contiguous(),
            im.radius.contiguous(), im.index >= 0,
            kernels.intrinsics(intr, device), 5.0)


def synthetic_edge_args(device, h: int = 120, w: int = 160):
    """The edge map's (vmap, nmap) of synthetic_depth, cropped to h x w."""
    import torch

    from maskfusion_tpu_torch.camera import CameraIntrinsics
    from maskfusion_tpu_torch.ops import preprocess as pp

    _, depth, k = synthetic_depth()
    vmap = pp.create_vmap(torch.from_numpy(depth[:h, :w].copy()).to(device),
                          CameraIntrinsics(*k), 5.0)
    return vmap.contiguous(), pp.create_nmap(vmap).contiguous()


# ---------------------------------------------------------------- bounds
def bilateral_bound(H: int, W: int, R: int):
    taps_y = sum(min(y + R, H - 1) - max(y - R, 0) + 1 for y in range(H))
    taps_x = sum(min(x + R, W - 1) - max(x - R, 0) + 1 for x in range(W))
    ops = BILATERAL_OPS_PER_TAP * taps_y * taps_x
    nbytes = H * W * 4 * 2
    return bound_record(ops, nbytes)


def scan_bound(live, window: int = 2):
    """What these inputs need from any implementation: every pixel's live
    byte and its 8 output bytes, pos, normal and radius (28 B) of the live
    texels only; the ray of every pixel and the hit of every live tap."""
    import torch

    H, W = live.shape
    k = 2 * window + 1
    box = torch.nn.functional.conv2d(
        live.to(torch.float32)[None, None],
        torch.ones((1, 1, k, k), device=live.device), padding=window)
    live_taps = int(box.sum().item())
    n_live = int(live.sum().item())
    ops = SCAN_OPS_PER_PIXEL * H * W + SCAN_OPS_PER_LIVE_TAP * live_taps
    nbytes = H * W * (1 + 4 + 4) + n_live * (12 + 12 + 4)
    return bound_record(ops, nbytes)


def edge_bound(vmap):
    """Each map read once (24 B a pixel), the output written once (4 B);
    the neighbour arithmetic runs on the valid interior pixels only."""
    H, W = vmap.shape[:2]
    inner = vmap[1:-1, 1:-1]
    valid = int((inner[..., 0].isfinite() & (inner[..., 2] > 0)).sum().item())
    return bound_record(EDGE_OPS_PER_PIXEL * valid, H * W * (24 + 4))


def bound_record(ops: float, nbytes: float):
    t_ops = ops / PEAK_FP32_S * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": nbytes}


# ---------------------------------------------------------------- checks
def check_scan(args, z, s, zp, sp, window: int = 2,
               max_flips: float = 3e-3) -> dict:
    """Hold the scan kernel's (best_z, best_src) = (z, s) against its plain
    version's (zp, sp) on the same `args`; raise AssertionError outside.

    Depth, as tests/test_pallas.py: fewer than 3e-3 of the pixels differ by
    more than 1e-5.  Winner (best_src picks the normal, colour and
    confidence that combined_predict fetches): s is -1 exactly where z is
    +inf, and every winner is a live tap inside its pixel's window whose
    disk the pixel ray meets within the disk's radius (1e-3 relative slack
    on r^2), at the kernel's z to 1e-5.  Where s differs from sp at equal
    depth, the kernel's tap is thus a true tie; such pixels stay under
    `max_flips` (inclusive).  The hit is recomputed here in float64."""
    import torch

    pos, normal, radius, live, intr, max_depth = args
    fx, fy, cx, cy = intr.tolist()
    H, W = radius.shape
    both_inf = torch.isinf(z) & torch.isinf(zp)
    differ = ~((z - zp).abs() <= 1e-5) & ~both_inf
    frac = float(differ.double().mean().item())
    same = ~differ & torch.isfinite(zp)
    err = float((z - zp).abs()[same].max().item()) if bool(same.any()) \
        else 0.0
    flips = float(((s != sp) & ~differ).double().mean().item())
    if not torch.equal(s >= 0, torch.isfinite(z)):
        raise AssertionError("predict_l0_scan: best_src >= 0 is not where "
                             "best_z is finite")
    won = s >= 0
    yy, xx = torch.meshgrid(torch.arange(H, device=z.device),
                            torch.arange(W, device=z.device), indexing="ij")
    y, x, src = yy[won], xx[won], s[won].long()
    in_window = (((src // W - y).abs() <= window)
                 & ((src % W - x).abs() <= window) & (src < H * W))
    src = torch.where(in_window, src, 0)
    lx = (x.double() - cx) / fx
    ly = (y.double() - cy) / fy
    ray = torch.stack([lx, ly, torch.ones_like(lx)], -1)
    ray = ray / ray.norm(dim=-1, keepdim=True)
    cp = pos.reshape(-1, 3)[src].double()
    cn = normal.reshape(-1, 3)[src].double()
    hit = ray * ((cp * cn).sum(-1) / (ray * cn).sum(-1))[:, None]
    miss2 = ((hit - cp) ** 2).sum(-1)
    r2 = radius.reshape(-1)[src].double() ** 2
    dz = (hit[:, 2] - z[won].double()).abs()
    depth_err = float(dz.max().item()) if bool(won.any()) else 0.0
    bad = ~(in_window & live.reshape(-1)[src] & (miss2 <= r2 * (1 + 1e-3))
            & (dz <= 1e-5) & (z[won] > 0) & (z[won] <= max_depth))
    out = {"differing_fraction": frac, "max_abs_err": err,
           "winner_id_flips": flips, "winner_depth_err": depth_err}
    if bool(bad.any()):
        i = int(bad.nonzero()[0, 0].item())
        raise AssertionError(
            f"predict_l0_scan: {int(bad.sum().item())} winners are no hit "
            f"at their pixel's depth, e.g. pixel ({int(y[i])}, {int(x[i])}) "
            f"-> tap {int(s[won][i])} (in window {bool(in_window[i])}, "
            f"|dz| {float(dz[i]):.3e}); {out}")
    if not (frac < 3e-3 and flips <= max_flips):
        raise AssertionError(
            f"predict_l0_scan disagrees: {frac} of pixels in depth (bound "
            f"3e-3), winner ids at {flips} (bound {max_flips}); {out}")
    return out


def check_edge_map(out, ref) -> dict:
    """Hold the edge kernel's map `out` against its plain version's `ref`,
    as tests/test_pallas.py holds the Pallas kernel: fewer than 3e-3 of the
    pixels differ by more than 1e-5 (the concavity gate on sign(side) flips
    on knife-edge neighbours under another rounding).  Every value is
    finite and in [0, 1].  Raises AssertionError outside."""
    import torch

    d = (out - ref).abs()
    differ = ~(d <= 1e-5)
    frac = float(differ.double().mean().item())
    err = float(d[~differ].max().item()) if bool((~differ).any()) else 0.0
    res = {"differing_fraction": frac, "max_abs_err": err,
           "max_abs_err_all": float(d.max().item())}
    if out.shape != ref.shape or out.dtype != torch.float32:
        raise AssertionError(f"geometric_edge_map: {out.shape} {out.dtype}")
    if not (bool(out.isfinite().all()) and float(out.min()) >= 0.0
            and float(out.max()) <= 1.0):
        raise AssertionError("geometric_edge_map: values outside [0, 1]")
    if not frac < 3e-3:
        raise AssertionError(f"geometric_edge_map disagrees at {frac} of "
                             f"the pixels (bound 3e-3); {res}")
    return res


def build_fields(kernels, name: str, H: int, W: int, param: int) -> dict:
    """A kernel record's registers, shared bytes (static + dynamic) and
    spill bytes, from ptxas -v of this run's build, and its launch at
    (H, W) with radius / window `param`: grid, threads a block, blocks
    resident a SM and the waves they make on this card."""
    import torch

    entry = {"bilateral_depth": f"bilateral_depth_kernelILi{param}E",
             "predict_l0_scan": f"predict_l0_scan_kernelILi{param}E",
             "geometric_edge_map": "geometric_edge_map_kernel"}[name]
    hits = [v for k, v in kernels.kernel_resources().items() if entry in k]
    if len(hits) != 1:
        raise AssertionError(f"{name}: {len(hits)} ptxas entries match "
                             f"{entry!r} in the build log")
    res = hits[0]
    shape = kernels.launch_shape(name, H, W, param)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = shape["grid"][0] * shape["grid"][1]
    return {"regs": res["regs"],
            "smem_bytes": res["smem_static"] + shape["dynamic_smem_bytes"],
            "spills": res["spill_stores"] + res["spill_loads"],
            "grid": shape["grid"], "threads": shape["threads"],
            "blocks_per_sm": shape["blocks_per_sm"],
            "waves": blocks / (sms * shape["blocks_per_sm"])}


def log_build_fields(name: str, rec: dict) -> None:
    log(f"  {name}: {rec['regs']} registers, {rec['smem_bytes']} shared "
        f"bytes, {rec['spills']} spill bytes; grid {rec['grid']} of "
        f"{rec['threads']} threads, {rec['blocks_per_sm']} resident a SM, "
        f"{rec['waves']:.3f} waves")


def scan_record(kernels, args, which: str, window: int = 2) -> dict:
    """Kernel 2 against its plain version on the index map in `args`
    (check_scan), both timed, with the bound of these inputs and the
    kernel's build fields."""
    import torch

    live = args[3]
    H, W = live.shape
    z, s = kernels.predict_l0_scan(*args)
    torch.cuda.synchronize()
    zp, sp = kernels.predict_l0_scan_plain(*args)
    agree = check_scan(args, z, s, zp, sp)
    ze, se = kernels.predict_l0_scan(*args, exact_division=True)
    if not (torch.equal(z, ze) and torch.equal(s, se)):
        raise AssertionError("predict_l0_scan: the fast division and "
                             "__fdiv_rn give different results")
    n_live = int(live.sum().item())
    log(f"  predict_l0_scan {H}x{W}, {which} map ({n_live} live texels, "
        f"{n_live / (H * W):.2%}): differing pixels "
        f"{agree['differing_fraction']:.2e}, max |dz| elsewhere "
        f"{agree['max_abs_err']:.3e}; winner ids differ at equal depth at "
        f"{agree['winner_id_flips']:.2e}; every winner's own hit depth "
        f"within {agree['winner_depth_err']:.3e} of best_z; the fast "
        "division and __fdiv_rn agree bit for bit")
    ms, ms_win, queued = time_ms(lambda: kernels.predict_l0_scan(*args), 50)
    cold = time_ms_cold(kernels.predict_l0_scan, args)
    plain_ms, _, plain_queued = time_ms(
        lambda: kernels.predict_l0_scan_plain(*args), 3, 3)
    rec = {"name": "predict_l0_scan", "map": which, "route": "cuda",
           "source": "maskfusion_tpu_torch/csrc/predict_l0_scan.cu",
           "replaces": "maskfusion_tpu/ops/pallas_kernels.py:230",
           "launches": 0, "max_abs_err": agree["max_abs_err"],
           "plain_ms": plain_ms, "library_ms": None,
           **timing_fields(ms, ms_win, cold),
           "windows_queued": [queued, plain_queued],
           "live_texels": n_live, "live_share": n_live / (H * W),
           "differing_fraction": agree["differing_fraction"],
           "winner_id_flips": agree["winner_id_flips"],
           "winner_depth_err": agree["winner_depth_err"],
           **scan_bound(live, window),
           **build_fields(kernels, "predict_l0_scan", H, W, window)}
    log_times(f"predict_l0_scan, {which} map", rec)
    log_build_fields("predict_l0_scan", rec)
    return rec


# ---------------------------------------------------------------- phases
def phase_kernels(dev, kernels, MaskFusion, Config, Resolution,
                  CameraIntrinsics, FrameData, frames):
    import torch

    from maskfusion_tpu_torch import se3
    from maskfusion_tpu_torch.ops import splat as splat_ops

    records = []
    W, H = 640, 480
    # --- kernel 1 at the main path's shapes: VGA, R=6, zero holes
    depth = frames[0].host_depth().copy()
    depth[100:140, 200:260] = 0.0
    depth[300:305, :] = 0.0
    depth[:, 500:502] = 0.0
    d = torch.from_numpy(depth).to(dev)
    R, ss, sc = 6, 0.024691358, 555.556
    out = kernels.bilateral_depth(d, R, ss, sc, 0.03)
    torch.cuda.synchronize()
    ref = kernels.bilateral_depth_plain(d, R, ss, sc, 0.03)
    err = float((out - ref).abs().max().item())
    log(f"  bilateral_depth 480x640 R=6: max |kernel - plain| = {err:.3e}")
    if not err <= 1e-5:
        raise AssertionError(f"bilateral_depth disagrees: {err} > 1e-5")
    ms, ms_win, queued = time_ms(
        lambda: kernels.bilateral_depth(d, R, ss, sc, 0.03), 50)
    cold = time_ms_cold(kernels.bilateral_depth, (d, R, ss, sc, 0.03))
    plain_ms, _, plain_queued = time_ms(
        lambda: kernels.bilateral_depth_plain(d, R, ss, sc, 0.03), 3, 3)
    rec = {"name": "bilateral_depth", "route": "cuda",
           "source": "maskfusion_tpu_torch/csrc/bilateral_depth.cu",
           "replaces": "maskfusion_tpu/ops/pallas_kernels.py:121",
           "launches": 0, "max_abs_err": err, "plain_ms": plain_ms,
           "library_ms": None, **timing_fields(ms, ms_win, cold),
           "windows_queued": [queued, plain_queued],
           **bilateral_bound(H, W, R),
           **build_fields(kernels, "bilateral_depth", H, W, R)}
    records.append(rec)
    log_times("bilateral_depth", rec)
    log_build_fields("bilateral_depth", rec)

    # --- kernel 2 on a real index map rendered at 480x640
    intr = CameraIntrinsics(528.0, 528.0, 320.0, 240.0)
    eng = MaskFusion(Resolution(W, H), intr,
                     Config(static_mode=True,
                            global_surfel_capacity=1 << 22), device=dev)
    eng.process_frame(frames[0])
    st = eng.global_model.state
    im = splat_ops.render_index_map(
        st.map, se3.pose_inverse(st.pose), intr, H, W, 1.0,
        eng.cfg.effective_time_delta(), eng.cfg.depth_cutoff)
    args = (im.pos.contiguous(), im.normal.contiguous(),
            im.radius.contiguous(), im.index >= 0,
            kernels.intrinsics(intr, dev), eng.cfg.depth_cutoff)
    rec = scan_record(kernels, args, "global")
    small = synthetic_scan_args(dev)
    small_agree = check_scan(small, *kernels.predict_l0_scan(*small),
                             *kernels.predict_l0_scan_plain(*small),
                             max_flips=SYNTHETIC_SCAN_MAX_FLIPS)
    log(f"  predict_l0_scan 120x160 synthetic scene: {small_agree}")
    rec["synthetic_winner_id_flips"] = small_agree["winner_id_flips"]
    records.append(rec)
    del eng, st, im
    return records


def phase_engine(dev, kernels, MaskFusion, Config, Resolution,
                 CameraIntrinsics, FrameData, frames, n_warm, n_timed,
                 n_stage):
    from maskfusion_tpu_torch import bench

    W, H = 640, 480
    cfg = Config(static_mode=True, global_surfel_capacity=1 << 22)
    engine = MaskFusion(Resolution(W, H),
                        CameraIntrinsics(528.0, 528.0, 320.0, 240.0), cfg,
                        device=dev)
    n_main = n_warm + n_timed
    # the main path: every launch count starts at 0 here; the frames run as
    # the port bench runs them, one timed window
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    bench.warm_up(engine, frames[:n_warm])
    (fps,) = bench.timed_windows(engine, frames[n_warm:n_main], n_timed, 1)
    total = time.perf_counter() - t0
    launches = {"bilateral_depth": kernels.bilateral_depth.launches,
                "predict_l0_scan": kernels.predict_l0_scan.launches}
    surfels = engine.global_model.surfel_count
    log(f"  {n_warm} warm-up and {n_timed} timed frames in {total:.2f} s; "
        f"timed window {fps:.2f} FPS; {surfels} surfels")
    log(f"  launches over the {n_main} main-path frames: {launches}")
    for name, count in launches.items():
        if count < n_main:
            raise AssertionError(
                f"{name} launched {count} times in {n_main} frames")
    pose = engine.current_pose
    if not np.isfinite(pose).all():
        raise AssertionError(f"non-finite pose:\n{pose}")
    if not surfels > 0:
        raise AssertionError("empty map after the run")

    stage_ms = span_self_ms(engine, frames[n_main:n_main + n_stage])
    prof = profile_frames(engine, frames[n_main + n_stage:], 1000.0 / fps)
    m = engine.download_map()
    direct = {"poses": engine.pose_log_numpy(),
              "confident_surfels": int(
                  (m["conf"] > cfg.conf_threshold_global).sum())}
    return {"fps": fps, "frames_timed": n_timed, "span_self_ms": stage_ms,
            "launches": launches, "surfels": surfels, "profile": prof}, direct


def span_self_ms(engine, frames):
    """Runs `frames` under the profiler (CUDA activity, as the benchmark
    traces) and prints the host self time of each span of the program's
    span log (utils/stopwatch; `mfbench.spans.self_ns`), the mean per frame
    by span name.  Returns it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from maskfusion_tpu_torch.utils import stopwatch
    from mfbench import spans

    stopwatch.clear_log()
    with profile(activities=[ProfilerActivity.CUDA]):
        for f in frames:
            engine.process_frame(f)
        torch.cuda.synchronize()
    recs = stopwatch.read_log()
    kids = spans.children(recs)
    ms: dict = {}
    for i in spans.named(recs, {r["name"] for r in recs} - {"frame_to_pose"}):
        name = recs[i]["name"]
        ms[name] = ms.get(name, 0.0) + spans.self_ns(recs, i, kids) * 1e-6
    ms = {k: v / len(frames) for k, v in ms.items()}
    log(f"  span self ms, host (mean of {len(frames)} frames): "
        + ", ".join(f"{k} {v:.2f}" for k, v in ms.items()))
    return ms


SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def profile_span(fn):
    """torch.profiler over fn(): the card's busy microseconds (the sum of
    its kernel and copy intervals), its time per kernel name, and the
    host's runtime calls counted inside fn's own span (the closing
    synchronise and any call the profiler makes itself stay out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("chip_smoke.span"):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    span = next(e.time_range for e in events
                if e.name == "chip_smoke.span"
                and e.device_type == torch.autograd.DeviceType.CPU)
    busy_us = 0.0
    calls: dict = {}
    kernels: dict = {}
    for e in events:
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.name != "chip_smoke.span"):
            # the span's own device-side range is no device work
            us = e.time_range.elapsed_us()
            busy_us += us
            kernels[e.name] = kernels.get(e.name, 0.0) + us
        elif ((e.name.startswith("cuda") or e.name.startswith("cuLaunch"))
              and span.start <= e.time_range.start
              and e.time_range.end <= span.end):
            calls[e.name] = calls.get(e.name, 0) + 1
    return busy_us, kernels, calls


def profile_frames(engine, frames, wall_ms_per_frame: float):
    """profile_span over a few frames: device busy time per frame, its
    share of the unprofiled frame time, and the host's runtime calls per
    frame."""
    n = len(frames)

    def run():
        for f in frames:
            engine.process_frame(f)

    busy_us, kernels, calls = profile_span(run)
    busy_ms = busy_us / 1e3 / n
    waits = sum(calls.get(k, 0) for k in SYNC_CALLS)
    out = {"frames": n, "device_busy_ms_per_frame": busy_ms,
           "device_busy_share": busy_ms / wall_ms_per_frame,
           "runtime_calls_per_frame": {k: v / n for k, v in sorted(
               calls.items(), key=lambda kv: -kv[1])[:6]},
           "synchronises_per_frame": waits / n,
           "top_kernels_ms_per_frame": {k[:80]: v / 1e3 / n for k, v in
                                        sorted(kernels.items(),
                                               key=lambda kv: -kv[1])[:4]}}
    log(f"  profile of {n} frames: device busy {busy_ms:.2f} ms/frame = "
        f"{out['device_busy_share']:.1%} of the unprofiled "
        f"{wall_ms_per_frame:.2f} ms/frame; runtime calls/frame "
        f"{out['runtime_calls_per_frame']}; synchronises/frame "
        f"{waits / n:.1f}; top kernels ms/frame "
        f"{out['top_kernels_ms_per_frame']}")
    return out


def _rot_deg(a, b) -> float:
    """The angle between two rotations, from the chord |Ra - Rb|_F =
    2 sqrt(2) sin(angle / 2): arccos of the trace loses ~0.02 deg to float32
    rounding near 0."""
    chord = np.linalg.norm(np.asarray(a, np.float64)[:3, :3]
                           - np.asarray(b, np.float64)[:3, :3])
    return float(np.degrees(2 * np.arcsin(min(1.0, chord / 8 ** 0.5))))


def _rot_deg_trace(a, b) -> float:
    """The same angle as arccos((tr(Ra^T Rb) - 1) / 2), the formula phase 4
    read before the chord's: logged beside it there, so the margin of the
    0.05 deg gate reads in both."""
    return float(np.degrees(np.arccos(np.clip(
        (np.trace(a[:3, :3].T @ b[:3, :3]) - 1) / 2, -1, 1))))


def phase_parity(dev, MaskFusion, Config, Resolution, CameraIntrinsics,
                 FrameData):
    import torch

    poses, frames, (fx, fy, cx, cy, w, h) = synthetic_trajectory(6)
    cfg = dict(global_surfel_capacity=1 << 16, static_mode=True,
               use_so3=False)

    def run(device):
        eng = MaskFusion(Resolution(w, h), CameraIntrinsics(fx, fy, cx, cy),
                         Config(**cfg), device=device)
        out = []
        for i, (rgb, depth) in enumerate(frames):
            eng.process_frame(FrameData(rgb=rgb, depth=depth,
                                        timestamp=float(i)))
            out.append(eng.current_pose.astype(np.float64))
        return out

    card, cpu = run(dev), run(torch.device("cpu"))
    dpos = max(np.linalg.norm(a[:3, 3] - b[:3, 3])
               for a, b in zip(card, cpu))
    drot = max(_rot_deg(a, b) for a, b in zip(card, cpu))
    drot_trace = max(_rot_deg_trace(a, b) for a, b in zip(card, cpu))
    ate = float(np.sqrt(np.mean([np.sum((a[:3, 3] - gt[:3, 3]) ** 2)
                                 for a, gt in zip(card, poses)])))
    log(f"  card vs CPU: max pose difference {dpos * 1e3:.4f} mm, "
        f"{drot:.5f} deg ({drot_trace:.5f} deg by arccos of the trace); "
        f"ATE on the card {ate * 1e3:.3f} mm")
    if not (dpos <= 1e-3 and drot <= 0.05):
        raise AssertionError(f"card and CPU poses differ: {dpos} m, "
                             f"{drot} deg")
    if not ate < 5e-3:
        raise AssertionError(f"ATE {ate} m >= 5 mm")
    return {"max_pose_diff_m": dpos, "max_rot_diff_deg": drot,
            "max_rot_diff_deg_trace": drot_trace, "ate_m": ate}


def multiobject_config(Config, **kw):
    """The multi-object engine with MaskFusion segmentation of the frame's
    masks, in the synchronous schedule unless `kw` asks otherwise."""
    return Config(**{"static_mode": False, "seg_method": "maskfusion",
                     "pipelined_multiobject": False, **kw})


def vga_multiobject_config():
    """bench.py's two-object configuration (bench.py:201-211), switched to
    the synchronous schedule: the port bench's _sync line."""
    from maskfusion_tpu_torch import bench

    return bench.two_object_config(pipelined=False)


def phase_edge_kernel(dev, kernels, MaskFusion, Config, Resolution,
                      CameraIntrinsics, frame, intr):
    """Kernel 3 on the level-0 maps of `frame` as the engine's preprocess
    makes them."""
    import torch

    W, H = 640, 480
    eng = MaskFusion(Resolution(W, H), CameraIntrinsics(*intr),
                     vga_multiobject_config(), device=dev)
    depth = torch.from_numpy(frame.host_depth())
    prep = eng.preprocess(torch.from_numpy(frame.rgb).to(dev), depth.to(dev),
                          torch.zeros((H, W), dtype=torch.uint8, device=dev))
    vmap = prep.levels[0]["vmap"].contiguous()
    nmap = prep.levels[0]["nmap"].contiguous()
    wd, wc = eng.cfg.seg_weight_distance, eng.cfg.seg_weight_concavity
    out = kernels.geometric_edge_map(vmap, nmap, wd, wc)
    torch.cuda.synchronize()
    ref = kernels.geometric_edge_map_plain(vmap, nmap, wd, wc)
    agree = check_edge_map(out, ref)
    log(f"  geometric_edge_map 480x640: differing pixels "
        f"{agree['differing_fraction']:.2e}, max |kernel - plain| elsewhere "
        f"{agree['max_abs_err']:.3e} ({agree['max_abs_err_all']:.3e} over "
        "all pixels)")
    small = synthetic_edge_args(dev)
    small_out = kernels.geometric_edge_map(*small, wd, wc)
    small_agree = check_edge_map(small_out,
                                 kernels.geometric_edge_map_plain(*small, wd,
                                                                  wc))
    log(f"  geometric_edge_map 120x160 synthetic scene: {small_agree}")
    digests = {"vga": digest(out), "synthetic_120x160": digest(small_out)}
    log(f"  geometric_edge_map output SHA-256: 480x640 {digests['vga']}, "
        f"120x160 {digests['synthetic_120x160']}")
    ms, ms_win, queued = time_ms(
        lambda: kernels.geometric_edge_map(vmap, nmap, wd, wc), 50)
    cold = time_ms_cold(kernels.geometric_edge_map, (vmap, nmap, wd, wc))
    floor = move_floor(vmap, nmap)
    plain_ms, _, plain_queued = time_ms(
        lambda: kernels.geometric_edge_map_plain(vmap, nmap, wd, wc), 3, 3)
    rec = {"name": "geometric_edge_map", "route": "cuda",
           "source": "maskfusion_tpu_torch/csrc/geometric_edge_map.cu",
           "replaces": "maskfusion_tpu/ops/pallas_kernels.py:171",
           "launches": 0, "max_abs_err": agree["max_abs_err"],
           "plain_ms": plain_ms, "library_ms": None,
           **timing_fields(ms, ms_win, cold),
           "windows_queued": [queued, plain_queued],
           "differing_fraction": agree["differing_fraction"],
           "output_sha256": digests, **floor,
           **edge_bound(vmap),
           **build_fields(kernels, "geometric_edge_map", H, W, 0)}
    log_times("geometric_edge_map", rec)
    log(f"  moving the same bytes (one PyTorch call, no stencil): cold "
        f"{floor['move_floor_ms_cold'] * 1e3:.2f} us, hot "
        f"{floor['move_floor_ms'] * 1e3:.2f} us")
    log_build_fields("geometric_edge_map", rec)
    return rec


def host_segmentation_times(dev, MaskFusion, Resolution, CameraIntrinsics,
                            frame, intr, turns: int = 5):
    """The multi-object frame's host segmentation (MfSegmentation.perform
    from the non-edge binary: components, edge reassignment, the overlap
    histograms, the mask rules, the depth moments) on `frame` at 640x480,
    on the native library (mfcore) and on its numpy versions
    (cpp.disabled()), in alternating turns; the two results must agree.
    Returns the median ms of each."""
    import torch

    from maskfusion_tpu_torch import cpp
    from maskfusion_tpu_torch.segmentation.mf_segmentation import ModelInfo

    W, H = 640, 480
    eng = MaskFusion(Resolution(W, H), CameraIntrinsics(*intr),
                     vga_multiobject_config(), device=dev)
    depth = torch.from_numpy(frame.host_depth())
    prep = eng.preprocess(torch.from_numpy(frame.rgb).to(dev), depth.to(dev),
                          torch.zeros((H, W), dtype=torch.uint8, device=dev))
    seg = eng.segmenter
    nonedge = seg.edge_binary(prep.levels[0]["vmap"].contiguous(),
                              prep.levels[0]["nmap"].contiguous())[1]
    nonedge = nonedge.cpu().numpy()
    ids = np.zeros((H, W), np.uint8)

    def perform():
        t0 = time.perf_counter()
        res = seg.perform(frame, None, None, ids, [ModelInfo(0, 0)], 1, True,
                          nonedge=nonedge)
        return (time.perf_counter() - t0) * 1e3, res.full_segmentation

    perform()
    times = {"native": [], "numpy": []}
    for _ in range(turns):
        ms, native = perform()
        times["native"].append(ms)
        with cpp.disabled():
            ms, plain = perform()
        times["numpy"].append(ms)
        if not np.array_equal(native, plain):
            raise AssertionError("native and numpy host segmentations differ")
    out = {k: float(np.median(v)) for k, v in times.items()}
    log(f"  host segmentation of a 640x480 two-object frame: native (mfcore) "
        f"{out['native']:.2f} ms, numpy {out['numpy']:.2f} ms (medians of "
        f"{turns} alternating turns; results equal)")
    return {"ms": out, "turns_ms": times}


def phase_multiobject(dev, kernels, MaskFusion, Config, Resolution,
                      CameraIntrinsics, FrameData, frames, intr, n_warm,
                      n_timed, n_stage, n_prof):
    import dataclasses

    import torch

    W, H = 640, 480
    engine = MaskFusion(Resolution(W, H), CameraIntrinsics(*intr),
                        vga_multiobject_config(), device=dev)
    n_main = n_warm + n_timed
    n_models = []
    # the main path: every launch count starts at 0 here
    kernels.reset_launch_counts()
    t_start = time.perf_counter()
    for f in frames[:n_warm]:
        engine.process_frame(f)
        n_models.append(len(engine.models))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t_start

    windowed_warm = engine.windowed_fuses
    t0 = time.perf_counter()
    staged = engine.upload_frame(frames[n_warm])
    for nxt in frames[n_warm + 1:n_main]:
        nxt_staged = engine.upload_frame(nxt)
        engine.process_frame(staged)
        n_models.append(len(engine.models))
        staged = nxt_staged
    diag = engine.process_frame(staged)
    n_models.append(len(engine.models))
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {k: getattr(kernels, k).launches for k in
                ("bilateral_depth", "predict_l0_scan", "geometric_edge_map")}
    fps = n_timed / total
    windowed = {"warm_up": windowed_warm,
                "timed": engine.windowed_fuses - windowed_warm}
    log(f"  warm-up {n_warm} frames in {warm_s:.2f} s; timed {n_timed} "
        f"frames in {total:.3f} s = {fps:.2f} FPS")
    log(f"  models after each frame: {n_models}; last frame: {diag}")
    log(f"  launches over the {n_main} main-path frames: {launches}")
    log(f"  frames whose objects fused in their windows: "
        f"{windowed['warm_up']} of {n_warm} warm-up, {windowed['timed']} of "
        f"{n_timed} timed; windows now "
        f"{[m.window for m in engine.models[1:]]}")
    if max(n_models) < 3:
        raise AssertionError(f"the run never held 3 models: {n_models}")
    # frame 1 initialises the global map: no tracking, no segmentation
    want = {"bilateral_depth": n_main, "geometric_edge_map": n_main - 1,
            "predict_l0_scan": n_main}
    for name, count in launches.items():
        if count < want[name]:
            raise AssertionError(
                f"{name} launched {count} times in {n_main} frames (at "
                f"least {want[name]} expected)")
    for k, m in enumerate(engine.models):
        pose = m.pose_log[-1]["pose"].cpu().numpy()
        if not np.isfinite(pose).all():
            raise AssertionError(f"model {m.model_id}: non-finite pose")
    counts = [m.surfel_count for m in engine.models]
    if not all(c > 0 for c in counts):
        raise AssertionError(f"an empty model map: {counts}")
    log(f"  model ids {[m.model_id for m in engine.models]}, classes "
        f"{[m.class_id for m in engine.models]}, surfels {counts}")
    # kernel 2 on object 1's index map, full frame as phase 2 renders the
    # global one and in its window as the windowed fuse renders it; these
    # launches come after the main path's counts
    from maskfusion_tpu_torch import se3
    from maskfusion_tpu_torch.ops import splat as splat_ops

    obj = engine.models[1]
    st = obj.state
    cfg = engine.cfg
    scans = []
    OW = engine._obj_window
    views = [("object", engine.intr, H, W)]
    if obj.window is not None:
        oy, ox = obj.window
        views.append((f"object window {OW}x{OW} at ({oy}, {ox})",
                      engine._intr_shift(oy, ox), OW, OW))
    elif windowed["timed"]:
        raise AssertionError("object 1 has no window after windowed frames")
    for which, k, h, w in views:
        im = splat_ops.render_index_map(
            st.map, se3.pose_inverse(st.pose), k, h, w, float(engine.tick),
            cfg.effective_time_delta(), cfg.depth_cutoff)
        if not bool((im.index >= 0).any()):
            raise AssertionError(f"{which}: the index map holds no live "
                                 "texel")
        scans.append(scan_record(
            kernels, (im.pos.contiguous(), im.normal.contiguous(),
                      im.radius.contiguous(), im.index >= 0,
                      kernels.intrinsics(k, st.pose.device),
                      cfg.depth_cutoff), which))
    del st, im
    # the two profiler views first, while the main path's models are live
    # (bench.py's scene spawns a fourth model near frame 31), then the
    # spans' self times
    rest = frames[n_main:]
    models_in = [len(engine.models)]
    prof = profile_frames(engine, rest[:n_prof], 1000.0 / fps)
    # the per-model loop on the same engine: launches a frame side by side
    models_in.append(len(engine.models))
    engine.cfg = dataclasses.replace(cfg, batch_object_tracking=False)
    prof_loop = profile_frames(engine, rest[n_prof:2 * n_prof],
                               1000.0 / fps)
    engine.cfg = cfg
    models_in.append(len(engine.models))
    stage_ms = span_self_ms(engine, rest[2 * n_prof:2 * n_prof + n_stage])
    key = "cudaLaunchKernel"
    per_frame = {
        "batched_windowed": prof["runtime_calls_per_frame"].get(key, 0.0),
        "per_model_loop": prof_loop["runtime_calls_per_frame"].get(key, 0.0),
        "models_before_between_after": models_in}
    log(f"  kernel launches a frame ({key}): batched and windowed "
        f"{per_frame['batched_windowed']:.1f}, per-model loop "
        f"{per_frame['per_model_loop']:.1f}; live models before, between "
        f"and after the two views {models_in}")
    return {"fps": fps, "timed_s": total, "frames_timed": n_timed,
            "windowed_frames": windowed,
            "span_self_ms": stage_ms,
            "launches": launches, "launches_per_frame": {
                k: v / n_main for k, v in launches.items()},
            "n_models": n_models, "surfels": counts, "profile": prof,
            "profile_per_model_loop": prof_loop,
            "kernel_launches_per_frame": per_frame}, scans


def phase_pipelined(dev, kernels, MaskFusion, Resolution, CameraIntrinsics,
                    frames, intr, n_warm, n_timed, n_prof):
    """The main path: bench.py's two-object configuration unchanged (the
    pipelined, prefused schedule) at 640x480, run as bench.py runs it."""
    import torch

    from maskfusion_tpu_torch import bench

    engine = MaskFusion(Resolution(640, 480), CameraIntrinsics(*intr),
                        bench.two_object_config(), device=dev)
    n_main = n_warm + n_timed
    n_models = []
    # the main path: every launch count starts at 0 here
    kernels.reset_launch_counts()
    t_start = time.perf_counter()
    for i, f in enumerate(frames[:n_warm]):
        engine.process_frame(f)
        n_models.append(len(engine.models))
        if i % 4 == 3:
            engine.drain_pipeline()
    engine.drain_pipeline()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t_start
    models_warm = len(engine.models)
    windowed_warm = engine.windowed_fuses
    waits_warm = engine.forced_waits
    t0 = time.perf_counter()
    staged = engine.upload_frame(frames[n_warm])
    for nxt in frames[n_warm + 1:n_main]:
        nxt_staged = engine.upload_frame(nxt)
        engine.process_frame(staged)
        n_models.append(len(engine.models))
        staged = nxt_staged
    engine.process_frame(staged)
    n_models.append(len(engine.models))
    engine.flush_diagnostics()
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {k: getattr(kernels, k).launches for k in
                ("bilateral_depth", "predict_l0_scan", "geometric_edge_map")}
    fps = n_timed / total
    windowed = {"warm_up": windowed_warm,
                "timed": engine.windowed_fuses - windowed_warm}
    log(f"  warm-up {n_warm} frames in {warm_s:.2f} s; timed {n_timed} "
        f"frames in {total:.3f} s = {fps:.2f} FPS; host stages that waited "
        f"on the device: {waits_warm} in the warm-up, "
        f"{engine.forced_waits - waits_warm} in the timed run (its last "
        "frames drained at the end)")
    log(f"  models after each frame: {n_models}; after the warm-up "
        f"{models_warm}, at the end {len(engine.models)}")
    log(f"  launches over the {n_main} main-path frames: {launches}")
    log(f"  frames tracked and fused in windows: {windowed['warm_up']} of "
        f"{n_warm} warm-up, {windowed['timed']} of {n_timed} timed; windows "
        f"now {[m.window for m in engine.models[1:]]}")
    if max(n_models) < 3:
        raise AssertionError(f"the run never held 3 models: {n_models}")
    # frame 1 initialises the global map: no device stage
    want = {"bilateral_depth": n_main, "geometric_edge_map": n_main - 1,
            "predict_l0_scan": n_main}
    for name, count in launches.items():
        if count < want[name]:
            raise AssertionError(
                f"{name} launched {count} times in {n_main} frames (at "
                f"least {want[name]} expected)")
    for m in engine.models:
        pose = m.pose_log[-1]["pose"].cpu().numpy()
        if not np.isfinite(pose).all():
            raise AssertionError(f"model {m.model_id}: non-finite pose")
    counts = [m.surfel_count for m in engine.models]
    if not all(c > 0 for c in counts):
        raise AssertionError(f"an empty model map: {counts}")
    log(f"  model ids {[m.model_id for m in engine.models]}, classes "
        f"{[m.class_id for m in engine.models]}, surfels {counts}")
    # steady state under the profiler: every synchronise must be a forced
    # drain (pipeline_depth frames in flight and the oldest not landed)
    waits0 = engine.forced_waits
    prof = profile_frames(engine, frames[n_main:n_main + n_prof],
                          1000.0 / fps)
    forced = engine.forced_waits - waits0
    prof["forced_drains_per_frame"] = forced / n_prof
    log(f"  profiled frames: {forced} forced drains in {n_prof} frames; "
        f"pending frames {len(engine._pending)}")
    if prof["synchronises_per_frame"] * n_prof > forced:
        raise AssertionError(
            f"{prof['synchronises_per_frame'] * n_prof:.0f} synchronises in "
            f"{n_prof} steady-state frames, {forced} of them forced drains")
    engine.drain_pipeline()
    return {"fps": fps, "timed_s": total, "frames_timed": n_timed,
            "windowed_frames": windowed, "launches": launches,
            "launches_per_frame": {k: v / n_main
                                   for k, v in launches.items()},
            "n_models": n_models, "n_models_warm": models_warm,
            "n_models_end": len(engine.models), "surfels": counts,
            "forced_waits": {"warm_up": waits_warm,
                             "timed": engine.forced_waits - waits_warm},
            "profile": prof}


def _object_offset(class_id: int, i: int) -> np.ndarray:
    """synthetic_two_objects' motion of the object of `class_id` (7: patch
    1, 8: patch 2) at frame i."""
    if class_id == 7:
        return np.array([0.006 * max(0, i - 1), 0.0, 0.0])
    return np.array([0.0, -0.006 * max(0, i - 2), 0.0])


_NO_POSE = np.full((4, 4), np.nan)


def _run_records(step, frames):
    """Per frame: model ids, class ids, logged poses and surfel counts.  A
    model spawned by the pipelined schedule's host stage of the frame just
    finished has no logged pose yet: NaN."""
    out = []
    for i in frames:
        eng = step(i)
        out.append(([m.model_id for m in eng.models],
                    [m.class_id for m in eng.models],
                    [m.pose_log[-1]["pose"].cpu().numpy().astype(np.float64)
                     if m.pose_log else _NO_POSE for m in eng.models],
                    [m.surfel_count for m in eng.models]))
    return out


def _motion_error(rec, i: int, spawn: dict) -> float:
    """The largest object translation error of a frame record against the
    scene's motion since the object's spawn frame."""
    err = 0.0
    for mid, cid, p in zip(rec[0][1:], rec[1][1:], rec[2][1:]):
        if np.isnan(p).any():
            continue
        true = _object_offset(cid, i) - _object_offset(cid, spawn[mid])
        err = max(err, float(np.linalg.norm(p[:3, 3] - true)))
    return err


def _compare_runs(card, cpu, first_frame: int, spawn: dict):
    """Per frame: model and class ids must agree (raises otherwise); the
    global pose difference (m, deg), the largest object pose difference
    (m), the largest relative surfel-count difference, and both runs'
    object errors against the scene's motion (m)."""
    rows = []
    for i, (a, b) in enumerate(zip(card, cpu), start=first_frame):
        if a[0] != b[0] or a[1] != b[1]:
            raise AssertionError(f"frame {i}: models {a[0]}/{a[1]} on the "
                                 f"card, {b[0]}/{b[1]} on the CPU")
        pa, pb = a[2], b[2]
        rows.append({
            "frame": i,
            "global_m": float(np.linalg.norm(pa[0][:3, 3] - pb[0][:3, 3])),
            "global_deg": _rot_deg(pa[0], pb[0]),
            # a pose logged on one side only reads as infinitely apart
            "object_m": max((float(np.nan_to_num(
                np.linalg.norm(x[:3, 3] - y[:3, 3]), nan=np.inf))
                for x, y in zip(pa[1:], pb[1:])
                if not (np.isnan(x).any() and np.isnan(y).any())),
                default=0.0),
            "count_rel": max(abs(x - y) / max(y, 1)
                             for x, y in zip(a[3], b[3])),
            "truth_card_m": _motion_error(a, i, spawn),
            "truth_cpu_m": _motion_error(b, i, spawn)})
    return rows


# tests/test_engine_multimodel.py:172-201 holds two runs of the JAX package
# that round differently (batched and looped) to 8 mm over frames 0-4 of
# this scene; past frame 4 an object's solve can turn such rounding into
# centimetres (PERF.md, PR 3)
OBJECT_HOLD_LAST_FRAME = 4


# phase 7's forms: two of the synchronous frame, and the prefused schedule
PARITY_FORMS = {
    "per_model_loop": dict(batch_object_tracking=False),
    # tests/test_engine_pipelined.py:19-33's window and margin
    "batched_windowed": dict(object_window=104, object_window_margin=24,
                             min_object_slots=2),
    "pipelined": dict(pipelined_multiobject=True, object_window=104,
                      object_window_margin=24, min_object_slots=2),
}
WINDOWED_FORMS = ("batched_windowed", "pipelined")


def phase_multiobject_parity(dev, MaskFusion, Config, Resolution,
                             CameraIntrinsics, FrameData, form: str):
    """The two-object scene of tests/test_engine_multimodel.py through the
    multi-object engine on the CPU, frames 0-6, in one of PARITY_FORMS.  As
    the port's lockstep test against the JAX engine, the card starts from
    the CPU engine's state after both spawns (frames 0-2, carried by
    convert.engine_snapshot / restore_engine) and runs frames 3-6.  Held on
    every frame: the same model and class ids, the global pose within
    1 mm / 0.05 deg.  Held up to OBJECT_HOLD_LAST_FRAME: object poses within
    8 mm, surfel counts within 1%.  Reported: the later frames, each run's
    object error against the scene's motion, and a card run from frame 0.
    The windowed forms must fuse their objects in their windows on every
    frame after the carry.  The pipelined form finishes every frame before
    the next (drain_pipeline): the CPU's records are always ready, so its
    engine finishes each at the start of the next frame, and the card's
    must do the same to run the same lifecycle."""
    import torch

    from maskfusion_tpu_torch.convert import engine_snapshot, restore_engine

    t0 = time.perf_counter()
    frames = synthetic_two_objects(7)
    fx, fy, cx, cy, w, h = SMALL
    carry_at = 3

    def engine(device):
        return MaskFusion(
            Resolution(w, h), CameraIntrinsics(fx, fy, cx, cy),
            multiobject_config(Config, global_surfel_capacity=1 << 16,
                               object_surfel_capacity=1 << 13,
                               model_spawn_offset=0, use_so3=False,
                               open_loop=True, **PARITY_FORMS[form]),
            device=device)

    def stepper(eng):
        def step(i):
            rgb, depth, lab = frames[i]
            eng.process_frame(FrameData(rgb=rgb, depth=depth, mask=lab,
                                        class_ids=[0, 7, 8],
                                        timestamp=float(i)))
            eng.drain_pipeline()
            return eng
        return step

    cpu_eng = engine(torch.device("cpu"))
    cpu = _run_records(stepper(cpu_eng), range(carry_at))
    snap = engine_snapshot(cpu_eng)
    cpu += _run_records(stepper(cpu_eng), range(carry_at, len(frames)))
    card_eng = engine(dev)
    restore_engine(card_eng, snap)
    carried = _run_records(stepper(card_eng), range(carry_at, len(frames)))
    windowed = card_eng.windowed_fuses
    if form in WINDOWED_FORMS and windowed != len(frames) - carry_at:
        raise AssertionError(f"{form}: {windowed} windowed frames of "
                             f"{len(frames) - carry_at}")
    spawn = {}
    for i, rec in enumerate(cpu):
        for mid in rec[0]:
            spawn.setdefault(mid, i)
    rows = _compare_runs(carried, cpu[carry_at:], carry_at, spawn)
    fresh = _run_records(stepper(engine(dev)), range(len(frames)))
    fresh_rows = _compare_runs(fresh, cpu, 0, spawn)
    log(f"  models per frame {[len(a[0]) for a in cpu]}, ids {cpu[-1][0]}; "
        f"surfels after frame {len(frames) - 1}: CPU {cpu[-1][3]}, card "
        f"(carried) {carried[-1][3]}, card (from frame 0) {fresh[-1][3]}")
    log(f"  {form}: windows {[m.window for m in card_eng.models[1:]]}, "
        f"{windowed} windowed frames on the card after the carry; "
        f"{time.perf_counter() - t0:.1f} s")
    for name, rs in (("carried after the spawns", rows),
                     ("from frame 0", fresh_rows)):
        log(f"  {form}, card vs CPU, {name}:")
        for r in rs:
            log(f"    frame {r['frame']}: global {r['global_m'] * 1e3:.4f} "
                f"mm {r['global_deg']:.5f} deg; objects "
                f"{r['object_m'] * 1e3:.3f} mm apart; counts "
                f"{r['count_rel']:.2%} apart; object error against the "
                f"motion {r['truth_card_m'] * 1e3:.2f} mm (card), "
                f"{r['truth_cpu_m'] * 1e3:.2f} mm (CPU)")
    if cpu[-1][0] != [0, 1, 2]:
        raise AssertionError(f"expected models [0, 1, 2], got {cpu[-1][0]}")
    for r in rows:
        held = (r["global_m"] <= 1e-3 and r["global_deg"] <= 0.05)
        if r["frame"] <= OBJECT_HOLD_LAST_FRAME:
            held = held and r["object_m"] <= 8e-3 and r["count_rel"] <= 0.01
        if not held:
            raise AssertionError(f"card and CPU runs differ: {r}")
    return {"carried": rows, "from_frame_0": fresh_rows,
            "windowed_frames": windowed}


def read_tum(path):
    """A TUM pose file as (timestamps, 4x4 camera->world matrices)."""
    from maskfusion_tpu_torch.io.ground_truth import GroundTruthOdometry

    gt = GroundTruthOdometry(str(path))
    stamps = [float(line.split()[0])
              for line in Path(path).read_text().splitlines()]
    return stamps, [gt.get_pose(t, relative_to_first=False).astype(
        np.float64) for t in stamps]


def phase_cli(kernels, frames, direct, workdir: Path, phase8_poses: list):
    """The -static CLI on the card, the way a user runs it
    (maskfusion_tpu_torch.main on a .klg log, no OpenCV): a raw KLG log of
    `frames` (distinct non-zero stamps), then

    - the CLI with -ep -em: it returns 0; the bilateral and scan kernels
      launch once a frame; poses-0.txt holds one line a frame, each within
      1 mm / 0.05 deg of the direct engine run on the same frames
      (`direct`, phase 3); cloud-0.ply loads, finite, with a count within
      1% of the direct run's confident surfels;
    - the CLI again with -p poses-0.txt: every logged pose equals its input
      within 1e-5 (the TUM text round trip), and the scan runs on every
      frame after the first (fuse, clean and predict of the general step).
    """
    from maskfusion_tpu_torch import main as cli
    from maskfusion_tpu_torch.io.export import load_ply

    n = len(frames)
    if len(direct["poses"]) != n:
        raise AssertionError(f"the direct run logged {len(direct['poses'])} "
                             f"poses for {n} frames")
    log_path = workdir / "static.klg"
    write_log(frames, log_path)
    out = {"frames": n}
    runs = (("static", ["-ep", "-em"]),
            ("ground_truth", ["-ep", "-p", str(workdir / "static" /
                                              "poses-0.txt")]))
    for name, extra in runs:
        export = workdir / name
        argv = ["-l", str(log_path), "-static", "-q", "-exportdir",
                str(export), "--global-capacity", str(1 << 22), *extra]
        # each CLI run is a path of its own: its counts start at 0 here
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        rc = cli.main(argv)
        seconds = time.perf_counter() - t0
        launches = {"bilateral_depth": kernels.bilateral_depth.launches,
                    "predict_l0_scan": kernels.predict_l0_scan.launches}
        log(f"  CLI {name} ({' '.join(argv[4:])}): rc {rc}, {n} frames in "
            f"{seconds:.2f} s, launches {launches}")
        if rc != 0:
            raise AssertionError(f"the {name} CLI returned {rc}")
        if launches != {"bilateral_depth": n, "predict_l0_scan": n}:
            raise AssertionError(f"the {name} CLI launched {launches} in "
                                 f"{n} frames (one of each a frame expected)")
        stamps, poses = read_tum(export / "poses-0.txt")
        if len(poses) != n:
            raise AssertionError(f"{name}: {len(poses)} poses for {n} frames")
        out[name] = {"seconds": seconds, "launches": launches}
        if name == "static":
            dpos = max(np.linalg.norm(a[:3, 3] - b[:3, 3])
                       for a, b in zip(poses, direct["poses"]))
            drot = max(_rot_deg(a, b) for a, b in zip(poses, direct["poses"]))
            cloud = load_ply(str(export / "cloud-0.ply"))
            k, want = len(cloud["pos"]), direct["confident_surfels"]
            log(f"  CLI against the direct engine run: max pose difference "
                f"{dpos * 1e3:.4f} mm, {drot:.5f} deg; cloud-0.ply {k} "
                f"surfels, direct run {want} above the confidence threshold")
            if not (dpos <= 1e-3 and drot <= 0.05):
                raise AssertionError(f"CLI and direct poses differ: {dpos} m, "
                                     f"{drot} deg")
            if not (np.isfinite(cloud["pos"]).all()
                    and abs(k - want) <= 0.01 * want and k > 0):
                raise AssertionError(f"cloud-0.ply: {k} surfels (direct run "
                                     f"{want}) or non-finite positions")
            inputs = (stamps, poses)
            out[name].update(max_pose_diff_m=dpos, max_rot_diff_deg=drot,
                             cloud_surfels=k, direct_surfels=want)
            # phase 15c holds the CLI at its default capacities to these
            phase8_poses[:] = poses
        else:
            err = max(float(np.abs(a - b).max())
                      for a, b in zip(poses, inputs[1]))
            log(f"  ground-truth run: logged poses within {err:.2e} of their "
                "inputs")
            if stamps != inputs[0] or not err <= 1e-5:
                raise AssertionError(f"ground-truth poses differ from their "
                                     f"inputs by {err} (bound 1e-5)")
            out[name]["max_abs_pose_err"] = err
    return out


def phase_bench(dev, frames, mo_frames, intr):
    """The port bench's four lines (maskfusion_tpu_torch.bench), on the
    frames rendered above; the NN-in-loop line must label a frame."""
    from maskfusion_tpu_torch import bench

    lines = [bench.bench_two_objects(dev, mo_frames, intr),
             bench.bench_two_objects(dev, mo_frames, intr, pipelined=False),
             bench.bench_nn_in_loop(dev, frames[:bench.NN_FRAMES],
                                    bench.STATIC_INTRINSICS),
             bench.bench_static(dev, frames)]
    if lines[2]["nn_labelled"] < 1:
        raise AssertionError("the NN-in-loop line labelled no frame")
    for line in lines:
        extra = {k: line[k] for k in ("n_models", "n_models_end",
                                      "windowed_frames", "nn_labelled",
                                      "nn_px", "nn_classes", "forced_waits")
                 if k in line}
        log(f"  {line['metric']}: {line['value']} {line['unit']} (windows "
            f"{line['reps']}) {extra}")
    return lines


def run_cli_log(kernels, frames, workdir: Path, name: str, flags):
    """The multi-object CLI (maskfusion_tpu_torch.main) with `flags`, -ep
    and a 2^22-surfel map on a raw KLG log of `frames` (one frame more: the
    KLG reader never returns a log's last), the three kernels' launch
    counts from 0, its output echoed.  Returns (rc, output, seconds,
    launches, the frames processed, the FPS line's value, the export
    directory)."""
    import contextlib
    import io

    from maskfusion_tpu_torch import main as cli

    log_path = workdir / f"{name}.klg"
    write_log(frames, log_path)
    export = workdir / name
    argv = ["-l", str(log_path), "-q", *flags, "-exportdir", str(export),
            "-ep", "--global-capacity", str(1 << 22)]
    kernels.reset_launch_counts()
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        rc = cli.main(argv)
    seconds = time.perf_counter() - t0
    out = text.getvalue()
    for line in out.splitlines():
        log("  | " + line)
    launches = {k: getattr(kernels, k).launches for k in
                ("bilateral_depth", "predict_l0_scan", "geometric_edge_map")}
    processed = re.search(r"processed (\d+) frames in .* \(([0-9.]+) FPS\)",
                          out)
    log(f"  CLI {' '.join(flags)}: rc {rc}, {len(frames)} frames in "
        f"{seconds:.2f} s, launches {launches}")
    return (rc, out, seconds, launches,
            int(processed.group(1)) if processed else 0,
            float(processed.group(2)) if processed else 0.0, export)


def phase_cli_nn(kernels, frames, workdir: Path):
    """`--nn` on the card, as a user runs it: the multi-object CLI (the
    prefused default) on a raw KLG log of `frames` (no masks) with the
    full-width Mask R-CNN (seeded random weights) labelling them on its
    worker thread and CUDA stream through a 5-frame delay queue.  It returns
    0, processes every frame of the log, drains the queue at its end,
    labels at least one frame, writes poses-0.txt and prints its FPS line;
    the three kernels' launches are counted over the run."""
    n = len(frames)
    rc, out, seconds, launches, processed, fps, export = run_cli_log(
        kernels, frames, workdir, "nn", ["--nn", "-frameQ", "5"])
    labelled = re.search(r"Mask R-CNN labelled (\d+) frames", out)
    if rc != 0:
        raise AssertionError(f"the --nn CLI returned {rc}")
    if processed != n:
        raise AssertionError(f"the --nn CLI did not process its {n} frames")
    if labelled is None or int(labelled.group(1)) < 1:
        raise AssertionError("the --nn CLI labelled no frame")
    stamps, poses = read_tum(export / "poses-0.txt")
    if not poses or not all(np.isfinite(p).all() for p in poses):
        raise AssertionError("the --nn CLI wrote no finite poses")
    return {"frames": n, "seconds": seconds, "launches": launches,
            "fps": fps, "labelled": int(labelled.group(1)),
            "poses": len(poses)}


def _valid_rows(out):
    return np.nonzero(out["detection_valid"])[0]


def phase_nn_trained(dev):
    """Phase 10a: the trained rich checkpoint (float32) carried by the
    port's converter, the card against the port's CPU forward on 4 seeded
    scenes (the same valid detections and classes, matched boxes' IoU >=
    0.98, mask logits within 1e-3 on the valid rows, generate_id_image
    equal on >= 99.5% of the pixels), then eval_rich_detection(n_scenes=6)
    on the card held to tests/test_maskrcnn_train.py's floors."""
    import torch

    from maskfusion_tpu_torch.maskrcnn import checkpoint_io
    from maskfusion_tpu_torch.maskrcnn import synthetic_shapes as ss
    from maskfusion_tpu_torch.maskrcnn.inference import generate_id_image

    path = (ROOT / "maskfusion_tpu" / "maskrcnn" / "checkpoints"
            / "shapes_rich_256.npz")
    params, meta = checkpoint_io.load_params(str(path))
    S = 256
    cfg = ss.rich_config(S)
    card = ss.forward_fn(cfg, params, dev)
    cpu = ss.forward_fn(cfg, params, "cpu")
    rng = np.random.default_rng(20)
    worst = {"box_iou": 1.0, "mask_err": 0.0, "id_equal": 1.0}
    keys = ("detections", "mask_logits", "detection_classes",
            "detection_scores", "detection_valid")
    for i in range(4):
        img = ss.make_rich_scene(rng, S)[0]
        a, b = card(img), cpu(img)
        va, vb = _valid_rows(a), _valid_rows(b)
        if not (np.array_equal(va, vb) and np.array_equal(
                a["detection_classes"][va], b["detection_classes"][vb])):
            raise AssertionError(f"scene {i}: the card's detections {va} "
                                 f"differ from the CPU's {vb}")
        ious = [ss.box_iou_np(a["detections"][k], b["detections"][k])
                for k in va]
        err = float(np.abs(a["mask_logits"][va]
                           - b["mask_logits"][vb]).max()) if len(va) else 0.0
        ia = generate_id_image(*(a[k] for k in keys), 480, 640, 0.5)[0]
        ib = generate_id_image(*(b[k] for k in keys), 480, 640, 0.5)[0]
        same = float((ia == ib).mean())
        log(f"  scene {i}: {len(va)} detections, classes "
            f"{a['detection_classes'][va].tolist()}, min box IoU "
            f"{min(ious, default=1.0):.5f}, mask logits max err {err:.2e}, "
            f"id image equal on {same:.4%}")
        worst = {"box_iou": min(worst["box_iou"], *ious, 1.0),
                 "mask_err": max(worst["mask_err"], err),
                 "id_equal": min(worst["id_equal"], same)}
        if not (min(ious, default=1.0) >= 0.98 and err <= 1e-3
                and same >= 0.995):
            raise AssertionError(f"scene {i}: card and CPU differ {worst}")
    t0 = time.perf_counter()
    q = ss.eval_rich_detection(params, image_size=S, n_scenes=6, device=dev)
    log(f"  eval_rich_detection(n_scenes=6) on the card in "
        f"{time.perf_counter() - t0:.1f} s: {q}; the checkpoint's meta: "
        f"det_iou {meta['det_iou']:.3f}, mask_iou {meta['mask_iou']:.3f}")
    floors = {"recall": 0.6, "det_iou": 0.45, "cls_acc": 0.7,
              "mask_iou": 0.45}
    if not all(q[k] >= v for k, v in floors.items()):
        raise AssertionError(f"the rich checkpoint on the card: {q} below "
                             f"{floors}")
    torch.cuda.synchronize()
    return {"card_vs_cpu": worst, "eval": q, "meta": {
        k: meta[k] for k in ("det_iou", "mask_iou", "recall", "cls_acc")}}


def network_macs(model, run):
    """Multiply-accumulates of the network's layers while ``run()`` calls
    it, by part, from the shapes each conv, dense and transposed-conv layer
    sees (forward hooks): the mask head is counted on every slot it runs
    on, valid or not."""
    import torch

    from maskfusion_tpu_torch.maskrcnn import model as mm

    macs = {"backbone": 0, "rpn": 0, "box_head": 0, "mask_head": 0}
    hooks = []

    def hook(part):
        def count(mod, inp, out):
            w = mod.weight
            if isinstance(mod, mm.Dense):
                n = out.numel() * w.shape[1]
            elif isinstance(mod, mm.ConvTranspose2x2):
                n = inp[0].numel() * w.shape[1] * 4
            else:
                n = out.numel() * w[0].numel()
            macs[part] += n
        return count

    for part in macs:
        for mod in getattr(model, part).modules():
            if isinstance(mod, (mm.Conv, mm.Dense, mm.ConvTranspose2x2)):
                hooks.append(mod.register_forward_hook(hook(part)))
    try:
        with torch.no_grad():
            run()
    finally:
        for h in hooks:
            h.remove()
    return macs


def profile_calls(fn):
    """profile_span over one call of fn: kernel launches, synchronises, the
    runtime calls and the card's busy ms."""
    busy_us, _, calls = profile_span(fn)
    launches = sum(v for k, v in calls.items() if "Launch" in k)
    syncs = sum(calls.get(k, 0) for k in SYNC_CALLS)
    return launches, syncs, calls, busy_us / 1e3


def tie_order(scores, cfg, dev, seed: int = 7):
    """The network's tie order on ``dev`` against the CPU's, for RPN
    ``scores`` (A,) on the CPU: the stable descending sort's first
    pre_nms_limit and the fixed-k NMS of the RPN and of the detections,
    (order, picks, valid) equal.  The boxes are seeded on a 1/64 grid, so
    both devices compute every IoU exactly alike.  Returns the distinct
    scores among the first pre_nms_limit."""
    import torch

    from maskfusion_tpu_torch.maskrcnn import model as mm

    rng = np.random.default_rng(seed)
    A = scores.shape[0]
    corner = rng.integers(0, 52, (A, 2))
    boxes = torch.from_numpy(np.concatenate(
        [corner, corner + rng.integers(1, 13, (A, 2))], 1) / 64).float()

    def run(device, n, k, thr):
        top, order = torch.sort(scores.to(device), descending=True,
                                stable=True)
        top, order = top[:n], order[:n]
        picks, valid = mm.nms_fixed(boxes.to(device)[order], top, k, thr)
        return order.cpu(), picks.cpu(), valid.cpu()

    for n, k, thr in ((cfg.pre_nms_limit, cfg.post_nms_proposals,
                       cfg.rpn_nms_threshold),
                      (cfg.post_nms_proposals, cfg.max_detections,
                       cfg.detection_nms_threshold)):
        for a, b, what in zip(run(dev, n, k, thr), run("cpu", n, k, thr),
                              ("order", "picks", "valid")):
            if not torch.equal(a, b):
                raise AssertionError(f"tie order on the card: {what} of "
                                     f"{k} in {n} differs from the CPU's")
    order = torch.sort(scores, descending=True, stable=True)[1]
    return len(torch.unique(scores[order[:cfg.pre_nms_limit]]))


def phase_nn_full_width(dev):
    """Phase 10b: the default MaskRCNNConfig (ResNet-50-FPN, 256 FPN
    channels, 512 px, 81 classes, bf16), seeded: the serving call's wall
    time (hot, median of 3 windows of 5) and the card's busy time a forward
    (median of 3 profiles), launches
    and synchronises per forward and the two NMS loops' share of the
    launches, peak memory, the MAC count and its bound at the card's bf16
    peak; P2..P6 against an f32 forward of the same weights (the bf16
    weights widened; relative L2 <= 3e-2 each) and every output finite."""
    import torch

    from maskfusion_tpu_torch.maskrcnn import model as mm
    from maskfusion_tpu_torch.maskrcnn.inference import MaskRCNNInference

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    net = MaskRCNNInference(mm.MaskRCNNConfig(), seed=0, device=dev)
    init_s = time.perf_counter() - t0
    weights = torch.cuda.memory_allocated() - base
    cfg = net.cfg
    S = cfg.image_size
    rgb = np.random.default_rng(30).integers(0, 256, (480, 640, 3),
                                             dtype=np.uint8)
    img = torch.from_numpy(rgb).to(dev)
    from maskfusion_tpu_torch.maskrcnn.resize import resize_rgb_u8

    x = resize_rgb_u8(img, (S, S)).float()[None]

    def forward():
        with torch.no_grad():
            return net.model(x)

    out = forward()
    torch.cuda.synchronize()
    for k, v in out.items():
        if v.is_floating_point() and not torch.isfinite(v).all():
            raise AssertionError(f"full-width output {k} is not finite")
    distinct = tie_order(torch.softmax(out["rpn_logits"][0].cpu(), -1)[:, 1],
                         cfg, dev)
    # the serving call as the worker makes it (host clock, its own stream)
    net.detect(rgb)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(5):
            net.detect(rgb)
        walls.append((time.perf_counter() - t0) * 1e3 / 5)
    wall_ms = float(np.median(walls))
    torch.cuda.reset_peak_memory_stats()
    forward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    # launches, synchronises and the card's busy time of one forward, in
    # three profiles (the busy time: their median)
    profiles = [profile_calls(forward) for _ in range(3)]
    launches, syncs, calls, _ = profiles[-1]
    busy = [p[3] for p in profiles]
    dev_ms = float(np.median(busy))
    # the two NMS loops alone, at the forward's sizes
    k = min(cfg.pre_nms_limit, mm.generate_anchors(cfg).shape[0])
    corner = 0.8 * torch.rand(k, 2, device=dev)
    boxes = torch.cat([corner, corner + 0.2 * torch.rand(k, 2, device=dev)],
                      1)
    scores = torch.rand(k, device=dev)
    nms_rpn = profile_calls(lambda: mm.nms_fixed(
        boxes, scores, cfg.post_nms_proposals, cfg.rpn_nms_threshold))[0]
    nb = cfg.post_nms_proposals
    nms_det = profile_calls(lambda: mm.nms_fixed(
        boxes[:nb], scores[:nb], cfg.max_detections,
        cfg.detection_nms_threshold))[0]
    macs = network_macs(net.model, lambda: net.model(x))
    total_macs = sum(macs.values())
    t_ops = 2 * total_macs / PEAK_BF16_S * 1e3
    nbytes = weights + x.numel() * 4 + sum(v.numel() * v.element_size()
                                           for v in out.values())
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    # P2..P6 against an f32 forward of the same weights (the bf16 ones,
    # widened): what the bf16 compute alone changes
    net32 = MaskRCNNInference(dataclasses.replace(cfg, dtype=torch.float32),
                              seed=0, device=dev)
    net32.model.load_state_dict({k: v.float() for k, v in
                                 net.model.state_dict().items()})
    with torch.no_grad():
        f16 = net.model.features(x)
        f32 = net32.model.features(x)
    rel = [float(torch.linalg.vector_norm((a.float() - b).flatten())
                 / torch.linalg.vector_norm(b.flatten()))
           for a, b in zip(f16, f32)]
    del net32, f16, f32
    rec = {"init_s": init_s, "serving_ms": wall_ms,
           "serving_windows_ms": walls, "forward_device_busy_ms": dev_ms,
           "forward_device_busy_profiles_ms": busy, "launches": launches,
           "synchronises": syncs,
           "nms_launches": {"rpn": nms_rpn, "detections": nms_det},
           "nms_share": (nms_rpn + nms_det) / launches,
           "weights_mb": weights / 2 ** 20, "peak_mb": peak / 2 ** 20,
           "gmac": {k: v / 1e9 for k, v in macs.items()},
           "gmac_total": total_macs / 1e9, "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "bound_ops_ms": t_ops, "bound_bytes_ms": t_bytes,
           "p2_p6_rel_l2_vs_f32": rel, "tie_order_distinct": distinct,
           "detections_valid": int(out["detection_valid"].sum())}
    log(f"  full width (512 px, 81 classes, bf16, seeded): init "
        f"{init_s:.1f} s; serving call {wall_ms:.2f} ms (windows "
        f"{[round(w, 2) for w in walls]}); the card busy "
        f"{dev_ms:.2f} ms a forward (profiles "
        f"{[round(b, 2) for b in busy]}); {launches} launches and {syncs} "
        f"synchronises "
        f"a forward, the NMS loops {nms_rpn} + {nms_det} "
        f"({rec['nms_share']:.1%}); weights {rec['weights_mb']:.1f} MB, "
        f"peak {rec['peak_mb']:.1f} MB; {total_macs / 1e9:.2f} GMAC "
        f"{ {k: round(v / 1e9, 2) for k, v in macs.items()} }, bound "
        f"{rec['bound_ms'] * 1e3:.1f} us ({rec['bound_by']}; bf16 "
        f"{t_ops * 1e3:.1f} us, bytes {t_bytes * 1e3:.1f} us); P2..P6 "
        f"relative L2 against f32 {[round(r, 4) for r in rel]}; tie order "
        f"equal to the CPU's ({distinct} distinct scores in the first "
        f"{cfg.pre_nms_limit})")
    if max(rel) > 3e-2:
        raise AssertionError(f"bf16 features differ from f32 by {rel}")
    if syncs:
        raise AssertionError(f"the forward synchronised {syncs} times "
                             f"({calls})")
    return rec


# ---------------------------------------------------------------- training
def _grads(model):
    return {n: p.grad.detach().float().cpu() for n, p in
            model.named_parameters() if p.grad is not None}


def phase_train_micro(dev):
    """Phase 11a: one create_train_step step at micro_config(64) (float32)
    on the card and on the CPU from the same seeded parameters, batch (two
    make_batch scenes) and draws: the losses within 1e-4 relative, every
    parameter's gradient within 1e-3 relative L2 and the whole gradient
    within 1e-4.  The card's gradients are not deterministic (the backward
    of ROIAlign's gathers adds with atomics), hence a relative bound."""
    import torch

    from maskfusion_tpu_torch.maskrcnn import synthetic_shapes as ss
    from maskfusion_tpu_torch.parallel.train import create_train_step

    cfg = ss.micro_config(64)
    batch = [torch.from_numpy(a) for a in
             ss.make_batch(np.random.default_rng(0), 2, 64)]
    draws = torch.rand((2, 2, cfg.post_nms_proposals + batch[1].shape[1]),
                       generator=torch.Generator().manual_seed(0))
    out = {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        init_fn, step_fn = create_train_step(cfg, 1e-3, device=device)
        state = init_fn(0, 2)
        state, loss = step_fn(state, draws.to(device),
                              *(a.to(device) for a in batch))
        out[name] = (float(loss), _grads(state.params))
    (la, ga), (lb, gb) = out["card"], out["cpu"]
    rel = {k: float(torch.linalg.vector_norm(ga[k] - gb[k])
                    / torch.linalg.vector_norm(gb[k]).clamp_min(1e-30))
           for k in gb}
    num = sum(float(torch.linalg.vector_norm(ga[k] - gb[k])) ** 2
              for k in gb)
    den = sum(float(torch.linalg.vector_norm(gb[k])) ** 2 for k in gb)
    whole = math.sqrt(num / den)
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:3]
    rec = {"loss_card": la, "loss_cpu": lb,
           "loss_rel": abs(la - lb) / abs(lb), "grad_rel_l2_whole": whole,
           "grad_rel_l2_worst": worst, "parameters": len(gb)}
    log(f"  micro step, card against CPU: loss {la:.6f} / {lb:.6f} "
        f"({rec['loss_rel']:.2e} relative); gradients of {len(gb)} "
        f"parameters: whole {whole:.2e} relative L2, worst "
        f"{[(k, f'{v:.2e}') for k, v in worst]}")
    if ga.keys() != gb.keys() or not (
            rec["loss_rel"] <= 1e-4 and worst[0][1] <= 1e-3
            and whole <= 1e-4):
        raise AssertionError(f"the card's train step differs from the "
                             f"CPU's: {rec}")
    return rec


def phase_train_shapes(dev):
    """Phase 11b: the shapes recipe (train_shapes, 700 steps) on the card,
    then its held-out quality on the card against the floors of
    tests/test_maskrcnn_train.py::test_shapes_checkpoint_quality, and the
    slow trainability test's criterion (the mean of the last 15 losses
    below 0.8 times the mean of the first 10)."""
    import torch

    from maskfusion_tpu_torch.maskrcnn import synthetic_shapes as ss

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, losses = ss.train_shapes(700, device=dev)
    seconds = time.perf_counter() - t0
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-15:]))
    t1 = time.perf_counter()
    q = ss.eval_shapes_detection(params, device=dev)
    eval_s = time.perf_counter() - t1
    rec = {"steps": len(losses), "seconds": seconds,
           "ms_per_step": seconds / len(losses) * 1e3,
           "loss_first10": first, "loss_last15": last, "eval": q,
           "eval_s": eval_s}
    log(f"  train_shapes(700) on the card in {seconds:.1f} s = "
        f"{rec['ms_per_step']:.2f} ms a step; loss {first:.4f} (first 10) "
        f"-> {last:.4f} (last 15); eval_shapes_detection in {eval_s:.1f} s: "
        f"{q}")
    floors = {"det_iou": 0.5, "cls_acc": 0.75, "mask_iou": 0.5,
              "mean_score": 0.55}
    if not (np.isfinite(losses).all() and last < 0.8 * first):
        raise AssertionError(f"train_shapes did not learn: {first} -> "
                             f"{last}")
    if not all(q[k] >= v for k, v in floors.items()):
        raise AssertionError(f"the shapes recipe on the card: {q} below "
                             f"{floors}")
    return rec


def phase_train_full_width(dev):
    """Phase 11c: create_train_step(MaskRCNNConfig()) -- ResNet-50-FPN,
    512 px, 81 classes, bf16 compute over float32 parameters, Adam at 1e-4
    -- on a batch of two make_batch scenes at 512 px, 10 steps on that one
    batch with a CUDA generator: every loss finite and the mean of the last
    3 below the first; wall ms a step (host clock to a synchronise, steps
    4-9), the card's busy ms, launches and synchronises of one profiled
    step (none may synchronise), peak memory, and the step's MACs (the
    forward's, counted by hooks on train_losses, times 3 for the
    backward's two products) against the bf16 peak."""
    import torch

    from maskfusion_tpu_torch.maskrcnn import model as mm
    from maskfusion_tpu_torch.maskrcnn import synthetic_shapes as ss
    from maskfusion_tpu_torch.parallel.train import create_train_step

    cfg = mm.MaskRCNNConfig()
    S = cfg.image_size
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    init_fn, step_fn = create_train_step(cfg, device=dev)
    state = init_fn(0, 2)
    batch = [torch.from_numpy(a).to(dev) for a in
             ss.make_batch(np.random.default_rng(40), 2, S)]
    gen = torch.Generator(device=dev).manual_seed(0)
    n_params = sum(p.numel() for p in state.params.parameters())
    torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    for i in range(3):
        state, loss = step_fn(state, gen, *batch)
        losses.append(loss)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(6):
        state, loss = step_fn(state, gen, *batch)
        losses.append(loss)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 6
    peak = torch.cuda.max_memory_allocated() - base

    def one_step():
        nonlocal state
        state, loss = step_fn(state, gen, *batch)
        losses.append(loss)

    launches, syncs, calls, busy_ms = profile_calls(one_step)
    values = torch.stack(losses).cpu().numpy()
    draws = torch.rand((2, 2, cfg.post_nms_proposals + batch[1].shape[1]),
                       generator=gen, device=dev)
    model = state.params
    fwd_macs = sum(network_macs(model, lambda: [
        model.train_losses(batch[0][b:b + 1], *(a[b] for a in batch[1:]),
                           draws[b]) for b in range(2)]).values())
    step_macs = 3 * fwd_macs
    t_ops = 2 * step_macs / PEAK_BF16_S * 1e3
    # bytes: the images and ground truth read once; the float32 parameters
    # and both Adam moments read and written once
    nbytes = (sum(a.numel() * a.element_size() for a in batch)
              + 2 * 3 * 4 * n_params)
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    rec = {"losses": values.tolist(), "first_3_steps_s": first_s,
           "wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy_ms,
           "launches_per_step": launches, "synchronises_per_step": syncs,
           "peak_mb": peak / 2 ** 20, "parameters": n_params,
           "forward_gmac": fwd_macs / 1e9, "step_gmac": step_macs / 1e9,
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "bound_ops_ms": t_ops, "bound_bytes_ms": t_bytes}
    log(f"  full width (512 px, 81 classes, bf16 over f32 parameters, "
        f"batch 2): {n_params / 1e6:.2f} M parameters; first 3 steps "
        f"{first_s:.2f} s; {wall_ms:.1f} ms a step (wall, 6 steps); the "
        f"card busy {busy_ms:.1f} ms a step; {launches} launches and {syncs} "
        f"synchronises a step; peak {rec['peak_mb']:.0f} MB; "
        f"{fwd_macs / 1e9:.1f} GMAC forward, {step_macs / 1e9:.1f} a step, "
        f"bound {rec['bound_ms']:.3f} ms ({rec['bound_by']}; bf16 "
        f"{t_ops:.3f} ms, bytes {t_bytes:.3f} ms); losses "
        f"{[round(float(v), 3) for v in values]}")
    if not np.isfinite(values).all():
        raise AssertionError(f"full-width losses not finite: {values}")
    if not values[-3:].mean() < values[0]:
        raise AssertionError(f"full-width losses did not fall: {values}")
    if syncs:
        raise AssertionError(f"a full-width train step synchronised {syncs} "
                             f"times ({calls})")
    return rec


# ---------------------------------------------------------------- Co-Fusion
def cofusion_config(Config, **kw):
    """bench.py's two-object configuration with the Co-Fusion segmenter
    (the CLI's -method cofusion); pipelined_multiobject stays at its
    default, which Co-Fusion answers with the synchronous frame."""
    from maskfusion_tpu_torch import bench

    return dataclasses.replace(bench.two_object_config(),
                               seg_method="cofusion", **kw)


def phase_cofusion(dev, kernels, MaskFusion, Config, Resolution,
                   CameraIntrinsics, FrameData, frames, intr, n_warm,
                   n_timed, n_prof):
    """Phase 12a: -method cofusion at 640x480 on bench.py's two-object
    frames (their masks dropped: Co-Fusion segments by motion), in
    bench.py's configuration with the Co-Fusion segmenter: warm-up and
    timed frames (FPS), the models at the end, the three kernels' launches
    over the run (the bilateral filter once a frame, the scan at least
    once, the edge map never: Co-Fusion computes no edges), every frame
    synchronous; then a profile of a few more frames (synchronises and
    launches a frame, the card's busy share)."""
    import torch

    W, H = 640, 480
    engine = MaskFusion(Resolution(W, H), CameraIntrinsics(*intr),
                        cofusion_config(Config), device=dev)
    frames = [dataclasses.replace(f, mask=None, class_ids=None)
              for f in frames]
    n_main = n_warm + n_timed
    kernels.reset_launch_counts()
    n_models = []
    t0 = time.perf_counter()
    for f in frames[:n_warm]:
        engine.process_frame(f)
        n_models.append(len(engine.models))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for f in frames[n_warm:n_main]:
        engine.process_frame(f)
        n_models.append(len(engine.models))
        if engine._pending:
            raise AssertionError("Co-Fusion took the pipelined step")
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    fps = n_timed / total
    launches = {k: getattr(kernels, k).launches for k in
                ("bilateral_depth", "predict_l0_scan", "geometric_edge_map")}
    log(f"  warm-up {n_warm} frames in {warm_s:.2f} s; timed {n_timed} "
        f"frames in {total:.3f} s = {fps:.2f} FPS; models after each frame "
        f"{n_models}; launches over the {n_main} frames {launches}")
    if (launches["bilateral_depth"] != n_main
            or launches["predict_l0_scan"] < n_main
            or launches["geometric_edge_map"] != 0):
        raise AssertionError(f"Co-Fusion launched {launches} in {n_main} "
                             "frames")
    for m in engine.models:
        if not np.isfinite(m.pose_log[-1]["pose"].cpu().numpy()).all():
            raise AssertionError(f"model {m.model_id}: non-finite pose")
    prof = profile_frames(engine, frames[n_main:n_main + n_prof],
                          1000.0 / fps)
    return {"fps": fps, "timed_s": total, "frames_timed": n_timed,
            "n_models": n_models, "n_models_end": len(engine.models),
            "model_ids": [m.model_id for m in engine.models],
            "surfels": [m.surfel_count for m in engine.models],
            "launches": launches, "launches_per_frame": {
                k: v / n_main for k, v in launches.items()},
            "profile": prof}


def phase_cofusion_parity(dev, MaskFusion, Config, Resolution,
                          CameraIntrinsics, FrameData, n_frames: int = 5):
    """Phase 12b: the 160x120 two-object scene without masks through the
    Co-Fusion engine on the CPU, frames 0-8; the card starts from the CPU
    engine's state after frame 3 (convert.engine_snapshot /
    restore_engine) and runs frames 4-8 (the CRF spawns an object from the
    motion at frame 7 on both).  Held on every frame: the same model ids, the
    global pose within 1 mm / 0.05 deg, object poses within 8 mm (the
    port's lockstep bounds against the JAX engine); reported: the share of
    pixels whose segmentation differs."""
    import torch

    from maskfusion_tpu_torch.convert import engine_snapshot, restore_engine

    frames = synthetic_two_objects(4 + n_frames)
    fx, fy, cx, cy, w, h = SMALL
    carry_at = 4

    def engine(device):
        return MaskFusion(
            Resolution(w, h), CameraIntrinsics(fx, fy, cx, cy),
            Config(global_surfel_capacity=1 << 16,
                   object_surfel_capacity=1 << 13, seg_method="cofusion",
                   model_spawn_offset=0, use_so3=False, open_loop=True),
            device=device)

    def step(eng, i):
        rgb, depth, _ = frames[i]
        eng.process_frame(FrameData(rgb=rgb, depth=depth,
                                    timestamp=float(i)))
        return ([m.model_id for m in eng.models],
                [m.pose_log[-1]["pose"].cpu().numpy().astype(np.float64)
                 for m in eng.models], eng.last_segmentation)

    cpu_eng = engine(torch.device("cpu"))
    for i in range(carry_at):
        step(cpu_eng, i)
    card_eng = engine(dev)
    restore_engine(card_eng, engine_snapshot(cpu_eng))
    rows = []
    for i in range(carry_at, len(frames)):
        (ia, pa, sa), (ib, pb, sb) = step(card_eng, i), step(cpu_eng, i)
        if ia != ib:
            raise AssertionError(f"frame {i}: models {ia} on the card, {ib} "
                                 "on the CPU")
        r = {"frame": i, "models": ia,
             "global_m": float(np.linalg.norm(pa[0][:3, 3] - pb[0][:3, 3])),
             "global_deg": _rot_deg(pa[0], pb[0]),
             "object_m": max((float(np.linalg.norm(x[:3, 3] - y[:3, 3]))
                              for x, y in zip(pa[1:], pb[1:])), default=0.0),
             "segmentation_differs": float((sa != sb).mean())}
        log(f"    frame {i}: models {ia}; global {r['global_m'] * 1e3:.4f} "
            f"mm {r['global_deg']:.5f} deg; objects {r['object_m'] * 1e3:.3f}"
            f" mm apart; segmentation differs on "
            f"{r['segmentation_differs']:.4%}")
        if not (r["global_m"] <= 1e-3 and r["global_deg"] <= 0.05
                and r["object_m"] <= 8e-3):
            raise AssertionError(f"Co-Fusion card and CPU differ: {r}")
        rows.append(r)
    return rows


def phase_cli_cofusion(kernels, frames, workdir: Path):
    """Phase 12c: `-method cofusion` through the CLI on a raw KLG log of
    phase 8's first frames (the static bench frames): it returns 0,
    processes every frame, writes one finite pose a frame (every frame is
    synchronous, so none is pending at the end), launches the bilateral
    filter once a frame and no edge map."""
    n = len(frames)
    rc, out, seconds, launches, processed, fps, export = run_cli_log(
        kernels, frames, workdir, "cofusion", ["-method", "cofusion"])
    if rc != 0:
        raise AssertionError(f"the Co-Fusion CLI returned {rc}")
    if processed != n:
        raise AssertionError(f"the Co-Fusion CLI did not process its {n} "
                             "frames")
    _, poses = read_tum(export / "poses-0.txt")
    if len(poses) != n or not all(np.isfinite(p).all() for p in poses):
        raise AssertionError(f"the Co-Fusion CLI wrote {len(poses)} poses "
                             f"for {n} frames, or non-finite ones")
    if launches["geometric_edge_map"] or launches["bilateral_depth"] != n:
        raise AssertionError(f"the Co-Fusion CLI launched {launches}")
    return {"frames": n, "seconds": seconds, "launches": launches,
            "fps": fps, "poses": len(poses)}

# ------------------------------------------------------ relocalisation
DEFORM_CAPACITY = 9437184    # the CLI's default global capacity
DEFORM_LIVE = 9_000_000      # live surfels in phase 13a's map
DEFORM_SAMPLE = 100_000      # rows held against the host blend


def phase_deformation(dev) -> dict:
    """13a: the deformation graph on the card at the CLI's default map
    size.  A 9,437,184-slot map holding 9,000,000 live surfels (seeded
    uniform positions in a 4 m cube, unit normals, 40,000 surfels a frame's
    init time; the dead rows hold values too) on the card; 1024 nodes
    sampled as the engine samples them (_apply_loop_closure: init-time
    order, systematic stride); 8 constraints moving live surfels by a
    rigid 4 mm shift (a closure the graph accepts, as
    tests/test_torch_reloc_engine.py's accepted case).  Timed: optimise()
    on two fresh graphs (the second with the native library warm) and
    which solver ran; apply_to_map_device over the whole map (cold and
    again); apply_to_points on 100,000 points (host in, host out).  Held:
    the acceptance gate passes; the map's blend on a 100,000-row sample of
    live rows within 1e-5 of the host blend (_apply_points_host); the dead
    rows bit-equal; apply_to_points within 1e-5 of the host blend."""
    import torch

    from maskfusion_tpu_torch.reloc.deformation import DeformationGraph

    cap, n = DEFORM_CAPACITY, DEFORM_LIVE
    gen = torch.Generator(device=dev).manual_seed(0)
    pos = torch.rand((cap, 3), generator=gen, device=dev) * 4.0 - 2.0
    normal = torch.nn.functional.normalize(
        torch.randn((cap, 3), generator=gen, device=dev), dim=1)
    init_time = (torch.arange(cap, device=dev) // 40000 + 1).float()
    times = init_time[:n].cpu().numpy()
    order = np.argsort(times)
    step = max(1, n // 1024)
    idx = order[::step][:1024]
    node_pos = pos[torch.from_numpy(idx).to(dev)].cpu().numpy()
    rng = np.random.default_rng(0)
    src = pos[torch.from_numpy(rng.integers(0, n, 8)).to(dev)].cpu().numpy()
    dst = src + np.array([0.004, -0.002, 0.0])

    def graph():
        g = DeformationGraph(node_pos, times[idx], device=dev)
        for a, b in zip(src, dst):
            g.add_constraint(a, b)
        return g

    opt_ms = []
    for _ in range(2):
        g = graph()
        t0 = time.perf_counter()
        total, mean_cons = g.optimise()
        opt_ms.append((time.perf_counter() - t0) * 1e3)
    accepted = bool(mean_cons < 0.0003 and total < 0.12)
    log(f"  optimise() at {g.n} nodes, {len(src)} constraints: "
        f"{opt_ms[0]:.1f} ms, then {opt_ms[1]:.1f} ms on a fresh graph "
        f"(solver {g.last_solver}; target < 50 ms with the native "
        f"solve); total {total:.3e}, mean constraint error "
        f"{mean_cons:.3e}, accepted {accepted}")
    if not accepted:
        raise AssertionError(f"the graph rejected a rigid 4 mm closure: "
                             f"total {total}, mean {mean_cons}")
    sample = torch.from_numpy(np.sort(rng.choice(n, DEFORM_SAMPLE,
                                                 replace=False))).to(dev)
    s_pos = pos[sample].cpu().numpy().astype(np.float64)
    s_nrm = normal[sample].cpu().numpy().astype(np.float64)
    dead_pos, dead_nrm = pos[n:].clone(), normal[n:].clone()
    torch.cuda.synchronize()
    apply_ms = []
    for k in range(2):
        t0 = time.perf_counter()
        g.apply_to_map_device(pos, normal, n)
        torch.cuda.synchronize()
        apply_ms.append((time.perf_counter() - t0) * 1e3)
        if k == 0:
            ref_p, ref_n = g._apply_points_host(s_pos, s_nrm)
            err_p = float(np.abs(pos[sample].cpu().numpy() - ref_p).max())
            err_n = float(np.abs(normal[sample].cpu().numpy()
                                 - ref_n).max())
            dead_equal = bool(torch.equal(pos[n:], dead_pos)
                              and torch.equal(normal[n:], dead_nrm))
    t0 = time.perf_counter()
    out_p, out_n = g.apply_to_points(s_pos, s_nrm)
    points_ms = (time.perf_counter() - t0) * 1e3
    err_pts = float(max(np.abs(out_p - ref_p).max(),
                        np.abs(out_n - ref_n).max()))
    log(f"  apply_to_map_device over {n} live of {cap} slots: "
        f"{apply_ms[0]:.1f} ms, again {apply_ms[1]:.1f} ms; against the "
        f"host blend on {DEFORM_SAMPLE} rows: positions {err_p:.2e}, "
        f"normals {err_n:.2e}; dead rows bit-equal {dead_equal}")
    log(f"  apply_to_points on {DEFORM_SAMPLE} points: {points_ms:.1f} ms "
        f"(target < 1 s), {err_pts:.2e} from the host blend")
    if not (err_p <= 1e-5 and err_n <= 1e-5 and err_pts <= 1e-5):
        raise AssertionError(f"the device blend differs from the host "
                             f"blend: {err_p}, {err_n}, {err_pts}")
    if not dead_equal:
        raise AssertionError("apply_to_map_device changed a dead row")
    return {"nodes": g.n, "constraints": len(src), "solver": g.last_solver,
            "optimise_ms": opt_ms, "total": total, "mean_cons": mean_cons,
            "accepted": accepted, "apply_to_map_ms": apply_ms,
            "live": n, "capacity": cap, "apply_to_points_ms": points_ms,
            "max_abs_err": {"map_pos": err_p, "map_normal": err_n,
                            "points": err_pts},
            "dead_rows_equal": dead_equal}


def reloc_scenario(eng, good, blind, n_good: int = 2,
                   max_blind: int = 20):
    """tests/test_reloc.py's relocalisation scenario on `eng`: `n_good`
    good frames, blind frames until the engine is lost (at most
    `max_blind`), then the good view again past the fern time gap (tick
    400) and once more.  Returns the per-frame (lost, last_frame_recovery,
    pose) and the number of fern frames after the good frames."""
    trace = []

    def run(frame, ts):
        eng.process_frame(dataclasses.replace(frame, timestamp=ts))
        trace.append((eng.lost, eng.last_frame_recovery,
                      eng.current_pose.astype(np.float64)))

    for i in range(n_good):
        run(good, float(i))
    n_ferns = len(eng.ferns.frames)
    for i in range(max_blind):
        run(blind, float(n_good + i))
        if eng.lost:
            break
    eng.tick = 400
    run(good, 400.0)
    run(good, 401.0)
    return trace, n_ferns


def check_recovery(trace, name: str) -> float:
    """The scenario's verdict: lost after the blind frames, recovered
    (last_frame_recovery) at the revisit within 2 cm of the first frame's
    pose, and no longer lost on the next frame.  Returns the recovery's
    translation error."""
    lost_at = next((i for i, t in enumerate(trace) if t[0]), None)
    err = float(np.linalg.norm(trace[-2][2][:3, 3] - trace[0][2][:3, 3]))
    log(f"  {name}: lost at frame {lost_at}, recovery at the revisit "
        f"{trace[-2][1]}, {err * 1e3:.3f} mm from the first frame's pose, "
        f"lost on the next frame {trace[-1][0]}")
    if lost_at is None or not trace[-2][1] or trace[-1][0]:
        raise AssertionError(f"{name}: the engine did not get lost and "
                             "recover: " + str([t[:2] for t in trace]))
    if not err < 0.02:
        raise AssertionError(f"{name}: recovery {err} m from the truth")
    return err


def phase_reloc_vga(dev, kernels, MaskFusion, Config, Resolution,
                    CameraIntrinsics, FrameData, frames, mo_frames, intr,
                    mo_run) -> dict:
    """13b: relocalisation at 640x480 on the card.  The -static engine with
    relocalisation and loop closure (every frame the synchronous step) on
    phase 3's first frame: 2 good frames, then 3 more profiled (launches
    and synchronises a frame), blind frames (no colour, no depth) until
    lost, the revisit at tick 400 recovered within 2 cm and lost cleared
    on the next frame.  Then the multi-object engine of phase 6 with
    relocalisation and loop closure (the JAX gate: the synchronous frame)
    on phase 6's frames: 14 warm-up and 8 timed frames, FPS, the three
    kernels' launches over this path (each must launch), a profile of 2
    frames: launches and synchronises a frame, beside phase 6's."""
    import torch

    W, H = 640, 480
    good = frames[0]
    blind = FrameData(rgb=np.zeros((H, W, 3), np.uint8),
                      depth=np.zeros((H, W), np.float32))
    cfg = Config(static_mode=True, global_surfel_capacity=1 << 22,
                 relocalisation=True, close_loops=True)
    eng = MaskFusion(Resolution(W, H),
                     CameraIntrinsics(528.0, 528.0, 320.0, 240.0), cfg,
                     device=dev)
    kernels.reset_launch_counts()
    for i in range(2):
        eng.process_frame(dataclasses.replace(good, timestamp=float(i)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(3):
        eng.process_frame(dataclasses.replace(good, timestamp=2.0 + i))
    torch.cuda.synchronize()
    static_ms = (time.perf_counter() - t0) * 1e3 / 3
    static_prof = profile_frames(
        eng, [dataclasses.replace(good, timestamp=5.0 + i)
              for i in range(2)], static_ms)
    trace, n_ferns = reloc_scenario(eng, good, blind, n_good=1)
    static_launches = {k: getattr(kernels, k).launches for k in
                       ("bilateral_depth", "predict_l0_scan",
                        "geometric_edge_map")}
    err = check_recovery(trace, "-static with ferns at 640x480")
    log(f"  -static frame with ferns: {static_ms:.1f} ms a frame, fern "
        f"frames {len(eng.ferns.frames)}, launches over the run "
        f"{static_launches}")

    n_warm, n_timed = 14, 8
    mcfg = dataclasses.replace(vga_multiobject_config(),
                               relocalisation=True, close_loops=True)
    meng = MaskFusion(Resolution(W, H), CameraIntrinsics(*intr), mcfg,
                      device=dev)
    kernels.reset_launch_counts()
    n_models = []
    for f in mo_frames[:n_warm]:
        out = meng.process_frame(f)
        n_models.append(len(meng.models))
        if out.get("pipelined"):
            raise AssertionError("a frame with ferns ran pipelined")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for f in mo_frames[n_warm:n_warm + n_timed]:
        meng.process_frame(f)
        n_models.append(len(meng.models))
    torch.cuda.synchronize()
    fps = n_timed / (time.perf_counter() - t0)
    launches = {k: getattr(kernels, k).launches for k in
                ("bilateral_depth", "predict_l0_scan", "geometric_edge_map")}
    prof = profile_frames(meng, mo_frames[n_warm + n_timed:
                                          n_warm + n_timed + 2],
                          1000.0 / fps)
    key = "cudaLaunchKernel"
    log(f"  multi-object with ferns at 640x480: {fps:.2f} FPS over "
        f"{n_timed} frames (phase 6, no ferns: {mo_run['fps']:.2f}); "
        f"models {n_models}; fern frames {len(meng.ferns.frames)}; "
        f"launches over {n_warm + n_timed} frames {launches}; a frame: "
        f"{prof['runtime_calls_per_frame'].get(key, 0.0):.1f} launches, "
        f"{prof['synchronises_per_frame']:.1f} synchronises (phase 6: "
        f"{mo_run['profile']['runtime_calls_per_frame'].get(key, 0.0):.1f}"
        f", {mo_run['profile']['synchronises_per_frame']:.1f})")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel never launched on the -rl "
                             f"multi-object path: {launches}")
    if max(n_models) < 3:
        raise AssertionError(f"the -rl run never held 3 models: {n_models}")
    return {"static": {"ms_per_frame": static_ms, "profile": static_prof,
                       "launches": static_launches,
                       "recovery_err_m": err, "fern_frames": n_ferns,
                       "lost_trace": [t[:2] for t in trace]},
            "multiobject": {"fps": fps, "frames_timed": n_timed,
                            "launches": launches, "n_models": n_models,
                            "fern_frames": len(meng.ferns.frames),
                            "profile": prof}}


def phase_reloc_parity(dev, MaskFusion, Config, Resolution,
                       CameraIntrinsics, FrameData) -> dict:
    """13c: the 160x120 relocalisation scenario (tests/test_reloc.py's:
    the wavy scene at the identity, 2 good frames, blind frames until
    lost, the revisit) on the card and on the CPU.  Held: the same lost /
    recovery verdict on every frame, poses within phase 4's bounds (1 mm,
    0.05 deg), the same fern frames kept (ids and times)."""
    import torch

    from maskfusion_tpu_torch.bench import render_points

    fx, fy, cx, cy, w, h = SMALL
    pts, cols = wavy_scene()
    rgb, depth = render_points(pts, cols, np.eye(4), *SMALL)
    good = FrameData(rgb=rgb, depth=depth)
    blind = FrameData(rgb=np.zeros_like(rgb), depth=np.zeros_like(depth))
    cfg = Config(global_surfel_capacity=1 << 16, static_mode=True,
                 use_so3=False, relocalisation=True, close_loops=True)
    runs = {}
    for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
        eng = MaskFusion(Resolution(w, h), CameraIntrinsics(fx, fy, cx, cy),
                         cfg, device=device)
        trace, _ = reloc_scenario(eng, good, blind)
        runs[name] = (trace, [(f.frame_id, f.src_time)
                              for f in eng.ferns.frames])
    (tc, fc), (tp, fp) = runs["card"], runs["cpu"]
    err = check_recovery(tc, "card at 160x120")
    dpos = max(np.linalg.norm(a[2][:3, 3] - b[2][:3, 3])
               for a, b in zip(tc, tp))
    drot = max(_rot_deg(a[2], b[2]) for a, b in zip(tc, tp))
    same = [a[:2] for a in tc] == [b[:2] for b in tp]
    log(f"  card vs CPU over {len(tc)} frames: the same lost/recovery "
        f"trace {same}; max pose difference {dpos * 1e3:.4f} mm, "
        f"{drot:.5f} deg; fern frames {fc} (CPU {fp})")
    if not (same and fc == fp and dpos <= 1e-3 and drot <= 0.05):
        raise AssertionError(f"card and CPU relocalisation differ: trace "
                             f"{same}, ferns {fc} / {fp}, {dpos} m, "
                             f"{drot} deg")
    return {"frames": len(tc), "max_pose_diff_m": dpos,
            "max_rot_diff_deg": drot, "recovery_err_m": err,
            "fern_frames": fc}


def phase_cli_reloc(kernels, frames, workdir: Path) -> dict:
    """13d: the CLI with -rl on phase 8's raw KLG log: `-static -rl` over
    every frame (one bilateral and one scan launch a frame, every pose
    finite); then the same run cut in two, `--save-state` after the first
    half (-e) and `--load-state` for the rest (-s): the resumed run's TUM
    poses match the uninterrupted run's within 1e-5 m."""
    n = len(frames)
    k = n // 2
    ckpt = workdir / "rl_state"
    rc, _, seconds, launches, processed, fps, export = run_cli_log(
        kernels, frames, workdir, "rl", ["-static", "-rl"])
    if rc != 0 or processed != n:
        raise AssertionError(f"-static -rl: rc {rc}, {processed} of {n} "
                             "frames")
    if launches["bilateral_depth"] != n or launches["predict_l0_scan"] < n:
        raise AssertionError(f"-static -rl launched {launches} in {n} "
                             "frames")
    stamps, poses = read_tum(export / "poses-0.txt")
    if len(poses) != n or not np.isfinite(np.asarray(poses)).all():
        raise AssertionError(f"-static -rl: {len(poses)} poses for {n} "
                             "frames, or non-finite ones")
    rc1, _, s1, _, p1, _, _ = run_cli_log(
        kernels, frames, workdir, "rl_first",
        ["-static", "-rl", "-e", str(k), "--save-state", str(ckpt)])
    rc2, _, s2, _, p2, _, export2 = run_cli_log(
        kernels, frames, workdir, "rl_rest",
        ["-static", "-rl", "-s", str(k), "--load-state", str(ckpt)])
    if (rc1, rc2, p1, p2) != (0, 0, k, n - k):
        raise AssertionError(f"save/load runs: rc {rc1} {rc2}, frames "
                             f"{p1} {p2} (expected {k} {n - k})")
    stamps2, poses2 = read_tum(export2 / "poses-0.txt")
    err = max(float(np.linalg.norm(a[:3, 3] - b[:3, 3]))
              for a, b in zip(poses2, poses))
    log(f"  -static -rl: {n} frames in {seconds:.2f} s ({fps:.2f} FPS), "
        f"launches {launches}; saved after {k} frames ({s1:.2f} s), "
        f"resumed for {n - k} ({s2:.2f} s): {len(poses2)} poses, max "
        f"{err:.2e} m from the uninterrupted run")
    if stamps2 != stamps or not err <= 1e-5:
        raise AssertionError(f"the resumed run's poses differ from the "
                             f"uninterrupted run's by {err} m")
    return {"frames": n, "seconds": seconds, "fps": fps,
            "launches": launches, "resumed_max_pose_diff_m": err,
            "split_at": k}


CLOSURE_SHIFT = np.array([0.004, -0.002, 0.0])   # phase 13e's closure


def one_object_scene():
    """tests/synthetic.make_scene_with_object (no offset): the wavy scene
    and a textured curved patch at z ~1.5 m, label 1 on the patch."""
    pts_bg, cols_bg = wavy_scene()
    x = np.linspace(-0.28, 0.28, 320)
    y = np.linspace(-0.21, 0.21, 240)
    X, Y = np.meshgrid(x, y)
    Z = 1.5 + 0.10 * np.sin(4.5 * X) + 0.08 * np.cos(5.5 * Y)
    pts = np.stack([X + 0.1, Y - 0.05, Z], -1).reshape(-1, 3).astype(
        np.float32)
    r = 127.5 + 110 * np.sin(17 * X)
    g = 127.5 + 110 * np.cos(13 * Y)
    cols = np.stack([r, g, np.full_like(r, 60.0)], -1).reshape(-1, 3)
    labels = np.concatenate([np.zeros(len(pts_bg), np.uint8),
                             np.ones(len(pts), np.uint8)])
    return (np.concatenate([pts_bg, pts]),
            np.concatenate([cols_bg, cols.clip(0, 255).astype(np.uint8)]),
            labels)


def phase_closure_parity(dev, MaskFusion, Config, Resolution,
                         CameraIntrinsics, FrameData) -> dict:
    """13e, first half: an accepted loop closure through the engine, card
    against CPU at 160x120.  The CPU -static engine with ferns runs 4
    frames of the wavy scene from a camera sliding 1 cm a frame along +x
    (tests/test_torch_reloc_engine.py's closure engine); its state is
    carried to a card engine and to a second CPU engine.  On each, frame 3
    is seen again and its fern search returns one FindResult: 40 map
    surfels led by a rigid 4 mm shift, the pose the camera's shifted as
    much.  It runs _relocalise's closure branch: the graph's optimise and
    gate, apply_to_map_device on the live map, apply_to_pose on every fern
    frame, the camera pose override; then frame 4 tracks from the deformed
    map.  Held: both accept; the deformed maps within 1e-5 on live rows and
    bit-equal to the carried map on dead ones, live surfels moved by about
    the shift; the fern poses within 1e-5 of each other and moved by the
    shift within half its length (a camera 2 m from the graph's nodes
    takes their blend, not the shift alone); the closure frame's pose is the FindResult's; frame 4's poses
    within phase 4's bounds (1 mm, 0.05 deg) and within 1 cm of the
    shifted truth."""
    import torch

    from maskfusion_tpu_torch.bench import render_points
    from maskfusion_tpu_torch.convert import engine_snapshot, \
        restore_engine
    from maskfusion_tpu_torch.reloc.ferns import FindResult, \
        SurfaceConstraint

    fx, fy, cx, cy, w, h = SMALL
    cpu = torch.device("cpu")
    cfg = Config(global_surfel_capacity=1 << 16, static_mode=True,
                 use_so3=False, relocalisation=True, close_loops=True)
    pts, cols = wavy_scene()
    truth, frames = [], []
    for i in range(5):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 0.01 * i
        truth.append(T)
        frames.append(render_points(pts, cols, T, *SMALL))

    def engine(device):
        return MaskFusion(Resolution(w, h), CameraIntrinsics(fx, fy, cx, cy),
                          cfg, device=device)

    def feed(eng, i, ts):
        rgb, depth = frames[i]
        eng.process_frame(FrameData(rgb=rgb, depth=depth, timestamp=ts))

    first = engine(cpu)
    for i in range(4):
        feed(first, i, float(i))
    snap = engine_snapshot(first)
    m0 = first.models[0].state.map
    n = first.models[0].surfel_count
    pos0, nrm0 = m0.pos.numpy().copy(), m0.normal.numpy().copy()
    ferns0 = [f.pose.copy() for f in first.ferns.frames]
    rng = np.random.default_rng(11)
    src = pos0[rng.choice(n, 40, replace=False)].astype(np.float64)
    est = first.current_pose.astype(np.float64)
    est[:3, 3] += CLOSURE_SHIFT
    res = FindResult(est.astype(np.float32),
                     [SurfaceConstraint(a, a + CLOSURE_SHIFT) for a in src],
                     0)
    runs = {}
    for name, device in (("card", dev), ("cpu", cpu)):
        eng = engine(device)
        restore_engine(eng, snap)
        rec = {"searched": 0}
        find, close = eng.ferns.find_frame, eng._apply_loop_closure

        def one_search(*args, _rec=rec, _eng=eng, _find=find, **kw):
            _eng.ferns.find_frame = _find
            _rec["searched"] += 1
            return res

        def closing(glob, found, _rec=rec, _eng=eng, _close=close):
            ok = _close(glob, found)
            m = glob.state.map
            _rec.update(accepted=ok, pos=m.pos.cpu().numpy(),
                        normal=m.normal.cpu().numpy(),
                        ferns=[f.pose.copy() for f in _eng.ferns.frames])
            return ok

        eng.ferns.find_frame = one_search
        eng._apply_loop_closure = closing
        feed(eng, 3, 4.0)
        rec["closure_pose"] = eng.current_pose.astype(np.float64)
        feed(eng, 4, 5.0)
        rec["next_pose"] = eng.current_pose.astype(np.float64)
        runs[name] = rec
    a, b = runs["card"], runs["cpu"]
    if not (a["searched"] == b["searched"] == 1 and a.get("accepted")
            and b.get("accepted")):
        raise AssertionError(f"the closure was not accepted: card "
                             f"{a.get('accepted')}, CPU {b.get('accepted')}")
    live = {}
    for k in ("pos", "normal"):
        x, y = a[k][:n], b[k][:n]
        if not np.array_equal(np.isnan(x), np.isnan(y)):
            raise AssertionError(f"the deformed {k} differ in their NaNs")
        live[k] = float(np.nanmax(np.abs(x - y)))
    dead_equal = all(np.array_equal(r[k][n:], ref[n:])
                     for r in (a, b)
                     for k, ref in (("pos", pos0), ("normal", nrm0)))
    moved = float(np.nanmedian(np.linalg.norm(a["pos"][:n] - pos0[:n],
                                              axis=1)))
    fern_diff = max(float(np.abs(x - y).max())
                    for x, y in zip(a["ferns"], b["ferns"]))
    fern_moved = max(float(np.linalg.norm(x[:3, 3] - y[:3, 3]
                                          - CLOSURE_SHIFT))
                     for x, y in zip(a["ferns"], ferns0))
    pose_err = max(float(np.abs(r["closure_pose"] - est).max())
                   for r in (a, b))
    dpos = float(np.linalg.norm(a["next_pose"][:3, 3]
                                - b["next_pose"][:3, 3]))
    drot = _rot_deg(a["next_pose"], b["next_pose"])
    truth_err = max(float(np.linalg.norm(r["next_pose"][:3, 3]
                                         - truth[4][:3, 3] - CLOSURE_SHIFT))
                    for r in (a, b))
    log(f"  accepted closure on {n} live surfels, {len(ferns0)} fern "
        f"frames: card vs CPU deformed map positions {live['pos']:.2e}, "
        f"normals {live['normal']:.2e}; dead rows bit-equal {dead_equal}; "
        f"median surfel moved {moved * 1e3:.3f} mm (shift "
        f"{np.linalg.norm(CLOSURE_SHIFT) * 1e3:.3f} mm); fern poses "
        f"{fern_diff:.2e} apart, {fern_moved * 1e3:.3f} mm from the shift; "
        f"closure "
        f"pose {pose_err:.2e} from the FindResult's; next frame "
        f"{dpos * 1e3:.4f} mm, {drot:.5f} deg apart, {truth_err * 1e3:.3f} "
        f"mm from the shifted truth")
    if not (live["pos"] <= 1e-5 and live["normal"] <= 1e-5 and dead_equal):
        raise AssertionError(f"card and CPU deform the map differently: "
                             f"{live}, dead rows equal {dead_equal}")
    if not (moved > 0.5 * np.linalg.norm(CLOSURE_SHIFT)
            and fern_moved <= 0.5 * np.linalg.norm(CLOSURE_SHIFT)
            and fern_diff <= 1e-5):
        raise AssertionError(f"the closure did not move the map and the "
                             f"ferns: {moved} m, {fern_moved}, {fern_diff}")
    if not (pose_err <= 1e-6 and dpos <= 1e-3 and drot <= 0.05
            and truth_err <= 0.01):
        raise AssertionError(f"the poses after the closure: {pose_err}, "
                             f"{dpos} m, {drot} deg, {truth_err} m")
    return {"live": n, "fern_frames": len(ferns0),
            "max_abs_err": live, "dead_rows_equal": dead_equal,
            "median_moved_m": moved, "fern_pose_diff": fern_diff,
            "fern_shift_err": fern_moved, "next_pose_diff_m": dpos,
            "next_rot_diff_deg": drot, "next_truth_err_m": truth_err}


REDETECTION_SCHEDULES = ("sync", "prefused")


def phase_redetection_parity(dev, MaskFusion, Config, Resolution,
                             CameraIntrinsics, FrameData) -> dict:
    """13e, second half: tests/test_torch_redetection.py's scenario, card
    against CPU at 160x120, in the synchronous schedule (the precomputed
    segmenter) and the prefused one (the maskfusion segmenter: the
    reactivation runs in the pipelined host stage).  Three frames of the
    one-object scene spawn the object; it is made inactive, as a tracking
    jump would; three more frames.  Held on each device: the inactive
    model is reactivated under its id with its map; card and CPU give the
    same reactivated id and the same live ids after every frame."""
    import torch

    from maskfusion_tpu_torch.bench import render_points

    fx, fy, cx, cy, w, h = SMALL
    pts, cols, labels = one_object_scene()
    rgb, depth, lab = render_points(pts, cols, np.eye(4), *SMALL,
                                    labels=labels)
    base = dict(global_surfel_capacity=1 << 16,
                object_surfel_capacity=1 << 13, use_so3=False,
                open_loop=True, enable_redetection=True,
                keep_all_models=True, model_spawn_offset=0)
    schedules = {
        "sync": dict(seg_method="precomputed"),
        "prefused": dict(seg_method="maskfusion",
                         pipelined_multiobject=True, fuse_mask_lag=True)}
    out = {}
    for sched in REDETECTION_SCHEDULES:
        runs = {}
        for name, device in (("card", dev), ("cpu", torch.device("cpu"))):
            eng = MaskFusion(Resolution(w, h),
                             CameraIntrinsics(fx, fy, cx, cy),
                             Config(**base, **schedules[sched]),
                             device=device)

            def step(i, _eng=eng):
                _eng.process_frame(FrameData(rgb=rgb, depth=depth, mask=lab,
                                             class_ids=[0, 7],
                                             timestamp=float(i)))
                _eng.drain_pipeline()
                return [m.model_id for m in _eng.models]

            ids = [step(i) for i in range(3)]
            if len(eng.models) != 2:
                raise AssertionError(f"{sched} on the {name}: the object "
                                     f"did not spawn: {ids}")
            obj = eng.models[1]
            eng._inactivate_model(obj, "phase 13e")
            ids += [step(i) for i in range(3, 6)]
            runs[name] = {"reactivated": obj.model_id, "ids": ids,
                          "inactive": obj in eng.inactive_models,
                          "surfels": obj.surfel_count,
                          "pipelined": eng._pipelined_active}
        a, b = runs["card"], runs["cpu"]
        log(f"  redetection, {sched}: model {a['reactivated']} reactivated "
            f"on the card with {a['surfels']} surfels (CPU {b['surfels']}); "
            f"live ids card {a['ids']}, CPU {b['ids']}; pipelined "
            f"{a['pipelined']}")
        for r in (a, b):
            if (r["inactive"] or r["reactivated"] not in r["ids"][-1]
                    or r["surfels"] <= 50
                    or r["pipelined"] != (sched == "prefused")):
                raise AssertionError(f"{sched}: the model was not "
                                     f"reactivated: {r}")
        if (a["reactivated"], a["ids"]) != (b["reactivated"], b["ids"]):
            raise AssertionError(f"{sched}: card and CPU reactivate "
                                 f"differently: {a}, {b}")
        out[sched] = a
    return out


VGA_SEQUENCE_FRAMES = 200


def phase_vga_sequence(kernels, workdir: Path) -> dict:
    """The port's sequence-level check at 640x480 (scripts/parity_vga.py's
    run): make_sequence's 200-frame sequence (seed 0), through the port's CLI with -method precomputed in the
    exact schedule, scored by tools.evaluate: camera ATE-RMSE, the object
    log's displacement error (parity_vga.object_displacement's: RMSE over
    the longest object log, re-based to its first frame) and the instance
    IoU.  Held within 2x of the JAX package's (PARITY.md: 3.25 mm, 1.22 cm,
    IoU 1.00 -> 6.5 mm, 2.44 cm, IoU >= 0.5)."""
    import contextlib
    import io

    from maskfusion_tpu_torch import main as cli
    from maskfusion_tpu_torch.tools import make_sequence
    from maskfusion_tpu_torch.tools.evaluate import ate_rmse, \
        segmentation_iou

    seq, out = workdir / "seq_vga", workdir / "seq_vga_out"
    t0 = time.perf_counter()
    make_sequence.generate(str(seq), frames=VGA_SEQUENCE_FRAMES, width=640,
                           height=480)
    gen_s = time.perf_counter() - t0
    argv = ["-dir", str(seq), "-cal", str(seq / "calibration.txt"),
            "-exportdir", str(out), "-ep", "-q", "--pipeline", "exact",
            "-method", "precomputed", "-es"]
    kernels.reset_launch_counts()
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        rc = cli.main(argv)
    run_s = time.perf_counter() - t0
    launches = {k: getattr(kernels, k).launches for k in
                ("bilateral_depth", "predict_l0_scan", "geometric_edge_map")}
    if rc != 0:
        raise AssertionError(f"the sequence CLI returned {rc}")
    ate = ate_rmse(str(out / "poses-0.txt"), str(seq / "groundtruth.txt"))
    iou = segmentation_iou(str(out), str(seq / "gt_masks"), est_offset=-1)
    obj_paths = [p for p in out.iterdir() if p.name.startswith("poses-")
                 and p.name != "poses-0.txt"]
    est = max((np.loadtxt(p).reshape(-1, 8) for p in obj_paths), key=len)
    gt = np.loadtxt(seq / "object_groundtruth.txt")
    gt_by_ts = {round(r[0], 3): r[1:4] for r in gt}
    pairs = [(r[1:4], gt_by_ts[round(r[0], 3)]) for r in est
             if round(r[0], 3) in gt_by_ts]
    e = np.array([p[0] for p in pairs])
    g = np.array([p[1] for p in pairs])
    d = np.linalg.norm((e - e[0]) - (g - g[0]), axis=1)
    obj = {"rmse_m": float(np.sqrt((d ** 2).mean())),
           "final_m": float(d[-1]), "max_m": float(d.max()),
           "frames": len(pairs)}
    log(f"  {VGA_SEQUENCE_FRAMES} frames generated in {gen_s:.1f} s, run "
        f"in {run_s:.1f} s ({VGA_SEQUENCE_FRAMES / run_s:.2f} FPS, reading "
        f"included); launches {launches}")
    log(f"  camera ATE-RMSE {ate['rmse'] * 1e3:.3f} mm over {ate['pairs']} "
        f"pairs (JAX package 3.25 mm); object displacement RMSE "
        f"{obj['rmse_m'] * 1e2:.3f} cm over {obj['frames']} frames, final "
        f"{obj['final_m'] * 1e2:.3f} cm (JAX 1.22 cm); instance IoU "
        f"{iou['mean_iou']:.4f} over {iou['frames']} frames (JAX 1.00)")
    if not (ate["rmse"] <= 2 * 3.25e-3 and obj["rmse_m"] <= 2 * 1.22e-2
            and iou["mean_iou"] >= 0.5 and ate["pairs"] >= 190):
        raise AssertionError(f"the VGA sequence is outside 2x of the JAX "
                             f"package's: {ate}, {obj}, {iou}")
    return {"frames": VGA_SEQUENCE_FRAMES, "generate_s": gen_s,
            "run_s": run_s, "launches": launches, "ate": ate,
            "object": obj, "iou": iou}


# ------------------------------------------------- viewer, defaults, soak
KERNEL_NAMES = ("bilateral_depth", "predict_l0_scan", "geometric_edge_map")
CLI_GLOBAL_CAPACITY = 9437184          # the CLI's defaults (main.py)
CLI_OBJECT_CAPACITY = 1 << 20
VIEWER_DEPTH_SHARE = 3e-3              # tests/test_pallas.py's tie rule
# fault 4 (ROADMAP) records the scan's winner flipping on 3.09% of the
# pixels of the smooth 160x120 scene between the card and the plain
# version, depths agreeing; a flipped winner may show another colour
VIEWER_TIE_SHARE = 3.09e-2
SOAK_FRAMES = 150
SOAK_JAX_BUCKETS = [327680, 409600, 512000]   # PARITY.md, first 120 frames


def hold_viewer_views(out, ref) -> dict:
    """Two render_map_view results of one map: depth within 1e-5 on all but
    VIEWER_DEPTH_SHARE of the pixels; a tie pixel is one whose winner
    differs (depth or normal more than 1e-5 apart), at most
    VIEWER_TIE_SHARE of them; colour within one level on the others."""
    depth_off = np.abs(out["depth"] - ref["depth"]) > 1e-5
    tie = depth_off | (np.abs(out["normal"] - ref["normal"]).max(-1) > 1e-5)
    diff = np.abs(out["rgb"].astype(int) - ref["rgb"].astype(int))
    rgb_off = diff[~tie].max(initial=0)
    rec = {"depth_differ": float(depth_off.mean()), "tie": float(tie.mean()),
           "rgb_differ": float((diff.max(-1) > 0).mean()),
           "max_rgb_diff_off_ties": int(rgb_off)}
    if not (rec["depth_differ"] < VIEWER_DEPTH_SHARE
            and rec["tie"] <= VIEWER_TIE_SHARE and rgb_off <= 1):
        raise AssertionError(f"the views differ beyond the bound: {rec}")
    return rec


def viewer_map(MaskFusion, Config, Resolution, CameraIntrinsics, FrameData,
               device):
    """The CPU -static engine after two frames of the 160x120 wavy scene
    (tests/test_cli.py's viewer scenario)."""
    _, frames, (fx, fy, cx, cy, w, h) = synthetic_trajectory(2)
    eng = MaskFusion(Resolution(w, h), CameraIntrinsics(fx, fy, cx, cy),
                     Config(global_surfel_capacity=1 << 16, static_mode=True,
                            use_so3=False), device=device)
    for i, (rgb, depth) in enumerate(frames):
        eng.process_frame(FrameData(rgb=rgb, depth=depth,
                                    timestamp=float(i)))
    return eng


def orbit_pose(live: np.ndarray) -> np.ndarray:
    """A free orbit view of the map: the live camera's orbit turned and
    pulled back (the 'm' key's camera, as tests/test_cli.py moves it)."""
    from maskfusion_tpu_torch.viewer import OrbitCamera

    cam = OrbitCamera.from_pose(live)
    cam.rotate(0.25, 0.1)
    cam.dolly(1.3)
    return cam.pose()


def phase_viewer_parity(dev, kernels, MaskFusion, Config, Resolution,
                        CameraIntrinsics, FrameData) -> dict:
    """15a: render_map_view at 160x120 on the card against the CPU, on a
    map the CPU engine built and convert carried to a card engine: from
    the live pose and from an orbit pose; each card render launches the
    scan once."""
    import torch

    from maskfusion_tpu_torch import viewer
    from maskfusion_tpu_torch.convert import engine_snapshot, \
        restore_engine

    cpu_eng = viewer_map(MaskFusion, Config, Resolution, CameraIntrinsics,
                         FrameData, torch.device("cpu"))
    card = MaskFusion(cpu_eng.res, cpu_eng.intr, cpu_eng.cfg, device=dev)
    restore_engine(card, engine_snapshot(cpu_eng))
    live = cpu_eng.current_pose
    out = {}
    for name, pose in (("live", live), ("orbit", orbit_pose(live))):
        ref = viewer.render_map_view(
            cpu_eng.models[0].state.map, pose, cpu_eng.intr,
            cpu_eng.res.width, cpu_eng.res.height)
        before = kernels.predict_l0_scan.launches
        got = viewer.render_map_view(
            card.models[0].state.map, pose, card.intr, card.res.width,
            card.res.height)
        launched = kernels.predict_l0_scan.launches - before
        rec = hold_viewer_views(got, ref)
        rec["scan_launches"] = launched
        rec["visible"] = float((got["depth"] > 0).mean())
        log(f"  {name} view: {rec['depth_differ']:.2e} of the pixels differ "
            f"in depth, {rec['tie']:.2e} tie (winner differs), "
            f"{rec['rgb_differ']:.2e} differ in colour (at most "
            f"{rec['max_rgb_diff_off_ties']} level off the ties); "
            f"{rec['visible']:.3f} of the view shows the map; "
            f"{launched} scan launch")
        if launched != 1:
            raise AssertionError(f"a card render launched the scan "
                                 f"{launched} times")
        if rec["visible"] < 0.3:
            raise AssertionError(f"the {name} view shows too little map")
        out[name] = rec
    return out


def time_viewer_frame(engine, kernels) -> dict:
    """The viewer on the engine's global map from its live pose: the
    render and its one fetch (render_index_map, combined_predict, the
    three images to the host) over the engine's bucket (map_extent, the
    port's form) and over the whole capacity (the JAX viewer's form), and
    the whole render_map_view as the viewer calls it (with the host's
    shading), each the median of 5 calls timed with CUDA events after one
    warm call; one LiveViewer frame after a warm one (host clock); each
    kernel's launches in that frame and in one -ev viewport; the canvas
    shape."""
    import torch

    from maskfusion_tpu_torch import gui, viewer
    from maskfusion_tpu_torch.mapping import surfel_map as sm
    from maskfusion_tpu_torch.ops import splat

    glob = engine.models[0]
    m, intr = glob.state.map, engine.intr
    H, W = engine.res.height, engine.res.width
    pose = glob.state.pose.cpu().numpy()
    count = int(m.count)
    extent = viewer.map_extent(glob)
    if extent is None or not count <= extent < m.capacity:
        raise AssertionError(f"the bucket {extent} does not bound the count "
                             f"{count} below the capacity {m.capacity}")
    pose_inv = torch.as_tensor(np.linalg.inv(pose).astype(np.float32),
                               device=m.pos.device)

    def render(view):
        im = splat.render_index_map(
            view, pose_inv, intr, H, W, time=float("inf"),
            time_delta=float("inf"), max_depth=12.0)
        pred = splat.combined_predict(im, intr, 12.0)
        return torch.cat([pred.rgb, pred.nmap, pred.depth[..., None]],
                         dim=-1).cpu()

    def event_ms(fn):
        fn()
        times = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    def counts():
        return {k: getattr(kernels, k).launches for k in KERNEL_NAMES}

    def launched(fn):
        before = counts()
        fn()
        return {k: n - before[k] for k, n in counts().items()}

    prefix_ms = event_ms(lambda: render(sm.prefix_view(m, extent)))
    full_ms = event_ms(lambda: render(m))
    view_ms = event_ms(lambda: viewer.render_map_view(m, pose, intr, W, H,
                                                      extent=extent))
    live = gui.LiveViewer(engine, offscreen=True)
    live.update()                     # warm: OpenCV's first text and resize
    pending = len(getattr(engine, "_pending", ()))
    t0 = time.perf_counter()
    frame_launches = launched(live.update)
    frame_ms = (time.perf_counter() - t0) * 1e3
    if len(getattr(engine, "_pending", ())) != pending:
        raise AssertionError("the viewer frame drained the pipeline")
    ev_launches = launched(lambda: viewer.viewport(engine))
    rec = {"count": count, "extent": extent, "capacity": m.capacity,
           "render_ms": prefix_ms, "render_full_capacity_ms": full_ms,
           "render_map_view_ms": view_ms, "viewer_frame_ms": frame_ms,
           "launches_viewer_frame": frame_launches,
           "launches_viewport": ev_launches,
           "canvas": list(live.last_canvas.shape), "models":
           len(engine.models), "pending_frames": pending}
    log(f"  {count} live surfels in a bucket of {extent} of {m.capacity}: "
        f"render and fetch {prefix_ms:.2f} ms over the bucket, "
        f"{full_ms:.2f} ms over the whole capacity; render_map_view "
        f"{view_ms:.2f} ms (CUDA events, medians of 5); a LiveViewer frame "
        f"{frame_ms:.1f} ms (host clock), canvas {rec['canvas']} with "
        f"{len(engine.models)} models, {pending} frames pending; launches "
        f"{frame_launches} in a viewer frame, {ev_launches} in a viewport")
    want = {"bilateral_depth": 0, "predict_l0_scan": 1,
            "geometric_edge_map": 0}
    if frame_launches != want or ev_launches != want:
        raise AssertionError(f"a viewer frame or a viewport launched "
                             f"{frame_launches} / {ev_launches}, {want} "
                             "expected")
    want_h = 2 * H + 24 + (H // 2 if len(engine.models) > 1 else 0)
    if rec["canvas"] != [want_h, 2 * W, 3]:
        raise AssertionError(f"canvas {rec['canvas']}, {want_h} rows "
                             "expected")
    return rec


def phase_viewer_vga(dev, kernels, MaskFusion, Config, Resolution,
                     CameraIntrinsics, frames, mo_frames, mo_intr) -> dict:
    """15b: the viewer at 640x480 at the CLI's default capacities, on the
    -static engine after 12 of phase 3's frames and on the prefused
    multi-object engine (bench.py's two-object configuration) after 16
    of phase 6b's frames, read without a drain."""
    from maskfusion_tpu_torch import bench

    out = {}
    static = MaskFusion(Resolution(640, 480),
                        CameraIntrinsics(*bench.STATIC_INTRINSICS),
                        Config(static_mode=True,
                               global_surfel_capacity=CLI_GLOBAL_CAPACITY),
                        device=dev)
    for f in frames[:12]:
        static.process_frame(f)
    static.flush_diagnostics()
    out["static"] = time_viewer_frame(static, kernels)
    del static
    cfg = dataclasses.replace(bench.two_object_config(),
                              global_surfel_capacity=CLI_GLOBAL_CAPACITY,
                              object_surfel_capacity=CLI_OBJECT_CAPACITY)
    mo = MaskFusion(Resolution(640, 480), CameraIntrinsics(*mo_intr), cfg,
                    device=dev)
    for f in mo_frames[:16]:
        mo.process_frame(f)
    if len(mo.models) < 2:
        raise AssertionError(f"no object model live after 16 frames: "
                             f"{len(mo.models)} models")
    out["prefused"] = time_viewer_frame(mo, kernels)
    mo.drain_pipeline()
    return out


def write_log(frames, path: Path) -> None:
    """A raw KLG log of `frames` with distinct non-zero stamps and one
    frame more: the KLG reader, as the reference's
    (KlgLogReader::hasMore), never returns a log's last frame."""
    from maskfusion_tpu_torch.io.klg_reader import write_klg

    stamped = [dataclasses.replace(f, timestamp=33333.0 * (i + 1))
               for i, f in enumerate(frames + frames[-1:])]
    write_klg(str(path), stamped, compress=False)


def phase_cli_defaults(kernels, frames, phase8_poses, workdir: Path) -> dict:
    """15c: `-static -viewer -ev` on phase 8's log at the CLI's default
    capacities (no capacity flag), the viewer offscreen as on any machine
    without a display: rc 0, poses within 1e-5 m of phase 8's run at
    2^22 surfels, one Viewport*.png a frame, the launches, peak memory."""
    import os

    import torch

    from maskfusion_tpu_torch import main as cli

    n = len(frames)
    log_path = workdir / "defaults.klg"
    write_log(frames, log_path)
    export = workdir / "defaults"
    # -ev writes only into an export directory that exists, as in the JAX
    # CLI (ROADMAP fault 15)
    export.mkdir()
    argv = ["-l", str(log_path), "-static", "-q", "-viewer", "-ev", "-ep",
            "-exportdir", str(export)]
    env = {k: os.environ.pop(k) for k in ("DISPLAY", "WAYLAND_DISPLAY")
           if k in os.environ}
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        rc = cli.main(argv)
        seconds = time.perf_counter() - t0
    finally:
        os.environ.update(env)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    launches = {k: getattr(kernels, k).launches for k in KERNEL_NAMES}
    if rc != 0:
        raise AssertionError(f"the CLI at its defaults returned {rc}")
    _, poses = read_tum(export / "poses-0.txt")
    shots = sorted(export.glob("Viewport*.png"))
    dpos = max(np.linalg.norm(a[:3, 3] - b[:3, 3])
               for a, b in zip(poses, phase8_poses))
    log(f"  rc {rc}, {n} frames in {seconds:.2f} s; {len(shots)} viewports; "
        f"poses within {dpos:.2e} m of phase 8's run at 2^22 surfels; "
        f"launches {launches}; peak {peak:.0f} MB allocated")
    if len(poses) != n or not dpos <= 1e-5:
        raise AssertionError(f"{len(poses)} poses for {n} frames, {dpos} m "
                             "from phase 8's run (bound 1e-5)")
    if len(shots) != n:
        raise AssertionError(f"{len(shots)} Viewport*.png for {n} frames")
    # a frame: one scan for the engine, one for the viewer, one for -ev
    want = {"bilateral_depth": n, "predict_l0_scan": 3 * n,
            "geometric_edge_map": 0}
    if launches != want:
        raise AssertionError(f"launches {launches}, {want} expected")
    return {"seconds": seconds, "frames": n, "viewports": len(shots),
            "max_pose_diff_m": dpos, "launches": launches,
            "peak_mb": peak}


def soak_frames(n: int, W: int = 640, H: int = 480):
    """scripts/soak_capacity.py's wide-sweep frames: the camera pans so
    most of each frame is new geometry."""
    from maskfusion_tpu_torch.frame import FrameData

    u, v = np.meshgrid(np.arange(W), np.arange(H))
    frames = []
    for i in range(n):
        ph = i * 0.35
        depth = (1.6 + 0.0004 * u + 0.0003 * v
                 + 0.25 * np.sin(u * 0.013 + ph)
                 * np.cos(v * 0.011 + 0.3 * ph)).astype(np.float32)
        rgb = np.stack([(u * 3 + 11 * i) % 256, (v * 2 + 5 * i) % 256,
                        (u + v + 7 * i) % 256], -1).astype(np.uint8)
        frames.append(FrameData(rgb=rgb, depth=depth, timestamp=float(i)))
    return frames


def phase_soak(dev, kernels, MaskFusion, Config, Resolution,
               CameraIntrinsics) -> dict:
    """15d: scripts/soak_capacity.py on the card: 150 wide-sweep frames
    through the -static engine at the CLI's default 9,437,184-slot map;
    every 10 frames the count, the engine's bucket and the soak's bucket
    (choose_bucket as the script computes it), ms a frame; the buckets
    visited, FPS, peak memory.  Held: no error, the count under the
    capacity and at or under the engine's bucket, finite poses, at least
    two bucket steps."""
    import torch

    from maskfusion_tpu_torch.mapping import surfel_map as sm

    t_gen = time.perf_counter()
    frames = soak_frames(SOAK_FRAMES)
    gen_s = time.perf_counter() - t_gen
    cap = CLI_GLOBAL_CAPACITY
    eng = MaskFusion(Resolution(640, 480),
                     CameraIntrinsics(528.0, 528.0, 320.0, 240.0),
                     Config(static_mode=True, global_surfel_capacity=cap),
                     device=dev)
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    rows, soak_buckets, engine_buckets = [], set(), set()
    t0 = t_last = time.perf_counter()
    for i, f in enumerate(frames):
        eng.process_frame(f)
        if eng.models[0].last_bucket:
            engine_buckets.add(eng.models[0].last_bucket)
        if i % 10 == 9:
            eng.flush_diagnostics()
            cnt = eng._last_count
            b_engine = eng.models[0].last_bucket
            b = sm.choose_bucket(cnt, cap, current=b_engine)
            soak_buckets.add(b)
            now = time.perf_counter()
            rows.append({"frame": i + 1, "count": int(cnt),
                         "bucket": int(b_engine), "soak_bucket": int(b),
                         "ms_per_frame": (now - t_last) * 100.0})
            t_last = now
            log(f"  frame {i + 1:4d}: surfels {cnt:9d}, engine bucket "
                f"{b_engine:9d}, soak bucket {b:9d}, "
                f"{rows[-1]['ms_per_frame']:.1f} ms a frame")
            if not (cnt < cap and b_engine >= cnt):
                raise AssertionError(f"count {cnt}, bucket {b_engine}, "
                                     f"capacity {cap}")
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    poses = eng.pose_log_numpy()
    if len(poses) != SOAK_FRAMES or not np.isfinite(np.asarray(poses)).all():
        raise AssertionError("the soak's poses are missing or not finite")
    first120 = sorted({r["soak_bucket"] for r in rows if r["frame"] <= 120})
    rec = {"frames": SOAK_FRAMES, "capacity": cap, "rows": rows,
           "final_count": rows[-1]["count"],
           "buckets_visited": sorted(soak_buckets),
           "engine_buckets": sorted(engine_buckets),
           "buckets_first_120": first120,
           "jax_buckets_first_120": SOAK_JAX_BUCKETS,
           "fps": SOAK_FRAMES / total, "peak_mb": peak,
           "frames_generated_s": gen_s,
           "launches": {k: getattr(kernels, k).launches for k in
                        KERNEL_NAMES}}
    log(f"  {SOAK_FRAMES} frames in {total:.1f} s = {rec['fps']:.2f} FPS "
        f"(frames made in {gen_s:.1f} s); buckets visited "
        f"{rec['buckets_visited']} (the engine's {rec['engine_buckets']}); "
        f"first 120 frames {first120}, the JAX run's {SOAK_JAX_BUCKETS}"
        f"{'' if first120 == SOAK_JAX_BUCKETS else ' (differ)'}; peak "
        f"{peak:.0f} MB allocated; launches {rec['launches']}")
    if len(rec["buckets_visited"]) < 2:
        raise AssertionError(f"one bucket only: {rec['buckets_visited']}")
    return rec


def fake_openni(frames, reader_box: dict):
    """A module in the shape of the primesense `openni` binding
    (tests/test_live_capture.py's fake) serving `frames` (uint16 mm depth,
    uint8 RGB) in turn.  It paces itself: a frame is served only once the
    reader in `reader_box["reader"]` has taken the one before, so the
    capture thread and the engine run side by side and the ring drops
    none; after the last frame the streams stall."""
    import threading
    import types

    ctl = {"next": 0, "cur": None, "lock": threading.Lock()}

    class Frame:
        def __init__(self, i, kind):
            self.i, self.kind = i, kind
            self.height, self.width = frames[i].depth.shape
            self.timestamp = 33333 * (i + 1)          # microseconds

        def get_buffer_as_uint16(self):
            return np.ascontiguousarray(frames[self.i].depth).tobytes()

        def get_buffer_as_uint8(self):
            return np.ascontiguousarray(frames[self.i].rgb).tobytes()

    class Stream:
        def __init__(self, kind):
            self.kind = kind

        def start(self):
            pass

        def stop(self):
            pass

        def read_frame(self):
            with ctl["lock"]:
                if self.kind == "color":
                    return None if ctl["cur"] is None else \
                        Frame(ctl["cur"], "color")
                reader = reader_box.get("reader")
                i = ctl["next"]
                if (i >= len(frames) or reader is None
                        or reader.current_frame < i):
                    ctl["cur"] = None
                    return None
                ctl["next"] = i + 1
                ctl["cur"] = i
                return Frame(i, "depth")

    class Device:
        def create_depth_stream(self):
            return Stream("depth")

        def create_color_stream(self):
            return Stream("color")

        def set_image_registration_mode(self, mode):
            ctl["registration"] = mode

    openni2 = types.SimpleNamespace(
        initialize=lambda: None, unload=lambda: None,
        IMAGE_REGISTRATION_DEPTH_TO_COLOR=7,
        Device=types.SimpleNamespace(open_any=Device))
    mod = types.ModuleType("openni")
    mod.openni2 = openni2
    return mod


def live_capture_run(MaskFusion, Config, Resolution, CameraIntrinsics,
                     FrameData, frames, intr, device, n: int,
                     capacity: int = 1 << 22, kernels=None) -> dict:
    """`n` of `frames` through OpenNI2LiveReader over fake_openni into the
    -static engine, then the same frames fed directly (depth converted as
    the reader converts it): frame indices, whether stop() joined the
    capture thread, each run's poses, and with `kernels` each kernel's
    launches in the live run alone (counted from 0 just before its loop,
    read just after)."""
    import sys

    from maskfusion_tpu_torch.io.live_readers import OpenNI2LiveReader

    frames = frames[:n]
    res = Resolution(frames[0].width, frames[0].height)
    cfg = Config(static_mode=True, global_surfel_capacity=capacity)
    box: dict = {}
    saved = sys.modules.get("openni")
    sys.modules["openni"] = fake_openni(frames, box)
    try:
        reader = OpenNI2LiveReader(start=False)
        box["reader"] = reader
        reader.start()
        eng = MaskFusion(res, CameraIntrinsics(*intr), cfg, device=device)
        indices, live_poses = [], []
        if kernels is not None:
            kernels.reset_launch_counts()
        t0 = time.perf_counter()
        for _ in range(n):
            f = reader.get_next()
            indices.append(f.index)
            eng.process_frame(f)
            live_poses.append(eng.current_pose.astype(np.float64))
        seconds = time.perf_counter() - t0
        launches = (None if kernels is None else
                    {k: getattr(kernels, k).launches for k in KERNEL_NAMES})
        thread = reader._thread
        reader.stop()
        joined = thread is not None and not thread.is_alive()
    finally:
        if saved is None:
            sys.modules.pop("openni", None)
        else:
            sys.modules["openni"] = saved
    direct = MaskFusion(res, CameraIntrinsics(*intr), cfg, device=device)
    direct_poses = []
    for i, f in enumerate(frames):
        depth = np.asarray(f.depth).astype(np.float32) * 1e-3
        direct.process_frame(FrameData(rgb=f.rgb, depth=depth,
                                       timestamp=33333 * (i + 1) * 1e-3))
        direct_poses.append(direct.current_pose.astype(np.float64))
    dpos = max(np.linalg.norm(a[:3, 3] - b[:3, 3])
               for a, b in zip(live_poses, direct_poses))
    return {"indices": indices, "joined": joined, "seconds": seconds,
            "max_pose_diff_m": float(dpos), "launches": launches}


def phase_live_capture(dev, kernels, MaskFusion, Config, Resolution,
                       CameraIntrinsics, FrameData, frames) -> dict:
    """15e: 20 of phase 3's frames through OpenNI2LiveReader (a fake
    `openni` binding) into the -static engine on the card.  Held: indices
    strictly increasing, stop() joins, poses within 1e-5 m of the same
    frames fed directly, the live run's launches one filter and one scan
    a frame."""
    from maskfusion_tpu_torch import bench

    n = 20
    rec = live_capture_run(MaskFusion, Config, Resolution, CameraIntrinsics,
                           FrameData, frames, bench.STATIC_INTRINSICS, dev,
                           n, kernels=kernels)
    idx = rec["indices"]
    log(f"  indices {idx}; {len(idx)} frames in {rec['seconds']:.2f} s "
        f"through the reader; stop() joined: {rec['joined']}; poses within "
        f"{rec['max_pose_diff_m']:.2e} m of the direct run; launches in the "
        f"live run {rec['launches']}")
    want = {"bilateral_depth": n, "predict_l0_scan": n,
            "geometric_edge_map": 0}
    if rec["launches"] != want:
        raise AssertionError(f"the live run launched {rec['launches']}, "
                             f"{want} expected")
    if not all(b > a for a, b in zip(idx, idx[1:])):
        raise AssertionError(f"frame indices not strictly increasing: {idx}")
    if not rec["joined"]:
        raise AssertionError("stop() left the capture thread running")
    if not rec["max_pose_diff_m"] <= 1e-5:
        raise AssertionError(f"live and direct poses differ by "
                             f"{rec['max_pose_diff_m']} m")
    return rec


# ----------------------------------------------------------- multi-device
MESH_FRAMES = 12             # phase 16a: the first of phase 6b's frames
# 16a holds split against unsplit on one card to frame
# OBJECT_HOLD_LAST_FRAME at these (measured: 0.0 m globally and at most
# 1.6e-8 m for the objects, PERF.md), and frames 5-11 at phase 7's 1 mm /
# 0.05 deg and 8 mm, past which an object's solve amplifies the rounding
# of the kernels' atomics
MESH_HOLD_M, MESH_HOLD_DEG = 1e-5, 1e-3


def mesh_devices():
    """16a's models mesh: every card, or cuda:0 twice where there is one."""
    import torch

    n = torch.cuda.device_count()
    names = [f"cuda:{i}" for i in range(n)] if n >= 2 else ["cuda:0"] * 2
    return names


def _mesh_rows(split, plain):
    """Per frame of two _run_records runs, split and unsplit: the model
    ids (which must agree; raises otherwise), the global pose difference
    (m, deg), the largest object pose difference (m) and both runs'
    surfel counts."""
    rows = []
    for i, (a, b) in enumerate(zip(split, plain)):
        if a[0] != b[0] or a[1] != b[1]:
            raise AssertionError(f"frame {i}: models {a[0]}/{a[1]} split, "
                                 f"{b[0]}/{b[1]} unsplit")
        pa, pb = a[2], b[2]
        rows.append({
            "frame": i, "models": a[0],
            "global_m": float(np.linalg.norm(pa[0][:3, 3] - pb[0][:3, 3])),
            "global_deg": _rot_deg(pa[0], pb[0]),
            "object_m": max((float(np.nan_to_num(
                np.linalg.norm(x[:3, 3] - y[:3, 3]), nan=np.inf))
                for x, y in zip(pa[1:], pb[1:])
                if not (np.isnan(x).any() and np.isnan(y).any())),
                default=0.0),
            "counts": [a[3], b[3]]})
    return rows


def _mesh_run(kernels, MaskFusion, Resolution, CameraIntrinsics, frames,
              intr, dev, mesh):
    """bench.py's two-object configuration (prefused) over `frames`, each
    finished before the next, so that the split and unsplit runs' host
    stages see the same lifecycle: per frame the _run_records record; ms a
    frame (host clock to a synchronise), the kernels' launches and peak MB
    a device over the run (above what was allocated before it); the
    engine."""
    import torch

    from maskfusion_tpu_torch import bench

    eng = MaskFusion(Resolution(640, 480), CameraIntrinsics(*intr),
                     bench.two_object_config(), device=dev, mesh=mesh)
    cards = sorted({d.index or 0 for d in
                    (mesh.devices if mesh is not None else [dev])})
    base = {}
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)
        base[c] = torch.cuda.memory_allocated(c)
    kernels.reset_launch_counts()

    def step(i):
        eng.process_frame(frames[i])
        eng.drain_pipeline()
        return eng

    t0 = time.perf_counter()
    records = _run_records(step, range(len(frames)))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    return records, eng, {
        "ms_per_frame": ms, "fps": 1e3 / ms,
        "launches": {k: getattr(kernels, k).launches for k in KERNEL_NAMES},
        "peak_mb": {f"cuda:{c}": (torch.cuda.max_memory_allocated(c)
                                  - base[c]) / 2 ** 20 for c in cards}}


def phase_models_mesh(dev, kernels, MaskFusion, Resolution,
                      CameraIntrinsics, frames, intr) -> dict:
    """16a: the object models split over a models mesh (every card, or
    cuda:0 twice on one card) at 640x480 in bench.py's two-object
    configuration (prefused) on phase 6b's first MESH_FRAMES frames,
    against the same engine without a mesh on the same card, each frame
    finished before the next: the same model ids on every frame, the
    global and object poses within MESH_HOLD_M (and MESH_HOLD_DEG) up to
    frame OBJECT_HOLD_LAST_FRAME, then within 1 mm / 0.05 deg and 8 mm
    (phase 7's bounds); both runs' ms a frame,
    kernel launches and peak memory a device.  Then one more prefused
    frame of the split engine under the profiler: its launches, device
    busy time and synchronises (none but forced drains, as in 6b)."""
    from maskfusion_tpu_torch.parallel.multimodel import ModelMesh

    names = mesh_devices()
    mesh = ModelMesh(names)
    log(f"  models mesh: {names}" + (" (one card: cuda:0 twice)"
                                     if len(set(names)) == 1 else ""))
    parity = frames[:MESH_FRAMES]
    # the unsplit run first: the split one is then profiled further
    plain, _, plain_run = _mesh_run(kernels, MaskFusion, Resolution,
                                    CameraIntrinsics, parity, intr, dev,
                                    None)
    split, eng, split_run = _mesh_run(kernels, MaskFusion, Resolution,
                                      CameraIntrinsics, parity, intr, dev,
                                      mesh)
    rows = _mesh_rows(split, plain)
    log(f"  split against unsplit, {len(parity)} frames each finished "
        f"before the next: models {[r['models'] for r in rows]}")
    for r in rows:
        log(f"    frame {r['frame']}: global {r['global_m']:.3e} m "
            f"{r['global_deg']:.3e} deg; objects {r['object_m']:.3e} m "
            f"apart; surfels {r['counts'][0]} / {r['counts'][1]}")
    for name, run in (("split", split_run), ("unsplit", plain_run)):
        log(f"  {name}: {run['ms_per_frame']:.1f} ms a frame finished one "
            f"by one ({run['fps']:.2f} FPS), launches {run['launches']}, "
            f"peak MB {run['peak_mb']}")
    if max(len(r["models"]) for r in rows) < 3:
        raise AssertionError("the split run never held two objects")
    for r in rows:
        if r["frame"] <= OBJECT_HOLD_LAST_FRAME:
            held = (r["global_m"] <= MESH_HOLD_M and r["object_m"]
                    <= MESH_HOLD_M and r["global_deg"] <= MESH_HOLD_DEG)
        else:
            held = (r["global_m"] <= 1e-3 and r["global_deg"] <= 0.05
                    and r["object_m"] <= 8e-3)
        if not held:
            raise AssertionError(f"split and unsplit runs differ: {r}")
    for name, count in split_run["launches"].items():
        if count == 0:
            raise AssertionError(f"{name} never launched in the split run")
    waits0 = eng.forced_waits
    prof = profile_frames(eng, frames[MESH_FRAMES:MESH_FRAMES + 1],
                          split_run["ms_per_frame"])
    forced = eng.forced_waits - waits0
    eng.drain_pipeline()
    if prof["synchronises_per_frame"] > forced:
        raise AssertionError(f"synchronises outside forced drains: {prof}")
    split_run.update(profile=prof, forced_drains_profiled=forced)
    return {"devices": names, "parity": rows, "split": split_run,
            "unsplit": plain_run}


# 16a's mesh across devices: the schedules of phase 7's forms it runs,
# and how far it holds the objects.  From frame 0 an object solved or fused
# on the CPU parts from the card's by rounding that this scene's object
# solve amplifies from frame 4 on: there every run is 20-28 mm off the
# true motion, and phase 7's card against the CPU from frame 0 parts by
# 12 mm (PERF.md)
ACROSS_FORMS = {"synchronous": "batched_windowed", "prefused": "pipelined"}
ACROSS_HOLD_LAST_FRAME, ACROSS_HOLD_M = 3, 1e-4


def phase_models_mesh_across(dev, MaskFusion, Config, Resolution,
                             CameraIntrinsics, FrameData) -> dict:
    """16a across devices: phase 7's 160x120 two-object scene, frames 0-6,
    with the two object slots split over ModelMesh([card, "cpu"]) -- every
    frame copies the frame's images, the slot's state and its results
    between the card and the host, and the CPU block runs the kernels'
    plain versions -- in the synchronous schedule (batched, windowed) and
    the prefused one, against the unsplit engine on the card, each frame
    finished before the next.  Held: the same model and class ids on every
    frame, the global pose within 1 mm / 0.05 deg (phase 7's), up to
    ACROSS_HOLD_LAST_FRAME the objects within ACROSS_HOLD_M and the
    surfel counts within 1%; after the run the second slot's state is on
    the CPU and the first's on the card.  Both schedules run and are
    logged before a failure is raised."""
    import torch

    from maskfusion_tpu_torch.parallel.multimodel import ModelMesh

    frames = synthetic_two_objects(7)
    fx, fy, cx, cy, w, h = SMALL
    card = torch.device("cuda", torch.cuda.current_device())
    out, failures = {}, []
    for name, form in ACROSS_FORMS.items():
        t0 = time.perf_counter()

        def run(mesh):
            eng = MaskFusion(
                Resolution(w, h), CameraIntrinsics(fx, fy, cx, cy),
                multiobject_config(Config, global_surfel_capacity=1 << 16,
                                   object_surfel_capacity=1 << 13,
                                   model_spawn_offset=0, use_so3=False,
                                   open_loop=True, **PARITY_FORMS[form]),
                device=dev, mesh=mesh)

            def step(i):
                rgb, depth, lab = frames[i]
                eng.process_frame(FrameData(rgb=rgb, depth=depth, mask=lab,
                                            class_ids=[0, 7, 8],
                                            timestamp=float(i)))
                eng.drain_pipeline()
                return eng
            return eng, _run_records(step, range(len(frames)))

        _, plain = run(None)
        eng, split = run(ModelMesh([card, "cpu"]))
        rows = _mesh_rows(split, plain)
        placed = [str(m.state.pose.device) for m in eng.models[1:]]
        log(f"  {name}, split over [{card}, cpu] against unsplit on the "
            f"card: models {[r['models'] for r in rows]}, object states "
            f"on {placed}; {time.perf_counter() - t0:.1f} s")
        for r in rows:
            log(f"    frame {r['frame']}: global {r['global_m']:.3e} m "
                f"{r['global_deg']:.3e} deg; objects {r['object_m']:.3e} m "
                f"apart; surfels {r['counts'][0]} / {r['counts'][1]}")
        if rows[-1]["models"] != [0, 1, 2]:
            failures.append(f"{name}: expected models [0, 1, 2], got "
                            f"{rows[-1]['models']}")
        if placed != [str(card), "cpu"]:
            failures.append(f"{name}: object states on {placed}")
        for r in rows:
            held = r["global_m"] <= 1e-3 and r["global_deg"] <= 0.05
            if r["frame"] <= ACROSS_HOLD_LAST_FRAME:
                held = (held and r["object_m"] <= ACROSS_HOLD_M
                        and all(abs(x - y) <= 0.01 * y
                                for x, y in zip(*r["counts"])))
            if not held:
                failures.append(f"{name}: split across the card and the "
                                f"CPU differs from unsplit: {r}")
        out[name] = {"rows": rows, "placed": placed,
                     "seconds": time.perf_counter() - t0}
    if failures:
        raise AssertionError("; ".join(failures))
    return out


def _nccl_rank(rank: int, world: int, micro_batch, micro_draws,
               full_batch) -> dict:
    """16b in each rank: the micro_config(64) sharded run (two steps,
    gathered parameters on rank 0) and a full-width step on the rank's
    card: wall ms (host clock to a synchronise, after a first step), the
    synchronises of a profiled step, peak MB."""
    import torch

    from maskfusion_tpu_torch.maskrcnn import model as mm
    from maskfusion_tpu_torch.maskrcnn import synthetic_shapes as ss
    from maskfusion_tpu_torch.parallel.mesh import make_mesh
    from maskfusion_tpu_torch.parallel.train import (create_train_step,
                                                     sharded_run)

    out = {"micro": sharded_run(rank, world, ss.micro_config(64),
                                micro_batch, micro_draws,
                                device_type="cuda")}
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh(world)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    init_fn, step_fn = create_train_step(mm.MaskRCNNConfig(), mesh=mesh)
    state = init_fn(0, 2)
    batch = [torch.from_numpy(a).to(dev) for a in full_batch]
    gen = torch.Generator(device=dev).manual_seed(0)
    state, loss = step_fn(state, gen, *batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, loss = step_fn(state, gen, *batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    losses = [loss]

    def one_step():
        nonlocal state
        state, step_loss = step_fn(state, gen, *batch)
        losses.append(step_loss)

    launches, syncs, _calls, busy_ms = profile_calls(one_step)
    out["full_width"] = {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "launches": launches, "synchronises": syncs,
        "peak_mb": (torch.cuda.max_memory_allocated() - base) / 2 ** 20,
        "losses": [float(v) for v in losses], "card": str(dev)}
    return out


def phase_sharded_step(dev) -> dict:
    """16b: create_train_step(..., mesh=make_mesh(n)) over NCCL at world
    size = the card count, spawned through parallel.launch: two
    micro_config(64) steps against the one-card step on the same batch and
    draws (after each step the loss within 1e-5 relative, the parameters
    within 2 lr a step taken and all but 1e-4 of them within 1e-6: the CPU
    test's bounds); one full-width step (ResNet-50-FPN, 512 px, 81 classes,
    batch 2 of phase 11c's make_batch scenes): wall ms, synchronises
    (none may), peak MB per card.  With one card the mesh is (1, 1) and the
    multi-card HSDP branch does not run (NCCL refuses two ranks on one
    card); that is printed, not caught."""
    import torch

    from maskfusion_tpu_torch.maskrcnn import synthetic_shapes as ss
    from maskfusion_tpu_torch.parallel.launch import run_ranks
    from maskfusion_tpu_torch.parallel.mesh import mesh_shape
    from maskfusion_tpu_torch.parallel.train import create_train_step

    world = torch.cuda.device_count()
    cfg, lr = ss.micro_config(64), 1e-4
    micro_batch = ss.make_batch(np.random.default_rng(0), 2, 64)
    n_draw = cfg.post_nms_proposals + micro_batch[1].shape[1]
    draws = [torch.rand((2, 2, n_draw), generator=torch.Generator()
                        .manual_seed(s)).numpy() for s in range(2)]
    full_batch = ss.make_batch(np.random.default_rng(40), 2, 512)
    t0 = time.perf_counter()
    ranks = run_ranks(_nccl_rank, world, "nccl",
                      (micro_batch, draws, full_batch), timeout_s=600.0)
    spawn_s = time.perf_counter() - t0
    _placements, steps = ranks[0]["micro"]
    init_fn, step_fn = create_train_step(cfg, lr, device=dev)
    state = init_fn(0, 2)
    tensors = [torch.from_numpy(a).to(dev) for a in micro_batch]
    rows = []
    for i, d in enumerate(draws):
        state, loss = step_fn(state, torch.from_numpy(d).to(dev), *tensors)
        ref = {k: v.detach().cpu().numpy()
               for k, v in state.params.state_dict().items()}
        diff = np.concatenate([np.abs(steps[i][2][k] - ref[k]).ravel()
                               for k in ref])
        rows.append({"step": i, "sharded": steps[i][0],
                     "one_card": float(loss),
                     "param_max_diff": float(diff.max()),
                     "param_share_over_1e-6": float((diff > 1e-6).mean())})
    full = [r["full_width"] for r in ranks]
    rec = {"world": world, "mesh": list(mesh_shape(world)),
           "seconds": spawn_s, "micro": rows, "full_width": full}
    log(f"  {world} NCCL rank(s), mesh (dp, mp) = {rec['mesh']}, "
        f"{spawn_s:.1f} s with the spawn: micro losses and parameters "
        f"against the one-card step after each step {rows}")
    for f in full:
        log(f"  full width on {f['card']}: {f['wall_ms']:.1f} ms a step "
            f"(wall), the card busy {f['device_busy_ms']:.1f} ms, "
            f"{f['launches']} launches, {f['synchronises']} synchronises, "
            f"peak {f['peak_mb']:.0f} MB, losses "
            f"{[round(v, 3) for v in f['losses']]}")
    if world < 2:
        log("  the multi-card HSDP branch did not run: one card here, and "
            "NCCL refuses two ranks on one card")
    for r in rows:
        if not abs(r["sharded"] - r["one_card"]) <= 1e-5 * abs(
                r["one_card"]):
            raise AssertionError(f"sharded and one-card losses differ: {r}")
        if not (r["param_max_diff"] <= 2 * lr * (r["step"] + 1)
                and r["param_share_over_1e-6"] <= 1e-4):
            raise AssertionError(f"sharded parameters differ: {r}")
    for f in full:
        if f["synchronises"]:
            raise AssertionError(f"the sharded full-width step synchronised "
                                 f"{f['synchronises']} times")
        if not np.isfinite(f["losses"]).all():
            raise AssertionError(f"non-finite losses {f['losses']}")
    return rec


def phase_entry(dev) -> dict:
    """16c: parallel.dryrun.entry()'s forward on the card (256 px, 81
    classes, seeded weights, a zero image): every output finite, ms a
    forward after a first."""
    import torch

    from maskfusion_tpu_torch.parallel.dryrun import entry

    forward, (model, image) = entry()
    out = forward(model, image)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = forward(model, image)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    shapes = [tuple(o.shape) for o in out]
    log(f"  entry forward: {ms:.1f} ms; outputs {shapes}")
    if not all(torch.isfinite(o.float()).all() for o in out):
        raise AssertionError("entry forward produced a non-finite value")
    return {"ms": ms, "shapes": shapes}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on a CUDA card", file=sys.stderr)
        return 2
    if not (ROOT / "maskfusion_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(maskfusion_tpu_torch/ not found beside the script)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from maskfusion_tpu_torch import CameraIntrinsics, Config, Resolution
    from maskfusion_tpu_torch.engine import MaskFusion
    from maskfusion_tpu_torch.frame import FrameData
    from maskfusion_tpu_torch.ops import kernels

    t_all = time.perf_counter()
    dev = torch.device("cuda")
    log_phase("phase 0: the card")
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    log(f"  nvidia-smi: {smi}")
    log(f"  torch: {torch.__version__} cuda {torch.version.cuda}; "
        f"device {name}; count {torch.cuda.device_count()}")

    log_phase("phase 1: build the kernels")
    kernels.load_library()
    log(f"  built {kernels.library_path().name} in "
        f"{kernels.build_seconds:.1f} s")
    for line in kernels.build_log.splitlines():
        if ("registers" in line or "spill" in line
                or line.startswith("==")):
            log("  " + line.strip())

    from maskfusion_tpu_torch import bench

    n_warm, n_timed, n_stage, n_prof = 8, 20, 6, 3
    n_static = n_warm + n_timed + n_stage + n_prof
    # bench.py's static frames: phases 2-3 and 8 take the first n_static,
    # the bench all of them
    all_frames = bench.make_frames(640, 480,
                                   max(n_static, bench.STATIC_FRAMES))
    frames = all_frames[:n_static]
    log_phase("phase 2: kernels against their plain versions at "
              "640x480")
    records = phase_kernels(dev, kernels, MaskFusion, Config, Resolution,
                            CameraIntrinsics, FrameData, frames)

    log_phase("phase 3: the -static engine at 640x480, 2^22 surfels")
    run, direct = phase_engine(dev, kernels, MaskFusion, Config, Resolution,
                               CameraIntrinsics, FrameData, frames, n_warm,
                               n_timed, n_stage)
    for rec in records:
        rec["launches"] = run["launches"][rec["name"]]
        log(f"  {rec['name']}: {rec['launches']} launches in the run, "
            f"{rec['ms_cold'] * 1e3:.2f} us per launch (cold L2) against a "
            f"bound of {rec['bound_ms'] * 1e3:.2f} us ({rec['bound_by']})")

    log_phase("phase 4: 160x120 synthetic trajectory, card against CPU")
    parity = phase_parity(dev, MaskFusion, Config, Resolution,
                          CameraIntrinsics, FrameData)

    # bench.py's two-object sequence spans 14 + 3 x 12 frames: the bench
    # runs them all, phase 6 the first 34
    mo_warm, mo_timed, mo_stage, mo_prof = 14, 12, 4, 2
    t_render = time.perf_counter()
    all_mo_frames, intr = bench.make_two_object_frames(
        640, 480, bench.TWO_OBJECT_FRAMES)
    mo_frames = all_mo_frames[:mo_warm + mo_timed + mo_stage + 2 * mo_prof]
    log_phase(f"phase 5: kernel 3 against its plain version at 640x480 "
              f"({len(all_mo_frames)} two-object frames rendered in "
              f"{time.perf_counter() - t_render:.1f} s)")
    records.append(phase_edge_kernel(dev, kernels, MaskFusion, Config,
                                     Resolution, CameraIntrinsics,
                                     mo_frames[0], intr))
    host_seg = host_segmentation_times(dev, MaskFusion, Resolution,
                                       CameraIntrinsics, mo_frames[1], intr)

    log_phase("phase 6: the synchronous multi-object engine at 640x480, "
              "2^22 + 2 x 2^19 surfels, batched and windowed object passes")
    mo_run, object_scans = phase_multiobject(
        dev, kernels, MaskFusion, Config, Resolution, CameraIntrinsics,
        FrameData, mo_frames, intr, mo_warm, mo_timed, mo_stage, mo_prof)
    records.extend(object_scans)

    log_phase("phase 6b: the main path, the prefused multi-object engine "
              "(the Config default) at 640x480 in bench.py's two-object "
              "configuration")
    pipe_run = phase_pipelined(dev, kernels, MaskFusion, Resolution,
                               CameraIntrinsics, mo_frames, intr, mo_warm,
                               mo_timed, 2 * mo_prof)
    for rec in records:
        rec["launches_by_path"] = {
            "static": run["launches"].get(rec["name"], 0),
            "multiobject": mo_run["launches"][rec["name"]],
            "pipelined": pipe_run["launches"][rec["name"]]}
        rec["launches"] = pipe_run["launches"][rec["name"]]
        log(f"  {rec['name']} ({rec.get('map', 'image')}): "
            f"{rec['launches']} launches in the run "
            f"({rec['launches'] / (mo_warm + mo_timed):.2f} a frame), "
            f"{rec['ms_cold'] * 1e3:.2f} us per launch (cold L2) against a "
            f"bound of {rec['bound_ms'] * 1e3:.2f} us ({rec['bound_by']})")

    log_phase("phase 7: 160x120 two-object scene, multi-object engine, "
              "card against CPU")
    mo_parity = {form: phase_multiobject_parity(
        dev, MaskFusion, Config, Resolution, CameraIntrinsics, FrameData,
        form) for form in PARITY_FORMS}

    log_phase(f"phase 8: the -static CLI on the card ({n_static} frames of "
              "a raw KLG log), with and without ground-truth poses, and "
              "--nn on its first 12")
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    phase8_poses: list = []
    with tempfile.TemporaryDirectory(dir=build) as workdir:
        cli_run = phase_cli(kernels, frames, direct, Path(workdir),
                            phase8_poses)
        cli_run["nn"] = phase_cli_nn(kernels, frames[:12], Path(workdir))
    for rec in records:
        rec["launches_by_path"].update({
            f"cli_{k}": cli_run[k]["launches"].get(rec["name"], 0)
            for k in ("static", "ground_truth", "nn")})

    log_phase("phase 9: the port bench (python -m "
              "maskfusion_tpu_torch.bench)")
    bench_lines = phase_bench(dev, all_frames, all_mo_frames, intr)

    log_phase("phase 10a: the trained rich Mask R-CNN (f32), card against "
              "CPU, and its quality floors on the card")
    nn_trained = phase_nn_trained(dev)
    log_phase("phase 10b: the full-width Mask R-CNN (ResNet-50-FPN, 512 px, "
              "bf16)")
    nn_full = phase_nn_full_width(dev)

    log_phase("phase 11a: the micro_config train step, card against CPU")
    train = {"micro": phase_train_micro(dev)}
    log_phase("phase 11b: the shapes recipe (train_shapes, 700 steps) on "
              "the card")
    train["shapes"] = phase_train_shapes(dev)
    log_phase("phase 11c: the full-width train step (ResNet-50-FPN, 512 px, "
              "bf16 over f32 parameters, batch 2)")
    train["full_width"] = phase_train_full_width(dev)

    log_phase("phase 12: -method cofusion at 640x480 on bench.py's "
              "two-object frames, card against CPU at 160x120, and the CLI")
    # bench.py's objects move least at the start of its 50-frame loop: the
    # first 20 frames warm up
    cofusion = phase_cofusion(dev, kernels, MaskFusion, Config, Resolution,
                              CameraIntrinsics, FrameData, mo_frames, intr,
                              20, 12, 2)
    cofusion["parity"] = phase_cofusion_parity(
        dev, MaskFusion, Config, Resolution, CameraIntrinsics, FrameData)
    with tempfile.TemporaryDirectory(dir=build) as workdir:
        cofusion["cli"] = phase_cli_cofusion(kernels, frames[:12],
                                             Path(workdir))
    for rec in records:
        rec["launches_by_path"].update(
            cofusion=cofusion["launches"][rec["name"]],
            cli_cofusion=cofusion["cli"]["launches"][rec["name"]])

    log_phase("phase 13a: the deformation graph on the card (1024 nodes, "
              f"{DEFORM_LIVE} live surfels in {DEFORM_CAPACITY} slots)")
    reloc = {"deformation": phase_deformation(dev)}
    log_phase("phase 13b: relocalisation at 640x480: the -static scenario, "
              "then the multi-object engine with ferns")
    reloc["vga"] = phase_reloc_vga(dev, kernels, MaskFusion, Config,
                                   Resolution, CameraIntrinsics, FrameData,
                                   frames, mo_frames, intr, mo_run)
    log_phase("phase 13c: the 160x120 relocalisation scenario, card "
              "against CPU")
    reloc["parity"] = phase_reloc_parity(dev, MaskFusion, Config, Resolution,
                                         CameraIntrinsics, FrameData)
    log_phase(f"phase 13d: the CLI with -rl on phase 8's log, and "
              "--save-state / --load-state")
    with tempfile.TemporaryDirectory(dir=build) as workdir:
        reloc["cli"] = phase_cli_reloc(kernels, frames, Path(workdir))
    log_phase("phase 13e: an accepted loop closure and redetection in both "
              "schedules at 160x120, card against CPU")
    reloc["closure"] = phase_closure_parity(dev, MaskFusion, Config,
                                            Resolution, CameraIntrinsics,
                                            FrameData)
    reloc["redetection"] = phase_redetection_parity(
        dev, MaskFusion, Config, Resolution, CameraIntrinsics, FrameData)
    for rec in records:
        rec["launches_by_path"].update(
            reloc_static=reloc["vga"]["static"]["launches"].get(
                rec["name"], 0),
            reloc_multiobject=reloc["vga"]["multiobject"]["launches"][
                rec["name"]],
            cli_rl=reloc["cli"]["launches"].get(rec["name"], 0))
    log_phase("phase 15a: the viewer at 160x120, card against CPU")
    views = {"parity": phase_viewer_parity(dev, kernels, MaskFusion, Config,
                                           Resolution, CameraIntrinsics,
                                           FrameData)}
    log_phase("phase 15b: the viewer at 640x480 at the CLI's default "
              "capacities, static and prefused multi-object")
    kernels.reset_launch_counts()
    views["vga"] = phase_viewer_vga(dev, kernels, MaskFusion, Config,
                                    Resolution, CameraIntrinsics, frames,
                                    mo_frames, intr)
    log_phase("phase 15c: `-static -viewer -ev` through the CLI at its "
              "default capacities on phase 8's log")
    with tempfile.TemporaryDirectory(dir=build) as workdir:
        views["cli_defaults"] = phase_cli_defaults(kernels, frames,
                                                   phase8_poses,
                                                   Path(workdir))
    log_phase(f"phase 15d: the soak, {SOAK_FRAMES} wide-sweep frames at "
              f"{CLI_GLOBAL_CAPACITY} global surfels")
    views["soak"] = phase_soak(dev, kernels, MaskFusion, Config, Resolution,
                               CameraIntrinsics)
    log_phase("phase 15e: live capture through OpenNI2LiveReader (a fake "
              "binding) into the -static engine")
    views["live_capture"] = phase_live_capture(
        dev, kernels, MaskFusion, Config, Resolution, CameraIntrinsics,
        FrameData, frames)
    for rec in records:
        rec["launches_by_path"].update(
            {f"viewer_{k}": views["vga"][k]["launches_viewer_frame"][
                rec["name"]] for k in ("static", "prefused")},
            cli_defaults=views["cli_defaults"]["launches"][rec["name"]],
            soak=views["soak"]["launches"][rec["name"]],
            live_capture=views["live_capture"]["launches"][rec["name"]])
    log_phase("phase 16a: the object models split over a models mesh at "
              "640x480 (bench.py's two-object configuration, prefused)")
    t16 = time.perf_counter()
    multi = {"models_mesh": phase_models_mesh(
        dev, kernels, MaskFusion, Resolution, CameraIntrinsics, mo_frames,
        intr)}
    log_phase("phase 16a: the object models split over the card and the "
              "CPU (160x120, synchronous and prefused)")
    multi["models_mesh_across"] = phase_models_mesh_across(
        dev, MaskFusion, Config, Resolution, CameraIntrinsics, FrameData)
    seconds = {"16a": time.perf_counter() - t16}
    for rec in records:
        rec["launches_by_path"]["models_mesh"] = \
            multi["models_mesh"]["split"]["launches"][rec["name"]]
    log_phase("phase 16b: the sharded Mask R-CNN train step over NCCL at "
              f"world size {torch.cuda.device_count()}")
    multi["sharded_step"] = phase_sharded_step(dev)
    seconds["16b"] = time.perf_counter() - t16 - seconds["16a"]
    log_phase("phase 16c: the entry forward (parallel.dryrun.entry) on the "
              "card")
    multi["entry"] = phase_entry(dev)
    multi["seconds"] = dict(seconds, phase_16=time.perf_counter() - t16)
    if "--vga-sequence" in sys.argv[1:]:
        log_phase(f"phase 14: the sequence check at 640x480 "
                  f"({VGA_SEQUENCE_FRAMES} frames through the CLI)")
        with tempfile.TemporaryDirectory(dir=build) as workdir:
            reloc["vga_sequence"] = phase_vga_sequence(kernels,
                                                       Path(workdir))
    torch.cuda.synchronize()
    log(f"engine: {json.dumps({k: v for k, v in run.items()})}")
    log(f"parity: {json.dumps(parity)}")
    log(f"multiobject: {json.dumps(mo_run)}")
    log(f"pipelined: {json.dumps(pipe_run)}")
    log(f"multiobject parity: {json.dumps(mo_parity)}")
    log(f"cli: {json.dumps(cli_run)}")
    log(f"host segmentation: {json.dumps(host_seg)}")
    log(f"nn trained: {json.dumps(nn_trained)}")
    log(f"nn full width: {json.dumps(nn_full)}")
    log(f"train: {json.dumps(train)}")
    log(f"cofusion: {json.dumps(cofusion)}")
    log(f"relocalisation: {json.dumps(reloc)}")
    log(f"viewer, defaults, soak, live capture: {json.dumps(views)}")
    log(f"multi-device: {json.dumps(multi)}")
    log(f"total {time.perf_counter() - t_all:.1f} s")
    for line in bench_lines:
        print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
