"""Probe of the batched object solve on a CUDA card: which operations wait
on the device, and what the slot axis costs against one model at a time.

    PYTHONPATH=. python tests/torch_slot_axis_probe.py

Runs the port bench's two-object configuration at 640x480 on bench.py's
two-object frames until two objects are live, then on the next frame's
preprocessed inputs:
- the object solve once batched (`MaskFusion.track_objects`) and once per
  object (`MaskFusion.track`), under torch.cuda.set_sync_debug_mode("warn"),
  printing every operation that synchronises with the device and where;
- both under torch.profiler: device time, kernel launches and the top
  kernels by device time;
- the Gram matrices J^T J of the reductions at the level-0 shape
  (P = 307,200 rows of 7), for two slots as one batched product, as one
  product of the slots side by side, and one product a slot (CUDA events);
- the 6x6 Cholesky routines on two slots and on one matrix: the
  synchronises each issues (torch.profiler).
Imports nothing of JAX.  About a minute.
"""

from __future__ import annotations

import sys
import time
import warnings

import numpy as np
import torch


def events_ms(fn, reps=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def profile(fn, label):
    from torch.profiler import ProfilerActivity, profile as tprof

    fn()
    torch.cuda.synchronize()
    with tprof(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy, launches, syncs, kern = 0.0, 0, 0, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            busy += us
            kern[e.name] = kern.get(e.name, 0.0) + us
        elif e.name == "cudaLaunchKernel":
            launches += 1
        elif e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize"):
            syncs += 1
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:8]
    print(f"{label}: device busy {busy / 1e3:.2f} ms, {launches} "
          f"cudaLaunchKernel, {syncs} stream/device synchronises", flush=True)
    for name, us in top:
        print(f"    {us / 1e3:8.3f} ms  {name[:110]}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from maskfusion_tpu_torch import bench
    from maskfusion_tpu_torch.camera import CameraIntrinsics, Resolution
    from maskfusion_tpu_torch.engine import MaskFusion

    frames, intr = bench.make_two_object_frames(640, 480, 8)
    eng = MaskFusion(Resolution(640, 480), CameraIntrinsics(*intr),
                     bench.two_object_config(pipelined=False),
                     device="cuda")
    i = 0
    while len(eng.models) < 3:
        eng.process_frame(frames[i])
        i += 1
    f = frames[i]
    rgb = torch.from_numpy(f.rgb).cuda()
    depth = torch.from_numpy(f.host_depth()).cuda()
    prep = eng.preprocess(rgb, depth, eng._prev_seg())
    objs = eng.models[1:]
    torch.cuda.synchronize()
    print(f"{len(objs)} objects live after {i} frames; "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    def batched():
        return eng.track_objects([m.state for m in objs],
                                 [m.model_id for m in objs], prep)

    def looped():
        return [eng.track(m.state, prep, m.model_id, is_object=True)
                for m in objs]

    for label, fn in (("batched", batched), ("per object", looped)):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        where = {}
        for w in caught:
            key = f"{w.filename.rsplit('/', 2)[-1]}:{w.lineno}"
            where[key] = where.get(key, 0) + 1
        print(f"{label}: {len(caught)} synchronising operations {where}",
              flush=True)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        print(f"{label}: host clock to the device's end "
              f"{(time.perf_counter() - t0) * 1e3:.2f} ms", flush=True)
        profile(fn, label)

    P, k, N = 480 * 640, 7, 2
    rows = torch.randn(N, P, k, device="cuda")
    print("Gram of (2, 307200, 7) rows, ms per call (CUDA events):",
          flush=True)
    print(f"  batched matmul rows.mT @ rows: "
          f"{events_ms(lambda: rows.mT @ rows):.4f}", flush=True)

    def side_by_side():
        flat = rows.permute(1, 0, 2).reshape(P, N * k)
        g = (flat.T @ flat).reshape(N, k, N, k)
        return g.diagonal(dim1=0, dim2=2).permute(2, 0, 1)

    print(f"  one product, slots side by side: "
          f"{events_ms(side_by_side):.4f}", flush=True)
    print(f"  one product a slot: "
          f"{events_ms(lambda: [r.T @ r for r in rows]):.4f}", flush=True)
    ref = rows.double().mT @ rows.double()
    for name, g in (("batched", rows.mT @ rows), ("side by side",
                                                  side_by_side())):
        err = float(((g.double() - ref).abs() / ref.abs().max()).max())
        print(f"  {name}: max relative error against float64 {err:.2e}",
              flush=True)
    from torch.profiler import ProfilerActivity, profile as tprof

    from maskfusion_tpu_torch import se3

    A = torch.randn(N, 6, 6, device="cuda")
    A = A @ A.mT + 6 * torch.eye(6, device="cuda")
    b = torch.randn(N, 6, device="cuda")
    for label, fn in (
            ("cholesky_ex, 2 slots", lambda: torch.linalg.cholesky_ex(A)),
            ("cholesky_solve, 2 slots",
             lambda: torch.cholesky_solve(b[..., None], A)),
            ("cholesky_ex, one matrix",
             lambda: torch.linalg.cholesky_ex(A[0])),
            ("cholesky_solve, one matrix",
             lambda: torch.cholesky_solve(b[0, :, None], A[0])),
            ("se3.solve_6x6_ldlt, 2 slots",
             lambda: se3.solve_6x6_ldlt(A, b))):
        fn()
        torch.cuda.synchronize()
        with tprof(activities=[ProfilerActivity.CPU]) as prof:
            fn()
        waits = sum(e.name in ("cudaStreamSynchronize",
                               "cudaDeviceSynchronize")
                    for e in prof.events())
        print(f"  {label}: {waits} stream/device synchronises", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
