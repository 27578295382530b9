"""Every call of the prefused multi-object frame that waits on the card.

    PYTHONPATH=. python tests/torch_sync_probe.py [frames]

Runs bench.py's two-object configuration unchanged (the prefused schedule,
the Config default) at 640x480 on bench.py's frames.  After a warm-up of
14 frames (both objects spawned), each further frame starts with the card
idle -- so its pending frame's results have landed and no drain is forced
-- and runs under torch.cuda.set_sync_debug_mode("warn"); every warning's
Python call stack is kept, and the distinct stacks are printed with their
counts, innermost port frame first.  A steady-state frame should print
none (tests/test_torch_kernels.py::test_prefused_frames_never_wait_on_the_card
asserts it at 160x120).  Then as many frames run back to back, as the bench
runs them, under torch.profiler: each synchronising runtime call is printed
with the ops above it and the port's lines that issued them.  Needs a CUDA
card; about a minute.
"""

from __future__ import annotations

import collections
import sys
import traceback
import warnings


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from maskfusion_tpu_torch import bench
    from maskfusion_tpu_torch.camera import CameraIntrinsics, Resolution
    from maskfusion_tpu_torch.engine import MaskFusion

    n_probe = int(argv[0]) if argv else 4
    n_warm = bench.TWO_OBJECT_WARM
    frames, intr = bench.make_two_object_frames(
        640, 480, bench.TWO_OBJECT_FRAMES, count=n_warm + n_probe)
    eng = MaskFusion(Resolution(640, 480), CameraIntrinsics(*intr),
                     bench.two_object_config(), device="cuda")
    bench.warm_up(eng, frames[:n_warm], drain_every=4)
    stacks: collections.Counter = collections.Counter()
    shown = warnings.showwarning

    def keep(message, category, filename, lineno, file=None, line=None):
        frames_ = [f for f in traceback.extract_stack()[:-1]
                   if "maskfusion_tpu_torch" in f.filename
                   or "torch_sync_probe" in f.filename]
        stacks[(str(message).splitlines()[0],) + tuple(
            f"{f.filename.split('maskfusion_tpu_torch/')[-1]}:{f.lineno} "
            f"{f.name}" for f in reversed(frames_))] += 1

    for f in frames[n_warm:]:
        staged = eng.upload_frame(f)
        torch.cuda.synchronize()
        warnings.showwarning = keep
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = keep
                eng.process_frame(staged)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            warnings.showwarning = shown
    print(f"{n_probe} steady-state prefused frames, each from an idle "
          f"card, models {[m.model_id for m in eng.models]}, forced waits "
          f"{eng.forced_waits}: {sum(stacks.values())} synchronising calls")
    for stack, count in stacks.most_common():
        print(f"{count}x {stack[0]}")
        for line in stack[1:8]:
            print(f"    {line}")
    # the same frames back to back, as the bench runs them, under the
    # profiler: every synchronising runtime call with the op that made it
    from torch.profiler import ProfilerActivity, profile

    more, _ = bench.make_two_object_frames(
        640, 480, bench.TWO_OBJECT_FRAMES,
        count=n_warm + 2 * n_probe)
    waits0 = eng.forced_waits
    with profile(activities=[ProfilerActivity.CPU], with_stack=True) as prof:
        for f in more[n_warm + n_probe:]:
            eng.process_frame(f)
    sites: collections.Counter = collections.Counter()
    for e in prof.events():
        if e.name not in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                          "cudaEventSynchronize"):
            continue
        chain, p = [], e.cpu_parent
        while p is not None and len(chain) < 4:
            chain.append(p.name)
            p = p.cpu_parent
        top = e.cpu_parent
        while top is not None and not top.stack:
            top = top.cpu_parent
        where = [line for line in (top.stack if top is not None else [])
                 if "maskfusion_tpu_torch" in line][:4]
        sites[(e.name, " <- ".join(chain), " | ".join(where))] += 1
    print(f"{n_probe} prefused frames back to back: forced waits "
          f"{eng.forced_waits - waits0}, {sum(sites.values())} "
          "synchronising runtime calls")
    for (name, chain, where), count in sites.most_common():
        print(f"{count}x {name} <- {chain}\n    {where}")
    eng.drain_pipeline()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
