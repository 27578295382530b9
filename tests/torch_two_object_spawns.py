"""Which models bench.py's two-object scene spawns, frame by frame, in
either schedule of the port bench's two-object lines, on the port and on
the JAX engine.

    python -m tests.torch_two_object_spawns [width] [engine ...] [--sync]
    PYTHONPATH=. python tests/torch_two_object_spawns.py 640 cuda

(the second form where another package named ``tests`` is installed, as
on the card's machine).

Engines: ``jax`` (the JAX engine on the CPU, its numpy segmentation path as
the lockstep tests run it), ``torch`` (the port on the CPU) and ``cuda``
(the port on the card); default ``jax torch``.  The frames are
maskfusion_tpu_torch.bench.make_two_object_frames(width, 3/4 width, 50),
bench.py's, and the configuration is the bench's ``two_object_config()``
(bench.py's: the pipelined, prefused schedule; ``--sync``: the synchronous
one) with the surfel capacities scaled by the frame's area against
640x480.  In the pipelined schedule the JAX engine waits for its pending
device results before each frame, so that, like the port on the CPU, it
finishes every pending frame at the start of the next; on the card the
port runs as it would (up to pipeline_depth frames in flight).  Each
engine runs all 50 frames on its own from the first, and is drained at the
end; each frame prints the live model ids, their class ids and surfel
counts, and each spawn or removal is marked.  At 160 wide on the CPU, a
few minutes an engine; the JAX engine is not run at 640 wide on a CPU.
"""

from __future__ import annotations

import sys

from maskfusion_tpu_torch import bench

N_FRAMES = 50


def config_fields(width: int, pipelined: bool) -> dict:
    cfg = bench.two_object_config(pipelined)
    scale = (width / bench.VGA[0]) ** 2
    return dict(global_surfel_capacity=int(cfg.global_surfel_capacity * scale),
                object_surfel_capacity=int(cfg.object_surfel_capacity * scale),
                seg_method=cfg.seg_method,
                model_spawn_offset=cfg.model_spawn_offset,
                static_mode=cfg.static_mode,
                pipelined_multiobject=cfg.pipelined_multiobject,
                batch_object_tracking=cfg.batch_object_tracking,
                object_window=cfg.object_window,
                min_object_slots=cfg.min_object_slots)


def make_engine(name: str, width: int, height: int, intr, pipelined: bool):
    fields = config_fields(width, pipelined)
    if name == "jax":
        import conftest  # noqa: F401  (JAX on the CPU, as the tests run it)
        import maskfusion_tpu.cpp as jnative
        from maskfusion_tpu.camera import CameraIntrinsics, Resolution
        from maskfusion_tpu.config import Config
        from maskfusion_tpu.engine import MaskFusion
        from maskfusion_tpu.frame import FrameData

        jnative._lib, jnative._tried = None, True   # the JAX numpy path
        eng = MaskFusion(Resolution(width, height), CameraIntrinsics(*intr),
                         Config(**fields))
        return eng, FrameData
    from maskfusion_tpu_torch.camera import CameraIntrinsics, Resolution
    from maskfusion_tpu_torch.config import Config
    from maskfusion_tpu_torch.engine import MaskFusion
    from maskfusion_tpu_torch.frame import FrameData

    eng = MaskFusion(Resolution(width, height), CameraIntrinsics(*intr),
                     Config(**fields), device="cpu" if name == "torch"
                     else "cuda")
    return eng, FrameData


def run(name: str, width: int, pipelined: bool) -> list:
    height = width * 3 // 4
    frames, intr = bench.make_two_object_frames(width, height, N_FRAMES)
    eng, frame_cls = make_engine(name, width, height, intr, pipelined)
    schedule = "prefused" if pipelined else "sync"
    ids_before = []
    out = []
    for i, f in enumerate(frames):
        if name == "jax":
            from tests.torch_helpers import wait_for_jax_pending

            wait_for_jax_pending(eng)
        eng.process_frame(frame_cls(rgb=f.rgb, depth=f.depth, mask=f.mask,
                                    class_ids=list(f.class_ids),
                                    timestamp=f.timestamp))
        if i == len(frames) - 1:
            eng.drain_pipeline()
        ids = [m.model_id for m in eng.models]
        classes = [m.class_id for m in eng.models]
        counts = [int(m.surfel_count) for m in eng.models]
        marks = [f"spawned {k}" for k in ids if k not in ids_before] + \
            [f"removed {k}" for k in ids_before if k not in ids]
        print(f"{name} {schedule} {width}x{height} frame {i}: ids {ids} "
              f"classes "
              f"{classes} surfels {counts}"
              + (f"  <- {', '.join(marks)}" if i and marks else ""),
              flush=True)
        out.append(ids)
        ids_before = ids
    return out


def main(argv) -> None:
    pipelined = "--sync" not in argv
    argv = [a for a in argv if a != "--sync"]
    width = int(argv[0]) if argv else 160
    engines = argv[1:] or ["jax", "torch"]
    runs = {name: run(name, width, pipelined) for name in engines}
    if len(runs) > 1:
        names = list(runs)
        differ = [i for i in range(N_FRAMES)
                  if len({tuple(runs[n][i]) for n in names}) > 1]
        print(f"frames whose live model ids differ between {names}: "
              f"{differ or 'none'}")


if __name__ == "__main__":
    main(sys.argv[1:])
