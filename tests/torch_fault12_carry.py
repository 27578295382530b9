"""Attribute the split of tests/torch_two_object_spawns.py at 160x120: from
an equal state, does the port drop the class-8 model where the JAX engine
does?

    python -m tests.torch_fault12_carry [split frame]

The JAX engine runs bench.py's two-object frames (the port bench's
``make_two_object_frames(160, 120, 50)``) in the prefused schedule of
``torch_two_object_spawns.config_fields`` up to the frame before the split
(default 20), waiting for its pending results before each frame, and is
drained there.  Its state crosses to the port (convert.engine_snapshot /
restore_engine); then both engines run the split frame and the one after
it and are drained.  Printed for each engine: the live model ids and
classes after each frame, and for each object model its tracked
translation jump at each frame (the norm of the pose increment's
translation, which the lifecycle holds against
``Config.model_deactivate_jump``).  On the CPU, a few minutes (the JAX
engine's compiles).
"""

from __future__ import annotations

import sys

import conftest  # noqa: F401  (JAX on the CPU, as the tests run it)
import numpy as np

from tests.torch_two_object_spawns import N_FRAMES, config_fields, make_engine

from maskfusion_tpu_torch import bench
from maskfusion_tpu_torch.convert import engine_snapshot, restore_engine
from tests.torch_helpers import wait_for_jax_pending


def _poses(eng) -> dict:
    """Every model's pose (the camera in the model's frame) on the host."""
    return {m.model_id: np.asarray(
        m.state.pose.cpu() if hasattr(m.state.pose, "cpu")
        else m.state.pose, np.float64) for m in eng.all_models()}


def _jumps(before: dict, after: dict) -> dict:
    """Each object's translation increment over one frame, inverse(before)
    @ after, the prev->curr increment the tracker reports."""
    return {mid: float(np.linalg.norm(
        (np.linalg.inv(before[mid]) @ a)[:3, 3]))
        for mid, a in after.items() if mid and mid in before}


def _describe(eng) -> str:
    return (f"ids {[m.model_id for m in eng.models]} classes "
            f"{[m.class_id for m in eng.models]} inactive "
            f"{[m.model_id for m in eng.inactive_models]}")


def main(argv) -> None:
    split = int(argv[0]) if argv else 20
    width, height = 160, 120
    frames, intr = bench.make_two_object_frames(width, height, N_FRAMES)
    jeng, JFrame = make_engine("jax", width, height, intr, True)
    teng, TFrame = make_engine("torch", width, height, intr, True)
    print("config:", config_fields(width, True), "deactivate jump",
          jeng.cfg.model_deactivate_jump, flush=True)

    def feed(eng, cls, i):
        f = frames[i]
        if cls is JFrame:
            wait_for_jax_pending(eng)
        eng.process_frame(cls(rgb=f.rgb, depth=f.depth, mask=f.mask,
                              class_ids=list(f.class_ids),
                              timestamp=f.timestamp))

    for i in range(split):
        feed(jeng, JFrame, i)
    jeng.drain_pipeline()
    print(f"jax after frame {split - 1}: {_describe(jeng)}", flush=True)
    restore_engine(teng, engine_snapshot(jeng))
    print(f"port restored: {_describe(teng)}", flush=True)
    for i in (split, split + 1):
        for name, eng, cls in (("jax", jeng, JFrame), ("port", teng, TFrame)):
            before = _poses(eng)
            feed(eng, cls, i)
            eng.drain_pipeline()
            after = _poses(eng)
            print(f"{name} frame {i}: {_describe(eng)} jumps "
                  f"{ {k: round(v, 5) for k, v in _jumps(before, after).items()} }",
                  flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
