"""How far the port's multi-object engine and the JAX engine drift apart
over a longer lockstep run than tests/test_torch_engine_multimodel.py makes.

    python -m tests.torch_lockstep_drift [frames] [camera step in m] [gt]
    python -m tests.torch_lockstep_drift [frames] [step] windowed

The JAX engine runs the slice's configuration through both spawns (frames
0-2) with its numpy segmentation path; its state crosses to the port
(convert.engine_snapshot / restore_engine) and both engines run the
remaining frames of the two-object scene side by side, the camera moving
along +x by the given step a frame (default: 12 frames, still camera).
Each frame prints the model ids of both, the global and object pose
differences and the surfel counts; after the first port frame it also
prints how many of the global map's slots differ by more than 1e-5 m in
position.  With ``gt`` both engines take each frame's camera pose as its
ground-truth pose (``process_frame(..., gt_pose=...)``).  With ``windowed``
both run tests/test_torch_object_passes.py's configuration instead (objects
tracked in one solve and fused in 104-pixel windows), and each frame also
prints the global rotation difference (deg, float64).  On the CPU, a few
minutes.
"""

from __future__ import annotations

import sys

import conftest  # noqa: F401  (JAX on the CPU, as the tests run it)
import numpy as np

import maskfusion_tpu.cpp as jnative
from maskfusion_tpu.camera import Resolution as JResolution
from maskfusion_tpu.config import Config as JConfig
from maskfusion_tpu.engine import MaskFusion as JMaskFusion
from maskfusion_tpu.frame import FrameData as JFrameData
from maskfusion_tpu_torch.camera import Resolution
from maskfusion_tpu_torch.config import Config
from maskfusion_tpu_torch.convert import (engine_snapshot, restore_engine,
                                          state_to_numpy)
from maskfusion_tpu_torch.engine import MaskFusion
from maskfusion_tpu_torch.frame import FrameData
from tests import synthetic as syn
from tests.test_torch_engine_multimodel import SLICE, _two_object_frames
from tests.test_torch_object_passes import SLICE as WINDOWED
from tests.test_torch_object_passes import _rot_deg
from tests.torch_helpers import CPU, tintr


def main(n_frames: int = 12, cam_step: float = 0.0,
         mode: str = "") -> None:
    ground_truth = mode == "gt"
    slice_cfg = WINDOWED if mode == "windowed" else SLICE
    frames = _two_object_frames(n_frames, cam_step=cam_step)

    def gt(i):
        return frames[i][3].astype(np.float32) if ground_truth else None

    jnative._lib, jnative._tried = None, True      # the JAX numpy path
    jeng = JMaskFusion(JResolution(syn.W, syn.H), syn.DEFAULT_INTR,
                       JConfig(**slice_cfg))

    def frame_data(cls, i):
        rgb, depth, lab, _ = frames[i]
        return cls(rgb=rgb, depth=depth, mask=lab, class_ids=[0, 7, 8],
                   timestamp=float(i))

    for i in range(3):
        jeng.process_frame(frame_data(JFrameData, i), gt_pose=gt(i))
    teng = MaskFusion(Resolution(syn.W, syn.H), tintr(syn.DEFAULT_INTR),
                      Config(**slice_cfg), device=CPU)
    restore_engine(teng, engine_snapshot(jeng))
    for i in range(3, n_frames):
        dj = jeng.process_frame(frame_data(JFrameData, i), gt_pose=gt(i))
        dt = teng.process_frame(frame_data(FrameData, i), gt_pose=gt(i))
        pj = [np.asarray(m.pose_log[-1]["pose"]) for m in jeng.models]
        pt = [teng.pose_log_numpy(k)[-1] for k in range(len(pj))]
        glob_mm = 1e3 * np.linalg.norm(pt[0][:3, 3] - pj[0][:3, 3])
        obj_mm = [round(1e3 * float(np.linalg.norm(a[:3, 3] - b[:3, 3])), 3)
                  for a, b in zip(pt[1:], pj[1:])]
        print(f"frame {i}: ids {dt['model_ids']} / {dj['model_ids']}; "
              f"global {glob_mm:.4f} mm, objects {obj_mm} mm; surfels "
              f"{[m.surfel_count for m in teng.models]} / "
              f"{[m.surfel_count for m in jeng.models]}; global x "
              f"{pt[0][0, 3] * 1e3:.3f} / {pj[0][0, 3] * 1e3:.3f} mm; "
              f"global rotation {_rot_deg(pt[0], pj[0]):.5f} deg; windows "
              f"{[m.window for m in teng.models[1:]]}", flush=True)
        if i == 3:
            a = state_to_numpy(teng.models[0].state)
            b = state_to_numpy(jeng.models[0].state)
            k = min(int(a["count"]), int(b["count"]))
            d = np.abs(a["pos"][:k] - b["pos"][:k]).max(1)
            print(f"  after the first port frame, global slots differing "
                  f"by > 1e-5 m: {int((d > 1e-5).sum())} of {k}, max "
                  f"{d.max() * 1e3:.3f} mm", flush=True)


if __name__ == "__main__":
    main(*(f(a) for f, a in zip((int, float, str), sys.argv[1:])))
