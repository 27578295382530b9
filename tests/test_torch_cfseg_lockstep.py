"""The port's Co-Fusion engine (-method cofusion) against the JAX engine
on the CPU, in lockstep.

The JAX engine runs tests/test_torch_engine_multimodel.py's two-object
motion (both objects moving 6 mm a frame, camera still) with the
Co-Fusion segmenter under the Config default pipelined_multiobject=True
(which both engines answer with the synchronous frame: the pipelined step
needs the maskfusion segmenter's device edge map), objects tracked and
fused one at a time as in that file's lockstep, through frame 5, where
no object has been segmented yet; its whole state crosses over with
convert.engine_snapshot / restore_engine and both engines run frames 6-9
side by side: the CRF spawns the first object at frame 6, the next frame
tracks it, and a jump past model_deactivate_jump drops it at frame 9 in
both.  Run from frame 0 instead, the engines' fuse rounding (ROADMAP
fault 2) moves the spawn by a frame.

Bounds, per frame: the same model ids and the same segmentation (measured:
equal on every frame); the global pose within 1 mm and 0.05 deg and each
object's within 8 mm (the multi-object lockstep's bounds; measured 0.066
and 0.067 mm); surfel counts within 1% (measured 0.04%)."""

import numpy as np
import pytest

from maskfusion_tpu.camera import Resolution as JResolution
from maskfusion_tpu.config import Config as JConfig
from maskfusion_tpu.engine import MaskFusion as JMaskFusion
from maskfusion_tpu.frame import FrameData as JFrameData
from maskfusion_tpu_torch.camera import Resolution
from maskfusion_tpu_torch.config import Config
from maskfusion_tpu_torch.convert import engine_snapshot, restore_engine
from maskfusion_tpu_torch.engine import MaskFusion
from maskfusion_tpu_torch.frame import FrameData
from tests import synthetic as syn
from tests.torch_helpers import CPU, numpy_paths, tintr

COFUSION = dict(global_surfel_capacity=1 << 16,
                object_surfel_capacity=1 << 13, seg_method="cofusion",
                use_so3=False, open_loop=True, model_spawn_offset=0,
                batch_object_tracking=False)
CARRY, FRAMES = 6, 10


def _frames():
    out = []
    for i in range(FRAMES):
        o1 = np.array([0.006 * max(0, i - 1), 0.0, 0.0])
        o2 = np.array([0.0, -0.006 * max(0, i - 2), 0.0])
        pts, cols, labels = syn.make_scene_with_two_objects(o1, o2)
        out.append(syn.render(pts, cols, np.eye(4, dtype=np.float32),
                              syn.DEFAULT_INTR, labels=labels)[:2])
    return out


def _no_pipelined_step(*args, **kwargs):
    raise AssertionError("Co-Fusion took the pipelined step")


def _rot_deg(a, b):
    return syn.rotation_angle_deg(a[:3, :3], b[:3, :3])


def test_cofusion_lockstep_with_jax_engine(monkeypatch):
    frames = _frames()
    assert JConfig(**COFUSION).pipelined_multiobject
    with numpy_paths():
        jeng = JMaskFusion(JResolution(syn.W, syn.H), syn.DEFAULT_INTR,
                           JConfig(**COFUSION))
        monkeypatch.setattr(jeng, "_pipelined_step", _no_pipelined_step)
        for i in range(CARRY):
            rgb, depth = frames[i]
            jeng.process_frame(JFrameData(rgb=rgb, depth=depth,
                                          timestamp=float(i)))
        assert [m.model_id for m in jeng.models] == [0]
        teng = MaskFusion(Resolution(syn.W, syn.H), tintr(syn.DEFAULT_INTR),
                          Config(**COFUSION), device=CPU)
        monkeypatch.setattr(teng, "_pipelined_step", _no_pipelined_step)
        restore_engine(teng, engine_snapshot(jeng))
        history = []
        for i in range(CARRY, FRAMES):
            rgb, depth = frames[i]
            dj = jeng.process_frame(JFrameData(rgb=rgb, depth=depth,
                                               timestamp=float(i)))
            dt = teng.process_frame(FrameData(rgb=rgb, depth=depth,
                                              timestamp=float(i)))
            assert dt["model_ids"] == dj["model_ids"], i
            history.append(dt["model_ids"])
            np.testing.assert_array_equal(teng.last_segmentation,
                                          jeng.last_segmentation)
            pj = [np.asarray(m.pose_log[-1]["pose"]) for m in jeng.models]
            pt = [teng.pose_log_numpy(k)[-1] for k in range(len(pj))]
            dpos = np.linalg.norm(pt[0][:3, 3] - pj[0][:3, 3])
            assert dpos <= 1e-3, f"frame {i}: global {dpos * 1e3:.3f} mm"
            assert _rot_deg(pt[0], pj[0]) <= 0.05, i
            for k in range(1, len(pj)):
                d = np.linalg.norm(pt[k][:3, 3] - pj[k][:3, 3])
                assert d <= 8e-3, f"frame {i}: object {k} {d * 1e3:.2f} mm"
            for mt, mj in zip(teng.models, jeng.models):
                assert abs(mt.surfel_count - mj.surfel_count) \
                    <= 0.01 * mj.surfel_count, \
                    (i, mt.model_id, mt.surfel_count, mj.surfel_count)
    # the CRF spawned an object from motion alone (no masks in the frames)
    assert history[0] == [0, 1], history
