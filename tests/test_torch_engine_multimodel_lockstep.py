"""A lockstep run of the port's synchronous multi-object frame against the
JAX engine from a state carried across after the spawns, and why it stays
short (split from tests/test_torch_engine_multimodel.py, which defines
the configuration `SLICE` and the scene, to keep each file's run short).

Lockstep bounds, per frame: the same model ids and class ids; the global
pose to 1 mm and 0.05 deg (the static parity test's); each object's logged
pose to 8 mm (tests/test_engine_multimodel.py:200-201: the small-object
solve amplifies float32 rounding); each model's surfel count to 1%."""

import numpy as np

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
from tests.test_torch_engine_multimodel import SLICE, _two_object_frames
from tests.torch_helpers import CPU, numpy_paths, tintr


def _rot_deg(a, b):
    return syn.rotation_angle_deg(a[:3, :3], b[:3, :3])


def test_lockstep_with_jax_engine():
    """The JAX engine runs the slice's configuration (maskfusion
    segmentation from the frame's masks, synchronous schedule, per-model
    loop) through both spawns; its whole state crosses over with
    convert.engine_snapshot / restore_engine, and both engines run the
    remaining frames side by side.  The scene is the two-object motion of
    tests/test_engine_multimodel.py:172-201, four tracked frames after the
    carry.  (With the camera also moving, or over more frames, the object
    poses of the two engines drift apart by several mm: ROADMAP, faults.)"""
    frames = _two_object_frames(7)
    with numpy_paths():
        jeng = JMaskFusion(JResolution(syn.W, syn.H), syn.DEFAULT_INTR,
                           JConfig(**SLICE))

        def jframe(i):
            rgb, depth, lab, _ = frames[i]
            return JFrameData(rgb=rgb, depth=depth, mask=lab,
                              class_ids=[0, 7, 8], timestamp=float(i))

        for i in range(3):
            jeng.process_frame(jframe(i))
        assert [m.model_id for m in jeng.models] == [0, 1, 2]
        teng = MaskFusion(Resolution(syn.W, syn.H), tintr(syn.DEFAULT_INTR),
                          Config(**SLICE), device=CPU)
        restore_engine(teng, engine_snapshot(jeng))
        assert [m.surfel_count for m in teng.models] == \
            [m.surfel_count for m in jeng.models]

        for i in range(3, len(frames)):
            rgb, depth, lab, cam = frames[i]
            dj = jeng.process_frame(jframe(i))
            dt = teng.process_frame(FrameData(
                rgb=rgb, depth=depth, mask=lab, class_ids=[0, 7, 8],
                timestamp=float(i)))
            assert dt["model_ids"] == dj["model_ids"], i
            assert dt["tracking_ok"] == dj["tracking_ok"], i
            assert [m.class_id for m in teng.models] == \
                [m.class_id for m in jeng.models]
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
        # the camera held still while both objects moved
        assert np.linalg.norm(pt[0][:3, 3]) < 5e-3
        for k, true in ((1, [0.024, 0.0, 0.0]), (2, [0.0, -0.024, 0.0])):
            assert np.linalg.norm(pt[k][:3, 3] - true) < 0.025, (k, pt[k])


def test_segment_sums_are_exact_where_the_jax_prefix_sums_drift():
    """Why the lockstep run stays short.  Fuse merges each matched surfel
    with the weighted mean of its pixel records.  The JAX package takes the
    per-slot sums as differences of one float32 running sum over all
    records (maskfusion_tpu/ops/sort_utils.py:77-124), so a slot's sum
    carries the rounding of the whole running total; the port sums per
    slot.  At the lockstep scene's scale (~19k surfels, a 160x120 frame of
    records, 2 m depths) the JAX merge moves positions by millimetres, and
    each frame's global fuse then feeds the next track: the engines drift
    apart over frames (ROADMAP, faults).  The port's sums hold float64."""
    import jax.numpy as jnp
    import torch

    from maskfusion_tpu.ops import sort_utils as jsu
    from maskfusion_tpu_torch.ops import sort_utils as tsu

    rng = np.random.default_rng(0)
    n_rec, cap, used = syn.W * syn.H, 1 << 16, 18922
    slots = rng.integers(0, used, n_rec).astype(np.int32)
    valid = rng.random(n_rec) < 0.5
    a = rng.uniform(0.2, 1.0, n_rec).astype(np.float32)
    pos = (rng.normal(0.0, 0.6, (n_rec, 3)) + [0.0, 0.0, 2.0]).astype(
        np.float32)
    vals = [a, a[:, None] * pos]
    exact_a = np.zeros(cap)
    exact_p = np.zeros((cap, 3))
    np.add.at(exact_a, slots[valid], vals[0][valid].astype(np.float64))
    np.add.at(exact_p, slots[valid], vals[1][valid].astype(np.float64))
    hit = exact_a > 0
    mean = exact_p[hit] / exact_a[hit, None]

    def merged_err(sums):
        sa, sp = (np.asarray(s, np.float64) for s in sums)
        return np.abs(sp[hit] / sa[hit, None] - mean).max()

    ours = tsu.segment_sum_dense(torch.from_numpy(slots),
                                 torch.from_numpy(valid),
                                 [torch.from_numpy(v) for v in vals], cap)
    ref = jsu.segment_sum_dense(jnp.asarray(slots), jnp.asarray(valid),
                                [jnp.asarray(v) for v in vals], cap)
    assert merged_err([s.numpy() for s in ours]) < 1e-5
    # the reference's known difference: millimetres on the same records
    assert merged_err(ref) > 1e-3
