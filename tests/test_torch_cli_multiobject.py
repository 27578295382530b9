"""The port's multi-object CLI against the JAX package's, on the CPU at
160x120: tests/test_cli.py's precomputed scenario in the synchronous
schedule, a ground-truth pose in the synchronous multi-object frame, and
the -method maskfusion case of the pipelined schedules, which
tests/test_torch_cli_prefused.py and tests/test_torch_cli_exact.py run
(split from tests/test_torch_cli.py to keep each file's run short)."""

import numpy as np

import chip_smoke
from maskfusion_tpu.camera import Resolution as JResolution
from maskfusion_tpu.config import Config as JConfig
from maskfusion_tpu.engine import MaskFusion as JMaskFusion
from maskfusion_tpu.frame import FrameData as JFrameData
from maskfusion_tpu_torch.camera import Resolution
from maskfusion_tpu_torch.config import Config
from maskfusion_tpu_torch.engine import MaskFusion
from maskfusion_tpu_torch.frame import FrameData
from tests import synthetic as syn
from tests.test_io import write_dataset
from tests.test_torch_cli import _run_both, _write_cal, assert_poses_close
from tests.torch_helpers import CPU, jax_record_ready, tintr


def test_cli_precomputed_multimodel_matches_jax(tmp_path):
    """tests/test_cli.py::test_cli_precomputed_multimodel on both CLIs in
    the synchronous schedule: the object model spawns on both sides, and
    the segmentation and label images of every frame are the same bit for
    bit (the bound of tests/test_torch_engine_multimodel_lockstep.py's
    test, which holds last_segmentation equal)."""
    data = tmp_path / "data"
    data.mkdir()
    write_dataset(str(data), n=3, with_masks=True)
    runs = _run_both(tmp_path, [
        "-dir", str(data), "-method", "precomputed", "--pipeline", "off",
        "-q", "-nso", "-cal", _write_cal(tmp_path / "cal.txt"), "-ep", "-es",
        "-el", "--global-capacity", str(1 << 16),
        "--object-capacity", str(1 << 13)])
    import cv2

    for side in runs.values():
        for name in ("poses-0.txt", "poses-1.txt", "Segmentation3.png",
                     "Labels3.png"):
            assert (side / name).exists(), (side, name)
    for tick in (1, 2, 3):
        for kind in ("Segmentation", "Labels"):
            a = cv2.imread(str(runs["torch"] / f"{kind}{tick}.png"),
                           cv2.IMREAD_UNCHANGED)
            b = cv2.imread(str(runs["jax"] / f"{kind}{tick}.png"),
                           cv2.IMREAD_UNCHANGED)
            np.testing.assert_array_equal(a, b, err_msg=f"{kind}{tick}")
    _, pt = chip_smoke.read_tum(runs["torch"] / "poses-0.txt")
    _, pj = chip_smoke.read_tum(runs["jax"] / "poses-0.txt")
    assert_poses_close(pt, pj)


def test_ground_truth_in_multiobject_mode():
    """A ground-truth pose in the synchronous multi-object frame, on the
    port and on the JAX engine with the same frames and the same poses (the
    camera moving, the two objects moving on their own): the global pose is
    the ground truth, the objects are tracked from the camera motion as
    warm start (Config.object_warm_start; without it no pose enters the
    object solve), segmentation still runs.  Before each frame the port takes
    the JAX engine's whole state (convert.engine_snapshot /
    restore_engine), so each frame's step starts from one state on both
    sides.  Per frame, at the bounds of
    tests/test_torch_engine_multimodel_lockstep.py's test: the same model
    ids and last_segmentation, each object's logged pose to 8 mm, each
    model's surfel count to 1%.  (Run free after one carry, the two
    engines' object poses part by 12-15 mm at frame 5 while the global
    poses agree exactly, `python -m tests.torch_lockstep_drift 7 0.004 gt`:
    the small-object solve amplifies the JAX fuse's prefix-sum rounding,
    ROADMAP fault 2.)"""
    from maskfusion_tpu_torch.convert import engine_snapshot, restore_engine
    from tests.test_torch_engine_multimodel import SLICE, _two_object_frames
    from tests.torch_helpers import numpy_paths

    cfg = dict(SLICE, object_warm_start=True)
    frames = _two_object_frames(6, cam_step=0.004)
    with numpy_paths():
        jeng = JMaskFusion(JResolution(syn.W, syn.H), syn.DEFAULT_INTR,
                           JConfig(**cfg))
        for i, (rgb, depth, lab, cam) in enumerate(frames):
            teng = MaskFusion(Resolution(syn.W, syn.H),
                              tintr(syn.DEFAULT_INTR), Config(**cfg),
                              device=CPU)
            if i:
                restore_engine(teng, engine_snapshot(jeng))
            gt = cam.astype(np.float32)
            kw = dict(rgb=rgb, depth=depth, mask=lab, class_ids=[0, 7, 8],
                      timestamp=float(i + 1))
            dj = jeng.process_frame(JFrameData(**kw), gt_pose=gt)
            dt = teng.process_frame(FrameData(**kw), gt_pose=gt)
            assert dt["tracking_ok"] and dj["tracking_ok"]
            assert [m.model_id for m in teng.models] == \
                [m.model_id for m in jeng.models], i
            np.testing.assert_array_equal(teng.last_segmentation,
                                          jeng.last_segmentation)
            np.testing.assert_allclose(teng.current_pose, gt, atol=1e-6)
            np.testing.assert_allclose(teng.pose_log_numpy()[-1], gt,
                                       atol=1e-6)
            pj = [np.asarray(m.pose_log[-1]["pose"]) for m in jeng.models]
            for k in range(1, len(pj)):
                d = np.linalg.norm(teng.pose_log_numpy(k)[-1][:3, 3]
                                   - pj[k][:3, 3])
                assert d <= 8e-3, f"frame {i}: object {k} {d * 1e3:.2f} mm"
            for mt, mj in zip(teng.models, jeng.models):
                assert abs(mt.surfel_count - mj.surfel_count) \
                    <= 0.01 * mj.surfel_count, \
                    (i, mt.model_id, mt.surfel_count, mj.surfel_count)
    assert [m.model_id for m in teng.models] == [0, 1, 2]
    assert set(teng.stopwatch.summary()) >= {"segmentation", "odom", "fuse"}


def pipelined_cli_case(tmp_path, monkeypatch, pipeline):
    """Both CLIs with -method maskfusion on four frames of one
    tests/test_io.write_dataset directory, in the default --pipeline
    prefused and in exact: the object spawns on both sides, and both write
    the same pose files (model ids) with the same stamps; global poses
    within 1 mm / 0.05 deg, the object's within 8 mm (the lockstep tests'
    object bound: the newborn's first solve amplifies the fuse's known
    segment-sum rounding, ROADMAP faults 1-2; measured 1.8 mm in exact).
    Neither CLI drains the pipeline before its exports, so both logs lack
    the frame still pending at the end (ROADMAP §3)."""
    monkeypatch.setattr(JMaskFusion, "_record_ready",
                        staticmethod(jax_record_ready))
    data = tmp_path / "data"
    data.mkdir()
    write_dataset(str(data), n=4, with_masks=True)
    args = ["-dir", str(data), "-method", "maskfusion", "-q", "-nso",
            "-cal", _write_cal(tmp_path / "cal.txt"), "-ep", "-offset", "0",
            "--global-capacity", str(1 << 16),
            "--object-capacity", str(1 << 13)]
    if pipeline != "prefused":
        args += ["--pipeline", pipeline]
    runs = _run_both(tmp_path, args)
    names = {k: sorted(p.name for p in v.glob("poses-*.txt"))
             for k, v in runs.items()}
    assert names["torch"] == names["jax"] == ["poses-0.txt", "poses-1.txt"]
    for name in names["jax"]:
        ts, pt = chip_smoke.read_tum(runs["torch"] / name)
        js, pj = chip_smoke.read_tum(runs["jax"] / name)
        assert ts == js, (name, ts, js)
        if name == "poses-0.txt":
            assert_poses_close(pt, pj)
        else:
            assert_poses_close(pt, pj, pos_m=8e-3, deg=180.0)
    stamps, _ = chip_smoke.read_tum(runs["torch"] / "poses-0.txt")
    assert len(stamps) == 3          # frame 3 is still pending
