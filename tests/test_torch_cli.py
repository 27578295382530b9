"""The port's CLI, ground-truth pose injection, diagnostics and bench frame
generators against the JAX package, on the CPU at 160x120.

The CLI scenarios are tests/test_cli.py's, run on both CLIs over one
tests/test_io.write_dataset directory (one JAX run per scenario, shared by
the module)."""

import dataclasses
import re
import sys

import numpy as np
import pytest
import torch

import bench as jbench
import chip_smoke
from maskfusion_tpu.camera import Resolution as JResolution
from maskfusion_tpu.config import Config as JConfig
from maskfusion_tpu.engine import MaskFusion as JMaskFusion
from maskfusion_tpu.frame import FrameData as JFrameData
from maskfusion_tpu.main import main as jmain
from maskfusion_tpu.utils import diag_export as jdiag
from maskfusion_tpu_torch import bench, camera
from maskfusion_tpu_torch.camera import Resolution
from maskfusion_tpu_torch.config import Config
from maskfusion_tpu_torch.engine import MaskFusion
from maskfusion_tpu_torch.frame import FrameData
from maskfusion_tpu_torch.io.export import load_ply
from maskfusion_tpu_torch.io.klg_reader import write_klg
from maskfusion_tpu_torch.main import main as tmain
from maskfusion_tpu_torch.utils import diag_export as tdiag
from tests import synthetic as syn
from tests.test_engine_static import make_trajectory
from tests.test_io import write_dataset
from tests.torch_helpers import CPU, jax_record_ready, tintr


def _write_cal(path):
    intr = syn.DEFAULT_INTR
    path.write_text(f"{intr.fx} {intr.fy} {intr.cx} {intr.cy}\n")
    return str(path)


def assert_poses_close(pa, pb, pos_m=1e-3, deg=0.05):
    assert len(pa) == len(pb)
    for i, (a, b) in enumerate(zip(pa, pb)):
        d = np.linalg.norm(a[:3, 3] - b[:3, 3])
        assert d <= pos_m, f"frame {i}: {d * 1e3:.4f} mm"
        r = chip_smoke._rot_deg(a, b)
        assert r <= deg, f"frame {i}: {r} deg"


def _run_both(base, args):
    """Both CLIs with `args`, each exporting into its own directory."""
    out = {}
    for name, run in (("jax", jmain), ("torch", tmain)):
        export = base / name
        kw = {"device": "cpu"} if name == "torch" else {}
        assert run([*args, "-exportdir", str(export)], **kw) == 0
        out[name] = export
    return out


# --------------------------------------------------------------- static CLI
@pytest.fixture(scope="module")
def static_data(tmp_path_factory):
    base = tmp_path_factory.mktemp("static")
    data = base / "data"
    data.mkdir()
    write_dataset(str(data), n=3, with_masks=False)
    return base, data, _write_cal(base / "cal.txt")


@pytest.fixture(scope="module")
def static_runs(static_data):
    base, data, cal = static_data
    return _run_both(base, ["-dir", str(data), "-static", "-q", "-nso",
                            "-cal", cal, "-ep", "-em",
                            "--global-capacity", str(1 << 16)])


def test_cli_static_matches_jax(static_runs):
    """tests/test_cli.py::test_cli_static_run_with_exports on both CLIs:
    per frame the port's pose within 1 mm / 0.05 deg of the JAX CLI's, the
    same stamps and line counts, a finite PLY."""
    ts, pt = chip_smoke.read_tum(static_runs["torch"] / "poses-0.txt")
    js, pj = chip_smoke.read_tum(static_runs["jax"] / "poses-0.txt")
    assert len(pt) == len(pj) == 3
    assert ts == js
    assert all(len(line.split()) == 8 for line in
               (static_runs["torch"] / "poses-0.txt").read_text()
               .splitlines())
    assert_poses_close(pt, pj)
    cloud = load_ply(str(static_runs["torch"] / "cloud-0.ply"))
    assert np.isfinite(cloud["pos"]).all()
    assert np.isfinite(cloud["normal"]).all()


def test_cli_unported_engine_options_raise(static_data):
    """-rl runs, static (the synchronous step, ferns being on) and in the
    CLI's default pipelined schedule (the synchronous frame, as ferns
    close the pipelined gate), and writes its poses; so does -method
    cofusion, in the synchronous frame.  No engine option raises."""
    base, data, cal = static_data
    common = ["-dir", str(data), "-q", "-cal", cal,
              "--global-capacity", str(1 << 16), "-ep"]
    for name, flags in (("rl_static", ["-static", "-rl"]), ("rl", ["-rl"]),
                        ("cofusion", ["-method", "cofusion"])):
        out = base / name
        assert tmain([*common, *flags, "-exportdir", str(out)],
                     device="cpu") == 0, name
        _, poses = chip_smoke.read_tum(out / "poses-0.txt")
        assert len(poses) == 3 and np.isfinite(np.asarray(poses)).all()
        # the dataset's camera holds still
        assert max(np.linalg.norm(p[:3, 3]) for p in poses) < 0.01


@pytest.mark.parametrize("flag,item", [
    (["-viewer"], "item 13 (viewer and gui)"),
    (["-ev"], "item 13 (viewer and gui)"),
    (["--save-state"], None),
    (["--load-state"], None),
], ids=["viewer", "viewport", "save_state", "load_state"])
def test_cli_unported_flags_raise(flag, item, static_data, static_runs,
                                  tmp_path):
    """-viewer and -ev raise, naming their ROADMAP item.  --save-state
    writes the JAX package's checkpoint layout after the run;
    --load-state resumes one written after the first two frames, and the
    last frame's run exports the uninterrupted run's poses (within 1e-5 m
    and 1e-3 deg)."""
    if item is not None:
        with pytest.raises(NotImplementedError,
                           match=re.escape(f"ROADMAP queue 1 {item}")):
            tmain(["-dir", "no-such-dir", "-static", *flag], device="cpu")
        return
    import json

    base, data, cal = static_data
    common = ["-dir", str(data), "-static", "-q", "-nso", "-cal", cal,
              "--global-capacity", str(1 << 16)]
    ckpt = tmp_path / "ckpt"
    if flag == ["--save-state"]:
        assert tmain([*common, "--save-state", str(ckpt)],
                     device="cpu") == 0
        meta = json.loads((ckpt / "meta.json").read_text())
        assert meta["tick"] == 3 and meta["models"][0]["name"] == "model0"
        with np.load(ckpt / "model0.npz") as z:
            assert z["pos"].shape == (1 << 16, 3)      # at capacity
            assert int(z["count"]) > 1000
        return
    assert tmain([*common, "-e", "2", "--save-state", str(ckpt)],
                 device="cpu") == 0
    out = tmp_path / "resumed"
    assert tmain([*common, "-s", "2", "--load-state", str(ckpt), "-ep",
                  "-exportdir", str(out)], device="cpu") == 0
    ts, poses = chip_smoke.read_tum(out / "poses-0.txt")
    ts0, poses0 = chip_smoke.read_tum(static_runs["torch"] / "poses-0.txt")
    assert ts == ts0
    assert_poses_close(poses, poses0, pos_m=1e-5, deg=1e-3)


# ---------------------------------------------------------- multi-object CLI
def test_cli_precomputed_multimodel_matches_jax(tmp_path):
    """tests/test_cli.py::test_cli_precomputed_multimodel on both CLIs in
    the synchronous schedule: the object model spawns on both sides, and
    the segmentation and label images of every frame are the same bit for
    bit (the bound of tests/test_torch_engine_multimodel.py's lockstep
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


@pytest.mark.parametrize("pipeline", ["prefused", "exact"])
def test_cli_maskfusion_pipelined_matches_jax(tmp_path, monkeypatch,
                                              pipeline):
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


# ------------------------------------------------------------ the -l path
def _klg_frames(n):
    pts, cols = syn.make_scene()
    out = []
    for i, pose in enumerate(make_trajectory(n)):
        rgb, depth = syn.render(pts, cols, pose, syn.DEFAULT_INTR)
        out.append(FrameData(rgb=rgb, depth=np.round(depth * 1000).astype(
            np.uint16), timestamp=1000.0 * (i + 1)))
    return out


def test_cli_klg_without_opencv(tmp_path, monkeypatch):
    """`-l log.klg -static -ep -em` on a raw log with OpenCV unimportable:
    its poses are the port engine's on the same frames (the log carries one
    frame more: the reader never returns a log's last frame, as the
    reference's KlgLogReader::hasMore).  A .klg header holds no frame size,
    so the reader reads frames of the preset's size: here the default
    preset is the log's 160x120."""
    frames = _klg_frames(4)
    log = tmp_path / "seq.klg"
    write_klg(str(log), frames + frames[-1:], compress=False)
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(camera.PRESETS, "default",
                        (Resolution(syn.W, syn.H), tintr(syn.DEFAULT_INTR)))
    out = tmp_path / "out"
    assert tmain(["-l", str(log), "-static", "-q", "-nso",
                  "-exportdir", str(out), "-ep", "-em",
                  "--global-capacity", str(1 << 16)], device="cpu") == 0
    stamps, poses = chip_smoke.read_tum(out / "poses-0.txt")
    assert stamps == [f.timestamp for f in frames]
    eng = MaskFusion(Resolution(syn.W, syn.H), tintr(syn.DEFAULT_INTR),
                     Config(static_mode=True, use_so3=False,
                            global_surfel_capacity=1 << 16), device=CPU)
    for f in frames:
        eng.process_frame(f)
    np.testing.assert_allclose(poses, eng.pose_log_numpy(), atol=1e-6)
    assert np.isfinite(load_ply(str(out / "cloud-0.ply"))["pos"]).all()


# ------------------------------------------------- --nn and --toml
NN_ARGS = ["-exportdir", None, "-ep", "-nso", "-offset", "0",
           "-segMinNew", "0.005", "--global-capacity", str(1 << 15),
           "--object-capacity", str(1 << 12)]


@pytest.fixture()
def micro_nn(monkeypatch, tmp_path):
    """A 64x64 KLG log of the trained shapes scene (tests/test_engine_nn.py's,
    no masks; one frame more than the reader returns), the default preset
    set to its size, and the CLI's network swapped for the trained micro
    network on the CPU: the CLI builds its full-width MaskRCNNConfig, whose
    score threshold and class filter the swap keeps and records."""
    from maskfusion_tpu_torch.maskrcnn import checkpoint_io
    from maskfusion_tpu_torch.maskrcnn import inference
    from maskfusion_tpu_torch.maskrcnn.synthetic_shapes import micro_config
    from tests.test_torch_maskrcnn_inference import INTR, MICRO, S, _scene

    rgb, depth, _ = _scene()
    frames = [FrameData(rgb=rgb, depth=np.round(depth * 1000).astype(
        np.uint16), timestamp=1000.0 * (i + 1)) for i in range(7)]
    log = tmp_path / "nn.klg"
    write_klg(str(log), frames, compress=False)
    monkeypatch.setitem(camera.PRESETS, "default",
                        (Resolution(S, S), camera.CameraIntrinsics(*INTR)))
    params, _ = checkpoint_io.load_params(MICRO)
    made = []
    real = inference.MaskRCNNInference

    def micro(cfg, filter_classes=None, device=None, **_):
        made.append(dict(score_threshold=cfg.score_threshold,
                         filter_classes=filter_classes, device=device,
                         image_size=cfg.image_size))
        small = dataclasses.replace(micro_config(S),
                                    score_threshold=cfg.score_threshold)
        return real(small, params=params, filter_classes=filter_classes,
                    device="cpu")

    monkeypatch.setattr(inference, "MaskRCNNInference", micro)
    return log, len(frames) - 1, made


def test_cli_nn_runs_the_network(micro_nn, tmp_path, capsys):
    """`-l log.klg --nn -frameQ 3` in the multi-object default (prefused):
    the worker labels frames through the delay queue, the flush drains it
    at the end of the log, every frame is processed, the object spawns
    (poses-1.txt) and the FPS line is printed.  The CLI asks for the
    full-width network (512 px) with the Config's score threshold."""
    log, n, made = micro_nn
    out = tmp_path / "out"
    args = list(NN_ARGS)
    args[1] = str(out)
    assert tmain(["-l", str(log), "--nn", "-frameQ", "3", *args],
                 device="cpu") == 0
    text = capsys.readouterr().out
    assert f"processed {n} frames" in text
    labelled = int(re.search(r"Mask R-CNN labelled (\d+) frames",
                             text).group(1))
    assert 1 <= labelled <= n
    assert made == [dict(score_threshold=0.55, filter_classes=None,
                         device="cpu", image_size=512)]
    assert (out / "poses-0.txt").exists() and (out / "poses-1.txt").exists()


def test_cli_toml_reaches_the_config(micro_nn, tmp_path, monkeypatch):
    """`--toml config.toml --nn`: score_threshold, filter_classes and
    trackable_classes reach the engine's Config, and the first two the
    network."""
    from maskfusion_tpu_torch import engine

    log, n, made = micro_nn
    seen = []

    class Recording(engine.MaskFusion):
        def __init__(self, res, intr, cfg, **kw):
            seen.append(cfg)
            super().__init__(res, intr, cfg, **kw)

    monkeypatch.setattr(engine, "MaskFusion", Recording)
    toml = tmp_path / "config.toml"
    toml.write_text("[MaskRCNN]\nscore_threshold = 0.3\n"
                    "filter_classes = [1, 2]\n"
                    "[ModelSpawning]\ntrackable_classes = [2]\n")
    args = list(NN_ARGS)
    args[1] = str(tmp_path / "out")
    assert tmain(["-l", str(log), "--nn", "--toml", str(toml), *args],
                 device="cpu") == 0
    cfg, = seen
    assert (cfg.score_threshold, cfg.filter_classes,
            cfg.trackable_classes) == (0.3, [1, 2], [2])
    assert made == [dict(score_threshold=0.3, filter_classes=[1, 2],
                         device="cpu", image_size=512)]


# --------------------------------------------------------- ground truth
GT_CFG = dict(global_surfel_capacity=1 << 16, use_so3=False,
              static_mode=True)


def test_ground_truth_injection():
    """tests/test_engine_static.py::test_ground_truth_injection on the port
    (each pose equals its ground-truth pose to 1e-6), beside the JAX engine
    on the same frames: surfel counts within 1% per frame (the static
    parity test's bound)."""
    teng = MaskFusion(Resolution(syn.W, syn.H), tintr(syn.DEFAULT_INTR),
                      Config(**GT_CFG), device=CPU)
    jeng = JMaskFusion(JResolution(syn.W, syn.H), syn.DEFAULT_INTR,
                       JConfig(**GT_CFG))
    pts, cols = syn.make_scene()
    for i, pose in enumerate(make_trajectory(3)):
        rgb, depth = syn.render(pts, cols, pose, syn.DEFAULT_INTR)
        dt = teng.process_frame(FrameData(rgb=rgb, depth=depth),
                                gt_pose=pose)
        dj = jeng.process_frame(JFrameData(rgb=rgb, depth=depth),
                                gt_pose=pose)
        np.testing.assert_allclose(teng.current_pose, pose, atol=1e-6)
        np.testing.assert_allclose(teng.pose_log_numpy()[-1], pose,
                                   atol=1e-6)
        assert dt["tracking_ok"] and dj["tracking_ok"]
        assert abs(dt["surfels"] - dj["surfels"]) <= 0.01 * dj["surfels"], \
            (i, dt["surfels"], dj["surfels"])
    assert teng.last_segmentation is not None
    assert not teng.last_segmentation.any()
    assert set(teng.stopwatch.summary()) == {"Preprocess", "odom", "fuse",
                                             "Run"}


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
    tests/test_torch_engine_multimodel.py's lockstep test: the same model
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


# ------------------------------------------------------------ diagnostics
def test_diag_export_artifacts(tmp_path):
    """tests/test_tools.py::test_diag_export_artifacts on the port: the
    metrics CSV (the JAX columns, with ms_<stage> from the stopwatch), and
    on the general step (here a ground-truth frame) an alignment-error
    image per interval frame."""
    out = tmp_path / "diag"
    cfg = Config(**GT_CFG, diag_export_dir=str(out), diag_export_interval=1)
    eng = MaskFusion(Resolution(syn.W, syn.H), tintr(syn.DEFAULT_INTR), cfg,
                     device=CPU)
    pts, cols = syn.make_scene()
    rgb, depth = syn.render(pts, cols, np.eye(4), syn.DEFAULT_INTR)
    for i in range(3):
        eng.process_frame(FrameData(rgb=rgb, depth=depth, timestamp=float(i)))
    eng.process_frame(FrameData(rgb=rgb, depth=depth, timestamp=3.0),
                      gt_pose=np.eye(4))
    rows = (out / "metrics.csv").read_text().strip().splitlines()
    assert len(rows) == 4           # header + frames 2-4
    assert rows[0].split(",") == [
        "tick", "n_models", "surfels", "tracking_ok", "icp_error",
        "icp_count", "ms_Preprocess", "ms_odom", "ms_projection",
        "ms_segmentation", "ms_fuse", "ms_Run"]
    assert float(rows[1].split(",")[-1]) > 0.0       # ms_Run recorded
    # the -static fast path passes no frame vertices: images only from the
    # general step's frame 4
    assert sorted(p.name for p in out.glob("*.png")) == [
        "icp_error_00004_m0.png"]


def test_alignment_error_image_matches_jax():
    rng = np.random.default_rng(6)
    shape = (syn.H, syn.W, 3)
    pv = rng.normal(size=shape).astype(np.float32)
    pn = rng.normal(size=shape).astype(np.float32)
    fv = rng.normal(size=shape).astype(np.float32)
    pv[:10, :, 0] = np.nan
    fv[20:25, 5:9, 0] = np.inf
    pn[50, :, 0] = np.nan
    j = np.asarray(jdiag._alignment_error_image(pv, pn, fv))
    t = tdiag._alignment_error_image(torch.from_numpy(pv),
                                     torch.from_numpy(pn),
                                     torch.from_numpy(fv)).numpy()
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    assert np.isnan(t).sum() > 0
    np.testing.assert_allclose(t, j, atol=1e-6, equal_nan=True)


# ------------------------------------------------------- bench generators
def test_bench_frames_equal_bench_py():
    for a, b in zip(bench.make_frames(64, 48, 3),
                    jbench.make_frames(64, 48, 3)):
        assert a.timestamp == b.timestamp
        np.testing.assert_array_equal(a.rgb, b.rgb)
        assert a.depth.dtype == b.depth.dtype == np.uint16
        np.testing.assert_array_equal(a.depth, b.depth)


def test_bench_two_object_frames_equal_bench_py():
    tf, tk = bench.make_two_object_frames(80, 60, 4)
    jf, jk = jbench.make_two_object_frames(80, 60, 4)
    assert tk == jk
    head, _ = bench.make_two_object_frames(80, 60, 4, count=2)
    assert len(tf) == len(jf) == 4 and len(head) == 2
    for i, (a, b) in enumerate(zip(tf, jf)):
        for k in ("rgb", "depth", "mask"):
            x, y = getattr(a, k), getattr(b, k)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y, err_msg=f"{k} {i}")
        assert a.class_ids == b.class_ids == [0, 7, 8]
        assert a.timestamp == b.timestamp
    for a, b in zip(head, tf):
        np.testing.assert_array_equal(a.rgb, b.rgb)


def test_bench_windows_and_line():
    """The bench's warm-up and timed windows and the line's format, at
    160x120 on the CPU (a control-flow check: the bench itself runs on the
    card only)."""
    eng = MaskFusion(Resolution(160, 120),
                     bench_intrinsics_small(), bench.static_config(),
                     device=CPU)
    frames = bench.make_frames(160, 120, 6)
    bench.warm_up(eng, frames[:2])
    fps = bench.timed_windows(eng, frames[2:], 2, 2)
    assert len(fps) == 2 and all(f > 0 for f in fps)
    assert eng.tick == 6
    assert len(eng.global_model.pose_log) == 6
    line = bench.fps_line("slam_fps_640x480_static", fps,
                          bench.device_line("cpu"))
    assert list(line) == ["metric", "value", "unit", "vs_baseline", "reps",
                          "device"]
    assert line["device"] == "cpu"
    assert line["vs_baseline"] == round(line["value"] / 30.0, 4)
    with pytest.raises(ValueError, match="frames given"):
        bench.timed_windows(eng, frames[3:], 2, 2)


def bench_intrinsics_small():
    from maskfusion_tpu_torch.camera import CameraIntrinsics

    return CameraIntrinsics(*(v / 4 for v in bench.STATIC_INTRINSICS))
