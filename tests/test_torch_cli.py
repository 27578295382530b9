"""The port's CLI, ground-truth pose injection, diagnostics and bench frame
generators against the JAX package, on the CPU at 160x120.

The CLI scenarios are tests/test_cli.py's, run on both CLIs over one
tests/test_io.write_dataset directory (one JAX run per scenario, shared by
the module).  The multi-object CLI scenarios are in
tests/test_torch_cli_multiobject.py, tests/test_torch_cli_prefused.py and
tests/test_torch_cli_exact.py (split from this file to keep each file's
run short)."""

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
from tests.test_torch_viewer import TIE_SHARE
from tests.torch_helpers import CPU, tintr


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


def _viewer_canvases(monkeypatch, module):
    """Spy on `module`.LiveViewer.update: the canvas of every frame, and
    whether the viewer composed offscreen."""
    seen = []
    orig = module.LiveViewer.update

    def spy(self, diag=None):
        ok = orig(self, diag)
        seen.append((self.offscreen, self.last_canvas.copy()))
        return ok

    monkeypatch.setattr(module.LiveViewer, "update", spy)
    return seen


@pytest.fixture(scope="module")
def static_runs(static_data):
    """Both CLIs on the static dataset with -ep -em, the live viewer and
    the viewport export (one run each, shared by the module), with no
    display set: the export directories and every frame's viewer canvas.
    -ev writes only into an export directory that exists, as in the JAX
    CLI (ROADMAP fault 15), so both are made first."""
    from maskfusion_tpu import gui as jgui
    from maskfusion_tpu_torch import gui as tgui

    base, data, cal = static_data
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("DISPLAY", raising=False)
        mp.delenv("WAYLAND_DISPLAY", raising=False)
        canvases = {"jax": _viewer_canvases(mp, jgui),
                    "torch": _viewer_canvases(mp, tgui)}
        for name in ("jax", "torch"):
            (base / name).mkdir()
        out = _run_both(base, ["-dir", str(data), "-static", "-q", "-nso",
                               "-cal", cal, "-ep", "-em", "-viewer", "-ev",
                               "--global-capacity", str(1 << 16)])
    out["canvases"] = canvases
    return out


def test_cli_static_matches_jax(static_runs):
    """tests/test_cli.py::test_cli_static_run_with_exports on both CLIs
    (with the viewer and the viewport export on, which only read the
    engines): per frame the port's pose within 1 mm / 0.05 deg of the JAX
    CLI's, the same stamps and line counts, a finite PLY."""
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


@pytest.mark.parametrize("flag", [["-viewer"], ["-ev"], ["--save-state"],
                                  ["--load-state"]],
                         ids=["viewer", "viewport", "save_state",
                              "load_state"])
def test_cli_viewer_viewport_and_state_flags(flag, static_data,
                                             static_runs, tmp_path):
    """-viewer and -ev run on both CLIs over the static dataset (the
    module's shared runs, static_runs).  The live viewer composes offscreen (no display set) a canvas of the JAX CLI's
    shape each frame; -ev writes one Viewport<tick>.png a frame of the JAX
    CLI's shape.  The first frame's canvas (below the HUD bar) and
    viewport are within the viewer's bound of the JAX CLI's
    (tests/test_torch_viewer.py: one level, but for 3e-3 of the pixels on
    the scan's ties): before the first fuse both maps are the same.  From
    the first fuse on, the JAX package's cumsum segment sums move merged
    colours and positions (ROADMAP fault 2; 27% of this dataset's
    predicted pixels by more than one level at tick 2), so the later
    viewports' depth and label panels are held to the bound and their
    colour panels are not compared.  As in the JAX CLI, -ev writes only
    into an export directory that exists (fault 15).  --save-state writes
    the JAX package's checkpoint layout after the run; --load-state
    resumes one written after the first two frames, and the last frame's
    run exports the uninterrupted run's poses (within 1e-5 m and 1e-3
    deg)."""
    base, data, cal = static_data
    common = ["-dir", str(data), "-static", "-q", "-nso", "-cal", cal,
              "--global-capacity", str(1 << 16)]
    if flag == ["-viewer"]:
        seen = static_runs["canvases"]
        assert len(seen["torch"]) == len(seen["jax"]) == 3
        assert all(off for off, _ in seen["torch"] + seen["jax"])
        for (_, out), (_, ref) in zip(seen["torch"], seen["jax"]):
            assert out.shape == ref.shape == (2 * syn.H + 24, 2 * syn.W, 3)
            assert out[24:].std() > 5.0
        out, ref = seen["torch"][0][1], seen["jax"][0][1]
        diff = np.abs(out[24:].astype(int) - ref[24:].astype(int)).max(-1)
        assert (diff > 1).mean() < TIE_SHARE
        return
    if flag == ["-ev"]:
        import cv2

        H, W = syn.H, syn.W
        for tick in (1, 2, 3):
            a, b = (cv2.imread(str(static_runs[k] / f"Viewport{tick}.png"))
                    for k in ("torch", "jax"))
            assert a.shape == b.shape == (2 * H, 2 * W, 3), tick
            diff = np.abs(a.astype(int) - b.astype(int)).max(-1)
            held = diff if tick == 1 else diff[H:]
            assert (held > 1).mean() < TIE_SHARE, tick
        assert sorted(p.name for p in static_runs["torch"].glob(
            "Viewport*.png")) == ["Viewport1.png", "Viewport2.png",
                                  "Viewport3.png"]
        return
    import json

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
    network on the CPU: the CLI builds MaskFusion's labeller, whose sizes,
    score threshold and class filter the swap records (and keeps the
    threshold and filter)."""
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
                         image_size=cfg.image_size,
                         backbone_blocks=cfg.backbone_blocks, norm=cfg.norm,
                         proposals=(cfg.pre_nms_limit,
                                    cfg.post_nms_proposals,
                                    cfg.max_detections)))
        small = dataclasses.replace(micro_config(S),
                                    score_threshold=cfg.score_threshold)
        return real(small, params=params, filter_classes=filter_classes,
                    device="cpu")

    monkeypatch.setattr(inference, "MaskRCNNInference", micro)
    return log, len(frames) - 1, made


# what --nn builds: matterport's COCO Mask R-CNN
LABELLER = dict(image_size=1024, backbone_blocks=(3, 4, 23, 3),
                norm="frozen_bn", proposals=(6000, 1000, 100))


def test_cli_nn_runs_the_network(micro_nn, tmp_path, capsys):
    """`-l log.klg --nn -frameQ 3` in the multi-object default (prefused):
    the worker labels frames through the delay queue, the flush drains it
    at the end of the log, every frame is processed, the object spawns
    (poses-1.txt) and the FPS line is printed.  The CLI asks for
    MaskFusion's labeller (matterport's COCO ResNet-101-FPN: 1024 px,
    frozen BatchNorm, 6000/1000/100) with the Config's score threshold."""
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
                         device="cpu", **LABELLER)]
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
                         device="cpu", **LABELLER)]


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
