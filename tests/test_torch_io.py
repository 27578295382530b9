"""The port's readers, exporters and stopwatch against the JAX package's on
the same files: frames read bit for bit alike, files written byte for byte
alike, and the same numbers out of the ground-truth trajectory and the
stopwatch."""

import os
import struct
import zlib

import numpy as np
import pytest
import torch

from maskfusion_tpu.frame import FrameData as JFrameData
from maskfusion_tpu.io import exr as jexr
from maskfusion_tpu.io import export as jex
from maskfusion_tpu.io.ground_truth import GroundTruthOdometry as JGroundTruth
from maskfusion_tpu.io.image_reader import ImageLogReader as JImageLogReader
from maskfusion_tpu.io.klg_reader import KlgLogReader as JKlgLogReader
from maskfusion_tpu.io.klg_reader import write_klg as jwrite_klg
from maskfusion_tpu.utils.stopwatch import Stopwatch as JStopwatch
from maskfusion_tpu_torch.frame import FrameData
from maskfusion_tpu_torch.io import exr as texr
from maskfusion_tpu_torch.io import export as tex
from maskfusion_tpu_torch.io.ground_truth import GroundTruthOdometry
from maskfusion_tpu_torch.io.image_reader import ImageLogReader
from maskfusion_tpu_torch.io.klg_reader import KlgLogReader, write_klg
from maskfusion_tpu_torch.utils.stopwatch import Stopwatch
from tests import synthetic as syn
from tests.test_io import write_dataset

FRAME_FIELDS = ("rgb", "depth", "mask")
META_FIELDS = ("timestamp", "index", "class_ids", "rois")


def assert_same_frame(a, b):
    """Two FrameData (of either package) hold the same arrays, bit for bit,
    and the same metadata."""
    for k in FRAME_FIELDS:
        x, y = getattr(a, k), getattr(b, k)
        if x is None or y is None:
            assert x is None and y is None, k
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)
    for k in META_FIELDS:
        assert getattr(a, k) == getattr(b, k), k


def _frames(n=3, stamps=(0, 100, 200)):
    pts, cols = syn.make_scene()
    poses = [syn.pose_from(np.array([0.0, 0.004 * i, 0.0]),
                           np.array([0.01 * i, 0.0, 0.0])) for i in range(n)]
    out = []
    for pose, ts in zip(poses, stamps):
        rgb, depth = syn.render(pts, cols, pose, syn.DEFAULT_INTR)
        out.append((rgb, depth, float(ts)))
    return out


# ------------------------------------------------------------ image reader
@pytest.mark.parametrize("depth_fmt,with_masks,prefetch", [
    ("exr", True, True), ("png", True, False), ("png", False, True)])
def test_image_reader_matches_jax(tmp_path, depth_fmt, with_masks, prefetch):
    write_dataset(str(tmp_path), n=3, with_masks=with_masks,
                  depth_fmt=depth_fmt)
    jr = JImageLogReader(str(tmp_path), prefetch=prefetch)
    tr = ImageLogReader(str(tmp_path), prefetch=prefetch)
    assert tr.get_num_frames() == jr.get_num_frames() == 3
    assert tr.has_masks() == jr.has_masks() == with_masks
    jf, tf = list(jr), list(tr)
    assert len(jf) == len(tf) == 3
    for a, b in zip(tf, jf):
        assert_same_frame(a, b)
    assert tf[0].depth.dtype == (np.float32 if depth_fmt == "exr"
                                 else np.uint16)
    if with_masks:
        assert tf[0].class_ids == [0, 7]
    jr.close()
    tr.close()


# -------------------------------------------------------------------- KLG
def _walk(reader):
    """The same calls on either package's reader: next, next, previous,
    next, rewind, next, fast-forward, next."""
    out = [reader.get_next(), reader.get_next(), reader.get_previous(),
           reader.get_next()]
    assert reader.rewind()
    out.append(reader.get_next())
    reader.fast_forward(3)
    out.append(reader.get_next())
    out.append(reader.has_more())
    reader.close()
    return out


@pytest.mark.parametrize("compress", [True, False], ids=["jpeg", "raw"])
def test_klg_across_packages(tmp_path, compress):
    """A JAX-written log read by the port and a port-written log read by the
    JAX package: the two writers' files are byte-identical and every read
    is bit-equal to the other package's."""
    frames = _frames(5, stamps=(0, 100, 200, 300, 400))
    jpath, tpath = str(tmp_path / "j.klg"), str(tmp_path / "t.klg")
    jwrite_klg(jpath, [JFrameData(rgb=r, depth=d, timestamp=ts)
                       for r, d, ts in frames], compress=compress)
    write_klg(tpath, [FrameData(rgb=r, depth=d, timestamp=ts)
                      for r, d, ts in frames], compress=compress)
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    for src in (jpath, tpath):
        jw = _walk(JKlgLogReader(src, syn.W, syn.H))
        tw = _walk(KlgLogReader(src, syn.W, syn.H))
        for a, b in zip(tw[:-1], jw[:-1]):
            assert_same_frame(a, b)
        assert tw[-1] == jw[-1]
    f0 = tw[0]
    assert f0.depth.dtype == np.uint16 and f0.timestamp == 0.0
    np.testing.assert_allclose(f0.host_depth(), frames[0][1], atol=2e-3)


@pytest.mark.parametrize("compress", [True, False], ids=["zlib", "raw"])
def test_klg_depth_only_across_packages(tmp_path, compress):
    """A log whose frames carry no RGB payload (rgbSize 0), its depth zlib
    or raw: both packages read the same depth and a black image."""
    frames = _frames(5, stamps=(0, 100, 200, 300, 400))
    path = str(tmp_path / "depth.klg")
    with open(path, "wb") as f:
        f.write(struct.pack("<i", len(frames)))
        for _, depth, ts in frames:
            mm = np.round(depth * 1000.0).astype(np.uint16).tobytes()
            payload = zlib.compress(mm) if compress else mm
            f.write(struct.pack("<qii", int(ts), len(payload), 0))
            f.write(payload)
    tw = _walk(KlgLogReader(path, syn.W, syn.H))
    jw = _walk(JKlgLogReader(path, syn.W, syn.H))
    for a, b in zip(tw[:-1], jw[:-1]):
        assert_same_frame(a, b)
    assert tw[-1] == jw[-1]
    assert not tw[0].rgb.any()
    np.testing.assert_allclose(tw[0].host_depth(), frames[0][1], atol=1e-3)


# -------------------------------------------------------------------- EXR
@pytest.mark.parametrize("comp,half", [(0, False), (2, False), (3, False),
                                       (3, True)])
def test_exr_across_packages(tmp_path, comp, half):
    rng = np.random.default_rng(0)
    img = rng.uniform(0.3, 4.0, (120, 160)).astype(np.float32)
    jp, tp = str(tmp_path / "j.exr"), str(tmp_path / "t.exr")
    jexr.write_exr(jp, {"Y": img}, compression=comp, half=half)
    texr.write_exr(tp, {"Y": img}, compression=comp, half=half)
    assert open(jp, "rb").read() == open(tp, "rb").read()
    for p in (jp, tp):
        np.testing.assert_array_equal(texr.read_exr(p)["Y"],
                                      jexr.read_exr(p)["Y"])
        np.testing.assert_array_equal(texr.read_exr_depth(p),
                                      jexr.read_exr_depth(p))


def test_exr_multichannel_across_packages(tmp_path):
    rng = np.random.default_rng(1)
    chans = {c: rng.uniform(0, 2, (33, 40)).astype(np.float32)
             for c in ("R", "G", "B")}
    jp, tp = str(tmp_path / "j.exr"), str(tmp_path / "t.exr")
    jexr.write_exr(jp, chans)
    texr.write_exr(tp, chans)
    assert open(jp, "rb").read() == open(tp, "rb").read()
    for p in (jp, tp):
        tb, jb = texr.read_exr(p), jexr.read_exr(p)
        assert sorted(tb) == sorted(jb) == ["B", "G", "R"]
        for c in chans:
            np.testing.assert_array_equal(tb[c], jb[c])
            np.testing.assert_allclose(tb[c], chans[c], atol=1e-7)
        np.testing.assert_array_equal(texr.read_exr_depth(p), chans["R"])


# ----------------------------------------------------------- ground truth
def test_ground_truth_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    path = str(tmp_path / "traj.txt")
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n\n")
        for i in range(12):
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            t = rng.normal(size=3)
            sep = "," if i % 3 == 0 else " "
            f.write(sep.join(f"{v:.9f}" for v in
                             (0.05 * i, *t, *q)) + "\n")
        f.write("1.5 0 0 0\n")       # short line: skipped
    jg, tg = JGroundTruth(path), GroundTruthOdometry(path)
    assert len(tg.poses) == len(jg.poses) == 12
    for ts in (0.0, 0.049, 0.26, 0.33, 0.551, 9.0, -1.0):
        for rel in (True, False):
            a, b = tg.get_pose(ts, rel), jg.get_pose(ts, rel)
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_allclose(a, b, atol=1e-7)
    empty = tmp_path / "empty.txt"
    empty.write_text("# nothing\n")
    assert GroundTruthOdometry(str(empty)).get_pose(0.0) is None


# ---------------------------------------------------------------- exports
def test_save_ply_byte_identical(tmp_path):
    rng = np.random.default_rng(3)
    n = 200
    surfels = {
        "pos": rng.normal(size=(n, 3)).astype(np.float32),
        "conf": np.linspace(0, 20, n).astype(np.float32),
        "color": rng.uniform(-10, 270, (n, 3)).astype(np.float32),
        "normal": rng.normal(size=(n, 3)).astype(np.float32),
        "radius": rng.uniform(0.001, 0.01, n).astype(np.float32),
    }
    jp, tp = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    assert tex.save_ply(tp, surfels, 10.0) == jex.save_ply(jp, surfels, 10.0)
    assert open(jp, "rb").read() == open(tp, "rb").read()
    tb, jb = tex.load_ply(tp), jex.load_ply(jp)
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k])


def test_export_poses_byte_identical(tmp_path):
    """The port's pose log holds torch tensors, the JAX one host arrays:
    the same TUM lines come out (stamps and ticks), both quaternion
    branches included."""
    poses = [np.eye(4, dtype=np.float32),
             syn.pose_from(np.array([0, 0, 0.1]), np.array([1, 2, 3])),
             syn.pose_from(np.array([3.0, 0.2, 0.1]), np.array([0, 1, 0])),
             syn.pose_from(np.array([0.1, 3.05, 0]), np.array([0, 0, 1])),
             syn.pose_from(np.array([0, 0.1, 3.1]), np.array([4, 0, 0]))]
    log = [{"timestamp": 1.5 + i, "tick": i + 1, "pose": p.astype(np.float32)}
           for i, p in enumerate(poses)]

    class JModel:
        model_id = 3
        pose_log = log

    class TModel:
        model_id = 3
        pose_log = [dict(e, pose=torch.from_numpy(e["pose"])) for e in log]

    for ticks in (False, True):
        jd, td = tmp_path / f"j{ticks}", tmp_path / f"t{ticks}"
        (jp,) = jex.export_poses(str(jd), [JModel()], use_ticks=ticks)
        (tp,) = tex.export_poses(str(td), [TModel()], use_ticks=ticks)
        assert os.path.basename(tp) == "poses-3.txt"
        assert open(jp, "rb").read() == open(tp, "rb").read()
        assert len(open(tp).read().splitlines()) == len(poses)


@pytest.mark.parametrize("name", ["export_segmentation_png",
                                  "export_label_image",
                                  "export_normal_image"])
def test_png_exports_byte_identical(tmp_path, name):
    rng = np.random.default_rng(4)
    if name == "export_normal_image":
        img = rng.normal(size=(syn.H, syn.W, 3)).astype(np.float32)
        img /= np.linalg.norm(img, axis=-1, keepdims=True)
        img[10:20, 30:50] = np.nan
    else:
        img = rng.integers(0, 40, (syn.H, syn.W)).astype(np.uint8)
        img[5:15, 5:15] = 255
    jp = getattr(jex, name)(str(tmp_path / "j"), 7, img)
    tp = getattr(tex, name)(str(tmp_path / "t"), 7, img)
    assert os.path.basename(jp) == os.path.basename(tp)
    assert open(jp, "rb").read() == open(tp, "rb").read()


# -------------------------------------------------------------- stopwatch
def test_stopwatch_matches_jax():
    rng = np.random.default_rng(5)
    times = [("Preprocess", v) for v in rng.uniform(1, 5, 7)]
    times += [("Run", v) for v in rng.uniform(10, 90, 9)]
    times += [("odom", v) for v in rng.uniform(0, 30, 4)]
    order = rng.permutation(len(times))
    jw, tw = JStopwatch(), Stopwatch()
    for i in order:
        jw.record(*times[i])
        tw.record(*times[i])
    assert tw.summary() == jw.summary()
    assert tw.last_ms == jw.last_ms
    for budget in (5.0, 10.0, 33.33, 100.0):
        assert tw.should_skip_frames(budget) == jw.should_skip_frames(budget)
    tw.record("Run", 70.0)
    assert tw.should_skip_frames(33.33) == 2
    with tw.scope("fuse"):
        pass
    assert tw.counts["fuse"] == 1 and tw.last_ms["fuse"] >= 0.0
    assert Stopwatch().should_skip_frames() == 0


# ------------------------------------------------------------- checkpoints
# tests/test_io.py::test_checkpoint_resume's configuration: the -static
# frame with relocalisation and loop closure on (the synchronous step,
# with a fern database to carry)
CKPT = dict(global_surfel_capacity=1 << 16, static_mode=True,
            use_so3=False, relocalisation=True, close_loops=True)


def _ckpt_frames(n=5):
    pts, cols = syn.make_scene()
    out = []
    for i in range(n):
        pose = syn.pose_from(np.zeros(3), np.array([0.004 * i, 0, 0]))
        rgb, depth = syn.render(pts, cols, pose, syn.DEFAULT_INTR)
        out.append((rgb, depth, float(i)))
    return out


def _port_engine():
    from maskfusion_tpu_torch.camera import Resolution
    from maskfusion_tpu_torch.config import Config
    from maskfusion_tpu_torch.engine import MaskFusion
    from tests.torch_helpers import CPU, tintr

    return MaskFusion(Resolution(syn.W, syn.H), tintr(syn.DEFAULT_INTR),
                      Config(**CKPT), device=CPU)


def _jax_engine():
    from maskfusion_tpu.camera import Resolution
    from maskfusion_tpu.config import Config
    from maskfusion_tpu.engine import MaskFusion

    return MaskFusion(Resolution(syn.W, syn.H), syn.DEFAULT_INTR,
                      Config(**CKPT))


def _run(eng, frame_cls, frames):
    poses = []
    for rgb, depth, ts in frames:
        eng.process_frame(frame_cls(rgb=rgb, depth=depth, timestamp=ts))
        poses.append(np.array(eng.current_pose))
    return poses


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Each package runs 3 frames, saves a checkpoint and runs 2 more;
    returns the two checkpoint directories and each package's poses over
    the last 2 frames."""
    from maskfusion_tpu.io import checkpoint as jckpt
    from maskfusion_tpu_torch.io import checkpoint as tckpt

    base = tmp_path_factory.mktemp("ckpt")
    frames = _ckpt_frames()
    out = {"frames": frames}
    for name, make, cls, ckpt in (("jax", _jax_engine, JFrameData, jckpt),
                                  ("port", _port_engine, FrameData, tckpt)):
        eng = make()
        _run(eng, cls, frames[:3])
        ckpt.save(eng, str(base / name))
        out[name] = (str(base / name), _run(eng, cls, frames[3:]),
                     eng.global_model.surfel_count, len(eng.ferns.frames))
    return out


def test_checkpoint_resume(tmp_path):
    """tests/test_io.py::test_checkpoint_resume on the port: save mid-run,
    restore into a fresh engine, continue; the trajectories match a run
    without the interruption."""
    from maskfusion_tpu_torch.io import checkpoint

    frames = _ckpt_frames()
    a = _port_engine()
    _run(a, FrameData, frames[:3])
    checkpoint.save(a, str(tmp_path / "ckpt"))
    b = _port_engine()
    checkpoint.load(b, str(tmp_path / "ckpt"))
    assert b.tick == a.tick
    assert b.global_model.surfel_count == a.global_model.surfel_count
    assert len(b.ferns.frames) == len(a.ferns.frames)
    np.testing.assert_allclose(b.current_pose, a.current_pose, atol=1e-6)
    pa = _run(a, FrameData, frames[3:])
    pb = _run(b, FrameData, frames[3:])
    np.testing.assert_allclose(pa[-1], pb[-1], atol=1e-5)
    assert a.global_model.surfel_count == b.global_model.surfel_count
    assert [e["tick"] for e in b.global_model.pose_log] == [1, 2, 3, 4, 5]


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_checkpoint_resumes_across_packages(checkpoints, writer, reader):
    """A checkpoint written by one package resumes in the other: the fern
    database and the map come across whole, and over the next two frames
    the resumed engine's poses follow the writer's own continuation within
    the lockstep bounds (1 mm, 0.05 deg; tests/test_torch_engine_static.py)
    and its surfel count within 1%."""
    from maskfusion_tpu.io import checkpoint as jckpt
    from maskfusion_tpu_torch.io import checkpoint as tckpt

    import chip_smoke

    path, ref_poses, ref_count, ref_ferns = checkpoints[writer]
    if reader == "port":
        eng, cls, load = _port_engine(), FrameData, tckpt.load
    else:
        eng, cls, load = _jax_engine(), JFrameData, jckpt.load
    load(eng, path)
    assert eng.tick == 3 and len(eng.ferns.frames) >= 1
    assert len(eng.global_model.pose_log) == 3
    poses = _run(eng, cls, checkpoints["frames"][3:])
    for a, b in zip(poses, ref_poses):
        assert np.linalg.norm(a[:3, 3] - b[:3, 3]) <= 1e-3
        assert chip_smoke._rot_deg(a, b) <= 0.05
    assert abs(eng.global_model.surfel_count - ref_count) <= 0.01 * ref_count
    assert len(eng.ferns.frames) == ref_ferns
