"""The port's live-capture readers (maskfusion_tpu_torch/io/live_readers.py)
on the CPU.

The four scenarios of tests/test_live_capture.py run the port's OpenNI2
adapter and capture thread against that file's fake `openni` binding;
tests/test_tools.py's video reader and SDK stubs run on the port, and the
port's video frames are bit-equal to the JAX reader's on the same file.
Last, chip_smoke.py's self-pacing fake binding feeds the port's -static
engine through the reader at 160x120 (phase 15e's scenario), against the
same frames fed directly."""

import sys

import numpy as np
import pytest
import torch

import chip_smoke
from maskfusion_tpu.io import live_readers as jlive
from maskfusion_tpu_torch.io import live_readers as tlive
from tests.test_live_capture import _install_fake_openni, _make_ctl


def test_capture_loop_delivers_ordered_frames(monkeypatch):
    ctl = _make_ctl()
    _install_fake_openni(monkeypatch, ctl)
    r = tlive.OpenNI2LiveReader()
    try:
        assert ctl.get("initialized")
        assert ctl.get("registration") == 7
        f1 = r.get_next()
        f2 = r.get_next()
        assert f1 is not None and f2 is not None
        assert f2.index > f1.index          # monotonic, newest-first ring
        assert f1.rgb.shape == (48, 64, 3)
        assert f1.rgb.dtype == np.uint8
        assert f1.depth.dtype == np.float32
        # depth converted mm -> m, as the JAX reader does
        mm = np.round(f1.depth[0, 0] * 1000.0)
        assert 1000 <= mm < 1500
        assert f1.depth[0, 0] == np.float32(mm) * np.float32(1e-3)
        assert r.has_more()
        thread = r._thread
    finally:
        r.stop()
    assert not r.has_more()
    assert not thread.is_alive()
    assert ctl.get("unloaded")


def test_capture_survives_transient_errors(monkeypatch):
    ctl = _make_ctl()
    ctl["raise_once"] = True
    _install_fake_openni(monkeypatch, ctl)
    r = tlive.OpenNI2LiveReader()
    try:
        assert r.get_next() is not None
        assert not ctl["raise_once"]         # the error was raised, then
    finally:                                 # capture went on
        r.stop()


def test_capture_timeout_when_stalled(monkeypatch):
    ctl = _make_ctl()
    ctl["stall"] = True
    _install_fake_openni(monkeypatch, ctl)
    r = tlive.OpenNI2LiveReader(timeout=0.3)
    try:
        with pytest.raises(tlive.DeviceNotAvailable,
                           match="no frames arriving"):
            r.get_next()
    finally:
        r.stop()


def test_missing_sdk_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "openni", None)
    monkeypatch.setattr("importlib.import_module",
                        lambda name: (_ for _ in ()).throw(ImportError(name)))
    with pytest.raises(tlive.DeviceNotAvailable, match="openni"):
        tlive.OpenNI2LiveReader()


def test_live_reader_stubs_raise_cleanly():
    """tests/test_tools.py::test_live_reader_stubs_raise_cleanly: without
    their SDK bindings the three adapters raise DeviceNotAvailable."""
    for cls in (tlive.OpenNI2LiveReader, tlive.FreenectLiveReader,
                tlive.RealsenseLiveReader):
        with pytest.raises(tlive.DeviceNotAvailable):
            cls()


def test_video_reader_matches_jax(tmp_path):
    """tests/test_tools.py::test_video_reader on the port, and every frame
    bit-equal to the JAX reader's on the same video (colours flipped
    too)."""
    import cv2

    path = str(tmp_path / "clip.avi")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (64, 48))
    rng = np.random.default_rng(0)
    for i in range(5):
        img = np.full((48, 64, 3), i * 40, np.uint8)
        img[8:24, 8:40] = rng.integers(0, 256, (16, 32, 3), dtype=np.uint8)
        w.write(img)
    w.release()
    for flip in (False, True):
        t = tlive.VideoLogReader(path, flip_colors=flip, synthetic_depth=1.0)
        j = jlive.VideoLogReader(path, flip_colors=flip, synthetic_depth=1.0)
        n = 0
        while (ft := t.get_next()) is not None:
            fj = j.get_next()
            assert fj is not None
            np.testing.assert_array_equal(ft.rgb, fj.rgb)
            np.testing.assert_array_equal(ft.depth, fj.depth)
            assert ft.rgb.shape == (48, 64, 3) and np.all(ft.depth == 1.0)
            assert (ft.index, ft.timestamp) == (fj.index, fj.timestamp)
            n += 1
        assert j.get_next() is None
        assert n == 5 and t.has_more() == j.has_more()
    with pytest.raises(tlive.DeviceNotAvailable):
        tlive.VideoLogReader(str(tmp_path / "missing.avi"))


def test_ring_buffer_keeps_the_newest():
    from maskfusion_tpu_torch.frame import FrameData

    ring = tlive.RingBuffer(size=3)
    assert ring.latest() is None
    for i in range(5):
        ring.push(FrameData(rgb=np.zeros((2, 2, 3), np.uint8),
                            depth=np.full((2, 2), i, np.float32)))
    f = ring.latest()
    assert f.index == 4 and f.depth[0, 0] == 4
    assert len(ring._dq) == 3


def test_paced_capture_feeds_the_engine():
    """chip_smoke.py phase 15e at 160x120 on the CPU: 5 frames of the
    synthetic trajectory (uint16 mm depth) through OpenNI2LiveReader over
    chip_smoke's self-pacing fake binding into the -static engine: no frame
    dropped (indices 0-4), stop() joins the capture thread, and the poses
    equal those of the same frames fed directly."""
    from maskfusion_tpu_torch import CameraIntrinsics, Config, Resolution
    from maskfusion_tpu_torch.engine import MaskFusion
    from maskfusion_tpu_torch.frame import FrameData

    _, frames, (fx, fy, cx, cy, _, _) = chip_smoke.synthetic_trajectory(5)
    frames = [FrameData(rgb=rgb, depth=np.round(depth * 1000.0).astype(
        np.uint16)) for rgb, depth in frames]
    rec = chip_smoke.live_capture_run(
        MaskFusion, Config, Resolution, CameraIntrinsics, FrameData, frames,
        (fx, fy, cx, cy), torch.device("cpu"), 5, capacity=1 << 16)
    assert rec["indices"] == [0, 1, 2, 3, 4]
    assert rec["joined"]
    assert rec["max_pose_diff_m"] == 0.0
    assert "openni" not in sys.modules
