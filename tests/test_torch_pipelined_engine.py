"""The port's pipelined multi-object schedules through its engine, on the
CPU, at the bounds of the JAX package's own tests of the same schedules
(tests/test_engine_pipelined.py):

- the Config defaults (the prefused schedule, and the exact one) running
  frames on the CPU;
- the exact schedule, drained, against the synchronous one;
- the prefused schedule spawning and tracking a moving object;
- the tracking gate closed: nothing fuses and a newborn keeps its first-fuse
  weight;
- the ids-guard on a segmentation and an id image made by hand;
- a schedule change (an untrackable class appears) draining the pipeline,
  with the fuses in tick order;
- the drains behind flush_diagnostics and download_map, and the snapshot's
  refusal of pending frames.

tests/test_torch_kernels.py::test_prefused_frames_never_wait_on_the_card
runs the prefused schedule on a CUDA card."""

import collections
import dataclasses
import functools

import numpy as np
import pytest
import torch

from maskfusion_tpu_torch.convert import engine_snapshot
from maskfusion_tpu_torch.engine import DEAD_SLOT_ID
from maskfusion_tpu_torch.frame import FrameData
from tests.test_torch_pipelined import moving_object_frames, port_engine

# tests/test_engine_pipelined.py:19-33's run(): no window, no slot floor
EXACT_SYNC = dict(object_window=0, min_object_slots=0)


def feed(eng, frames, start=0):
    for i, (rgb, depth, lab) in enumerate(frames, start=start):
        eng.process_frame(FrameData(rgb=rgb, depth=depth, mask=lab,
                                    class_ids=[0, 7], timestamp=float(i)))
    return eng


@functools.lru_cache(maxsize=None)
def frames(count):
    return tuple(moving_object_frames(count))


def test_exact_schedule_matches_synchronous():
    """tests/test_engine_pipelined.py::test_pipelined_matches_sync: six
    frames in the exact schedule (fuse_mask_lag=False), drained, against
    the synchronous schedule: the same models, every pose to 5e-5 and every
    surfel count within 2."""
    pipe = feed(port_engine(fuse_mask_lag=False, **EXACT_SYNC), frames(6))
    pipe.drain_pipeline()
    sync = feed(port_engine(pipelined_multiobject=False, **EXACT_SYNC),
                frames(6))
    assert [m.model_id for m in pipe.models] == \
        [m.model_id for m in sync.models] == [0, 1]
    for mp, ms in zip(pipe.models, sync.models):
        np.testing.assert_allclose(mp.state.pose.numpy(),
                                   ms.state.pose.numpy(), atol=5e-5)
        assert abs(mp.surfel_count - ms.surfel_count) <= 2, (
            mp.model_id, mp.surfel_count, ms.surfel_count)
    # every frame logged; a spawned object's log starts one frame later in
    # the pipelined schedule (its spawn frame was logged before it existed)
    assert [e["tick"] for e in pipe.models[0].pose_log] == \
        [e["tick"] for e in sync.models[0].pose_log] == list(range(1, 7))


def test_prefused_tracks_object():
    """tests/test_engine_pipelined.py::test_mask_lag_tracks_object: eight
    frames in the prefused schedule (the default) with the JAX test's
    window and slot floor: the object spawns, its first fuse lands, its map
    fills, its logged pose follows the motion along +x, and the global map
    stays whole."""
    eng = feed(port_engine(), frames(8))
    eng.drain_pipeline()
    assert len(eng.models) >= 2
    obj = eng.models[1]
    assert obj.fused_once
    assert obj.surfel_count > 50
    assert obj.pose_log[-1]["pose"][0, 3] > 0.005
    assert eng.models[0].surfel_count > 1000
    assert eng.windowed_fuses > 0


@pytest.mark.parametrize("lag", [True, False], ids=["prefused", "exact"])
def test_config_defaults_run_on_the_cpu(lag):
    """`MaskFusion(res, intr, Config(seg_method="maskfusion"))` with every
    other field at its default (the prefused schedule; `fuse_mask_lag=False`
    the exact one) constructs and runs frames with device="cpu": three
    frames, drained, spawn the object and log finite poses for every
    frame."""
    from maskfusion_tpu_torch.camera import Resolution
    from maskfusion_tpu_torch.config import Config
    from maskfusion_tpu_torch.engine import MaskFusion
    from tests import synthetic as syn
    from tests.torch_helpers import tintr

    kw = {} if lag else {"fuse_mask_lag": False}
    eng = MaskFusion(Resolution(syn.W, syn.H), tintr(syn.DEFAULT_INTR),
                     Config(seg_method="maskfusion", **kw), device="cpu")
    out = feed(eng, frames(3))
    assert out.cfg.pipelined_multiobject and len(eng._pending) == 1
    eng.drain_pipeline()
    assert [m.model_id for m in eng.models] == [0, 1]
    assert [e["tick"] for e in eng.models[0].pose_log] == [1, 2, 3]
    assert all(np.isfinite(e["pose"].numpy()).all()
               for m in eng.models for e in m.pose_log)


def _state_tensors(m):
    st = m.state
    return [a.clone() for a in tuple(st.map) + (st.pred_vmap, st.pred_nmap,
                                                 st.pred_rgb)]


def test_closed_gate_keeps_maps_and_first_fuse():
    """A frame whose tracking covariance fails the threshold (forced here
    below any covariance) is fused with the gate closed: every model's map,
    surfel count and predictions come out as they went in, its host stage
    reads the verdict, and the newborn whose first fuse that frame carried
    gets its first-fuse weight back."""
    eng = feed(port_engine(), frames(3)[:2])
    eng.drain_pipeline()
    assert [m.model_id for m in eng.models] == [0, 1]
    assert not eng.models[1].fused_once
    before = [_state_tensors(m) for m in eng.models]
    eng._cov_thresh = -1.0
    feed(eng, frames(3)[2:], start=2)
    assert eng.models[1].fused_once          # provisional, at the queue
    eng.drain_pipeline()
    assert not eng._last_tracking_ok
    assert not eng.models[1].fused_once      # restored by the host stage
    for m, ref in zip(eng.models, before):
        for a, b in zip(_state_tensors(m), ref):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_ids_guard_by_hand():
    """The guard rule seg = where((seg == ids) | (ids == 0), seg, 255) on a
    segmentation and an id image made by hand: the fuse stage given the
    guard equals the fuse stage given the hand-guarded segmentation, and
    the guarded pixels (both claim a model, not the same one) fuse into no
    model."""
    eng = feed(port_engine(), frames(4))
    eng.drain_pipeline()
    glob, obj = eng.models
    H, W = eng.last_segmentation.shape
    seg = eng.last_segmentation.copy()
    ids = np.zeros_like(seg)
    ids[:, W // 2:] = seg[:, W // 2:]               # agreeing claims
    ids[: H // 2, : W // 3] = obj.model_id          # object over background
    ids[H // 2:, W // 3: W // 2] = 0                # nothing projected
    want = np.where((seg == ids) | (ids == 0), seg, 255).astype(np.uint8)
    assert (want == 255).sum() > 100
    assert ((want == 255) == ((seg != ids) & (ids != 0))).all()
    rgb = torch.from_numpy(frames(5)[4][0])
    depth = torch.from_numpy(frames(5)[4][1])
    n_slots = 2
    aux = np.asarray([[obj.model_id, *obj.window], [DEAD_SLOT_ID, 0, 0]],
                     np.float32)
    stage = eng.pipelined_device_stage(
        glob.state, eng._padded_obj_states([obj], n_slots), aux, rgb, depth,
        torch.from_numpy(seg), 5.0, 1 << 16, 1 << 13, True)
    prep, prev_poses = stage[0], stage[6]
    params = eng._obj_params([obj], n_slots)

    def run(seg_in, guard):
        st = [m.state._replace(map=m.state.map._replace(
            **{f: getattr(m.state.map, f).clone()
               for f in m.state.map._fields}))
            for m in (glob, obj)]
        g, o = eng.fuse_stage(
            st[0], (st[1], eng._dummy_obj_state(1 << 13, 1)), prep, rgb,
            torch.from_numpy(seg_in), prev_poses, 5.0, params, 1 << 16,
            1 << 13, 1, windowed=True, gate=torch.tensor(True),
            ids_guard=None if guard is None else torch.from_numpy(guard))
        return [g, o[0]]

    for a, b in zip(run(seg, ids), run(want, None)):
        for x, y in zip(tuple(a.map) + a[1:], tuple(b.map) + b[1:]):
            assert torch.equal(x.nan_to_num(), y.nan_to_num())


def test_schedule_changes_drain_in_tick_order():
    """With class 7 untrackable, the object's spawn moves the prefused
    schedule to the lagfuse fallback, whose fuses go out at the host
    stage, and the object mirrors the camera; made trackable again, the
    schedule moves back, its fuses going out at the queue.  Each change
    finishes the pending frames first, so every fuse goes out in tick
    order (clean's `time` never runs backwards) and every frame is logged
    once.  The records never report ready here, so two frames stay in
    flight, as on a card whose host runs ahead."""
    eng = port_engine(trackable_classes=[8], pipeline_depth=2)
    eng._record_ready = lambda P: False
    times = []
    fcp, win = eng.fuse_clean_predict, eng.fuse_clean_predict_obj_win

    def fuse(*a, **k):
        times.append(a[5])
        return fcp(*a, **k)

    def fuse_win(*a, **k):
        times.append(a[5])
        return win(*a, **k)

    eng.fuse_clean_predict, eng.fuse_clean_predict_obj_win = fuse, fuse_win
    kinds = []

    class Recorded(collections.deque):
        def append(self, P):
            kinds.append(P["kind"])
            super().append(P)

    eng._pending = Recorded()
    feed(eng, frames(8)[:5])
    assert [m.model_id for m in eng.models] == [0, 1]
    assert kinds[0] == "prefused" and kinds[-1] == "lagfuse", kinds
    np.testing.assert_allclose(eng.models[1].state.pose.numpy(),
                               eng.models[0].state.pose.numpy(), atol=1e-6)
    eng.cfg = dataclasses.replace(eng.cfg, trackable_classes=None)
    feed(eng, frames(8)[5:], start=5)
    eng.drain_pipeline()
    assert kinds[-1] == "prefused", kinds
    assert times == sorted(times), times
    assert sorted(set(times)) == [float(k) for k in range(2, 9)]
    glob_ticks = [e["tick"] for e in eng.models[0].pose_log]
    assert glob_ticks == list(range(1, 9))


def test_flush_and_download_drain_the_pipeline():
    """flush_diagnostics and download_map finish the pending frames before
    they read, as in the JAX package (engine.py:2433-2436, 2547-2549), and
    the snapshot refuses an engine with pending frames."""
    eng = feed(port_engine(), frames(3))
    assert len(eng._pending) == 1
    with pytest.raises(ValueError, match="drain_pipeline"):
        engine_snapshot(eng)
    eng.flush_diagnostics()
    assert not eng._pending
    assert eng.models[0].pose_log[-1]["tick"] == 3
    feed(eng, frames(4)[3:], start=3)
    assert len(eng._pending) == 1
    cloud = eng.download_map(0)
    assert not eng._pending and len(cloud["pos"]) > 1000
    assert eng.models[0].pose_log[-1]["tick"] == 4
    assert engine_snapshot(eng)["tick"] == 4
