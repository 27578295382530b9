"""The port's batched and windowed object passes through its engine, on the
CPU, at the bounds of the JAX package's own tests of the same passes:

- batched against looped (tests/test_engine_multimodel.py:172-201): the
  objects tracked in one solve and fused through the fuse stage in their
  windows, against the per-model loop;
- windowed against full frame (tests/test_engine_pipelined.py:120-143, here
  in the synchronous schedule);
- padded object slots against the exact slot count
  (tests/test_engine_pipelined.py:92-118).

tests/test_torch_kernels.py::test_batched_windowed_path_on_the_card runs
the same scene on a CUDA card."""

import functools

import numpy as np
import pytest

from maskfusion_tpu_torch.frame import FrameData
from tests import synthetic as syn
from tests.test_torch_object_passes import port_engine, two_object_frames


def run_two_objects(n_frames, **overrides):
    """The two-object scene through the port's engine in the object
    passes' configuration (tests/test_torch_object_passes.SLICE)."""
    eng = port_engine(**overrides)
    for i, (rgb, depth, lab) in enumerate(two_object_frames(n_frames)):
        eng.process_frame(FrameData(rgb=rgb, depth=depth, mask=lab,
                                    class_ids=[0, 7, 8],
                                    timestamp=float(i)))
    return eng


def poses(eng):
    return [m.state.pose.cpu().numpy() for m in eng.models]


def test_batched_matches_looped():
    """Five frames, batch_object_tracking on (one solve, fuse stage,
    windows) and off (per-model loop, full frame): the same models, the
    global pose to 1e-4 and the objects to 8e-3, the JAX package's bounds
    (its small-object solves amplify rounding through the map)."""
    batched = run_two_objects(5)
    looped = run_two_objects(5, batch_object_tracking=False)
    assert [m.model_id for m in batched.models] == \
        [m.model_id for m in looped.models] == [0, 1, 2]
    assert [m.class_id for m in batched.models[1:]] == [7, 8]
    assert batched.windowed_fuses > 0 and looped.windowed_fuses == 0
    pb, pl = poses(batched), poses(looped)
    np.testing.assert_allclose(pb[0], pl[0], atol=1e-4)
    for a, b in zip(pb[1:], pl[1:]):
        np.testing.assert_allclose(a, b, atol=8e-3)


def test_windowed_matches_full_frame():
    """Six frames with the 104-pixel object window and without it: the
    window holds each mask and its margin, so the passes see the same
    pixels.  Poses to 2e-4, surfel counts within 2% (at least 4)."""
    win = run_two_objects(6)
    full = run_two_objects(6, object_window=0)
    assert [m.model_id for m in win.models] == \
        [m.model_id for m in full.models]
    assert len(win.models) >= 2
    assert win.models[1].window is not None and win.windowed_fuses > 0
    assert full.models[1].window is None and full.windowed_fuses == 0
    for mw, mf in zip(win.models, full.models):
        np.testing.assert_allclose(mw.state.pose.numpy(),
                                   mf.state.pose.numpy(), atol=2e-4)
        assert abs(mw.surfel_count - mf.surfel_count) <= \
            max(4, int(0.02 * mf.surfel_count)), (
            mw.model_id, mw.surfel_count, mf.surfel_count)


@functools.lru_cache(maxsize=None)
def run_moving_object(min_object_slots):
    """tests/test_engine_pipelined.py's run(): one object moving along +x
    from frame 1, eight frames, the 104-pixel window (each slot count run
    once; the tests only read the engine)."""
    eng = port_engine(min_object_slots=min_object_slots)
    for i in range(8):
        off = np.array([0.006 * max(0, i - 1), 0.0, 0.0])
        pts, cols, labels = syn.make_scene_with_object(offset=off)
        rgb, depth, lab = syn.render(pts, cols, np.eye(4, dtype=np.float32),
                                     syn.DEFAULT_INTR, labels=labels)
        eng.process_frame(FrameData(rgb=rgb, depth=depth, mask=lab,
                                    class_ids=[0, 7], timestamp=float(i)))
    return eng


@pytest.mark.parametrize("floor", [2, 4])
def test_padded_slots_match_exact(floor):
    """min_object_slots pads the fuse stage's object slots with dead ones
    (mask id 254, an empty map): the same models and trajectories as the
    exact slot count, at tests/test_engine_pipelined.py:92-118's bounds.
    No dead slot enters `models`."""
    exact = run_moving_object(0)
    padded = run_moving_object(floor)
    assert [m.model_id for m in padded.models] == \
        [m.model_id for m in exact.models]
    assert len(padded.models) >= 2
    assert all(m.model_id < 254 for m in padded.models)
    np.testing.assert_allclose(padded.models[0].state.pose.numpy(),
                               exact.models[0].state.pose.numpy(), atol=1e-3)
    for mp, me in zip(padded.models, exact.models):
        assert abs(mp.surfel_count - me.surfel_count) <= \
            max(16, 0.01 * me.surfel_count)
    est_p = padded.models[1].pose_log[-1]["pose"][:3, 3].numpy()
    est_e = exact.models[1].pose_log[-1]["pose"][:3, 3].numpy()
    assert est_p[0] > 0.005 and est_e[0] > 0.005
    assert np.abs(est_p - est_e).max() < 0.01
    # the dead slots were made once each and stayed empty
    dead = padded._dummy_state_cache
    assert len(dead) == floor - 1
    assert all(int(st.map.count) == 0 for st in dead.values())
