"""The port's batched and windowed object passes against the JAX engine's.

One JAX engine runs the object passes' configuration (the synchronous
schedule, MaskFusion segmentation of the frame's masks,
batch_object_tracking with a 104-pixel object window and 24-pixel margin,
min_object_slots=2) on the
two-object scene of tests/test_engine_multimodel.py:172-201 through both
spawns (frames 0-2).  Its state crosses into the port with
convert.engine_snapshot / restore_engine, and the tests hold, on that
carried state and frame 3's inputs:

- the batched object solve against the JAX engine's `_track_objects` and
  against the port's own one-slot solves (atol 2e-5, the single-solve bound
  of tests/test_torch_odometry.py);
- the fuse stage, windowed and full frame with a padded dead slot, against
  the JAX engine's `_pipelined_fuse_stage` (the bounds of
  tests/test_torch_mapping.py);
- the object windows against the JAX engine's `_update_windows`, with the
  JAX native library on and off, and `_slot_class`;
- a lockstep run of both engines over four more frames (the bounds of
  tests/test_torch_engine_multimodel.py::test_lockstep_with_jax_engine),
  with the windows engaged.

The JAX engine runs with its native library off, as the port's lockstep
test runs it: the port's segmentation is the numpy path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import maskfusion_tpu.cpp as jnative
from maskfusion_tpu.camera import Resolution as JResolution
from maskfusion_tpu.config import Config as JConfig
from maskfusion_tpu.engine import MapState as JMapState
from maskfusion_tpu.engine import MaskFusion as JMaskFusion
from maskfusion_tpu.engine import Model as JModel
from maskfusion_tpu.engine import _slot_class as j_slot_class
from maskfusion_tpu.frame import FrameData as JFrameData
from maskfusion_tpu.mapping import surfel_map as jsm
from maskfusion_tpu_torch import cpp as tnative
from maskfusion_tpu_torch.camera import Resolution
from maskfusion_tpu_torch.config import Config
from maskfusion_tpu_torch.convert import engine_snapshot, restore_engine
from maskfusion_tpu_torch.engine import (DEAD_SLOT_ID, MaskFusion,
                                         Preprocessed, _slot_class)
from maskfusion_tpu_torch.frame import FrameData
from maskfusion_tpu_torch.tracking import odometry as todo
from tests import synthetic as syn
from tests.torch_helpers import CPU, n, t, tintr

SLICE = dict(global_surfel_capacity=1 << 16, object_surfel_capacity=1 << 13,
             seg_method="maskfusion", pipelined_multiobject=False,
             model_spawn_offset=0, object_window=104,
             object_window_margin=24, min_object_slots=2)
CLASS_IDS = [0, 7, 8]
CARRY_AT = 3      # frames 0-2 run on the JAX engine: both objects spawn
# a camera motion to warm-start object solves from (Config.object_warm_start)
MOTION = syn.pose_from(np.array([0.0, 0.004, 0.0]),
                       np.array([0.003, 0.0, -0.002]))


def two_object_frames(count):
    """tests/test_engine_multimodel.py:172-201's scene: a still camera,
    object 1 moving along +x from frame 1, object 2 along -y from frame
    2."""
    frames = []
    for i in range(count):
        o1 = np.array([0.006 * max(0, i - 1), 0.0, 0.0])
        o2 = np.array([0.0, -0.006 * max(0, i - 2), 0.0])
        pts, cols, labels = syn.make_scene_with_two_objects(o1, o2)
        frames.append(syn.render(pts, cols, np.eye(4, dtype=np.float32),
                                 syn.DEFAULT_INTR, labels=labels))
    return frames


def port_engine(**overrides) -> MaskFusion:
    return MaskFusion(Resolution(syn.W, syn.H), tintr(syn.DEFAULT_INTR),
                      Config(**{**SLICE, **overrides}), device=CPU)


def carry_state() -> dict:
    """Frames 0-2 on the JAX engine (its native library off: the port's
    segmentation is the numpy path), and what the tests read: the JAX
    engine, its snapshot, frame 3's preprocessed inputs (the JAX engine's,
    and the same arrays as the port's Preprocessed), the frames, and the
    native library's state before (`native`)."""
    saved = jnative._lib, jnative._tried
    jnative._lib, jnative._tried = None, True
    frames = two_object_frames(7)
    jeng = JMaskFusion(JResolution(syn.W, syn.H), syn.DEFAULT_INTR,
                       JConfig(**SLICE))
    for i in range(CARRY_AT):
        rgb, depth, lab = frames[i]
        jeng.process_frame(JFrameData(rgb=rgb, depth=depth, mask=lab,
                                      class_ids=CLASS_IDS,
                                      timestamp=float(i)))
    assert [m.model_id for m in jeng.models] == [0, 1, 2]
    assert all(m.window is not None for m in jeng.models[1:])
    snap = engine_snapshot(jeng)
    rgb, depth, _ = frames[CARRY_AT]
    prep_j = jeng._preprocess(jnp.asarray(rgb), jnp.asarray(depth),
                              jnp.asarray(jeng.last_segmentation))
    prep_t = Preprocessed(
        filt_depth=t(prep_j.filt_depth), intensity=t(prep_j.intensity),
        levels=tuple({k: t(v) for k, v in lv.items()}
                     for lv in prep_j.levels),
        frame_pyr=todo.FramePyramids(*(tuple(t(a) for a in f)
                                       for f in prep_j.frame_pyr)),
        vmap_raw=t(prep_j.vmap_raw))
    return dict(jeng=jeng, snap=snap, frames=frames, prep_j=prep_j,
                prep_t=prep_t, native=saved)


@pytest.fixture(scope="module")
def carried():
    """carry_state(), shared by the module's tests, with the port on its
    numpy path as the JAX engine."""
    with tnative.disabled():
        state = carry_state()
        yield state
    jnative._lib, jnative._tried = state["native"]


def _restored(snap, **overrides) -> MaskFusion:
    eng = port_engine(**overrides)
    restore_engine(eng, snap)
    return eng


def _jstate(rec) -> JMapState:
    """A fresh JAX MapState from a snapshot record (the JAX fuse stage
    donates its inputs)."""
    st = rec["state"]
    m = jsm.SurfelMap(*(jnp.asarray(st[f])
                        for f in jsm.SurfelMap._fields[:-1]),
                      count=jnp.asarray(st["count"], jnp.int32))
    return JMapState(m, *(jnp.asarray(st[f]) for f in JMapState._fields[1:]))


def _jdead(glob_rec, capacity: int) -> JMapState:
    """The JAX engine's dead padding-slot state (engine.py:1418-1441)."""
    g = glob_rec["state"]
    # two buffers: the fuse stage donates each once
    return JMapState(
        map=jsm.empty(capacity), pose=jnp.eye(4, dtype=jnp.float32),
        last_delta=jnp.eye(4, dtype=jnp.float32),
        pred_vmap=jnp.full(g["pred_vmap"].shape, jnp.nan, jnp.float32),
        pred_nmap=jnp.full(g["pred_nmap"].shape, jnp.nan, jnp.float32),
        pred_rgb=jnp.zeros(g["pred_rgb"].shape, jnp.float32),
        so3_intensity=jnp.zeros(g["so3_intensity"].shape,
                                g["so3_intensity"].dtype))


# ------------------------------------------------------------ tracking
def test_batched_track_matches_jax_and_one_slot(carried):
    """One solve for both objects.  Against the JAX engine's vmapped
    `_track_objects` on the same carried states and preprocessed frame, and
    slot by slot against the port's one-slot solve (`track`): poses and
    jump norms to 2e-5."""
    snap, prep_t = carried["snap"], carried["prep_t"]
    jeng = carried["jeng"]
    recs = snap["models"][1:]
    ids = [r["model_id"] for r in recs]
    poses_j, jumps_j = jeng._track_objects(
        *(jnp.stack([jnp.asarray(r["state"][k]) for r in recs])
          for k in ("pose", "pred_vmap", "pred_nmap", "pred_rgb",
                    "so3_intensity")),
        jnp.asarray(ids, jnp.uint8), carried["prep_j"], None)
    teng = _restored(snap)
    states = [m.state for m in teng.models[1:]]
    poses_t, jumps_t = teng.track_objects(states, ids, prep_t)
    assert poses_t.shape == (2, 4, 4)
    np.testing.assert_allclose(n(poses_t), n(poses_j), atol=2e-5)
    np.testing.assert_allclose(n(jumps_t), n(jumps_j), atol=2e-5)
    for k, (st, mid) in enumerate(zip(states, ids)):
        one = teng.track(st, prep_t, mid, is_object=True)
        np.testing.assert_allclose(n(poses_t[k]), n(one.pose), atol=2e-5)
        np.testing.assert_allclose(
            float(jumps_t[k]),
            float(torch.linalg.vector_norm(one.delta[:3, 3])), atol=2e-5)


@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm_start"])
def test_batched_track_without_so3_matches_one_slot(carried, warm):
    """The batched solve without the SO(3) pre-alignment, from the carried
    poses and from a warm start (a camera motion), slot by slot against the
    one-slot solve (itself held against the JAX package in
    tests/test_torch_odometry.py): poses to 2e-5.  (With the SO(3)
    pre-alignment AND this warm start, object 2's two solves part by
    5.4e-4: their sums differ in the last bits, and one photometric
    correspondence rounds to the neighbouring pixel; `python -m
    tests.test_torch_object_passes` prints it.)"""
    teng = _restored(carried["snap"], use_so3=False)
    objs = teng.models[1:]
    motion = torch.tensor(MOTION) if warm else None
    poses, _ = teng.track_objects([m.state for m in objs],
                                  [m.model_id for m in objs],
                                  carried["prep_t"], motion)
    for k, m in enumerate(objs):
        one = teng.track(m.state, carried["prep_t"], m.model_id,
                         is_object=True, warm=motion)
        np.testing.assert_allclose(n(poses[k]), n(one.pose), atol=2e-5)


# ------------------------------------------------------------ fuse stage
def _assert_maps_match(mt, mj, what):
    """A fused, cleaned and compacted map against the JAX one, at the
    bounds of tests/test_torch_mapping.py: the count to clean's 1e-3 of
    the surfels; on an equal count, every slot's fields at the fuse
    bounds, except the slots of fault 1 (a JAX segment sum that reads a
    tiny positive value marks a slot updated: only last_seen differs
    there)."""
    cj, ct = int(mj.count), int(mt.count)
    assert abs(ct - cj) <= 1e-3 * cj, (what, ct, cj)
    if ct != cj:
        return
    spurious = n(mt.last_seen)[:cj] != n(mj.last_seen)[:cj]
    assert spurious.mean() < 5e-3, what
    same = ~spurious
    for name, atol in (("pos", 2e-3), ("conf", 2e-3), ("color", 0.5),
                       ("init_time", 0), ("normal", 2e-3),
                       ("radius", 1e-4)):
        np.testing.assert_allclose(n(getattr(mt, name))[:cj][same],
                                   n(getattr(mj, name))[:cj][same],
                                   atol=atol, err_msg=f"{what} {name}")
        assert not n(getattr(mt, name))[cj:].any(), (what, name)


def _assert_global_map_close(mt, mj):
    """The global map, which carries the JAX package's known segment-sum
    drift (ROADMAP faults 1-2: its sums are differences of one float32
    running sum; on this 19k-surfel map after four frames they move merged
    positions by up to 9 mm and confidences by up to 1e-2): the same count
    and creation times, every position within 1 cm, and all but 0.5% of
    the positions within the fuse bound of 2e-3 (measured: 0.2%)."""
    c = int(mj.count)
    assert int(mt.count) == c
    np.testing.assert_array_equal(n(mt.init_time)[:c], n(mj.init_time)[:c])
    d = np.abs(n(mt.pos)[:c] - n(mj.pos)[:c]).max(-1)
    assert d.max() < 1e-2 and (d > 2e-3).mean() < 5e-3, (d.max(),
                                                          (d > 2e-3).mean())


def _assert_predictions_match(st, sj, what):
    """Predicted vertices and normals: the same valid pixels but for scan
    ties (under 3e-3 of the pixels), and within 1e-4 elsewhere."""
    for name in ("pred_vmap", "pred_nmap"):
        a, b = n(getattr(st, name)), n(getattr(sj, name))
        differ = (np.isfinite(a[..., 2]) != np.isfinite(b[..., 2])) | (
            np.abs(np.nan_to_num(a) - np.nan_to_num(b)).max(-1) > 1e-4)
        assert differ.mean() < 3e-3, (what, name, differ.mean())


def _fuse_both(state, windowed: bool):
    """The fuse stage of both engines on the carried state with frame 3's
    inputs: the global model, both objects and one padded dead slot.
    Returns the port's (global, objects, its dead state), the JAX engine's
    (global, objects) and the inputs (rgb, labels, prev_poses, tick,
    statics)."""
    snap, jeng = state["snap"], state["jeng"]
    rgb, _, lab = state["frames"][CARRY_AT]
    tick = CARRY_AT + 1
    recs = snap["models"]
    cap = SLICE["object_surfel_capacity"]
    params = np.asarray(
        [[r["model_id"], r["conf_threshold"], min(5.0, r["max_depth"]),
          1.0 if r["fused_once"] else 100.0, *r["window"]]
         for r in recs[1:]]
        + [[DEAD_SLOT_ID, 1.0, 5.0, 1.0, 0, 0]], np.float32)
    prevs = np.stack([r["state"]["pose"] for r in recs]
                     + [np.eye(4, dtype=np.float32)])
    statics = dict(glob_bucket=SLICE["global_surfel_capacity"],
                   obj_bucket=cap, parity=tick % 2, windowed=windowed)
    glob_j, objs_j = jeng._pipelined_fuse_stage(
        _jstate(recs[0]),
        tuple(_jstate(r) for r in recs[1:]) + (_jdead(recs[0], cap),),
        state["prep_j"], jnp.asarray(rgb), jnp.asarray(lab),
        jnp.asarray(prevs), float(tick), jnp.asarray(params), **statics)
    teng = _restored(snap)
    dead = teng._dummy_obj_state(cap, 2)
    glob_t, objs_t = teng.fuse_stage(
        teng.models[0].state,
        tuple(m.state for m in teng.models[1:]) + (dead,),
        state["prep_t"], t(rgb), t(lab), t(prevs), float(tick), params,
        **statics)
    return ((glob_t, objs_t, dead), (glob_j, objs_j),
            (rgb, lab, prevs, tick, statics))


@pytest.mark.parametrize("windowed", [True, False],
                         ids=["windowed", "full_frame"])
def test_fuse_stage_matches_jax(carried, windowed):
    """The fuse stage on the carried state with frame 3's inputs: the
    global model, both objects and one padded dead slot, against the JAX
    engine's `_pipelined_fuse_stage` (which the synchronous schedule calls
    with gate and ids guard unset).  The objects' maps and predictions at
    the mapping tests' bounds; the global pass is the port's own full-frame
    fuse_clean_predict, bit for bit, and its map is held to the JAX one
    within the known segment-sum drift.  The dead slot stays empty."""
    (glob_t, objs_t, dead), (glob_j, objs_j), args = _fuse_both(carried,
                                                                windowed)
    snap, recs = carried["snap"], carried["snap"]["models"]
    rgb, lab, prevs, tick, statics = args
    # the stage's global pass is the port's full-frame fuse_clean_predict
    ref = _restored(snap)
    direct, _, _ = ref.fuse_clean_predict(
        ref.models[0].state, carried["prep_t"], t(rgb), t(lab),
        t(prevs[0]), float(tick), 0, ref.cfg.conf_threshold_global,
        ref.cfg.depth_cutoff, ref.cfg.weight_multiplier, True,
        statics["glob_bucket"], statics["parity"], True)
    for a, b in zip(tuple(glob_t.map) + tuple(glob_t[1:]),
                    tuple(direct.map) + tuple(direct[1:])):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
    _assert_global_map_close(glob_t.map, glob_j.map)
    for k, (st, sj) in enumerate(zip((glob_t,) + objs_t[:2],
                                     (glob_j,) + objs_j[:2])):
        if k:
            _assert_maps_match(st.map, sj.map, f"object {k}")
            _assert_predictions_match(st, sj, f"object {k}")
        np.testing.assert_allclose(n(st.last_delta), n(sj.last_delta),
                                   atol=1e-6)
        np.testing.assert_array_equal(n(st.so3_intensity),
                                      n(sj.so3_intensity))
    for k in (1, 2):
        # an object never fills in: NaN outside what its map predicts,
        # and with a window, outside the window
        pv = n(objs_t[k - 1].pred_vmap)
        assert np.isfinite(pv[..., 2]).any()
        if windowed:
            oy, ox = recs[k]["window"]
            outside = np.ones(pv.shape[:2], bool)
            outside[oy:oy + 104, ox:ox + 104] = False
            assert np.isnan(pv[outside]).all()
    assert objs_t[2] is dead and int(dead.map.count) == 0
    assert not n(dead.map.pos).any() and int(objs_j[2].map.count) == 0


# ------------------------------------------------------------ windows
def _window_cases(carried):
    """Label images: every frame's labels, the carried segmentation, one
    without object 2 (its previous window stays), one with object 1 grown
    past the window (None), one with object 2 at the frame's corner."""
    labs = [f[2] for f in carried["frames"]]
    cases = labs + [carried["snap"]["last_segmentation"]]
    gone = labs[3].copy()
    gone[gone == 2] = 0
    big = labs[3].copy()
    big[10:100, 5:120] = 1
    corner = np.zeros_like(labs[3])
    corner[110:, 150:] = 2
    corner[40:50, 60:70] = 1
    return cases + [gone, big, corner]


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "native"])
def test_windows_match_jax(carried, native):
    """`_update_windows` of the port against the JAX engine's, frame by
    frame on the same label images, with both packages' native
    bounding-box pass off and on: the same windows, origins multiples of 8
    inside the frame."""
    jeng = carried["jeng"]
    if native:
        jnative._lib, jnative._tried = carried["native"]
        assert jnative.load() is not None
    teng = _restored(carried["snap"])
    jmodels = [JModel(model_id=m.model_id, state=None, window=m.window)
               for m in teng.models]
    saved = jeng.models
    jeng.models = jmodels
    seen = []
    try:
        for seg in _window_cases(carried):
            jeng._update_windows(seg)
            with tnative.disabled(not native):
                teng._update_windows(seg)
            got = [m.window for m in teng.models[1:]]
            assert got == [m.window for m in jmodels[1:]]
            seen.append(got)
            for w in got:
                if w is not None:
                    oy, ox = w
                    assert oy % 8 == 0 and ox % 8 == 0
                    assert 0 <= oy <= syn.H - 104 and 0 <= ox <= syn.W - 104
    finally:
        jeng.models = saved
        jnative._lib, jnative._tried = None, True
    gone, big, corner = seen[-3:]
    assert gone[1] == seen[-4][1] is not None    # an absent label keeps it
    assert big[0] is None                         # does not fit
    assert corner[1] == (16, 56)                  # clipped into the frame


@pytest.mark.parametrize("n_live,floor,want", [
    (0, 0, 0), (1, 0, 1), (2, 0, 2), (3, 0, 4), (4, 0, 4), (5, 0, 8),
    (0, 2, 2), (1, 2, 2), (2, 2, 2), (3, 2, 4)])
def test_slot_class(n_live, floor, want):
    """tests/test_engine_pipelined.py:85-89's cases, on both packages."""
    assert _slot_class(n_live, floor) == j_slot_class(n_live, floor) == want


# ------------------------------------------------------------- lockstep
def _rot_deg(a, b) -> float:
    """The angle between two rotations in float64, from the chord
    |Ra - Rb|_F = 2 sqrt(2) sin(angle / 2) (chip_smoke._rot_deg): the
    arccos of a float32 trace reads ~0.05 deg for equal rotations."""
    chord = np.linalg.norm(np.asarray(a, np.float64)[:3, :3]
                           - np.asarray(b, np.float64)[:3, :3])
    return float(np.degrees(2 * np.arcsin(min(1.0, chord / 8 ** 0.5))))


def test_lockstep_with_jax_engine(carried):
    """Both engines run frames 3-6 side by side from the carried state, in
    the object passes' configuration: objects tracked in one solve and
    fused in their windows.  Per frame, the bounds of
    tests/test_torch_engine_multimodel.py's lockstep test: the same model
    and class ids, segmentation and windows; the global pose to 1 mm and
    0.05 deg; each object's logged pose to 8 mm; each surfel count to 1%.
    The windows stay engaged on every frame.  (Run longer, the engines
    drift apart: ROADMAP fault 2, tests/torch_lockstep_drift.py.)"""
    jeng, snap, frames = carried["jeng"], carried["snap"], carried["frames"]
    teng = _restored(snap)
    assert [m.window for m in teng.models] == \
        [m.window for m in jeng.models]
    for i in range(CARRY_AT, len(frames)):
        rgb, depth, lab = frames[i]
        dj = jeng.process_frame(JFrameData(
            rgb=rgb, depth=depth, mask=lab, class_ids=CLASS_IDS,
            timestamp=float(i)))
        dt = teng.process_frame(FrameData(
            rgb=rgb, depth=depth, mask=lab, class_ids=CLASS_IDS,
            timestamp=float(i)))
        assert dt["model_ids"] == dj["model_ids"] == [0, 1, 2], i
        assert [m.class_id for m in teng.models] == \
            [m.class_id for m in jeng.models]
        np.testing.assert_array_equal(teng.last_segmentation,
                                      jeng.last_segmentation)
        assert [m.window for m in teng.models] == \
            [m.window for m in jeng.models], i
        assert all(m.window is not None for m in teng.models[1:])
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
    assert teng.windowed_fuses == len(frames) - CARRY_AT


def _solve_differences(state) -> dict:
    """The largest pose differences of the batched solve on the carried
    state: against the JAX engine's `_track_objects`, and against the
    port's one-slot solves (with and without the SO(3) pre-alignment)."""
    snap, prep_t = state["snap"], state["prep_t"]
    recs = snap["models"][1:]
    ids = [r["model_id"] for r in recs]
    poses_j, _ = state["jeng"]._track_objects(
        *(jnp.stack([jnp.asarray(r["state"][k]) for r in recs])
          for k in ("pose", "pred_vmap", "pred_nmap", "pred_rgb",
                    "so3_intensity")),
        jnp.asarray(ids, jnp.uint8), state["prep_j"], None)
    out = {}
    for use_so3, warm in ((True, None), (False, None), (True, MOTION),
                          (False, MOTION)):
        teng = _restored(snap, use_so3=use_so3)
        states = [m.state for m in teng.models[1:]]
        motion = None if warm is None else torch.tensor(warm)
        poses, _ = teng.track_objects(states, ids, prep_t, motion)
        if use_so3 and warm is None:
            out["batched - JAX"] = float(np.abs(n(poses) - n(poses_j)).max())
        out[f"batched - one slot, use_so3={use_so3}, warm start "
            f"{warm is not None}"] = max(
            float(np.abs(n(poses[k]) - n(teng.track(
                st, prep_t, mid, is_object=True, warm=motion).pose)).max())
            for k, (st, mid) in enumerate(zip(states, ids)))
    return out


def _fuse_differences(state) -> dict:
    """The fuse stage's map differences against the JAX engine's, windowed:
    the global map's largest position difference and its share of slots
    past 2e-3 m, each object's largest position difference."""
    (glob_t, objs_t, _), (glob_j, objs_j), _ = _fuse_both(state, True)
    c = int(glob_j.map.count)
    d = np.abs(n(glob_t.map.pos)[:c] - n(glob_j.map.pos)[:c]).max(-1)
    out = {"global max |dpos| (m)": float(d.max()),
           "global share of slots past 2e-3 m": float((d > 2e-3).mean())}
    for k in (0, 1):
        c = int(objs_j[k].map.count)
        out[f"object {k + 1} max |dpos| (m)"] = float(np.abs(
            n(objs_t[k].map.pos)[:c] - n(objs_j[k].map.pos)[:c]).max())
    return out


if __name__ == "__main__":
    # python -m tests.test_torch_object_passes: print the differences the
    # tests hold, on their carried state (CPU, about a minute)
    import conftest  # noqa: F401  (JAX on the CPU, as the tests run it)

    carried_state = carry_state()
    for key, value in {**_solve_differences(carried_state),
                       **_fuse_differences(carried_state)}.items():
        print(f"{key}: {value:.3e}", flush=True)
