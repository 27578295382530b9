"""The port's pipelined multi-object schedule against the JAX engine's.

One JAX engine runs the configuration of
tests/test_engine_pipelined.py::test_padded_object_slots_match_exact (the
prefused schedule, MaskFusion segmentation of the frame's masks, a 104-pixel
object window with a 24-pixel margin, two object slots, no SO(3)
pre-alignment) on its moving-object scene through the spawn (frames 0-2),
drained.  Its state crosses into the port with convert.engine_snapshot /
restore_engine, and the tests hold, on that carried state and frame 3's
inputs:

- the device stage (preprocess, the global track, the windowed object
  tracker, the windowed id projection, the edge map's non-edge binary and
  the packed hostvec) against the JAX engine's `_pipelined_device_stage`;
- the fuse stage with the tracking gate and the ids-guard against the JAX
  engine's `_pipelined_fuse_stage` (the bounds of
  tests/test_torch_object_passes.py);
- a lockstep run of both engines over the remaining frames of the eight;
- the device stage and the fuse stage of a port engine whose object slots
  are split over a two-entry models mesh (``ModelMesh(["cpu", "cpu"])``:
  one slot a block, each solved, projected and fused on its own) against
  the same JAX stages, at the same bounds.  The JAX package holds its own
  split stages equal to its unsplit ones
  (tests/test_parallel.py::test_engine_model_axis_sharded_matches_unsharded).

The JAX engine runs with its native library off, as the port's other
lockstep tests run it, and the test waits for its pending device results
before each frame, so that both engines finish every pending frame at the
start of the next one (the port's records are always ready on the CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import maskfusion_tpu.cpp as jnative
from maskfusion_tpu.camera import Resolution as JResolution
from maskfusion_tpu.config import Config as JConfig
from maskfusion_tpu.engine import MaskFusion as JMaskFusion
from maskfusion_tpu.frame import FrameData as JFrameData
from maskfusion_tpu_torch import cpp as tnative
from maskfusion_tpu_torch.camera import Resolution
from maskfusion_tpu_torch.config import Config
from maskfusion_tpu_torch.convert import engine_snapshot, restore_engine
from maskfusion_tpu_torch.engine import DEAD_SLOT_ID, MaskFusion, Preprocessed
from maskfusion_tpu_torch.frame import FrameData
from maskfusion_tpu_torch.parallel.multimodel import ModelMesh
from maskfusion_tpu_torch.tracking import odometry as todo
from tests import synthetic as syn
from tests.test_torch_object_passes import (_assert_global_map_close,
                                            _assert_maps_match,
                                            _assert_predictions_match, _jdead,
                                            _jstate, _rot_deg)
from tests.torch_helpers import CPU, n, t, tintr, wait_for_jax_pending

# tests/test_engine_pipelined.py:19-33 with mask_lag=True, object_window=104
# and min_object_slots=2
SLICE = dict(global_surfel_capacity=1 << 16, object_surfel_capacity=1 << 13,
             seg_method="maskfusion", use_so3=False, model_spawn_offset=0,
             pipelined_multiobject=True, object_window=104,
             object_window_margin=24, fuse_mask_lag=True, min_object_slots=2)
CLASS_IDS = [0, 7]
CARRY_AT = 3      # frames 0-2 run on the JAX engine: the object spawns
N_FRAMES = 8
# the bounds of the lockstep tests (tests/test_torch_object_passes.py) hold
# up to this frame; the later ones are reported
HOLD_LAST_FRAME = 4
# a two-entry models mesh on the CPU: one object slot a block
MESH = ModelMesh(["cpu", "cpu"])


def moving_object_frames(count):
    """tests/test_engine_pipelined.py's scene: a still camera and one object
    moving along +x from frame 1."""
    frames = []
    for i in range(count):
        off = np.array([0.006 * max(0, i - 1), 0.0, 0.0])
        pts, cols, labels = syn.make_scene_with_object(offset=off)
        frames.append(syn.render(pts, cols, np.eye(4, dtype=np.float32),
                                 syn.DEFAULT_INTR, labels=labels))
    return frames


def port_engine(mesh=None, **overrides) -> MaskFusion:
    return MaskFusion(Resolution(syn.W, syn.H), tintr(syn.DEFAULT_INTR),
                      Config(**{**SLICE, **overrides}), device=CPU,
                      mesh=mesh)


def _frame_data(cls, frames, i):
    rgb, depth, lab = frames[i]
    return cls(rgb=rgb, depth=depth, mask=lab, class_ids=CLASS_IDS,
               timestamp=float(i))


def carry_state() -> dict:
    """Frames 0-2 on the JAX engine in the prefused schedule, drained, and
    what the tests read: the JAX engine, its snapshot, frame 3's inputs to
    the device stage on both sides, and the native library's state before
    (`native`)."""
    saved = jnative._lib, jnative._tried
    jnative._lib, jnative._tried = None, True
    frames = moving_object_frames(N_FRAMES)
    jeng = JMaskFusion(JResolution(syn.W, syn.H), syn.DEFAULT_INTR,
                       JConfig(**SLICE))
    for i in range(CARRY_AT):
        wait_for_jax_pending(jeng)
        jeng.process_frame(_frame_data(JFrameData, frames, i))
    jeng.drain_pipeline()
    assert [m.model_id for m in jeng.models] == [0, 1]
    assert jeng.models[1].window is not None
    snap = engine_snapshot(jeng)
    return dict(jeng=jeng, snap=snap, frames=frames, native=saved)


@pytest.fixture(scope="module")
def carried():
    """carry_state(), with both device stages run on frame 3 (the JAX
    engine's once), shared by the module's tests, with the port on its
    numpy path as the JAX engine."""
    with tnative.disabled():
        state = carry_state()
        state.update(device_stages(state))
        yield state
    jnative._lib, jnative._tried = state["native"]


def _restored(snap, mesh=None, **overrides) -> MaskFusion:
    eng = port_engine(mesh, **overrides)
    restore_engine(eng, snap)
    return eng


def _stage_inputs(snap):
    """Frame 3's device-stage arguments shared by both engines: the slot
    rows [mask_id, oy, ox] (one live object, one dead slot), the buckets
    (the full capacities) and the tick."""
    recs = snap["models"]
    aux = np.asarray([[r["model_id"], *r["window"]] for r in recs[1:]]
                     + [[DEAD_SLOT_ID, 0, 0]], np.float32)
    return aux, dict(glob_bucket=SLICE["global_surfel_capacity"],
                     obj_bucket=SLICE["object_surfel_capacity"]), CARRY_AT + 1


def device_stages(state) -> dict:
    """Both engines' device stage on the carried state and frame 3, the
    objects windowed."""
    snap, jeng = state["snap"], state["jeng"]
    rgb, depth, _ = state["frames"][CARRY_AT]
    seg = snap["last_segmentation"]
    aux, buckets, tick = _stage_inputs(snap)
    recs = snap["models"]
    cap = SLICE["object_surfel_capacity"]
    out_j = jeng._pipelined_device_stage(
        _jstate(recs[0]), (_jstate(recs[1]), _jdead(recs[0], cap)),
        jnp.asarray(aux), jnp.asarray([0, recs[1]["model_id"], 0],
                                      jnp.float32),
        jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(seg), float(tick),
        windowed=True, **buckets)
    teng = _restored(snap)
    return {"stage_j": out_j, "stage_t": port_device_stage(state, teng),
            "stage_engine": teng}


def port_device_stage(state, teng):
    """The port engine's device stage on the carried state and frame 3."""
    rgb, depth, _ = state["frames"][CARRY_AT]
    aux, buckets, tick = _stage_inputs(state["snap"])
    objs = teng.models[1:]
    return teng.pipelined_device_stage(
        teng.models[0].state, teng._padded_obj_states(objs, 2), aux, t(rgb),
        t(depth), t(state["snap"]["last_segmentation"]), float(tick),
        windowed=True, **buckets)


# ------------------------------------------------------------ device stage
def _hostvec_fields(hv, n_slots=2):
    """JAX's hostvec layout over the padded slot axis: counts, cov, jumps,
    pre-track poses, world poses."""
    hv = n(hv)
    N = 1 + n_slots
    p0 = N + 1 + n_slots
    return (hv[:N], hv[N], hv[N + 1:p0],
            hv[p0:p0 + 16 * N].reshape(N, 4, 4),
            hv[p0 + 16 * N:p0 + 32 * N].reshape(N, 4, 4))


def test_device_stage_matches_jax(carried):
    """The device stage on the carried state and frame 3, the object in
    its window and one dead slot, against the JAX engine's
    `_pipelined_device_stage(..., windowed=True)`: the global and object
    poses to 2e-5 (the solve bound of tests/test_torch_odometry.py and of
    the batched solve in tests/test_torch_object_passes.py, which hold here
    for the halo-built windowed pyramids too); the hostvec's surfel counts exactly, its jumps, pre-track
    and world poses to 2e-5 and its covariance maximum to 1e-3 relative, the
    tracking verdict `okf` equal; the id image and the non-edge binary
    equal but for fewer than 3e-3 of the pixels (scan ties and
    knife-edge concavity gates, tests/test_pallas.py's bound).  The dead
    slot keeps its identity pose and a zero jump."""
    _assert_device_stage_matches(carried["stage_t"], carried)


def test_device_stage_on_a_models_mesh_matches_jax(carried):
    """test_device_stage_matches_jax's bounds for a port engine whose two
    object slots are split over ModelMesh(["cpu", "cpu"]): the live slot
    solves and projects in its own block (the dead one's block has
    nothing to solve)."""
    teng = _restored(carried["snap"], MESH)
    assert teng._shard_model_axis(2) is not None
    _assert_device_stage_matches(port_device_stage(carried, teng), carried)


def _assert_device_stage_matches(stage_t, carried):
    (prep_j, gpose_j, oposes_j, hv_j, ids_j, nonedge_j, prev_j,
     okf_j) = carried["stage_j"]
    (prep_t, gpose_t, oposes_t, hv_t, ids_t, nonedge_t, prev_t,
     okf_t) = stage_t
    np.testing.assert_allclose(n(gpose_t), n(gpose_j), atol=2e-5)
    assert len(oposes_t) == len(oposes_j) == 2
    np.testing.assert_allclose(n(oposes_t[0]), n(oposes_j[0]), atol=2e-5)
    np.testing.assert_array_equal(n(oposes_t[1]), np.eye(4))
    np.testing.assert_allclose(n(oposes_t[1]), n(oposes_j[1]), atol=1e-6)
    assert hv_t.shape == hv_j.shape == (3 + 1 + 2 + 2 * 16 * 3,)
    ct, cov_t, jt, pt, wt = _hostvec_fields(hv_t)
    cj, cov_j, jj, pj, wj = _hostvec_fields(hv_j)
    np.testing.assert_array_equal(ct, cj)
    assert ct[2] == 0
    np.testing.assert_allclose(cov_t, cov_j, rtol=1e-3)
    np.testing.assert_allclose(jt, jj, atol=2e-5)
    assert jt[1] == 0
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(n(prev_t), pt)
    np.testing.assert_allclose(wt, wj, atol=2e-5)
    assert bool(okf_t) == bool(okf_j)
    for name, a, b in (("ids", ids_t, ids_j), ("nonedge", nonedge_t,
                                                 nonedge_j)):
        a, b = n(a), n(b)
        assert a.shape == b.shape == (syn.H, syn.W) and a.dtype == b.dtype
        assert (a != b).mean() < 3e-3, (name, (a != b).mean())
    # the object shows in the id image, inside its window only
    oy, ox = carried["snap"]["models"][1]["window"]
    ids = n(ids_t)
    outside = np.ones_like(ids, bool)
    outside[oy:oy + 104, ox:ox + 104] = False
    assert (ids == 1).sum() > 100 and not (ids[outside] == 1).any()


def test_windowed_tracker_matches_full_frame(carried):
    """The windowed object tracker against the full-frame one on the
    carried state: the window holds the object's mask and its margin, so
    the solves see the same associations (tests/test_engine_pipelined.py
    holds the two schedules' trajectories to 2e-4; one solve here)."""
    teng = carried["stage_engine"]
    prep = carried["stage_t"][0]
    obj = teng.models[1]
    oy, ox = obj.window
    mids = torch.tensor([obj.model_id], dtype=torch.int32)
    win, jw = teng.track_objects_win(
        [obj.state], mids, [(oy, ox)],
        torch.tensor([[oy, ox]], dtype=torch.float32), prep)
    full, jf = teng.track_objects([obj.state], mids, prep)
    np.testing.assert_allclose(n(win), n(full), atol=2e-4)
    np.testing.assert_allclose(n(jw), n(jf), atol=2e-4)


# ------------------------------------------------------------ fuse stage
@pytest.mark.parametrize("gate", [True, False], ids=["open", "closed"])
def test_gated_guarded_fuse_stage_matches_jax(carried, gate):
    """The fuse stage as the prefused schedule queues it on frame 3: the
    newest segmentation (frame 2's) under the ids-guard of the device
    stage's id image, the gate open or closed, against the JAX engine's
    `_pipelined_fuse_stage(..., gate=, ids_guard=)` on the same inputs (the
    JAX engine's preprocessed frame and id image): with the gate open, the
    maps and predictions at the bounds of tests/test_torch_object_passes.py;
    closed, every map, count and prediction as it went in, on both."""
    _assert_fuse_stage_matches(carried, gate, None)


@pytest.mark.parametrize("gate", [True, False], ids=["open", "closed"])
def test_fuse_stage_on_a_models_mesh_matches_jax(carried, gate):
    """test_gated_guarded_fuse_stage_matches_jax for a port engine whose
    two object slots are split over ModelMesh(["cpu", "cpu"]): the live
    slot fuses in its own block, from the block's copy of the inputs."""
    _assert_fuse_stage_matches(carried, gate, MESH)


def _assert_fuse_stage_matches(carried, gate, mesh):
    snap, jeng = carried["snap"], carried["jeng"]
    prep_j, _, oposes_j, _, ids_j, _, prev_j, _ = carried["stage_j"]
    prep_t = Preprocessed(
        filt_depth=t(prep_j.filt_depth), intensity=t(prep_j.intensity),
        levels=tuple({k: t(v) for k, v in lv.items()}
                     for lv in prep_j.levels),
        frame_pyr=todo.FramePyramids(*(tuple(t(a) for a in f)
                                       for f in prep_j.frame_pyr)),
        vmap_raw=t(prep_j.vmap_raw))
    rgb, _, _ = carried["frames"][CARRY_AT]
    seg = snap["last_segmentation"]
    recs = snap["models"]
    cap = SLICE["object_surfel_capacity"]
    params = np.asarray(
        [[r["model_id"], r["conf_threshold"], min(5.0, r["max_depth"]),
          1.0 if r["fused_once"] else 100.0, *r["window"]]
         for r in recs[1:]]
        + [[DEAD_SLOT_ID, 1.0, 5.0, 1.0, 0, 0]], np.float32)
    tick = CARRY_AT + 1
    statics = dict(glob_bucket=SLICE["global_surfel_capacity"],
                   obj_bucket=cap, parity=tick % 2, windowed=True)
    # the device stage's new poses go into the stage, as in the engine
    # (copies: the JAX fuse stage donates its states)
    glob_in = _jstate(recs[0])._replace(
        pose=jnp.array(np.asarray(carried["stage_j"][1])))
    obj_in = _jstate(recs[1])._replace(pose=jnp.array(np.asarray(
        oposes_j[0])))
    glob_j, objs_j = jeng._pipelined_fuse_stage(
        glob_in, (obj_in, _jdead(recs[0], cap)), prep_j, jnp.asarray(rgb),
        jnp.asarray(seg), prev_j, float(tick), jnp.asarray(params),
        gate=jnp.asarray(gate), ids_guard=ids_j, **statics)
    teng = _restored(snap, mesh)
    g, o = teng.models[0], teng.models[1]
    g.state = g.state._replace(pose=t(carried["stage_j"][1]))
    o.state = o.state._replace(pose=t(oposes_j[0]))
    before = [[a.clone() for a in tuple(m.state.map) + m.state[3:6]]
              for m in (g, o)]
    dead = teng._dummy_obj_state(cap, 1)
    glob_t, objs_t = teng.fuse_stage(
        g.state, (o.state, dead), prep_t, t(rgb), t(seg), t(prev_j),
        float(tick), params, gate=torch.tensor(gate), ids_guard=t(ids_j),
        **statics)
    if gate:
        _assert_global_map_close(glob_t.map, glob_j.map)
        _assert_maps_match(objs_t[0].map, objs_j[0].map, "object 1")
        _assert_predictions_match(objs_t[0], objs_j[0], "object 1")
    else:
        for st, sj, ref in zip((glob_t, objs_t[0]), (glob_j, objs_j[0]),
                               before):
            for a, b, r in zip(tuple(st.map) + st[3:6],
                               tuple(sj.map) + sj[3:6], ref):
                np.testing.assert_array_equal(n(a), n(r))
                np.testing.assert_array_equal(n(b), n(r))
    for st, sj in zip((glob_t, objs_t[0]), (glob_j, objs_j[0])):
        np.testing.assert_allclose(n(st.last_delta), n(sj.last_delta),
                                   atol=1e-6)
    assert objs_t[1] is dead and int(dead.map.count) == 0


# ------------------------------------------------------------- lockstep
def _logged(eng, tick):
    """Each model's logged pose of frame `tick` (None where it has none)."""
    out = []
    for m in eng.models:
        hit = [e["pose"] for e in m.pose_log if e["tick"] == tick]
        out.append(np.asarray(hit[-1].cpu() if isinstance(hit[-1],
                                                          torch.Tensor)
                              else hit[-1]) if hit else None)
    return out


def test_prefused_lockstep_with_jax_engine(carried):
    """Both engines run frames 3-7 side by side from the carried state in
    the prefused schedule, each finishing every pending frame at the start
    of the next, and are drained at the end.  Per frame: the same model
    ids, segmentation, windows and pending frames; for each finished frame
    up to frame 4 the bounds of the lockstep tests, the global pose to 1 mm
    and 0.05 deg, the object's logged pose to 8 mm and each surfel count to
    1%; later frames are printed (run longer, the engines drift apart:
    ROADMAP fault 2).  Drained, the object has moved more than 5 mm along
    +x in both; the port's object is in its window on every frame."""
    jeng, snap, frames = carried["jeng"], carried["snap"], carried["frames"]
    teng = _restored(snap)
    rows = []

    def compare(i):
        # frame i (tick i + 1) has finished on both engines
        pj, pt = _logged(jeng, i + 1), _logged(teng, i + 1)
        assert all(p is not None for p in pj + pt), i
        row = {"frame": i,
               "global_m": float(np.linalg.norm(pt[0][:3, 3] - pj[0][:3, 3])),
               "global_deg": _rot_deg(pt[0], pj[0]),
               "object_m": float(np.linalg.norm(pt[1][:3, 3]
                                                - pj[1][:3, 3])),
               "counts": [(mt.surfel_count, mj.surfel_count)
                          for mt, mj in zip(teng.models, jeng.models)]}
        rows.append(row)
        if i <= HOLD_LAST_FRAME:
            assert row["global_m"] <= 1e-3 and row["global_deg"] <= 0.05, row
            assert row["object_m"] <= 8e-3, row
            for ct, cj in row["counts"]:
                assert abs(ct - cj) <= 0.01 * cj, row

    for i in range(CARRY_AT, N_FRAMES):
        wait_for_jax_pending(jeng)
        dj = jeng.process_frame(_frame_data(JFrameData, frames, i))
        dt = teng.process_frame(_frame_data(FrameData, frames, i))
        assert dt["model_ids"] == dj["model_ids"] == [0, 1], i
        assert len(teng._pending) == len(jeng._pending) == 1
        np.testing.assert_array_equal(teng.last_segmentation,
                                      jeng.last_segmentation)
        assert [m.window for m in teng.models] == \
            [m.window for m in jeng.models], i
        if i > CARRY_AT:
            compare(i - 1)
    teng.drain_pipeline()
    jeng.drain_pipeline()
    compare(N_FRAMES - 1)
    print("prefused lockstep, port against JAX:", *rows, sep="\n  ")
    for p in (_logged(teng, N_FRAMES)[1], _logged(jeng, N_FRAMES)[1]):
        assert p[0, 3] > 0.005, p
    assert teng.windowed_fuses == N_FRAMES - CARRY_AT
