"""Relocalisation and loop closure in the port's engine: the engine
scenarios of tests/test_reloc.py run on the port and on the JAX engine,
and a lockstep loop closure from a JAX engine state carried across (the
module-level cases are tests/test_torch_reloc.py's).

Bounds: relocalisation at the same frames as the JAX engine's, within
2 cm of the truth and 1e-4 of the JAX engine's pose; the same fern frames
kept (up to 5% of their codes may flip a threshold bit: each engine's
maps are its own prediction); the loop closure's accept decision equal,
its deformed map within 1e-5 on live rows and bit-equal on dead ones, the
fern poses within 1e-5."""

import numpy as np
import pytest

from maskfusion_tpu.camera import Resolution as JResolution
from maskfusion_tpu.config import Config as JConfig
from maskfusion_tpu.engine import MaskFusion as JMaskFusion
from maskfusion_tpu.frame import FrameData as JFrameData
from maskfusion_tpu.reloc.ferns import FindResult as JFindResult
from maskfusion_tpu.reloc.ferns import SurfaceConstraint as JConstraint
from maskfusion_tpu_torch.camera import Resolution
from maskfusion_tpu_torch.config import Config
from maskfusion_tpu_torch.convert import engine_snapshot, restore_engine
from maskfusion_tpu_torch.engine import MaskFusion
from maskfusion_tpu_torch.frame import FrameData
from maskfusion_tpu_torch.reloc.ferns import FindResult, SurfaceConstraint
from tests import synthetic as syn
from tests.test_torch_reloc import assert_same_db
from tests.torch_helpers import CPU, assert_close_nan, numpy_paths, tintr

RELOC = dict(global_surfel_capacity=1 << 16, static_mode=True,
             use_so3=False, relocalisation=True, close_loops=True)


# ------------------------------------------------------------------ engine
def reloc_frames():
    pts, cols = syn.make_scene()
    good = syn.render(pts, cols, np.eye(4), syn.DEFAULT_INTR)
    blind = (np.zeros((syn.H, syn.W, 3), np.uint8),
             np.zeros((syn.H, syn.W), np.float32))
    return good, blind


def run_reloc(eng, frame_cls):
    """tests/test_reloc.py's relocalisation scenario: 2 good frames, 13
    blind ones, then the good view again at tick 400 and 401.  Returns the
    per-frame (lost, last_frame_recovery) and the pose after the revisit."""
    good, blind = reloc_frames()
    trace = []
    for i in range(2):
        eng.process_frame(frame_cls(rgb=good[0], depth=good[1],
                                    timestamp=float(i)))
        trace.append((eng.lost, eng.last_frame_recovery))
    n_ferns = len(eng.ferns.frames)
    for i in range(13):
        eng.process_frame(frame_cls(rgb=blind[0], depth=blind[1],
                                    timestamp=float(2 + i)))
        trace.append((eng.lost, eng.last_frame_recovery))
    eng.tick = 400
    eng.process_frame(frame_cls(rgb=good[0], depth=good[1], timestamp=400.0))
    trace.append((eng.lost, eng.last_frame_recovery))
    recovered = np.array(eng.current_pose)
    eng.process_frame(frame_cls(rgb=good[0], depth=good[1], timestamp=401.0))
    trace.append((eng.lost, eng.last_frame_recovery))
    return trace, recovered, n_ferns


@pytest.fixture(scope="module")
def jax_reloc():
    eng = JMaskFusion(JResolution(syn.W, syn.H), syn.DEFAULT_INTR,
                      JConfig(**RELOC))
    return (eng,) + run_reloc(eng, JFrameData)


def test_engine_relocalisation_recovers_from_lost(jax_reloc):
    """Blind frames make the engine lost; the revisit is recovered from the
    fern database (the -rl path, MaskFusion.cpp:377-443) at the same frame
    as the JAX engine, within 2 cm, and the next good frame clears lost.
    Every frame runs the synchronous step (ferns leave the fast path)."""
    jeng, jtrace, jpose, jn = jax_reloc
    eng = MaskFusion(Resolution(syn.W, syn.H), tintr(syn.DEFAULT_INTR),
                     Config(**RELOC), device=CPU)
    trace, pose, n = run_reloc(eng, FrameData)
    assert n >= 1 and n == jn
    assert trace == jtrace
    assert trace[14] == (True, False), "lost after the blind frames"
    assert trace[15] == (True, True) and not trace[16][0]
    t_err = np.linalg.norm(pose[:3, 3])
    assert t_err < 0.02, f"recovery pose error {t_err}"
    np.testing.assert_allclose(pose, jpose, atol=1e-4)
    assert_same_db(eng.ferns, jeng.ferns, code_flips=0.05)
    assert eng.stopwatch.summary().get("Preprocess") is not None


def test_engine_close_loops_with_pipelined_config():
    """-rl/close-loops with pipelined_multiobject requested: the engine
    runs the synchronous schedule (the pipelined gate requires ferns is
    None), as the JAX engine does, and keeps the same fern frames."""
    fields = dict(global_surfel_capacity=1 << 16,
                  object_surfel_capacity=1 << 12,
                  seg_method="precomputed", use_so3=False,
                  relocalisation=True, close_loops=True,
                  pipelined_multiobject=True)
    eng = MaskFusion(Resolution(syn.W, syn.H), tintr(syn.DEFAULT_INTR),
                     Config(**fields), device=CPU)
    jeng = JMaskFusion(JResolution(syn.W, syn.H), syn.DEFAULT_INTR,
                       JConfig(**fields))
    assert eng.ferns is not None
    pts, cols = syn.make_scene()
    rgb, depth = syn.render(pts, cols, np.eye(4), syn.DEFAULT_INTR)
    lab = np.zeros((syn.H, syn.W), np.uint8)
    for i in range(3):
        out = eng.process_frame(FrameData(rgb=rgb, depth=depth, mask=lab,
                                          timestamp=float(i)))
        assert not out.get("pipelined", False)
        jeng.process_frame(JFrameData(rgb=rgb, depth=depth, mask=lab,
                                      timestamp=float(i)))
    assert not eng._pipelined_active and not eng._pending
    assert len(eng.ferns.frames) >= 1
    assert_same_db(eng.ferns, jeng.ferns, code_flips=0.05)
    t_err = np.linalg.norm(eng.current_pose[:3, 3])
    assert t_err < 0.01


@pytest.fixture(scope="module")
def jax_closure_engine():
    """A JAX -static engine with ferns on (numpy paths) after 4 frames of
    a camera sliding along +x: a map of several init times and a fern
    database to carry into the port."""
    with numpy_paths():
        eng = JMaskFusion(JResolution(syn.W, syn.H), syn.DEFAULT_INTR,
                          JConfig(**RELOC))
        pts, cols = syn.make_scene()
        for i in range(4):
            pose = syn.pose_from(np.zeros(3), np.array([0.01 * i, 0, 0]))
            rgb, depth = syn.render(pts, cols, pose, syn.DEFAULT_INTR)
            eng.process_frame(JFrameData(rgb=rgb, depth=depth,
                                         timestamp=float(i)))
    return eng


@pytest.mark.parametrize("shift,accept", [(0.004, True), (None, False)],
                         ids=["accepted", "rejected"])
def test_apply_loop_closure_lockstep(jax_closure_engine, shift, accept):
    """One FindResult through _apply_loop_closure on a JAX engine and on
    the port carrying its state (fern database included): the same accept
    decision, the deformed maps within 1e-5 on live rows and bit-equal on
    dead ones, the fern poses within 1e-5.  The constraints lead points on
    the map's surface either by a rigid 4 mm shift (a closure the graph
    accepts) or to scattered targets 5 cm off (one it rejects)."""
    import copy

    import jax.numpy as jnp

    from maskfusion_tpu.engine import MaskFusion as JM

    jsrc = jax_closure_engine
    assert len(jsrc.ferns.frames) >= 1
    # a private copy of the JAX engine's state: the closure deforms it
    jeng = copy.copy(jsrc)
    jeng.models = [copy.copy(m) for m in jsrc.models]
    jeng.ferns = copy.copy(jsrc.ferns)
    jeng.ferns.frames = [copy.copy(f) for f in jsrc.ferns.frames]
    for f in jeng.ferns.frames:
        f.pose = f.pose.copy()
    jglob = jeng.models[0]
    jglob.state = jglob.state._replace(map=jglob.state.map._replace(
        pos=jnp.array(jglob.state.map.pos),
        normal=jnp.array(jglob.state.map.normal)))

    eng = MaskFusion(Resolution(syn.W, syn.H), tintr(syn.DEFAULT_INTR),
                     Config(**RELOC), device=CPU)
    restore_engine(eng, engine_snapshot(jeng))
    assert_same_db(eng.ferns, jeng.ferns)

    n = jglob.surfel_count
    pos = np.asarray(jglob.state.map.pos)
    rng = np.random.default_rng(11)
    src = pos[rng.choice(n, 40, replace=False)].astype(np.float64)
    if shift is None:
        dst = src + rng.normal(0, 0.05, src.shape)
    else:
        dst = src + np.array([shift, -0.5 * shift, 0.0])
    est = np.eye(4, dtype=np.float32)
    jres = JFindResult(est, [JConstraint(a, b) for a, b in zip(src, dst)], 0)
    tres = FindResult(est, [SurfaceConstraint(a, b)
                            for a, b in zip(src, dst)], 0)
    with numpy_paths():
        ok_j = JM._apply_loop_closure(jeng, jglob, jres)
        ok_t = eng._apply_loop_closure(eng.models[0], tres)
    assert ok_t == ok_j == accept
    tm = eng.models[0].state.map
    jm = jglob.state.map
    cap = tm.capacity
    for name in ("pos", "normal"):
        a = getattr(tm, name).numpy()
        b = np.asarray(getattr(jm, name))
        # (NaN where the input was NaN, in both)
        assert_close_nan(a[:n], b[:n], atol=1e-5)
        np.testing.assert_array_equal(a[n:cap], b[n:cap])
    if accept:
        moved = np.linalg.norm(tm.pos.numpy()[:n] - pos[:n], axis=1)
        assert np.median(moved) > 0.5 * shift
    else:
        np.testing.assert_array_equal(tm.pos.numpy(), pos)
    for a, b in zip(eng.ferns.frames, jeng.ferns.frames):
        np.testing.assert_allclose(a.pose, b.pose, atol=1e-5)
