"""A lockstep loop closure in the port's engine: _apply_loop_closure on a
JAX engine state carried across (tests/test_torch_reloc_engine.py holds
the relocalisation scenarios; this file was split from it to keep each
file's run short).

Bounds: the loop closure's accept decision equal, its deformed map within
1e-5 on live rows and bit-equal on dead ones, the fern poses within
1e-5."""

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
from maskfusion_tpu_torch.reloc.ferns import FindResult, SurfaceConstraint
from tests import synthetic as syn
from tests.test_torch_reloc import assert_same_db
from tests.test_torch_reloc_engine import RELOC
from tests.torch_helpers import CPU, assert_close_nan, numpy_paths, tintr


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
