"""Relocalisation in the port's engine: the engine scenarios of
tests/test_reloc.py run on the port and on the JAX engine (the
module-level cases are tests/test_torch_reloc.py's; the lockstep loop
closure is tests/test_torch_loop_closure.py's).

Bounds: relocalisation at the same frames as the JAX engine's, within
2 cm of the truth and 1e-4 of the JAX engine's pose; the same fern frames
kept (up to 5% of their codes may flip a threshold bit: each engine's
maps are its own prediction)."""

import numpy as np
import pytest

from maskfusion_tpu.camera import Resolution as JResolution
from maskfusion_tpu.config import Config as JConfig
from maskfusion_tpu.engine import MaskFusion as JMaskFusion
from maskfusion_tpu.frame import FrameData as JFrameData
from maskfusion_tpu_torch.camera import Resolution
from maskfusion_tpu_torch.config import Config
from maskfusion_tpu_torch.engine import MaskFusion
from maskfusion_tpu_torch.frame import FrameData
from tests import synthetic as syn
from tests.test_torch_reloc import assert_same_db
from tests.torch_helpers import CPU, tintr

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
