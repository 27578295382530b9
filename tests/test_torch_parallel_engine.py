"""The engine's object models split over a "models" axis, on the CPU.

- ``parallel.multimodel.shard_model_axis``: the contiguous block plan of
  ``PartitionSpec(axis)`` for divisible counts, None (everything on the
  engine's device) for indivisible and empty counts, an axis of one
  device, another axis name and no mesh, mirroring
  tests/test_parallel.py::test_shard_model_axis_helper;
- the engine with ``ModelMesh(["cpu", "cpu"])`` against the same engine
  without a mesh over tests/test_parallel.py::
  test_engine_model_axis_sharded_matches_unsharded's six frames (two
  objects moving apart), in the pipelined schedules, exact and prefused:
  each block's solve and fuse run on their own (the solve called once a
  block), and the runs end with the same model ids, poses within 5e-5 and
  surfel counts within 2 (that test's bounds).  Measured: poses and
  counts equal, bit for bit, on this CPU.
"""

import numpy as np
import pytest
import torch

from maskfusion_tpu_torch.camera import Resolution
from maskfusion_tpu_torch.config import Config
from maskfusion_tpu_torch.engine import MaskFusion
from maskfusion_tpu_torch.frame import FrameData
from maskfusion_tpu_torch.parallel.multimodel import (Block, ModelMesh,
                                                      shard_model_axis)
from tests import synthetic as syn
from tests.torch_helpers import tintr

CPU = torch.device("cpu")


def test_shard_model_axis_plan():
    mesh = ModelMesh(["cpu", "cpu"])
    assert mesh.shape == {"models": 2}
    assert shard_model_axis(mesh, "models", 8) == [Block(CPU, 0, 4),
                                                   Block(CPU, 4, 8)]
    assert shard_model_axis(mesh, "models", 2) == [Block(CPU, 0, 1),
                                                   Block(CPU, 1, 2)]
    # indivisible (7 % 2) and empty counts, no mesh, one device, another
    # axis: no split, as the JAX constraint's no-op cases
    assert shard_model_axis(mesh, "models", 7) is None
    assert shard_model_axis(mesh, "models", 0) is None
    assert shard_model_axis(None, "models", 8) is None
    assert shard_model_axis(ModelMesh(["cpu"]), "models", 8) is None
    assert shard_model_axis(mesh, "objects", 8) is None
    four = ModelMesh(["cpu"] * 4, axis="objects")
    assert [(b.start, b.stop) for b in shard_model_axis(four, "objects",
                                                        8)] == [
        (0, 2), (2, 4), (4, 6), (6, 8)]


def _frames():
    out = []
    for i in range(6):
        off = np.array([0.006 * max(0, i - 1), 0.0, 0.0])
        pts, cols, labels = syn.make_scene_with_two_objects(off1=off,
                                                            off2=-off)
        out.append(syn.render(pts, cols, np.eye(4, dtype=np.float32),
                              syn.DEFAULT_INTR, labels=labels))
    return out


@pytest.fixture(scope="module")
def frames():
    return _frames()


@pytest.fixture
def solves(monkeypatch):
    """The object slots of each batched solve (track_objects) called."""
    calls = []
    orig = MaskFusion.track_objects

    def counted(self, states, *a, **k):
        calls.append(len(states))
        return orig(self, states, *a, **k)

    monkeypatch.setattr(MaskFusion, "track_objects", counted)
    return calls


def _run(frames, mesh, fuse_mask_lag, solves):
    """tests/test_parallel.py's engine run (with the MaskFusion segmenter,
    whose device edge map the pipelined schedules need) and the object
    slots each batched solve took."""
    solves.clear()
    cfg = Config(global_surfel_capacity=1 << 16,
                 object_surfel_capacity=1 << 13, seg_method="maskfusion",
                 use_so3=False, model_spawn_offset=0,
                 pipelined_multiobject=True, fuse_mask_lag=fuse_mask_lag)
    eng = MaskFusion(Resolution(syn.W, syn.H), tintr(syn.DEFAULT_INTR), cfg,
                     device="cpu", mesh=mesh)
    for i, (rgb, depth, lab) in enumerate(frames):
        eng.process_frame(FrameData(rgb=rgb, depth=depth, mask=lab,
                                    class_ids=[0, 7, 8],
                                    timestamp=float(i)))
    eng.drain_pipeline()
    return eng, list(solves)


@pytest.mark.parametrize("fuse_mask_lag", [False, True],
                         ids=["exact", "prefused"])
def test_engine_model_axis_split_matches_unsplit(frames, fuse_mask_lag,
                                                 solves):
    ref, ref_solves = _run(frames, None, fuse_mask_lag, solves)
    eng, solves = _run(frames, ModelMesh(["cpu", "cpu"]), fuse_mask_lag,
                       solves)
    assert len(eng.models) >= 3      # global + 2 objects: the axis tiles
    assert eng._shard_model_axis(len(eng.models) - 1) is not None
    # two objects: one solve of both unsplit, one a block split
    assert ref_solves and set(ref_solves) == {2}
    assert solves == [1] * (2 * len(ref_solves))
    assert [m.model_id for m in eng.models] == \
        [m.model_id for m in ref.models]
    for mm, mr in zip(eng.models, ref.models):
        np.testing.assert_allclose(mm.state.pose.numpy(),
                                   mr.state.pose.numpy(), atol=5e-5)
        assert abs(mm.surfel_count - mr.surfel_count) <= 2
