"""Model redetection in the port (Config.enable_redetection): the fern
model matcher of tests/test_tools.py, and the reactivation scenario of
tests/test_engine_multimodel.py run on the port and on the JAX engine in
the synchronous schedule (the precomputed segmenter, as the JAX test runs
it; the prefused schedule is tests/test_torch_redetection_pipelined.py's).
Both engines must reactivate the same model id, with the same live ids
after every frame."""

import numpy as np
import pytest

from maskfusion_tpu.camera import Resolution as JResolution
from maskfusion_tpu.config import Config as JConfig
from maskfusion_tpu.engine import MaskFusion as JMaskFusion
from maskfusion_tpu.frame import FrameData as JFrameData
from maskfusion_tpu.mapping.model_matching import \
    FernModelMatcher as JMatcher
from maskfusion_tpu_torch.camera import Resolution
from maskfusion_tpu_torch.config import Config
from maskfusion_tpu_torch.engine import MaskFusion
from maskfusion_tpu_torch.frame import FrameData
from maskfusion_tpu_torch.mapping.model_matching import FernModelMatcher
from tests import synthetic as syn
from tests.torch_helpers import CPU, numpy_paths, tintr, \
    wait_for_jax_pending

BASE = dict(global_surfel_capacity=1 << 16, object_surfel_capacity=1 << 13,
            use_so3=False, open_loop=True, enable_redetection=True,
            keep_all_models=True, model_spawn_offset=0)
SCHEDULES = {
    "sync": dict(seg_method="precomputed"),
    "prefused": dict(seg_method="maskfusion", pipelined_multiobject=True,
                     fuse_mask_lag=True),
}


def test_fern_model_matcher():
    """tests/test_tools.py's matcher case on both packages: model 1's
    prediction is found in the frame, with the same confidence."""

    class FakeState:
        pass

    class FakeModel:
        def __init__(self, mid, img):
            self.model_id = mid
            self.state = FakeState()
            self.state.pred_rgb = img
            self.state.pose = np.eye(4)

    rng = np.random.default_rng(0)
    img_a = rng.uniform(0, 255, (40, 40, 3)).astype(np.float32)
    img_b = rng.uniform(0, 255, (40, 40, 3)).astype(np.float32)
    models = [FakeModel(1, img_a), FakeModel(2, img_b)]
    results = []
    for cls, frame_cls in ((FernModelMatcher, FrameData),
                           (JMatcher, JFrameData)):
        matcher = cls()
        assert all(matcher.build_model_description(m) for m in models)
        frame = frame_cls(rgb=img_a.astype(np.uint8),
                          depth=np.ones((40, 40), np.float32))
        res = matcher.detect_in_region(frame, (0, 0, 40, 40), models)
        assert res is not None and res.model_id == 1
        results.append(res)
    assert results[0].confidence == results[1].confidence
    np.testing.assert_array_equal(results[0].pose, results[1].pose)
    # a region holding neither model is not matched
    blank = FrameData(rgb=np.zeros((40, 40, 3), np.uint8),
                      depth=np.ones((40, 40), np.float32))
    assert FernModelMatcher().detect_in_region(
        blank, (0, 0, 40, 40), models) is None


def run_redetection(eng, frame_cls, jax_engine: bool):
    """Three frames of the one-object scene (the object spawns), the
    object made inactive as a tracking jump would, three more frames.
    Returns the reactivated model's old id and the live ids after each
    frame (each frame's host stage finished: drained)."""
    def frame(i):
        pts, cols, labels = syn.make_scene_with_object()
        rgb, depth, lab = syn.render(pts, cols, np.eye(4, dtype=np.float32),
                                     syn.DEFAULT_INTR, labels=labels)
        if jax_engine:
            wait_for_jax_pending(eng)
        eng.process_frame(frame_cls(rgb=rgb, depth=depth, mask=lab,
                                    class_ids=[0, 7], timestamp=float(i)))
        eng.drain_pipeline()
        return [m.model_id for m in eng.models]

    ids = [frame(i) for i in range(3)]
    assert len(eng.models) == 2
    obj = eng.models[1]
    eng._inactivate_model(obj, "test")
    assert obj in eng.inactive_models and len(eng.models) == 1
    ids += [frame(i) for i in range(3, 6)]
    assert obj not in eng.inactive_models
    return obj.model_id, ids


def jax_run(schedule: str):
    fields = {**BASE, **SCHEDULES[schedule]}
    with numpy_paths():
        eng = JMaskFusion(JResolution(syn.W, syn.H), syn.DEFAULT_INTR,
                          JConfig(**fields))
        out = run_redetection(eng, JFrameData, True)
    return schedule, fields, out


@pytest.fixture(scope="module")
def jax_redetection():
    return jax_run("sync")


def test_redetection_reactivates_inactive_model(jax_redetection):
    """A deactivated object that reappears is reactivated instead of
    spawning a new model, in the same frame and under the same id as in the
    JAX engine (the synchronous schedule here; the prefused one in
    tests/test_torch_redetection_pipelined.py)."""
    check_redetection(*jax_redetection)


def check_redetection(schedule, fields, jax_out):
    jold, jids = jax_out
    with numpy_paths():
        eng = MaskFusion(Resolution(syn.W, syn.H), tintr(syn.DEFAULT_INTR),
                         Config(**fields), device=CPU)
        old, ids = run_redetection(eng, FrameData, False)
    assert old in ids[-1], f"model {old} not reactivated (models {ids})"
    assert (old, ids) == (jold, jids)
    assert eng._pipelined_active == (schedule == "prefused")
    # the reactivated model kept its map
    assert eng.models[1].surfel_count > 50
