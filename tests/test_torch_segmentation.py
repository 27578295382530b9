"""Port parity of the segmentation package: MfSegmentation's label rules on
the cases of tests/test_mfseg_rules.py, MfSegmentation.perform on rendered
object frames, and PreSegmentation, each against the JAX package.

Both packages take their native library (mfcore) by default; the
comparisons on rendered frames force both onto their numpy paths (bincount
rules, scipy components) and ask for the same segmentation exactly
(tests/test_torch_mfcore.py holds native against native)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from maskfusion_tpu.camera import Resolution as JResolution
from maskfusion_tpu.config import Config as JConfig
from maskfusion_tpu.frame import FrameData as JFrameData
from maskfusion_tpu.ops import preprocess as jpp
from maskfusion_tpu.segmentation.mf_segmentation import (
    MfSegmentation as JMfSegmentation, ModelInfo as JModelInfo)
from maskfusion_tpu.segmentation.pre_segmentation import (
    PreSegmentation as JPreSegmentation)
from maskfusion_tpu_torch.camera import CameraIntrinsics, Resolution
from maskfusion_tpu_torch.config import Config
from maskfusion_tpu_torch.frame import FrameData
from maskfusion_tpu_torch.segmentation import create_segmenter
from maskfusion_tpu_torch.segmentation.cf_segmentation import CfSegmentation
from maskfusion_tpu_torch.segmentation.mf_segmentation import (
    MfSegmentation, ModelInfo)
from maskfusion_tpu_torch.segmentation.pre_segmentation import (
    PreSegmentation)
from tests import synthetic as syn
from tests import test_mfseg_rules as rules
from tests.torch_helpers import numpy_paths, t, tintr


@pytest.fixture()
def jax_numpy_path():
    """Both packages' numpy paths (the JAX module's native library unloaded,
    the port's disabled), restored afterwards."""
    with numpy_paths():
        yield


# ---------------------------------------------------------------- rules
@pytest.fixture()
def port_seg():
    """The port's segmenter with the configuration of the rules' fixture."""
    cfg = Config(seg_method="maskfusion", seg_min_mapped_component_size=8,
                 seg_edge_reassign_iters=0)
    return MfSegmentation(cfg, Resolution(rules.S, rules.S),
                          CameraIntrinsics(52.8, 52.8, 32.0, 32.0))


@pytest.mark.parametrize("case", [
    "test_065_rule_strict_inequality",
    "test_two_masks_cannot_both_claim",
    "test_small_component_never_mapped",
    "test_leftover_06_rule_tracks_projection",
    "test_person_class_becomes_ignore",
    "test_depth_stats_match_masked_moments",
])
def test_mfseg_rules_on_the_port(port_seg, case):
    """The six boundary cases of tests/test_mfseg_rules.py, run as written
    with the port's segmenter in place of the JAX one."""
    getattr(rules, case)(port_seg)


# ------------------------------------------------------- perform parity
def _frame(i: int):
    """Frame i of a two-object scene whose objects drift apart."""
    o1 = np.array([0.006 * i, 0.0, 0.0])
    o2 = np.array([0.0, -0.006 * i, 0.0])
    pts, cols, labels = syn.make_scene_with_two_objects(o1, o2)
    return syn.render(pts, cols, np.eye(4, dtype=np.float32),
                      syn.DEFAULT_INTR, labels=labels)


SCENARIOS = {
    # (config overrides, live models (id, class), projected-id source,
    #  next id, allow_new)
    "spawn_first": ({}, [(0, 0)], None, 1, True),
    "match_and_spawn": ({}, [(0, 0), (1, 7)], 1, 2, True),
    "both_tracked": ({}, [(0, 0), (1, 7), (2, 8)], "both", 3, True),
    "no_new_allowed": ({}, [(0, 0)], None, 1, False),
    "class_mismatch": ({}, [(0, 0), (1, 9)], 1, 2, True),
    "morphology": (dict(seg_morph_edge_iterations=1,
                        seg_morph_mask_iterations=1),
                   [(0, 0), (1, 7)], 1, 2, True),
    "person_mask": (dict(person_class_id=8), [(0, 0)], None, 1, True),
}


def _projected_ids(lab, source):
    """A projected-id image: the labels of `source` shifted by a few pixels,
    as a model rendered one frame late projects."""
    ids = np.zeros_like(lab)
    shifted = np.roll(lab, (2, 3), axis=(0, 1))
    if source == 1:
        ids[shifted == 1] = 1
    elif source == "both":
        ids[shifted == 1] = 1
        ids[shifted == 2] = 2
    return ids


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_perform_matches_jax(jax_numpy_path, name):
    """perform on a rendered two-object frame, each package running its
    own edge map from the same vertex and normal maps: the same
    segmentation, the same new-label decision and the same model data."""
    overrides, models, source, next_id, allow_new = SCENARIOS[name]
    rgb, depth, lab = _frame(1)
    vmap = jpp.create_vmap(jnp.asarray(depth), syn.DEFAULT_INTR, 5.0)
    nmap = jpp.create_nmap(vmap)
    vmap, nmap = np.asarray(vmap), np.asarray(nmap)
    ids = _projected_ids(lab, source)
    class_ids = [0, 7, 8]
    res = JResolution(syn.W, syn.H)
    jseg = JMfSegmentation(JConfig(seg_method="maskfusion", **overrides),
                           res, syn.DEFAULT_INTR)
    tseg = MfSegmentation(Config(seg_method="maskfusion", **overrides),
                          Resolution(syn.W, syn.H), tintr(syn.DEFAULT_INTR))
    jr = jseg.perform(
        JFrameData(rgb=rgb, depth=depth, mask=lab, class_ids=class_ids),
        jnp.asarray(vmap), jnp.asarray(nmap), ids,
        [JModelInfo(m, c) for m, c in models], next_id, allow_new)
    tr = tseg.perform(
        FrameData(rgb=rgb, depth=depth, mask=lab, class_ids=class_ids),
        t(vmap), t(nmap), ids, [ModelInfo(m, c) for m, c in models],
        next_id, allow_new)
    np.testing.assert_array_equal(tr.full_segmentation, jr.full_segmentation)
    assert tr.has_new_label == jr.has_new_label
    assert tr.new_model_class_id == jr.new_model_class_id
    assert len(tr.model_data) == len(jr.model_data)
    for a, b in zip(tr.model_data, jr.model_data):
        assert (a.model_id, a.is_empty, a.pixel_count, a.class_id) == \
            (b.model_id, b.is_empty, b.pixel_count, b.class_id)
        assert a.depth_mean == pytest.approx(b.depth_mean, abs=1e-6)
        assert a.depth_std == pytest.approx(b.depth_std, abs=1e-6)
    # the scenario exercises what its name says
    if name == "spawn_first":
        assert tr.has_new_label and (tr.full_segmentation == 1).sum() > 300
    if name == "both_tracked":
        assert not tr.has_new_label
        assert {1, 2} <= set(np.unique(tr.full_segmentation))
    if name == "person_mask":
        assert (tr.full_segmentation == 255).any()


# ---------------------------------------------------------- precomputed
def test_pre_segmentation_matches_jax():
    """PreSegmentation over a sequence: first-seen labels spawn one at a
    time, the label->model mapping persists, ignore labels stay 255, a
    deactivated model's label is re-offered, and remap_new_label redirects
    a label."""
    rgb, depth, lab = _frame(0)
    lab = lab.copy()
    lab[:4, :] = 255
    cfg_j, cfg_t = JConfig(seg_method="precomputed"), \
        Config(seg_method="precomputed")
    jseg, tseg = JPreSegmentation(cfg_j), PreSegmentation(cfg_t)
    steps = [
        # (live models, next id, allow_new, remap (tentative, actual))
        ([(0, 0)], 1, True, None),
        ([(0, 0), (1, 7)], 2, True, None),
        ([(0, 0), (1, 7), (2, 8)], 3, True, None),
        ([(0, 0), (2, 8)], 3, False, None),      # model 1 gone: re-offer
        ([(0, 0), (2, 8)], 3, True, (3, 5)),
        ([(0, 0), (2, 8), (5, 7)], 6, True, None),
    ]
    for models, next_id, allow_new, remap in steps:
        jr = jseg.perform(JFrameData(rgb=rgb, depth=depth, mask=lab,
                                     class_ids=[0, 7, 8]),
                          None, None, None,
                          [JModelInfo(m, c) for m, c in models], next_id,
                          allow_new)
        tr = tseg.perform(FrameData(rgb=rgb, depth=depth, mask=lab,
                                    class_ids=[0, 7, 8]),
                          None, None, None,
                          [ModelInfo(m, c) for m, c in models], next_id,
                          allow_new)
        np.testing.assert_array_equal(tr.full_segmentation,
                                      jr.full_segmentation)
        assert tr.has_new_label == jr.has_new_label
        assert [vars(m) for m in tr.model_data] == \
            [vars(m) for m in jr.model_data]
        if remap is not None:
            jseg.remap_new_label(*remap)
            tseg.remap_new_label(*remap)
        assert tseg.label_to_model == jseg.label_to_model
    assert (tr.full_segmentation[:4] == 255).all()


def test_create_segmenter():
    cfg = Config()
    res, intr = Resolution(syn.W, syn.H), tintr(syn.DEFAULT_INTR)
    assert isinstance(create_segmenter("maskfusion", cfg, res, intr),
                      MfSegmentation)
    assert isinstance(create_segmenter("precomputed", cfg, res, intr),
                      PreSegmentation)
    seg = create_segmenter("cofusion", cfg, res, intr, device="cpu")
    assert isinstance(seg, CfSegmentation) and seg.wants_model_views
    assert seg.device == torch.device("cpu")
    assert not hasattr(seg, "edge_binary")   # no pipelined schedule
    with pytest.raises(ValueError):
        create_segmenter("nonsense", cfg, res, intr)
