"""Parity of the port's Co-Fusion segmentation (maskfusion_tpu_torch.ops.
slic, segmentation.cf_segmentation) with the JAX package's on the CPU.

SLIC's segment sums differ in their last bits (the JAX package takes
differences of one float32 cumsum, the port scatter-adds), so an
assignment on a knife edge can flip.  Measured on the scenes below: at
most 1.04e-4 of the pixels change superpixel (on uniform noise; none on
the rendered scenes), colour means of the superpixels with equal members
within 1.9e-3 (of 0..255), positions and counts equal.  Held: 1e-3 of the
pixels, colour means within 5e-3, positions within 1e-4, counts equal.
Given equal superpixels, the CRF (within 1e-5) and the post-processing
(exactly) are held without slack.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskfusion_tpu.camera import Resolution as JResolution
from maskfusion_tpu.config import Config as JConfig
from maskfusion_tpu.frame import FrameData as JFrameData
from maskfusion_tpu.ops import slic as jslic
from maskfusion_tpu.segmentation import cf_segmentation as jcf
from maskfusion_tpu_torch.camera import Resolution
from maskfusion_tpu_torch.config import Config
from maskfusion_tpu_torch.engine import MaskFusion
from maskfusion_tpu_torch.frame import FrameData
from maskfusion_tpu_torch.ops import slic as tslic
from maskfusion_tpu_torch.segmentation import cf_segmentation as tcf
from tests import synthetic as syn
from tests.torch_helpers import CPU, numpy_paths, tintr


def _images():
    pts, cols = syn.make_scene()
    scene = syn.render(pts, cols, np.eye(4), syn.DEFAULT_INTR)[0]
    pts, cols, lab = syn.make_scene_with_two_objects(
        np.array([0.01, 0.0, 0.0]), np.zeros(3))
    two = syn.render(pts, cols, np.eye(4), syn.DEFAULT_INTR, labels=lab)[0]
    noise = np.random.default_rng(0).integers(0, 256, (syn.H, syn.W, 3),
                                              dtype=np.uint8)
    return {"scene": scene, "two_objects": two, "noise": noise}


@pytest.mark.parametrize("iterations", [3, 4])
@pytest.mark.parametrize("image", ["scene", "two_objects", "noise"])
def test_slic_matches_jax(image, iterations):
    rgb = _images()[image]
    a = jslic.slic(jnp.asarray(rgb), spacing=16, iterations=iterations)
    b = tslic.slic(torch.from_numpy(rgb), spacing=16, iterations=iterations)
    assert b.grid_hw == a.grid_hw
    la, lb = np.asarray(a.labels), b.labels.numpy()
    assert (la != lb).mean() <= 1e-3
    n = a.grid_hw[0] * a.grid_hw[1]
    same = np.array([np.array_equal(la == k, lb == k) for k in range(n)])
    assert same.mean() >= 0.9
    np.testing.assert_allclose(b.mean_rgb.numpy()[same],
                               np.asarray(a.mean_rgb)[same], atol=5e-3)
    np.testing.assert_allclose(b.mean_pos.numpy()[same],
                               np.asarray(a.mean_pos)[same], atol=1e-4)
    np.testing.assert_array_equal(b.counts.numpy()[same],
                                  np.asarray(a.counts)[same])


def test_downsample_upsample_match_jax():
    """Per-superpixel means over the finite pixels (NaN and inf holes
    skipped), of (H, W) and (H, W, C) maps, on the same labels: within
    3e-5 (the JAX package's cumsum rounding: measured 1.07e-5 on depths of
    0.5-3 m, 9e-8 on the unit normal map); a constant map comes back
    constant."""
    rgb = _images()["two_objects"]
    labels = np.array(jslic.slic(jnp.asarray(rgb)).labels)
    n = (syn.H // 16) * (syn.W // 16)
    rng = np.random.default_rng(1)
    depth = rng.uniform(0.5, 3.0, (syn.H, syn.W)).astype(np.float32)
    depth[rng.random((syn.H, syn.W)) < 0.2] = np.nan
    depth[:5, :5] = np.inf
    vmap = rng.normal(0, 1, (syn.H, syn.W, 3)).astype(np.float32)
    for values in (depth, vmap):
        a = np.asarray(jslic.downsample(jnp.asarray(values),
                                        jnp.asarray(labels), n))
        b = tslic.downsample(torch.from_numpy(values),
                             torch.from_numpy(labels).long(), n).numpy()
        np.testing.assert_allclose(b, a, atol=3e-5)
    low = tslic.downsample(torch.full((syn.H, syn.W), 3.5),
                           torch.from_numpy(labels).long(), n)
    up = tslic.upsample(low, torch.from_numpy(labels).long())
    np.testing.assert_allclose(up.numpy(), 3.5, atol=1e-5)


def test_dense_crf_matches_jax():
    """tests/test_cfseg.py's noisy two-halves unaries: the marginals within
    1e-5 of the JAX package's, and its accuracy assertions on the port's."""
    rng = np.random.default_rng(0)
    gh, gw = 12, 16
    n = gh * gw
    yy, xx = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
    true = (xx > gw // 2).astype(int).reshape(-1)
    unary = np.zeros((2, n), np.float32)
    noise = rng.normal(0, 1.2, n)
    unary[0] = np.where(true == 0, 0.2, 2.0) + noise
    unary[1] = np.where(true == 1, 0.2, 2.0) - noise
    pos = np.stack([yy.reshape(-1), xx.reshape(-1)], -1).astype(np.float32)
    feats_app = np.concatenate([pos * 0.3, np.zeros((n, 1))], 1).astype(
        np.float32)
    qj = np.asarray(jcf.dense_crf_meanfield(
        jnp.asarray(unary), jnp.asarray(feats_app), jnp.asarray(pos / 2.0),
        3.0, 2.0, 8))
    qt = tcf.dense_crf_meanfield(
        torch.from_numpy(unary), torch.from_numpy(feats_app),
        torch.from_numpy(pos / 2.0), 3.0, 2.0, 8).numpy()
    np.testing.assert_allclose(qt, qj, atol=1e-5)
    pred = qt.argmax(0)
    crf_acc = (pred == true).mean()
    assert crf_acc > (np.argmin(unary, 0) == true).mean()
    assert crf_acc > 0.9


class _Model:
    model_id = 0
    class_id = -1


def _misaligned_scene():
    """tests/test_cfseg.py::test_cfsegmentation_segments_misaligned_object's
    scene and views: the background model errs on the object."""
    pts, cols, labels = syn.make_scene_with_object(
        offset=np.array([0.04, 0, 0]))
    rgb, depth, lab = syn.render(pts, cols, np.eye(4), syn.DEFAULT_INTR,
                                 labels=labels)
    err = np.where(lab == 1, 0.5, 0.001).astype(np.float32)
    conf = np.ones((syn.H, syn.W), np.float32)
    return rgb, depth, lab, [{"error": err, "conf": conf}]


def _perform_both(rgb, depth, views, allow_new=True, ids=None):
    ids = np.zeros((syn.H, syn.W), np.uint8) if ids is None else ids
    jseg = jcf.CfSegmentation(JConfig(seg_method="cofusion"),
                              JResolution(syn.W, syn.H), syn.DEFAULT_INTR)
    tseg = tcf.CfSegmentation(Config(seg_method="cofusion"),
                              Resolution(syn.W, syn.H),
                              tintr(syn.DEFAULT_INTR), device=CPU)
    with numpy_paths():
        rj = jseg.perform(JFrameData(rgb=rgb, depth=depth), None, None, ids,
                          [_Model()], 1, allow_new, model_views=views)
        rt = tseg.perform(FrameData(rgb=rgb, depth=depth), None, None, ids,
                          [_Model()], 1, allow_new, model_views=views)
    return rj, rt


def _assert_results_equal(rj, rt):
    np.testing.assert_array_equal(rt.full_segmentation, rj.full_segmentation)
    assert rt.has_new_label == rj.has_new_label
    assert [vars(m) for m in rt.model_data] == \
        [vars(m) for m in rj.model_data]


def test_cfsegmentation_matches_jax():
    """The misaligned-object scene, with model views and without (the
    projected-id fallback), as uint16 millimetres too: the same
    segmentation and model data as the JAX package's, and the JAX test's
    IoU with the object."""
    rgb, depth, lab, views = _misaligned_scene()
    rj, rt = _perform_both(rgb, depth, views)
    _assert_results_equal(rj, rt)
    assert rt.has_new_label
    out = rt.full_segmentation
    iou = ((out == 1) & (lab == 1)).sum() / max(((out == 1) | (lab == 1))
                                                 .sum(), 1)
    assert iou > 0.5, f"cofusion IoU {iou}"
    depth_mm = np.round(depth * 1000).astype(np.uint16)
    _assert_results_equal(*_perform_both(rgb, depth_mm, views))
    ids = np.where(lab == 1, 0, 1).astype(np.uint8)   # the object unowned
    _assert_results_equal(*_perform_both(rgb, depth, None, ids=ids))
    _assert_results_equal(*_perform_both(rgb, depth, views, allow_new=False))


def test_cfsegmentation_exact_given_superpixels(monkeypatch):
    """With the JAX package's superpixels handed to the port, the unaries,
    the CRF's labels and the post-processing give the JAX result exactly,
    on a scene with two unexplained objects."""
    real_slic = jslic.slic

    def jax_slic(rgb, spacing=16, iterations=4, compactness=0.1):
        s = real_slic(jnp.asarray(rgb.numpy()), spacing, iterations,
                      compactness)
        return tslic.SlicResult(
            torch.from_numpy(np.array(s.labels)).long(), s.grid_hw,
            *(torch.from_numpy(np.array(a)) for a in
              (s.mean_rgb, s.mean_pos, s.counts)))

    monkeypatch.setattr(tslic, "slic", jax_slic)
    pts, cols, labels = syn.make_scene_with_two_objects(
        np.array([0.03, 0, 0]), np.array([0, -0.03, 0]))
    rgb, depth, lab = syn.render(pts, cols, np.eye(4), syn.DEFAULT_INTR,
                                 labels=labels)
    err = np.where(lab > 0, 0.4, 0.002).astype(np.float32)
    err[::7] = np.nan
    conf = (np.random.default_rng(3).random((syn.H, syn.W)) < 0.9).astype(
        np.float32)
    rj, rt = _perform_both(rgb, depth, [{"error": err, "conf": conf}])
    _assert_results_equal(rj, rt)
    assert rt.has_new_label


def test_pipelined_config_runs_the_synchronous_frame(monkeypatch):
    """Co-Fusion under the Config default pipelined_multiobject=True: the
    port, as the JAX engine (engine.py:1147-1153), runs the synchronous
    frame, because only the maskfusion segmenter has the device edge map;
    every frame's segmentation comes back at once."""
    def pipelined(*args, **kwargs):
        raise AssertionError("Co-Fusion took the pipelined step")

    eng = MaskFusion(Resolution(syn.W, syn.H), tintr(syn.DEFAULT_INTR),
                     Config(seg_method="cofusion",
                            global_surfel_capacity=1 << 16,
                            object_surfel_capacity=1 << 13),
                     device=CPU)
    assert eng.cfg.pipelined_multiobject
    monkeypatch.setattr(eng, "_pipelined_step", pipelined)
    pts, cols, labels = syn.make_scene_with_two_objects()
    rgb, depth, _ = syn.render(pts, cols, np.eye(4), syn.DEFAULT_INTR,
                               labels=labels)
    for i in range(3):
        out = eng.process_frame(FrameData(rgb=rgb, depth=depth,
                                          timestamp=float(i)))
        assert out["n_models"] == len(eng.models) == 1
        if i:
            assert eng.last_segmentation.shape == (syn.H, syn.W)
            assert not eng._pending
