"""The port's Mask R-CNN serving path on the CPU: the two resizes against
OpenCV, generate_id_image, the frame queue, the toml surface, the labelling
worker feeding the engine, a lockstep of and the offline runner.

tests/test_torch_nn_lockstep.py runs the two engines side by side on
frames the network labelled.  The networks here are the repository's
trained micro checkpoint
(``maskfusion_tpu/maskrcnn/checkpoints/shapes_micro_64.npz``) and, for the
offline runner, the full-width network with seeded random weights.
"""

import time

import numpy as np
import pytest
import torch

from maskfusion_tpu.maskrcnn import inference as jinf
from maskfusion_tpu_torch.camera import CameraIntrinsics, Resolution
from maskfusion_tpu_torch.config import Config
from maskfusion_tpu_torch.engine import MaskFusion
from maskfusion_tpu_torch.frame import FrameData
from maskfusion_tpu_torch.maskrcnn import checkpoint_io as tio
from maskfusion_tpu_torch.maskrcnn import inference as tinf
from maskfusion_tpu_torch.maskrcnn import model as tm
from maskfusion_tpu_torch.maskrcnn import synthetic_shapes as tss
from maskfusion_tpu_torch.maskrcnn.resize import (resize_mask_f32,
                                                  resize_rgb_u8)

MICRO = "maskfusion_tpu/maskrcnn/checkpoints/shapes_micro_64.npz"
S = 64


# ------------------------------------------------------------- resizes
RGB_SIZES = [((480, 640), (512, 512)), ((120, 160), (64, 64)),
             ((64, 64), (256, 256)), ((37, 100), (77, 51)),
             ((480, 640), (240, 320)), ((64, 64), (64, 64))]


@pytest.mark.parametrize("src,dst", RGB_SIZES)
def test_resize_rgb_matches_opencv(src, dst):
    """uint8 RGB against cv2.resize's INTER_LINEAR: within 1 everywhere and
    equal on at least 99% of the values (measured: 100% on every size
    here, the exact 2x downscale that OpenCV takes as INTER_AREA
    included)."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(sum(src + dst))
    for _ in range(2):
        img = rng.integers(0, 256, (*src, 3), dtype=np.uint8)
        ref = cv2.resize(img, (dst[1], dst[0])).astype(np.int32)
        got = resize_rgb_u8(torch.from_numpy(img),
                            (dst[1], dst[0])).numpy().astype(np.int32)
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1
        assert (got == ref).mean() >= 0.99
        assert (got == ref).all()            # the measured share: 100%


@pytest.mark.parametrize("w,h", [(14, 14), (1, 1), (5, 80), (300, 200),
                                 (28, 28), (13, 57), (56, 56)])
def test_resize_mask_matches_opencv(w, h):
    """float32 28x28 logits to a box's size against cv2.resize: within
    1e-5 of the largest magnitude (measured 1.5e-6 relative)."""
    cv2 = pytest.importorskip("cv2")
    m = np.random.default_rng(w * h).normal(0, 3, (28, 28)).astype(
        np.float32)
    ref = cv2.resize(m, (w, h))
    got = resize_mask_f32(m, (w, h))
    assert got.shape == ref.shape == (h, w)
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(m).max())


# --------------------------------------------- id image, queue, toml
def test_generate_id_image_matches_jax():
    """tests/test_maskrcnn.py::test_generate_id_image's case and random
    detections at 120x160, with a class filter: the same id image, class
    ids and ROIs as the JAX function (which pastes with cv2.resize)."""
    pytest.importorskip("cv2")
    H, W = 60, 80
    boxes = np.array([[0.1, 0.1, 0.5, 0.5], [0.4, 0.4, 0.9, 0.9],
                      [0.0, 0.0, 0.2, 0.2]])
    masks = np.ones((3, 28, 28), np.float32)
    classes, scores = np.array([7, 3, 5]), np.array([0.9, 0.8, 0.3])
    valid = np.array([True, True, True])
    t = tinf.generate_id_image(boxes, masks, classes, scores, valid, H, W)
    j = jinf.generate_id_image(boxes, masks, classes, scores, valid, H, W)
    np.testing.assert_array_equal(t[0], j[0])
    assert t[1:] == j[1:] and t[1] == [0, 7, 3]
    assert t[0][int(0.45 * H), int(0.45 * W)] == 1
    rng = np.random.default_rng(0)
    D = 20
    y1x1 = rng.uniform(0, 0.8, (D, 2))
    boxes = np.concatenate([y1x1, y1x1 + rng.uniform(0.01, 0.5, (D, 2))], 1)
    masks = rng.normal(0, 2, (D, 28, 28)).astype(np.float32)
    classes = rng.integers(1, 6, D)
    scores = rng.uniform(0, 1, D)
    valid = rng.uniform(0, 1, D) < 0.8
    for filt in (None, [1, 3]):
        t = tinf.generate_id_image(boxes, masks, classes, scores, valid,
                                   120, 160, 0.3, filt)
        j = jinf.generate_id_image(boxes, masks, classes, scores, valid,
                                   120, 160, 0.3, filt)
        np.testing.assert_array_equal(t[0], j[0])
        assert t[1:] == j[1:] and len(t[1]) > 2


def test_frame_queue_delay_semantics():
    """tests/test_maskrcnn.py::test_frame_queue_delay_semantics on the
    port's queue, and the end-of-stream flush."""
    q = tinf.FrameQueue(size=3)
    frames = [FrameData(rgb=np.zeros((4, 4, 3), np.uint8),
                        depth=np.zeros((4, 4), np.float32), index=i)
              for i in range(4)]
    q.push(frames[0])
    q.push(frames[1])
    assert q.pop_ready() is None           # unlabelled, queue not full
    assert q.newest_unlabelled() is frames[1]
    frames[0].mask = np.zeros((4, 4), np.uint8)
    assert q.pop_ready() is frames[0]      # labelled head pops
    q.push(frames[2])
    q.push(frames[3])
    assert q.pop_ready() is frames[1]      # queue full -> forced pop
    assert q.pop_ready() is None and len(q) == 2
    assert q.pop_ready(flush=True) is frames[2]
    assert q.pop_ready(flush=True) is frames[3]
    assert q.pop_ready(flush=True) is None and len(q) == 0


def test_load_toml_config_matches_jax(tmp_path):
    path = tmp_path / "config.toml"
    path.write_text('[MaskRCNN]\nscore_threshold = 0.7\n'
                    'filter_classes = [1, 62]\nclass_names = ["BG", "a"]\n'
                    '[ModelSpawning]\ntrackable_classes = [62]\n')
    assert tinf.load_toml_config(str(path)) == \
        jinf.load_toml_config(str(path))
    empty = tmp_path / "empty.toml"
    empty.write_text("")
    got = tinf.load_toml_config(str(empty))
    assert got == jinf.load_toml_config(str(empty))
    assert got["score_threshold"] == 0.55
    assert got["class_names"] == tinf.COCO_CLASS_NAMES


# ------------------------------------------------------ the device rule
def test_inference_needs_a_card_unless_cpu_is_asked():
    """No silent fallback: without a card the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tinf.MaskRCNNInference(tss.micro_config(S))


def test_worker_reports_a_failed_label():
    """An exception in the worker thread stops it and comes back from
    check() and stop(), not a silently unlabelled stream."""
    class Broken:
        def execute(self, frame):
            raise ValueError("broken network")

    q = tinf.FrameQueue(3)
    worker = tinf.MaskRCNNWorker(Broken(), q)
    q.push(FrameData(rgb=np.zeros((4, 4, 3), np.uint8),
                     depth=np.zeros((4, 4), np.float32)))
    worker.thread.join(timeout=30)
    assert not worker.thread.is_alive()
    with pytest.raises(RuntimeError, match="worker failed"):
        worker.check()
    with pytest.raises(RuntimeError, match="worker failed"):
        worker.stop()


# ------------------------------------------------ the network in the loop
def _scene(shaped: bool = False):
    """tests/test_engine_nn.py's static scene: a trained-domain shapes image;
    depth 2 m with the object's region raised to 1.5 m.  `shaped` curves
    both surfaces (a flat fronto-parallel patch leaves the object's
    in-plane translation unconstrained, so its pose wanders by centimetres
    in either package)."""
    rng = np.random.default_rng(3)
    img, _, _, _, masks = tss.make_shapes_scene(rng, S, max_objects=1)
    gt_mask = masks[0] > 0.5
    rgb = np.clip(img, 0, 255).astype(np.uint8)
    depth = np.where(gt_mask, 1.5, 2.0)
    if shaped:
        yy, xx = np.mgrid[:S, :S] / S
        depth = depth + np.where(
            gt_mask, 0.04 * np.sin(9 * xx) * np.cos(7 * yy),
            0.1 * np.sin(5 * xx + 1) * np.cos(4 * yy))
    return rgb, depth.astype(np.float32), gt_mask


NN_CFG = dict(global_surfel_capacity=1 << 15, object_surfel_capacity=1 << 12,
              seg_method="maskfusion", use_so3=False, model_spawn_offset=0,
              seg_min_new_rel=0.005)
INTR = (52.8, 52.8, 32.0, 32.0)


def test_engine_async_nn_spawns_object():
    """tests/test_engine_nn.py on the port (device='cpu'): frames with no
    masks go through the FrameQueue to the MaskRCNNWorker thread (the
    trained micro network) and into the engine (the Config default, the
    prefused schedule); the network's mask spawns an object whose
    segmentation overlaps the ground truth with IoU >= 0.4, and a label
    takes well under the 30-frame delay budget."""
    params, _ = tio.load_params(MICRO)
    rgb, depth, gt_mask = _scene()
    inference = tinf.MaskRCNNInference(tss.micro_config(S), params=params,
                                       device="cpu")
    queue = tinf.FrameQueue(size=30)
    worker = tinf.MaskRCNNWorker(inference, queue)
    eng = MaskFusion(Resolution(S, S), CameraIntrinsics(*INTR),
                     Config(**NN_CFG), device="cpu")
    try:
        waits = []
        for i in range(6):
            queue.push(FrameData(rgb=rgb.copy(), depth=depth.copy(),
                                 timestamp=float(i)))
            t0 = time.perf_counter()
            frame = None
            while frame is None and time.perf_counter() - t0 < 30:
                frame = queue.pop_ready()
                if frame is None:
                    time.sleep(0.005)
            assert frame is not None, "the worker never labelled the frame"
            waits.append(time.perf_counter() - t0)
            assert frame.mask is not None
            eng.process_frame(frame)
        eng.drain_pipeline()
    finally:
        worker.stop()
    assert worker.labelled >= 6
    assert len(eng.models) >= 2, [m.model_id for m in eng.models]
    obj = eng.models[1]
    assert obj.surfel_count > 10
    seg = eng.last_segmentation == obj.model_id
    iou = (seg & gt_mask).sum() / max((seg | gt_mask).sum(), 1)
    assert iou >= 0.4, f"segmentation IoU {iou:.2f}"
    assert max(waits[2:]) < 10.0, waits


# -------------------------------------------------------- offline runner
def test_offline_runner_writes_mask_files(tmp_path):
    """The -i/-o entry point on two colour images with the full-width
    network (seeded random weights, score threshold 0 so that detections
    exist): one Mask####.png (uint8 id image of the input's size) and one
    .txt (class ids, then one ROI a line) per image; the same weights
    written by flax as a .msgpack checkpoint give the same files."""
    cv2 = pytest.importorskip("cv2")
    from maskfusion_tpu_torch.maskrcnn import offline_runner

    src, out = tmp_path / "in", tmp_path / "out"
    src.mkdir()
    rng = np.random.default_rng(0)
    for i in (3, 4):
        cv2.imwrite(str(src / f"Color{i:04d}.png"),
                    rng.integers(0, 256, (60, 80, 3), dtype=np.uint8))
    assert offline_runner.main(["-i", str(src), "-o", str(out),
                                "--threshold", "0.0"], device="cpu") == 0
    for i in (3, 4):
        png = out / f"Mask{i:04d}.png"
        mask = cv2.imread(str(png), cv2.IMREAD_UNCHANGED)
        assert mask.shape == (60, 80) and mask.dtype == np.uint8
        lines = (out / f"Mask{i:04d}.png.txt").read_text().splitlines()
        classes = [int(c) for c in lines[0].split()]
        assert len(classes) == len(lines) - 1 == mask.max() >= 1
        for line in lines[1:]:
            y1, x1, y2, x2 = map(int, line.split())
            assert 0 <= y1 < y2 <= 60 and 0 <= x1 < x2 <= 80
    from flax import serialization

    from maskfusion_tpu_torch.convert import maskrcnn_flax_tree

    cfg = tm.MaskRCNNConfig()
    tree = maskrcnn_flax_tree(
        tm.init_params_(tm.MaskRCNN(cfg), 0).state_dict(), cfg)
    weights = tmp_path / "weights.msgpack"
    weights.write_bytes(serialization.msgpack_serialize(tree))
    out2 = tmp_path / "out2"
    assert offline_runner.main(["-i", str(src), "-o", str(out2),
                                "--threshold", "0.0", "--params",
                                str(weights)], device="cpu") == 0
    for name in ("Mask0003.png", "Mask0003.png.txt", "Mask0004.png",
                 "Mask0004.png.txt"):
        assert (out2 / name).read_bytes() == (out / name).read_bytes()
