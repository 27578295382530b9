"""MaskFusion's labeller (``model.matterport_coco_config``) on the CPU:
the port against the benchmark's plain reference (``mfbench/reference``)
on seeded weights with drawn FrozenBatchNorm statistics, the comparison
that decides the ``slam_nn_coco`` cell's ``correct`` refusing a network
without its normalisation or with a wrong NMS, the worker's spans and idle
time, and a tiny run of the cell's driver."""

import contextlib
import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from maskfusion_tpu_torch.frame import FrameData
from maskfusion_tpu_torch.maskrcnn import model as mm
from maskfusion_tpu_torch.maskrcnn.inference import (FrameQueue,
                                                     MaskRCNNInference,
                                                     MaskRCNNWorker)
from maskfusion_tpu_torch.maskrcnn.synthetic_shapes import micro_config
from maskfusion_tpu_torch.utils import stopwatch
from mfbench import harness
from mfbench.drivers import slam_nn_coco
from mfbench.drivers.slam_nn import no_host_init
from mfbench.drivers.train import program_config
from mfbench.reference import labeller
from mfbench.reference import maskrcnn as ref_mm
from mfbench.reference import network as ref_net
from mfbench.tests import tiny
from mfbench.tests.controls_nn_coco import no_bn, no_nms
from mfbench.traffic import bn_stats

CELL = "slam_nn_coco"
# the preset's every width but the FPN's and the heads', at 128 px: 4,092
# anchors, all of them under the 6,000-box pre-NMS limit
SMALL = dict(image_size=128, fpn_channels=32, box_head_dim=64,
             mask_head_channels=32, post_nms_proposals=64, max_detections=16,
             dtype=torch.float32)
# the port and the reference run the same float32 operations in the same
# order on the CPU: 1e-5 of the largest magnitude allows for another
# summation order inside a library call, and is 400x below what bfloat16
# rounding (4e-3) moves
REL = 1e-5
# boxes are normalised to [0, 1]: 1e-6 is a few float32 ulps of 1
BOX_ATOL = 1e-6


def small_net() -> dict:
    cfg = dataclasses.replace(mm.matterport_coco_config(), **SMALL)
    net = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    net["dtype"] = "float32"
    return net


@pytest.fixture(scope="module")
def labelled():
    """The seeded weights (kernels, then BatchNorm statistics drawn on the
    frame), the port's forward on a 96x128 frame, and the reference."""
    net = small_net()
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (96, 128, 3), dtype=np.uint8)
    w0 = slam_nn_coco.labeller_weights(net, rgb, 2 ** 33 + 5, "cpu")
    with no_host_init():
        inference = MaskRCNNInference(program_config(net), device="cpu")
    with torch.no_grad():
        for n, p in inference.model.named_parameters():
            p.copy_(w0[n])
    ref = ref_net.build(net, w0, device="cpu")
    return dict(net=net, w0=w0, rgb=rgb, inference=inference, ref=ref,
                out=inference.forward(rgb))


def _close(got, want, what):
    got, want = got.float(), want.float()
    assert got.shape == want.shape, what
    tol = REL * float(want.abs().max())
    assert float((got - want).abs().max()) <= tol, what


def test_the_preset_is_matterports_coco_model():
    cfg = mm.matterport_coco_config()
    assert (cfg.image_size, cfg.backbone_blocks, cfg.norm, cfg.num_classes,
            cfg.pre_nms_limit, cfg.post_nms_proposals, cfg.max_detections,
            cfg.rpn_nms_threshold, cfg.detection_nms_threshold,
            cfg.score_threshold, cfg.fpn_channels, cfg.box_head_dim,
            cfg.mask_head_channels, cfg.roi_pool_size, cfg.mask_pool_size,
            cfg.dtype) == (1024, (3, 4, 23, 3), "frozen_bn", 81, 6000, 1000,
                           100, 0.7, 0.3, 0.55, 256, 1024, 256, 7, 14,
                           torch.bfloat16)
    assert mm.matterport_coco_config(0.3).score_threshold == 0.3
    # the benchmark's configuration states what the preset builds
    config = harness.load_cell(CELL).config
    assert slam_nn_coco.program_network(config) == cfg


def test_drawn_statistics_are_not_the_identity(labelled):
    bn = {n: v for n, v in labelled["w0"].items()
          if n.rsplit(".", 1)[-1] in ("mean", "var", "scale", "bias")
          and "norm" in n}
    assert len(bn) == 4 * sum(isinstance(m, ref_mm.FrozenBatchNorm)
                              for m in labelled["ref"].modules())
    for n, v in bn.items():
        kind = n.rsplit(".", 1)[-1]
        assert torch.isfinite(v).all(), n
        if kind == "var":
            assert (v > 0).all() and float((v - 1).abs().min()) > 0, n
        if kind == "scale":             # a bottleneck's last norm damped
            damp = bn_stats.BRANCH_END_DAMP if n.endswith(
                bn_stats.BRANCH_END + ".scale") else 1.0
            assert 0.5 * damp <= float(v.min()), n
            assert float(v.max()) <= 1.5 * damp, n
        if kind in ("mean", "bias"):
            assert float(v.abs().max()) > 0, n


def test_the_labeller_matches_the_reference(labelled):
    out, ref = labelled["out"], labelled["ref"]
    img = torch.from_numpy(labelled["rgb"])
    from mfbench.reference.resize import resize_rgb_u8

    with torch.no_grad():
        want = ref(resize_rgb_u8(img, (128, 128)).float()[None])
    assert out["rpn_logits"].shape[1] == 4092
    for k in ("rpn_logits", "rpn_deltas", "class_logits", "mask_logits"):
        _close(out[k], want[k], k)
    for k in ("proposals", "detections"):
        assert float((out[k] - want[k]).abs().max()) <= BOX_ATOL, k
    for k in ("proposal_valid", "detection_valid", "detection_classes"):
        assert torch.equal(out[k], want[k]), k
    assert int(out["proposal_valid"].sum()) > 16
    _close(out["detection_scores"], want["detection_scores"],
           "detection_scores")
    # the outputs the reference forward does not return: the box deltas
    # at the proposals and the mask logits at the detection picks
    at = labeller.forward(ref, img, out["proposals"], out["pick_boxes"],
                          out["pick_classes"])
    _close(out["box_deltas"], at["box_deltas"], "box_deltas")
    _close(out["mask_logits"], at["mask_logits"], "mask_logits")
    gaps = labeller.compare(labeller.program_outputs(out), at)
    assert max(gaps.values()) <= REL
    # each NMS stage of the reference on the port's inputs to it
    assert labeller.nms_flips(ref, out) == {"proposal_flips": 0.0,
                                            "pick_flips": 0.0}


def test_the_check_refuses_a_labeller_without_batchnorm(labelled):
    limits = harness.load_cell(CELL).workload["limits"]
    img = torch.from_numpy(labelled["rgb"])
    inference = labelled["inference"]

    def gaps():
        out = inference.forward(labelled["rgb"])
        return labeller.compare(
            labeller.program_outputs(out),
            labeller.forward(labelled["ref"], img, out["proposals"],
                             out["pick_boxes"], out["pick_classes"]))

    good = gaps()
    assert all(good[k] <= limits[k] for k in slam_nn_coco.GAPS), good
    with no_bn():
        bad = gaps()
    assert any(bad[k] > limits[k] for k in slam_nn_coco.GAPS), bad


@contextlib.contextmanager
def nms_at(iou_threshold: float):
    """The port's NMS loops at another IoU threshold."""
    saved = mm.nms_fixed
    mm.nms_fixed = lambda boxes, scores, k, thr: saved(boxes, scores, k,
                                                        iou_threshold)
    try:
        yield
    finally:
        mm.nms_fixed = saved


@pytest.mark.parametrize("fault", ["top_k", "iou_0.5"])
def test_the_check_refuses_a_labeller_with_a_wrong_nms(labelled, fault):
    """Both NMS stages only feed the compared outputs: a top-k without
    suppression, or the wrong IoU threshold, moves no gap and must show in
    the flips."""
    limits = harness.load_cell(CELL).workload["limits"]
    with no_nms() if fault == "top_k" else nms_at(0.5):
        out = labelled["inference"].forward(labelled["rgb"])
    flips = labeller.nms_flips(labelled["ref"], out)
    assert set(flips) == set(slam_nn_coco.FLIPS)
    for k, v in flips.items():
        assert v > limits[k], (k, flips)


def _label_one(profiled: bool):
    """A micro labeller's worker labels one queued frame, with or without a
    profiler running on this thread; returns (the log, the worker)."""
    stopwatch.clear_log()
    inference = MaskRCNNInference(micro_config(64), device="cpu")
    queue = FrameQueue(4)
    rng = np.random.default_rng(1)
    queue.push(FrameData(rgb=rng.integers(0, 256, (48, 64, 3), np.uint8),
                         depth=np.full((48, 64), 1000, np.uint16)))

    def run():
        worker = MaskRCNNWorker(inference, queue)
        deadline = time.monotonic() + 60
        while worker.labelled < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.05)                     # idle: every frame labelled
        worker.stop()
        assert not worker.thread.is_alive()
        return worker

    if profiled:
        with profile(activities=[ProfilerActivity.CPU]):
            worker = run()
    else:
        worker = run()
    assert worker.labelled == 1
    return stopwatch.read_log(), worker


def test_worker_spans_enter_the_log_while_a_profiler_runs():
    log, worker = _label_one(profiled=True)
    label = [i for i, r in enumerate(log) if r["name"] == "label"]
    assert len(label) == 1
    root = log[label[0]]
    assert root["parent"] == -1 and root["tid"] == worker.thread.ident
    assert root["tid"] != threading.get_ident()
    inner = {r["name"]: r for r in log if r["parent"] == label[0]}
    assert set(inner) == {"label_features", "rpn_nms", "det_nms"}
    for r in inner.values():
        assert root["start_ns"] <= r["start_ns"] <= r["end_ns"] <= \
            root["end_ns"]
    assert worker.stopwatch.timings_ms["idle"] > 0


def test_worker_logs_nothing_without_a_profiler():
    log, worker = _label_one(profiled=False)
    assert log == [] and stopwatch.LOG.dropped == 0
    # the idle time is kept all the same, as a stopwatch aggregate
    assert worker.stopwatch.counts["idle"] >= 1
    assert worker.stopwatch.timings_ms["idle"] > 0


def test_tiny_run_of_the_cell_reaches_correct(tmp_path, monkeypatch):
    monkeypatch.setenv("MFBENCH_PATH", str(tmp_path))
    bench_path = tiny.make(tmp_path)
    bench = json.loads(bench_path.read_text())
    conf = json.loads((tmp_path / "configs" / "tiny_vga_nn.json")
                      .read_text())
    conf["name"] = "tiny_vga_nn_coco"
    conf["network"] = dict(tiny.micro_network(0.999), norm="frozen_bn")
    (tmp_path / "configs" / "tiny_vga_nn_coco.json").write_text(
        json.dumps(conf))
    w = harness.load_json(harness.HERE / "workloads" / f"{CELL}.json")
    w["traffic"].update(loop_frames=20,
                        intrinsics=[132.0, 132.0, 80.0, 60.0])
    (tmp_path / "workloads" / "tiny_nn_coco.json").write_text(json.dumps(w))
    entry = next(c for c in bench["configs"]
                 if c["name"] == "maskfusion_vga_nn")
    bench["configs"].append(dict(entry, name="tiny_vga_nn_coco",
                                 file="tiny_vga_nn_coco.json"))
    cell = next(c for c in bench["workloads"] if c["name"] == CELL)
    bench["workloads"].append(dict(cell, name="tiny_nn_coco",
                                   config="tiny_vga_nn_coco"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"] = m["workloads"] + ["tiny_nn_coco"]
    bench_path.write_text(json.dumps(bench))

    out = tiny.run("tiny_nn_coco", bench_path, seed=2 ** 35 + 3,
                   seconds=3.0, trace=True)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == set(w["limits"])
    mine = {m["name"] for m in bench["per_layer"]
            if "tiny_nn_coco" in m.get("workloads", [])}
    # the fuse graphs' hit share reads a counter that only a card's
    # graphed fuses record: on the CPU the fuse runs eagerly
    assert len(mine) == 9 and "fuse_graph_hit_pct" not in out["metrics"]
    assert mine - {"fuse_graph_hit_pct"} <= set(out["metrics"]), \
        out["metrics"]
    assert 0 <= out["metrics"]["nn_worker_idle_pct"]["value"] <= 100
    plain = tiny.run("tiny_nn_coco", bench_path, seed=2 ** 35 + 3,
                     seconds=2.0)
    assert plain["correct"] and set(plain["metrics"]) == {"slam_fps",
                                                          "setup_s"}
