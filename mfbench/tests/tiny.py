"""Tiny copies of the benchmark's cells, for tests on the CPU.

``make(tmp)`` writes, into directory ``tmp``, configurations and workloads
derived from the real ones (the same engine and traffic settings; 160x120
frames, small maps, the micro network) and a ``BENCHMARK.json`` that names
them beside the real cells, and returns that file's path.  Point
``MFBENCH_PATH`` at ``tmp`` so that the harness finds them.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path

from mfbench import harness

CELLS = {"tiny_slam": ("slam_two_objects", "tiny_vga"),
         "tiny_train": ("train_b8_1024", "tiny_r50"),
         "tiny_nn": ("slam_nn_labelled", "tiny_vga_nn")}


def micro_network(score_threshold: float) -> dict:
    net = {"num_classes": 3, "image_size": 64,
           "anchor_scales": [8, 16, 32, 64, 128], "anchor_ratios": [1.0],
           "pre_nms_limit": 128, "post_nms_proposals": 32,
           "max_detections": 4, "roi_pool_size": 7, "mask_pool_size": 7,
           "fpn_channels": 32, "box_head_dim": 64, "mask_head_channels": 32,
           "backbone_blocks": [1, 1, 1, 1], "train_rois": 16,
           "roi_positive_ratio": 0.5, "score_threshold": score_threshold,
           "rpn_positive_iou": 0.5, "dtype": "float32"}
    return net


def make(tmp) -> Path:
    tmp = Path(tmp)
    (tmp / "configs").mkdir(parents=True, exist_ok=True)
    (tmp / "workloads").mkdir(parents=True, exist_ok=True)
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    vga = harness.load_json(harness.HERE / "configs" / "maskfusion_vga.json")
    r50 = harness.load_json(harness.HERE / "configs" /
                            "maskrcnn_r50_fpn.json")
    tv = copy.deepcopy(vga)
    tv["resolution"] = [160, 120]
    tv["engine"].update(global_surfel_capacity=1 << 16,
                        object_surfel_capacity=1 << 14, object_window=104,
                        object_window_margin=24)
    tvn = copy.deepcopy(tv)
    tvn["network"] = micro_network(0.999)
    tvn["frame_queue"] = 5
    tr = copy.deepcopy(r50)
    tr["network"] = micro_network(0.0)
    tr["batch"] = 2
    configs = {"tiny_vga": tv, "tiny_vga_nn": tvn, "tiny_r50": tr}
    for name, c in configs.items():
        c["name"] = name
        (tmp / "configs" / f"{name}.json").write_text(json.dumps(c))
    for cell, (real, conf) in CELLS.items():
        w = harness.load_json(harness.HERE / "workloads" / f"{real}.json")
        t = w["traffic"]
        if "loop_frames" in t:
            t["loop_frames"] = 20
        if "trace_frames" in t:
            t["trace_frames"] = 1
        if "intrinsics" in t:
            t["intrinsics"] = [132.0, 132.0, 80.0, 60.0]
        if w["driver"] == "train":
            t.update(max_instances=4, min_side=0.2, max_side=0.45,
                     trace_steps=1)
        (tmp / "workloads" / f"{cell}.json").write_text(json.dumps(w))
        entry = next(e for e in bench["workloads"] if e["name"] == real) \
            if any(e["name"] == real for e in bench["workloads"]) else \
            {"traffic": real, "chips": 1, "why": "tiny"}
        bench["workloads"].append(dict(entry, name=cell, config=conf))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real in m.get("workloads", []):
                m["workloads"].append(cell)
    for name in configs:
        base = "maskrcnn_r50_fpn" if name == "tiny_r50" else "maskfusion_vga"
        entry = next(c for c in bench["configs"] if c["name"] == base)
        bench["configs"].append(dict(entry, name=name, file=f"{name}.json"))
    path = tmp / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


def run(cell: str, bench_path, seed: int = 1, seconds: float = 3.0,
        trace: bool = False) -> dict:
    """One run of a tiny cell on the CPU through ``run.run_cell``."""
    import time

    from mfbench import run as run_mod

    c = harness.load_cell(cell, bench_path)
    return run_mod.run_cell(c, seed, seconds, trace, "cpu",
                            time.perf_counter())


if __name__ == "__main__":      # python -m mfbench.tests.tiny <dir> <cell>
    import os
    import sys

    os.environ["MFBENCH_PATH"] = sys.argv[1]
    p = make(sys.argv[1])
    out = run(sys.argv[2], p, trace=len(sys.argv) > 3)
    print(json.dumps(out))
    print(json.dumps(harness.forbidden_loaded()))
