"""The controls of ``slam_nn_coco``'s output check, run on the card.

    python3 -m mfbench.tests.controls_nn_coco <seconds> \
        [--fault no_bn|no_nms] <seed> ...

For each seed, one run of the cell's driver in this process.  Without a
fault the control is computed beside the program's check: the reference
with its multiply-accumulate operands rounded to fp8, in the program's
place (the SLAM stages in TF32 and bfloat16, as ``controls.py`` has
them).  ``--fault no_bn`` plants a fault in the program instead: every
FrozenBatchNorm of the network is the identity; ``--fault no_nms``: both
NMS loops keep the top scores without suppressing any box.  A fault's
readings are the program's numbers.  Prints one JSON line a seed: every
number the program's check computed, the control's, and whether each
passes the cell's limits.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from mfbench import harness  # noqa: E402

CELL = "slam_nn_coco"


@contextlib.contextmanager
def no_bn():
    """The program's FrozenBatchNorm as the identity."""
    from maskfusion_tpu_torch.maskrcnn import model as mm

    saved = mm.FrozenBatchNorm.forward
    mm.FrozenBatchNorm.forward = lambda self, x: x
    try:
        yield
    finally:
        mm.FrozenBatchNorm.forward = saved


@contextlib.contextmanager
def no_nms():
    """The program's NMS as a top-k: the k highest scores, none
    suppressed."""
    from maskfusion_tpu_torch.maskrcnn import model as mm

    def top_k(boxes, scores, k, iou_threshold):
        idx = torch.topk(scores, k).indices
        return idx, scores[idx] > float("-inf")

    saved = mm.nms_fixed
    mm.nms_fixed = top_k
    try:
        yield
    finally:
        mm.nms_fixed = saved


FAULTS = {"no_bn": no_bn, "no_nms": no_nms}


def readings(seeds, seconds: float, fault=None):
    from mfbench.drivers import slam_nn_coco

    cell = harness.load_cell(CELL)
    limits = cell.workload["limits"]

    def passes(nums):
        return all(k not in nums or nums[k] <= lim
                   for k, lim in limits.items())

    out = []
    for seed in seeds:
        with FAULTS[fault]() if fault else contextlib.nullcontext():
            res = slam_nn_coco.run(
                cell, seed, seconds, False, "cuda", time.perf_counter(),
                control=None if fault else "fp8")
        r = {"seed": seed, "program": res.values,
             "program_correct": res.correct}
        if res.control is not None:
            r["control"] = res.control
            r["control_passes"] = passes(res.control)
        out.append(r)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    fault = None
    if "--fault" in argv:
        i = argv.index("--fault")
        fault = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    if fault is not None and fault not in FAULTS:
        raise SystemExit(f"unknown fault {fault!r}")
    seconds, seeds = float(argv[0]), [int(s) for s in argv[1:]]
    for r in readings(seeds, seconds, fault):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
