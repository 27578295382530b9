"""The controls of the output checks, run on the card at a cell's size.

    python3 -m mfbench.tests.controls <cell> <seconds> [--fault F] \
        [--controls N] [--window S] <seed> ...

For each seed, one run of the cell's driver in this process (a short
window at the cell's own load), with its control computed beside the
program's check on the first N seeds (all by default): the reference in
the next precision below the one the configuration states, put in the
program's place (for the SLAM frame's float32 with TF32 off: TF32 matmuls
and the other stages rounded through bfloat16; fp8 for the network's
bfloat16).  Prints one JSON line a seed: every number the program's check
computed, the control's, and whether each would pass the cell's limits.
``--window S`` (SLAM) ends each window after S seconds, the checked frames
drawn as in a run of ``<seconds>``: long enough to reach them is enough.
``--fault half_batch`` plants that fault in the training step first (the
batch's second half left out, the mean taken over the rest; its readings
are the program's numbers then), ``--fault half_batch_mean`` a subtler
one (every image's loss computed, the mean and so the gradient taken over
the first half); ``--fault f32`` runs the network in float32 instead of
the configuration's bfloat16 (a witness of what the precision alone
costs).
"""

from __future__ import annotations

import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from mfbench import harness  # noqa: E402

CONTROLS = {"slam": "low", "slam_nn": "fp8", "train": "fp8"}


def half_batch():
    """The training step's loss over the first half of the batch alone."""
    from maskfusion_tpu_torch.maskrcnn.model import MaskRCNN

    loss = MaskRCNN.batch_loss

    def half(self, images, *rest, **kw):
        n = images.shape[0] // 2
        return loss(self, images[:n], *(r[:n] if hasattr(r, "shape") else r
                                          for r in rest), **kw)

    MaskRCNN.batch_loss = half


def half_batch_mean():
    """The training step computes every image's loss and takes the mean
    (and so the gradient) over the first half of the batch alone."""
    import torch
    from maskfusion_tpu_torch.maskrcnn.model import MaskRCNN

    def half(self, images, gt_boxes, gt_classes, gt_valid, gt_masks, draws,
             full_loss=True):
        losses = [self.train_losses(images[b][None], gt_boxes[b],
                                    gt_classes[b], gt_valid[b], gt_masks[b],
                                    draws[b])["total"]
                  for b in range(images.shape[0])]
        return torch.stack(losses[:len(losses) // 2]).mean()

    MaskRCNN.batch_loss = half


FAULTS = {"half_batch": half_batch, "half_batch_mean": half_batch_mean}


def readings(cell_name: str, seeds, seconds: float, device="cuda",
             bench_path=None, fault=None, controls=None, window=None):
    """(program's numbers, control's numbers, control passes?) a seed; the
    control on the first ``controls`` seeds (all by default)."""
    cell = harness.load_cell(cell_name, bench_path)
    if fault in FAULTS:
        FAULTS[fault]()
    elif fault == "f32":
        cell.config["network"]["dtype"] = "float32"
    kind = cell.workload["driver"]
    driver = importlib.import_module(f"mfbench.drivers.{kind}")
    limits = cell.workload["limits"]
    out = []
    for i, seed in enumerate(seeds):
        ctrl_kind = CONTROLS[kind] if controls is None or i < controls \
            else None
        kw = {"window_seconds": window} if window else {}
        res = driver.run(cell, seed, seconds, False, device,
                         time.perf_counter(), control=ctrl_kind, **kw)
        prog = dict(res.values or {k: v for k, (v, _) in res.checks.items()})
        r = {"seed": seed, "program": prog, "program_correct": res.correct}
        if res.control is not None:
            ctrl = dict(res.control)
            r["control"] = ctrl
            r["control_passes"] = all(not (k in ctrl) or ctrl[k] <= limits[k]
                                      for k in limits)
        out.append(r)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opts = {}
    for flag in ("--fault", "--controls", "--window"):
        if flag in argv:
            i = argv.index(flag)
            opts[flag] = argv[i + 1]
            argv = argv[:i] + argv[i + 2:]
    cell, seconds, seeds = argv[0], float(argv[1]), [int(s) for s in argv[2:]]
    n = opts.get("--controls")
    w = opts.get("--window")
    for r in readings(cell, seeds, seconds, fault=opts.get("--fault"),
                      controls=None if n is None else int(n),
                      window=None if w is None else float(w)):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
