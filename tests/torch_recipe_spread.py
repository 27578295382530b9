"""How far the shapes recipe's outcome spreads over seeds and runs.

    PYTHONPATH=. python tests/torch_recipe_spread.py {jax,cpu,cuda} \
        SEED [SEED ...] [--nondeterministic] [--steps 700]

Trains the shapes recipe (``synthetic_shapes.train_shapes``, 700 steps by
default) once for each seed, in the JAX package on the CPU (``jax``) or in
the port on the CPU or the card, and prints one JSON line a run: its
seconds, the mean of its first 10 and last 15 losses, and
``eval_shapes_detection``'s quality, with whether each of
tests/test_maskrcnn_train.py::test_shapes_checkpoint_quality's floors holds.
``--nondeterministic`` runs the port's recipe without torch's
deterministic algorithms (on the card, ROIAlign's backward then adds with
atomics, and one seed gives another network each run).  A run takes about
40-80 s on the card or on one CPU core.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

FLOORS = {"det_iou": 0.5, "cls_acc": 0.75, "mask_iou": 0.5,
          "mean_score": 0.55}


def main(argv=None) -> int:
    p = argparse.ArgumentParser("torch_recipe_spread")
    p.add_argument("where", choices=["jax", "cpu", "cuda"])
    p.add_argument("seeds", type=int, nargs="+")
    p.add_argument("--steps", type=int, default=700)
    p.add_argument("--nondeterministic", action="store_true")
    args = p.parse_args(argv)
    if args.where == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from maskfusion_tpu.maskrcnn import synthetic_shapes as ss

        def run(seed):
            params, losses = ss.train_shapes(args.steps, seed=seed)
            return losses, ss.eval_shapes_detection(params)
    else:
        import torch

        from maskfusion_tpu_torch.maskrcnn import synthetic_shapes as ss

        if args.nondeterministic:
            ss.torch.use_deterministic_algorithms = lambda *a, **k: None

        def run(seed):
            params, losses = ss.train_shapes(args.steps, seed=seed,
                                             device=args.where)
            return losses, ss.eval_shapes_detection(params,
                                                    device=args.where)

        if args.where == "cuda":
            from maskfusion_tpu_torch.bench import device_line

            print(device_line(torch.device("cuda")), flush=True)
    for seed in args.seeds:
        t0 = time.perf_counter()
        losses, q = run(seed)
        print(json.dumps({
            "where": args.where, "seed": seed,
            "deterministic": not args.nondeterministic,
            "seconds": time.perf_counter() - t0,
            "loss_first10": float(np.mean(losses[:10])),
            "loss_last15": float(np.mean(losses[-15:])), **q,
            "floors_held": all(q[k] >= v for k, v in FLOORS.items())}),
            flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
