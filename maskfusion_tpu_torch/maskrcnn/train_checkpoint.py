"""Train a shapes-domain Mask R-CNN with the repository's recipes and save
its checkpoint.

    python -m maskfusion_tpu_torch.maskrcnn.train_checkpoint shapes \
        [--steps 700] [--size 64] [--seed 0] [--cpu] [--out PATH]
    python -m maskfusion_tpu_torch.maskrcnn.train_checkpoint rich \
        [--steps 1500] [--size 256] [--seed 0] [--cpu] [--out PATH]

The port's counterpart of ``scripts/train_shapes_checkpoint.py`` and
``scripts/train_rich_checkpoint.py``, with their flags and defaults: the
recipe (``synthetic_shapes.train_shapes`` / ``train_rich``) on the first
CUDA card (``--cpu`` for smoke runs), then the held-out evaluation, whose
quality dict goes into the checkpoint's ``meta``.  The file is the
repository's float16 .npz of the flax-named tree (``checkpoint_io``),
which the JAX package's ``checkpoint_io.load_params`` reads as well.
``--out`` defaults under ``build/checkpoints/``: the committed checkpoints
in ``maskfusion_tpu/maskrcnn/checkpoints/`` are never overwritten by
default.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

RECIPES = {
    # domain: (default steps, default size, checkpoint name, meta domain)
    "shapes": (700, 64, "shapes_micro_64.npz", "synthetic_shapes"),
    "rich": (1500, 256, "shapes_rich_256.npz", "synthetic_shapes_rich"),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser("train_checkpoint")
    p.add_argument("domain", choices=sorted(RECIPES))
    p.add_argument("--steps", type=int)
    p.add_argument("--size", type=int)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--out", help="checkpoint path (default: "
                   "build/checkpoints/<the committed file's name>)")
    args = p.parse_args(argv)
    steps0, size0, name, domain = RECIPES[args.domain]
    steps = args.steps if args.steps is not None else steps0
    size = args.size if args.size is not None else size0
    out = args.out or os.path.join(ROOT, "build", "checkpoints", name)

    from maskfusion_tpu_torch.maskrcnn import checkpoint_io
    from maskfusion_tpu_torch.maskrcnn import synthetic_shapes as ss

    device = "cpu" if args.cpu else None
    t0 = time.perf_counter()
    if args.domain == "shapes":
        params, losses = ss.train_shapes(steps, size, args.seed,
                                         log_every=100, device=device)
        quality = ss.eval_shapes_detection(params, size, device=device)
    else:
        params, losses = ss.train_rich(steps, size, args.seed,
                                       log_every=100, device=device)
        quality = ss.eval_rich_detection(params, size, device=device)
    print(f"trained {steps} steps in {time.perf_counter() - t0:.0f}s",
          flush=True)
    print("quality:", quality, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    checkpoint_io.save_params(out, params, meta={
        "domain": domain, "image_size": size, "steps": steps,
        "seed": args.seed, **quality})
    print("wrote", out, os.path.getsize(out) / 1e6, "MB", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
