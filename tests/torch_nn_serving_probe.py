"""The full-width Mask R-CNN's serving call on a CUDA card, on the host clock.

    PYTHONPATH=<tree> python tests/torch_nn_serving_probe.py [windows]

Builds the default MaskRCNNConfig (ResNet-50-FPN, 512 px, 81 classes, bf16)
from seeded weights on the card and prints one JSON line: the serving call
(MaskRCNNInference.detect on a seeded 640x480 frame, hot, 5 calls a window)
and each of the two fixed-k NMS loops alone at the forward's sizes, in ms
a call, median and windows, with the card's nvidia-smi name and power limit.
The tree on PYTHONPATH is the one timed: run two trees in turns (a, b, b, a)
to compare them on one card.  Needs a CUDA card; under half a minute.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np


def windows_ms(fn, windows: int, calls: int = 5):
    """Host ms a call of ``fn`` (which waits for its own result), a window
    of ``calls`` each, after one warm call."""
    fn()
    out = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) * 1e3 / calls)
    return float(np.median(out)), out


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from maskfusion_tpu_torch.maskrcnn import model as mm
    from maskfusion_tpu_torch.maskrcnn.inference import MaskRCNNInference

    windows = int(argv[0]) if argv else 5
    dev = torch.device("cuda")
    net = MaskRCNNInference(mm.MaskRCNNConfig(), seed=0, device=dev)
    cfg = net.cfg
    rgb = np.random.default_rng(30).integers(0, 256, (480, 640, 3),
                                             dtype=np.uint8)
    rec = {"serving": windows_ms(lambda: net.detect(rgb), windows)}
    g = torch.Generator(device=dev).manual_seed(0)
    n = cfg.pre_nms_limit
    corner = 0.8 * torch.rand(n, 2, device=dev, generator=g)
    boxes = torch.cat([corner, corner + 0.2 * torch.rand(
        n, 2, device=dev, generator=g)], 1)
    scores = torch.rand(n, device=dev, generator=g)
    for name, m, k, thr in (
            ("nms_rpn", n, cfg.post_nms_proposals, cfg.rpn_nms_threshold),
            ("nms_detections", cfg.post_nms_proposals, cfg.max_detections,
             cfg.detection_nms_threshold)):
        def nms():
            mm.nms_fixed(boxes[:m], scores[:m], k, thr)[1].cpu()
        rec[name] = windows_ms(nms, windows)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(json.dumps({k: {"ms": v[0], "windows_ms": v[1]}
                      for k, v in rec.items()} | {"device": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
