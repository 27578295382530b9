"""The benchmark's yardstick: published peaks, kernel bounds, the network's
multiply-accumulates and the device's busy time as a union of intervals.

Frozen copies of the arithmetic of ``chip_smoke.py`` (``bilateral_bound``,
``edge_bound``, ``bound_record``, ``network_macs`` and the train step's
``3 x forward``), so that a later change to the program cannot move the
yardstick it is measured with.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Tuple

# NVIDIA H100 SXM, published dense peaks (data sheet, 700 W)
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_BF16_S = 989e12

BILATERAL_OPS_PER_TAP = 9   # 2 sub/mul for the range term, 2 for space and
                            # sum, exp, 1 mul + 2 adds of the accumulation
EDGE_OPS_PER_NEIGHBOUR = 17  # side: 3 sub, 3 mul, 2 add; concavity: 3 mul,
                             # 2 add, 1 sub; the gate, |side|, 2 maxima
EDGE_OPS_PER_PIXEL = 8 * EDGE_OPS_PER_NEIGHBOUR + 3   # 2 weights, the clamp


def bound_record(ops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the operations
    over the FP32 rate and the bytes over the memory rate."""
    t_ops = ops / PEAK_FP32_S * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": nbytes}


def bilateral_bound(H: int, W: int, R: int) -> dict:
    """The bilateral filter's taps inside the image, each of
    ``BILATERAL_OPS_PER_TAP`` operations; the depth read and written once."""
    taps_y = sum(min(y + R, H - 1) - max(y - R, 0) + 1 for y in range(H))
    taps_x = sum(min(x + R, W - 1) - max(x - R, 0) + 1 for x in range(W))
    return bound_record(BILATERAL_OPS_PER_TAP * taps_y * taps_x, H * W * 4 * 2)


def edge_bound(H: int, W: int, valid_inner: int) -> dict:
    """Each map read once (24 B a pixel), the output written once (4 B); the
    neighbour arithmetic on the ``valid_inner`` valid interior pixels."""
    return bound_record(EDGE_OPS_PER_PIXEL * valid_inner, H * W * (24 + 4))


def network_macs(model, run: Callable[[], object], classes) -> Dict[str, int]:
    """Multiply-accumulates of the network's layers while ``run()`` calls
    it, by part, from the shapes each conv, dense and transposed-conv layer
    sees (forward hooks).  ``classes`` is (Conv, Dense, ConvTranspose2x2) of
    the network's module; the parts are its attributes ``backbone``,
    ``rpn``, ``box_head`` and ``mask_head``."""
    import torch

    conv, dense, deconv = classes
    macs = {"backbone": 0, "rpn": 0, "box_head": 0, "mask_head": 0}
    hooks = []

    def hook(part):
        def count(mod, inp, out):
            w = mod.weight
            if isinstance(mod, dense):
                n = out.numel() * w.shape[1]
            elif isinstance(mod, deconv):
                n = inp[0].numel() * w.shape[1] * 4
            else:
                n = out.numel() * w[0].numel()
            macs[part] += n
        return count

    for part in macs:
        for mod in getattr(model, part).modules():
            if isinstance(mod, (conv, dense, deconv)):
                hooks.append(mod.register_forward_hook(hook(part)))
    try:
        with torch.no_grad():
            run()
    finally:
        for h in hooks:
            h.remove()
    return macs


def train_step_flops(forward_macs: float) -> float:
    """A training step's operations: the forward, and a backward of twice
    the forward's multiply-accumulates, two operations each."""
    return 2.0 * 3.0 * forward_macs


def merged(intervals: Iterable[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals as sorted disjoint intervals:
    time that two streams cover at once counts once."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def gaps(busy: List[Tuple[float, float]], start: float,
         end: float) -> List[Tuple[float, float]]:
    """The idle intervals of [start, end) between the merged busy ones."""
    out, t = [], start
    for s, e in busy:
        s, e = max(s, start), min(e, end)
        if e <= s:
            continue
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if end > t:
        out.append((t, end))
    return out
