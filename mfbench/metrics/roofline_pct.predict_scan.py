"""The level-0 scan's share of its roofline: the bound of each launch the
program recorded (the counter ``scan_live``: H, W, window, live texels,
live taps) summed, over the profiled time of the kernels whose name holds
``predict_l0_scan``, in %.  None unless the recorded launches are as many
as the profiled kernels.

A launch's bound is the larger of its operations over the FP32 peak and its
bytes over the memory peak (``arith.bound_record``): 10 operations a pixel
(its ray) and 27 a live tap (two dots, the divide, the hit, miss^2, r^2, 4
compares); every pixel's live byte and 8 output bytes, and pos, normal and
radius (28 B) of the live texels only.
"""

from mfbench import arith, spans

SCAN_OPS_PER_PIXEL = 10
SCAN_OPS_PER_LIVE_TAP = 27


def scan_bound_ms(v: dict) -> float:
    HW = v["H"] * v["W"]
    ops = SCAN_OPS_PER_PIXEL * HW + SCAN_OPS_PER_LIVE_TAP * v["live_taps"]
    nbytes = HW * (1 + 4 + 4) + v["live"] * (12 + 12 + 4)
    return arith.bound_record(ops, nbytes)["bound_ms"]


def read(ctx):
    if not ctx.profile:
        return None
    launches = spans.counters(spans.program_log(), "scan_live")
    hits = [v for k, v in ctx.profile["kernels"].items()
            if "predict_l0_scan" in k]
    us = sum(v["us"] for v in hits)
    if not launches or us <= 0 or sum(v["n"] for v in hits) != len(launches):
        return None
    bound_ms = sum(scan_bound_ms(r["values"]) for r in launches)
    return 100.0 * bound_ms * 1e3 / us
