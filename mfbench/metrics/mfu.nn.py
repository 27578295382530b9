"""The network's share of the card's bf16 peak over the window: forward
operations (2 x the multiply-accumulates counted at set-up) times the
forwards that ran in the window, over the window's time."""

from mfbench import arith


def read(ctx):
    c = ctx.spans.counters
    if not c.get("nn_forward_macs") or ctx.window_s <= 0:
        return None
    flops = 2.0 * c["nn_forward_macs"] * len(ctx.spans.spans.get(
        "nn_forward", []))
    return 100.0 * flops / (ctx.window_s * arith.PEAK_BF16_S)
