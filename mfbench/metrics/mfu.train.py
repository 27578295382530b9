"""The training step's share of the card's bf16 peak over the window:
2 x 3 x the forward's multiply-accumulates (counted at set-up) a step,
times the steps of the window, over the window's time."""

from mfbench import arith


def read(ctx):
    c = ctx.spans.counters
    if not c.get("train_forward_macs") or ctx.window_s <= 0:
        return None
    flops = arith.train_step_flops(c["train_forward_macs"]) * ctx.units
    return 100.0 * flops / (ctx.window_s * arith.PEAK_BF16_S)
