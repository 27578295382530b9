"""The bilateral filter's bound (``arith.bilateral_bound`` at the frame's
size and the engine's radius) over the profiled mean time of the
``bilateral_depth`` kernel, in %."""

from mfbench import arith, harness


def read(ctx):
    t = harness.kernel_mean_us(ctx, "bilateral_depth")
    if not t:
        return None
    W, H = ctx.cell.config["resolution"]
    R = max(1, int(round(ctx.cell.config["engine"]["bilateral_radius"]
                         * W / 640.0)))
    return 100.0 * arith.bilateral_bound(H, W, R)["bound_ms"] * 1e3 / t
