"""The edge map's bound (``arith.edge_bound``: 28 bytes a pixel, the
neighbour arithmetic on the valid interior pixels of the checked frames)
over the profiled mean time of the ``geometric_edge_map`` kernel, in %."""

from mfbench import arith, harness


def read(ctx):
    t = harness.kernel_mean_us(ctx, "geometric_edge_map")
    valid = ctx.spans.counters.get("edge_valid_inner")
    if not t or valid is None:
        return None
    W, H = ctx.cell.config["resolution"]
    return 100.0 * arith.edge_bound(H, W, valid)["bound_ms"] * 1e3 / t
