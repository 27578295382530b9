"""The engine's stopwatch scope ``segmentation``: host milliseconds, the mean
over the window's calls."""


def read(ctx):
    c = ctx.spans.counters
    n = c.get("stopwatch.segmentation.n", 0)
    return c["stopwatch.segmentation.ms"] / n if n else None
