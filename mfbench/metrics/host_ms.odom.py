"""The engine's stopwatch scope ``odom``: host milliseconds, the mean
over the window's calls."""


def read(ctx):
    c = ctx.spans.counters
    n = c.get("stopwatch.odom.n", 0)
    return c["stopwatch.odom.ms"] / n if n else None
