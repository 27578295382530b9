"""The share of the window in which the labelling worker waited with every
queued frame labelled: the worker's stopwatch aggregate ``idle`` over the
window, in %.  None where the program's worker keeps no such aggregate."""


def read(ctx):
    idle = ctx.spans.counters.get("nn_worker_idle_ms")
    if idle is None or ctx.window_s <= 0:
        return None
    return 100.0 * idle / (1e3 * ctx.window_s)
