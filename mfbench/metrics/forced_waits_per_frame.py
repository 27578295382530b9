"""Host stages that found their frame's results not yet landed and waited
(the engine's ``forced_waits``), a window frame."""


def read(ctx):
    if "forced_waits" not in ctx.spans.counters or not ctx.units:
        return None
    return ctx.spans.counters["forced_waits"] / ctx.units
