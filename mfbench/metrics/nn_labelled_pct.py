"""Frames of the window that left the delay queue labelled, over the
frames pushed, in %."""


def read(ctx):
    c = ctx.spans.counters
    if not c.get("nn_pushed"):
        return None
    return 100.0 * c["nn_labelled"] / c["nn_pushed"]
