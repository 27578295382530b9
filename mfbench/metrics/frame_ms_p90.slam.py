"""The 90th percentile of the time between successive ``process_frame``
returns in the window (the harness's ``frame`` span), in ms."""

from mfbench import harness


def read(ctx):
    spans = ctx.spans.spans.get("frame", [])
    if len(spans) < 10:
        return None
    return harness.quantile([(b - a) * 1e3 for a, b in spans], 9, 10)
