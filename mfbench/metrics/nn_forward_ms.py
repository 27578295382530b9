"""The harness's span around ``MaskRCNNInference.execute`` on the worker
thread: host milliseconds a labelled frame, the mean over the window."""


def read(ctx):
    spans = ctx.spans.spans.get("nn_forward", [])
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) / len(spans)
