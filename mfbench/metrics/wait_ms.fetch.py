"""Host time spent waiting on the card's results in the host stages: the
summed durations of the program's spans ``fetch`` and ``fetch_ids``, ms a
traced frame (``mfbench.spans``)."""

from mfbench import spans


def read(ctx):
    return spans.total_ms(ctx, ("fetch", "fetch_ids"))
