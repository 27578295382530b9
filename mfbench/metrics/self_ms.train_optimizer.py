"""Host time of the training step's update (the gradient averaging and Adam):
the summed durations of the program's spans ``optimizer``, ms a traced step
(``mfbench.spans``)."""

from mfbench import spans


def read(ctx):
    return spans.total_ms(ctx, ("optimizer",))
