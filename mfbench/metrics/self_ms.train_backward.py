"""Host time of the training step's backward (``zero_grad`` and
``loss.backward``): the summed durations of the program's spans
``backward``, ms a traced step (``mfbench.spans``)."""

from mfbench import spans


def read(ctx):
    return spans.total_ms(ctx, ("backward",))
