"""Host time of the training step's forward (the batch loss) outside the RPN's
NMS: the self time of the program's spans ``forward``, ms a traced step
(``mfbench.spans``)."""

from mfbench import spans


def read(ctx):
    return spans.self_ms(ctx, "forward")
