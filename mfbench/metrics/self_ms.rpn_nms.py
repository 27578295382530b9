"""Host time of the RPN proposals' NMS, every image of the step: the summed
durations of the program's spans ``rpn_nms``, ms a traced step
(``mfbench.spans``)."""

from mfbench import spans


def read(ctx):
    return spans.total_ms(ctx, ("rpn_nms",))
