"""Host time of the labeller's proposal NMS (6000 boxes, 1000 picks): the
mean self time of the program's spans ``rpn_nms`` inside the whole
``label`` spans of the traced frames, ms a label
(``mfbench.labeller_spans``)."""

from mfbench import labeller_spans


def read(ctx):
    return labeller_spans.mean_self_ms(ctx, "rpn_nms")
