"""Host time of the labeller's detection NMS (1000 boxes, 100 picks): the
mean self time of the program's spans ``det_nms`` inside the whole
``label`` spans of the traced frames, ms a label
(``mfbench.labeller_spans``)."""

from mfbench import labeller_spans


def read(ctx):
    return labeller_spans.mean_self_ms(ctx, "det_nms")
