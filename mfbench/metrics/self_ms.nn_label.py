"""Host time of a label outside its three inner spans (the RPN head, the
proposal sort, ROIAlign, the box and mask heads, the fetch and the id-image
paste): the mean self time of the program's whole ``label`` spans
(``MaskRCNNInference.execute``) in the traced frames, ms a label
(``mfbench.labeller_spans``)."""

from mfbench import labeller_spans


def read(ctx):
    return labeller_spans.mean_self_ms(ctx, "label")
