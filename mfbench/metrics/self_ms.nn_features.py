"""Host time of the labeller's backbone and FPN (``MaskRCNN.features``): the
mean self time of the program's spans ``label_features`` inside the whole
``label`` spans of the traced frames, ms a label
(``mfbench.labeller_spans``)."""

from mfbench import labeller_spans


def read(ctx):
    return labeller_spans.mean_self_ms(ctx, "label_features")
