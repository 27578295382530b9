"""Host time of the global track: the self time of the program's spans
``track_global`` (inside the device stage's ``odom``), ms a traced frame
(``mfbench.spans``)."""

from mfbench import spans


def read(ctx):
    return spans.self_ms(ctx, "track_global")
