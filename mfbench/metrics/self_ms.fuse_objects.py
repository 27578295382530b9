"""Host time of the live object slots' fuse, clean and predict: the self time
of the program's spans ``fuse_objects`` (inside ``fuse``), ms a traced frame
(``mfbench.spans``)."""

from mfbench import spans


def read(ctx):
    return spans.self_ms(ctx, "fuse_objects")
