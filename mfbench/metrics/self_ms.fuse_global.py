"""Host time of the global model's fuse, clean and predict: the self time of
the program's spans ``fuse_global`` (inside ``fuse``), ms a traced frame
(``mfbench.spans``)."""

from mfbench import spans


def read(ctx):
    return spans.self_ms(ctx, "fuse_global")
