"""Host time of the objects' warm start and batched solve: the self time of the
program's spans ``track_objects`` (inside ``odom``), ms a traced frame
(``mfbench.spans``)."""

from mfbench import spans


def read(ctx):
    return spans.self_ms(ctx, "track_objects")
