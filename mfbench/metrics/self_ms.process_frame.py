"""Host time of a frame under no named stage: the self time of the program's
spans ``process_frame`` (outside ``odom``, ``fuse``, ``host_stage`` and
every other span inside it), ms a traced frame (``mfbench.spans``)."""

from mfbench import spans


def read(ctx):
    return spans.self_ms(ctx, "process_frame")
