"""The labeller's spans in the program's log, as its readers read them.

``MaskRCNNInference.execute`` is the span ``label``, the root on the
worker's thread; ``label_features`` (the backbone and FPN), ``rpn_nms`` and
``det_nms`` open inside it.  A ``label`` span is whole when it closed
before the traced frames ended (the driver's ``profile["end_ns"]``): the
profiler records only spans that open while it runs, so a whole span and
every span inside it were recorded.  Readers average over whole spans, and
give None where there is none (a program without these spans).
"""

from __future__ import annotations

from typing import List, Optional

from mfbench import spans


def whole_labels(ctx):
    """(the log, the indices of the whole ``label`` spans)."""
    log = spans.program_log() or []
    end = ctx.profile.get("end_ns") if ctx.profile else None
    if end is None:
        return log, []
    return log, [i for i in spans.named(log, ["label"])
                 if log[i]["parent"] == -1 and log[i]["end_ns"] <= end]


def mean_self_ms(ctx, name: str) -> Optional[float]:
    """The mean self time of the spans ``name`` inside whole ``label``
    spans (``label`` itself: the whole ones), in ms."""
    log, labels = whole_labels(ctx)
    roots = set(labels)

    def root(i: int) -> int:
        while log[i]["parent"] >= 0:
            i = log[i]["parent"]
        return i

    hits: List[int] = [i for i in spans.named(log, [name])
                       if root(i) in roots]
    if not hits:
        return None
    kids = spans.children(log)
    return sum(spans.self_ns(log, i, kids) for i in hits) * 1e-6 / len(hits)
