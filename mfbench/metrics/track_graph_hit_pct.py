"""How often the tracking solve replays a CUDA graph it already had: of
the graphed solves in the traced frames (the program's counter
``track_graph``, one a solve), the share that replayed a graph captured
before it, in %.  A solve that meets a new shape captures its graph first
and counts as a miss.  None where the program records no such counter
(a program without the graphs)."""

from mfbench import spans


def read(ctx):
    calls = spans.counters(spans.program_log(), "track_graph")
    if not calls:
        return None
    hits = sum(1 for r in calls if not r["values"].get("captured"))
    return 100.0 * hits / len(calls)
