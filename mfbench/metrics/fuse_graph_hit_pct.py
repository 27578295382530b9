"""How often a model's fuse, clean and predict replays a CUDA graph it
already had: of the graphed fuses in the traced frames (the program's
counter ``fuse_graph``, one a model's pass), the share that replayed a
graph captured before it, in %.  A pass that meets a new key (a bucket
step, a new window size, the first gate) captures its graph first and
counts as a miss.  None where the program records no such counter (a
program without the fuse graphs)."""

from mfbench import spans


def read(ctx):
    calls = spans.counters(spans.program_log(), "fuse_graph")
    if not calls:
        return None
    hits = sum(1 for r in calls if not r["values"].get("captured"))
    return 100.0 * hits / len(calls)
