"""The program's span log, as the per-layer readers read it.

While the harness's profiler runs (``harness.traced``: the traced frames or
steps), the program records its spans and counters in the log of
``maskfusion_tpu_torch.utils.stopwatch``; a reader imports that log once the
run is over.  A program without the log (one older than it) gives None, and
so does a reader whose spans are missing: the metric is left out.  The log
holds every profiled window of the process, and a run profiles one.

A record is a dict: ``kind`` ("span" or "counter"), ``name``, ``id`` (the
frame's tick or the step), ``start_ns``, ``end_ns``, ``parent`` (the index
of the span it opened inside, -1 for none), ``tid`` and ``values``.  A
span's self time is its duration minus the union of its direct children's
intervals (the part of it that no named stage inside it covers).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from mfbench import arith


def program_log() -> Optional[List[dict]]:
    """The program's records, or None where the program keeps no log."""
    try:
        from maskfusion_tpu_torch.utils import stopwatch
    except ImportError:
        return None
    read = getattr(stopwatch, "read_log", None)
    return read() if read is not None else None


def children(log: List[dict]) -> Dict[int, List[int]]:
    """Each span's direct children, by index."""
    kids: Dict[int, List[int]] = {}
    for i, r in enumerate(log):
        if r["kind"] == "span" and r["parent"] >= 0:
            kids.setdefault(r["parent"], []).append(i)
    return kids


def duration_ns(r: dict) -> int:
    return r["end_ns"] - r["start_ns"]


def self_ns(log: List[dict], i: int, kids: Dict[int, List[int]]) -> int:
    """Span ``i``'s duration minus the union of its direct children's
    intervals, each clipped to it."""
    r = log[i]
    s, e = r["start_ns"], r["end_ns"]
    inside = [(max(s, log[k]["start_ns"]), min(e, log[k]["end_ns"]))
              for k in kids.get(i, []) if log[k]["end_ns"] is not None]
    covered = sum(b - a for a, b in arith.merged(inside))
    return (e - s) - covered


def named(log: List[dict], names: Iterable[str]) -> List[int]:
    """The indices of the ended spans of these names."""
    names = set(names)
    return [i for i, r in enumerate(log) if r["kind"] == "span"
            and r["name"] in names and r["end_ns"] is not None]


def per_unit_ms(ctx, total_ns: float) -> Optional[float]:
    """``total_ns`` in ms a traced frame or step (the profile's units; the
    window's ``ctx.units`` counts the untraced frames)."""
    n = ctx.profile.get("units") if ctx.profile else None
    return total_ns * 1e-6 / n if n else None


def self_ms(ctx, name: str, log: Optional[List[dict]] = None
            ) -> Optional[float]:
    """The self time of the spans ``name`` in the traced window, ms a
    traced frame or step; None where there are none."""
    log = program_log() if log is None else log
    hits = named(log or [], [name])
    if not hits:
        return None
    kids = children(log)
    return per_unit_ms(ctx, sum(self_ns(log, i, kids) for i in hits))


def total_ms(ctx, names: Iterable[str], log: Optional[List[dict]] = None
             ) -> Optional[float]:
    """The summed durations of the spans of these names in the traced
    window, ms a traced frame or step; None where there are none."""
    log = program_log() if log is None else log
    hits = named(log or [], names)
    if not hits:
        return None
    return per_unit_ms(ctx, sum(duration_ns(log[i]) for i in hits))


def counters(log: Optional[List[dict]], name: str) -> List[dict]:
    return [r for r in log or [] if r["kind"] == "counter"
            and r["name"] == name]
