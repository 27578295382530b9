"""Per-stage wall-time telemetry, and the port's span log.

``Stopwatch`` is the equivalent of the reference Stopwatch singleton
(Core/Utils/Stopwatch.h:64-170): named TICK/TOCK sections aggregated per
name, and the 30 FPS frameskip governor's decision input
(MainController.cpp:487-489).  Copy of ``maskfusion_tpu/utils/stopwatch.py``
for the PyTorch port, without its UDP export: the reference broadcasts its
sections every ~10 s to 127.0.0.1:45454 for ElasticFusion's external
viewer, a program that is not part of this system, and no caller of either
package turned the export on.  Scopes read the host's wall clock, so on a
card they time the host's dispatch of the work, not the device's execution
of it (no scope synchronises).

The span log.  While a torch profiler is active in the process
(``torch.profiler.profile``, with CPU activity, CUDA activity or both,
started on any thread), every ``Stopwatch.scope`` and every ``span`` on
any thread (the Mask R-CNN worker's too) appends one record to a
process-wide log, and ``count`` appends a counter; at any other time
nothing is recorded and a span costs one check.  A record holds its kind,
name, frame or step id (a span without one takes its parent's), start and
end in ns of ``time.time_ns()`` -- the clock the profiler stamps its host
events with (``_KinetoEvent.start_ns()``), so a span brackets the
operations and CUDA runtime calls it issued --, the index of the span it
opened inside (-1: none), the thread id and, for a counter, its values,
which may be device tensors: they are read by ``read_log``, after the run, so
recording never waits on the device.  The log keeps at most ``LOG_CAP``
records and counts the ones it had to drop.

Work replayed as a CUDA graph (tracking/graphs) runs no Python, so its
host-side records are taken by the replays: while a graph captures a
function on a thread (``noting``), each ``count`` and each ``replayed``
action of that function is noted instead of taken, and every replay of the
graph takes it with the replay's values of its device tensors.  While the
graph's eager warm-up runs (``warming_up``) ``replayed`` actions are not
taken: a kernel wrapper's launch count counts the launches the program
asks for, not the warm-up's extra one, which ``count`` records (the
profiler sees it).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

LOG_CAP = 1_000_000
SPAN, COUNTER = "span", "counter"
# a record: [kind, name, id, start_ns, end_ns, parent, thread id, values]
KIND, NAME, ID, START, END, PARENT, TID, VALUES = range(8)


class SpanLog:
    """The records of the spans and counters taken while a profiler ran."""

    def __init__(self, cap: int = LOG_CAP):
        self.cap = cap
        self.records: List[list] = []
        self.dropped = 0
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> List[int]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _append(self, kind: str, name: str, id_, start: int, end,
                parent: int, values: dict) -> Optional[int]:
        if id_ is None and 0 <= parent < len(self.records):
            id_ = self.records[parent][ID]
        with self._lock:
            if len(self.records) >= self.cap:
                self.dropped += 1
                return None
            self.records.append([kind, name, id_, start, end, parent,
                                 threading.get_ident(), values])
            return len(self.records) - 1

    def open(self, name: str, id_=None) -> Optional[int]:
        """Start a span inside the thread's innermost open one; returns
        its index for ``close`` (None: the log is full)."""
        t = time.time_ns()
        st = self._stack()
        idx = self._append(SPAN, name, id_, t, None, st[-1] if st else -1,
                           {})
        if idx is not None:
            st.append(idx)
        return idx

    def close(self, idx: Optional[int]) -> None:
        if idx is None:
            return
        self.records[idx][END] = time.time_ns()
        st = self._stack()
        if idx in st:
            del st[st.index(idx):]

    def since(self, name: str, id_, start_ns: int) -> None:
        """A span that started at ``start_ns`` and ends now, outside the
        nesting of the open spans (it may cross frames)."""
        self._append(SPAN, name, id_, start_ns, time.time_ns(), -1, {})

    def count(self, name: str, id_=None, values=None) -> None:
        st = self._stack()
        t = time.time_ns()
        self._append(COUNTER, name, id_, t, t, st[-1] if st else -1,
                     values or {})

    def read(self) -> List[dict]:
        """The records as dicts, each tensor value read as a number (or a
        list of them)."""
        out = []
        for r in list(self.records):
            values = {k: (v.tolist() if hasattr(v, "tolist") else v)
                      for k, v in r[VALUES].items()}
            out.append({"kind": r[KIND], "name": r[NAME], "id": r[ID],
                        "start_ns": r[START], "end_ns": r[END],
                        "parent": r[PARENT], "tid": r[TID],
                        "values": values})
        return out

    def clear(self) -> None:
        with self._lock:
            self.records.clear()
            self.dropped = 0
            self._local = threading.local()


LOG = SpanLog()

# what a CUDA graph capture on this thread is doing: ``warm`` while its
# eager warm-up runs, ``noted`` (a list) while it captures
_GRAPH = threading.local()


@contextlib.contextmanager
def warming_up():
    """While a graph's eager warm-up runs on this thread."""
    _GRAPH.warm = True
    try:
        yield
    finally:
        _GRAPH.warm = False


@contextlib.contextmanager
def noting():
    """While a graph captures on this thread: yields the list of the
    records the captured work notes, (action, device tensors) pairs that
    each replay takes as ``action(**tensors)``."""
    noted = _GRAPH.noted = []
    try:
        yield noted
    finally:
        _GRAPH.noted = None


def in_graph_capture() -> bool:
    """Whether a graph's warm-up or capture runs on this thread."""
    return (getattr(_GRAPH, "warm", False)
            or getattr(_GRAPH, "noted", None) is not None)


def replayed(action: Callable[..., None], **tensors) -> None:
    """Takes a host-side record of device work: ``action(**tensors)`` now;
    while a graph captures on this thread, at each of its replays; never
    for a graph's warm-up."""
    noted = getattr(_GRAPH, "noted", None)
    if noted is not None:
        noted.append((action, tensors))
    elif not getattr(_GRAPH, "warm", False):
        action(**tensors)


def recording() -> bool:
    """Whether a torch profiler runs in this process.  The profiler's
    own check (``_profiler_enabled``) sees it only on the thread that
    started it; ``torch.autograd.profiler`` keeps this process-wide flag
    for such fast checks, set while a profile runs."""
    return _profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "id", "idx")

    def __init__(self, name: str, id_):
        self.name, self.id = name, id_

    def __enter__(self):
        self.idx = LOG.open(self.name, self.id)
        return self

    def __exit__(self, *exc):
        LOG.close(self.idx)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, id_=None):
    """A context manager that records a span of ``name`` for frame or step
    ``id_`` (None: its parent's) while a profiler runs, and does nothing
    otherwise."""
    if not recording():
        return _OFF
    return _Span(name, id_)


def span_since(name: str, id_, start_ns: int) -> None:
    """Records the span from ``start_ns`` (``time.time_ns()``) to now while
    a profiler runs."""
    if recording():
        LOG.since(name, id_, start_ns)


def count(name: str, id_=None, **values) -> None:
    """Records a counter while a profiler runs; values may be device
    tensors, read when the log is read.  Counted inside a graph's capture,
    it is recorded by each replay instead (``noting``)."""
    noted = getattr(_GRAPH, "noted", None)
    if noted is not None:
        tensors = {k: v for k, v in values.items()
                   if isinstance(v, torch.Tensor)}
        fixed = {k: v for k, v in values.items() if k not in tensors}
        noted.append((lambda **t: count(name, id_, **fixed, **t), tensors))
    elif recording():
        LOG.count(name, id_, values)


def read_log() -> List[dict]:
    """Every record taken so far (``SpanLog.read``)."""
    return LOG.read()


def clear_log() -> None:
    LOG.clear()


class Stopwatch:
    def __init__(self):
        self.timings_ms: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.last_ms: Dict[str, float] = {}

    @contextlib.contextmanager
    def scope(self, name: str):
        """Adds the block's host time to ``name``'s aggregate, and records
        it as a span of the log while a profiler runs."""
        idx = LOG.open(name) if recording() else None
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, (time.perf_counter() - t0) * 1000.0)
            LOG.close(idx)

    def record(self, name: str, ms: float):
        self.timings_ms[name] += ms
        self.counts[name] += 1
        self.last_ms[name] = ms

    def mean_ms(self, name: str) -> float:
        c = self.counts.get(name, 0)
        return self.timings_ms[name] / c if c else 0.0

    def summary(self) -> Dict[str, float]:
        return {k: self.mean_ms(k) for k in self.timings_ms}

    def should_skip_frames(self, budget_ms: float = 33.33) -> int:
        """Real-time governor: frames to skip when the last 'Run' section
        exceeded the budget (MainController.cpp:487-489)."""
        run = self.last_ms.get("Run", 0.0)
        return int(run / budget_ms) if run > budget_ms else 0
