"""What every cell shares: finding its files by name, the benchmark's own
spans, the reading of a profiler trace, and the result line.

A cell ``<cell>`` of ``BENCHMARK.json`` is ``workloads/<cell>.json`` (its
``driver``, its ``traffic`` parameters and the ``limits`` of its output
check) over the configuration file that ``BENCHMARK.json`` names.  A
per-layer metric ``<m>`` is ``metrics/<m>.py`` with ``read(ctx)``, which
returns a number or None (nothing to read: the metric is left out).  Extra
directories searched before this folder can be given in ``MFBENCH_PATH``
(os.pathsep-separated), each laid out as this folder is.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import statistics
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

from mfbench import arith

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "maskfusion_tpu")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")


def search_dirs() -> List[Path]:
    extra = [Path(p) for p in os.environ.get("MFBENCH_PATH", "").split(
        os.pathsep) if p]
    return extra + [HERE]


def find(sub: str, name: str) -> Path:
    for d in search_dirs():
        p = d / sub / name
        if p.is_file():
            return p
    raise FileNotFoundError(f"{sub}/{name} not found in "
                            f"{[str(d) for d in search_dirs()]}")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict                  # the cell's entry in BENCHMARK.json
    workload: dict               # workloads/<cell>.json
    config: dict                 # the configuration's file
    end_to_end: List[dict]       # the end-to-end metrics this cell reports
    per_layer: List[dict]        # the per-layer metrics this cell reports


def _reports(metric: dict, cell: str, e2e_names=None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def load_cell(name: str, bench_path: Optional[Path] = None) -> Cell:
    bench = load_json(bench_path or ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    workload = load_json(find("workloads", f"{name}.json"))
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cpath = Path(conf["file"])
    config = load_json(cpath if cpath.is_absolute() else
                       find("configs", cpath.name))
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, entry, workload, config, e2e, per_layer)


def load_reader(metric: str) -> Callable:
    path = find("metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "mfbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ------------------------------------------------------------------ spans
class Spans:
    """The benchmark's own host spans and counters, kept in memory."""

    def __init__(self):
        self.spans: Dict[str, List[Tuple[float, float]]] = {}
        self.counters: Dict[str, float] = {}

    def span(self, name: str, t0: float, t1: float) -> None:
        self.spans.setdefault(name, []).append((t0, t1))

    def count(self, name: str, n: float = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n


def print_window(spans: Spans, name: str, n: int, window_s: float) -> None:
    """One line on standard error: the window's units, rate and the spread
    of its spans (ms)."""
    ms = sorted((b - a) * 1e3 for a, b in spans.spans.get(name, []))
    if not ms:
        return
    pick = [ms[min(len(ms) - 1, int(q * len(ms)))] for q in (0.1, 0.5, 0.9)]
    print(f"window: {n} {name}s in {window_s:.3f} s, {n / window_s:.4f}/s; "
          f"{name} ms p10 {pick[0]:.1f} p50 {pick[1]:.1f} p90 {pick[2]:.1f}"
          f" max {ms[-1]:.1f}", file=sys.stderr)


def quantile(values: List[float], q: int, n: int = 100) -> float:
    """The q-th of n quantiles (statistics.quantiles, exclusive method)."""
    return statistics.quantiles(values, n=n)[q - 1]


# ---------------------------------------------------------------- tracing
def traced(fn: Callable[[], object], units: int, device) -> dict:
    """torch.profiler over ``fn()`` and a closing synchronise: the traced
    window's length (host clock), the device's busy time as the union of
    its kernel, copy and set intervals, the host's kernel launches and
    synchronises (the closing one left out), time a kernel, and the longest
    idle gaps, each with the CUDA runtime call the host was in (or none).
    Only the CUDA activity is traced: recording every host operation as
    well slows a launch-bound host about twofold, which would read as idle
    time of the card.  ``units`` frames or steps ran in it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    sync()
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window_s = time.perf_counter() - t0
    events = prof.events()
    CPU = torch.autograd.DeviceType.CPU
    dev, host, kernels = [], [], {}
    launches = syncs = 0
    for e in events:
        tr = e.time_range
        if e.device_type != CPU:
            dev.append((tr.start, tr.end))
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += tr.end - tr.start
            k[1] += 1
            continue
        name = e.name
        if name.startswith("cudaLaunchKernel") or name.startswith(
                "cuLaunchKernel"):
            launches += 1
        elif name in SYNC_CALLS:
            syncs += 1
        host.append((tr.start, tr.end, name))
    closing = [h for h in host if h[2] == "cudaDeviceSynchronize"]
    if closing:
        syncs -= 1                       # the window's own closing one
    stamps = [h[0] for h in host] + [s for s, _ in dev]
    start = min(stamps) if stamps else 0.0
    end = max([h[1] for h in host] + [e for _, e in dev] + [start])
    busy = arith.merged(dev)
    busy_us = sum(e - s for s, e in busy)
    idle = sorted(arith.gaps(busy, start, end),
                  key=lambda g: g[0] - g[1])[:10]
    labelled = []
    for s, e in idle:
        mid = 0.5 * (s + e)
        cover = [h for h in host if h[0] <= mid <= h[1]]
        label = min(cover, key=lambda h: h[1] - h[0])[2] if cover else \
            "host outside any CUDA call"
        labelled.append([label, (e - s) * 1e-6])
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    return {"units": units, "window_us": window_s * 1e6, "busy_us": busy_us,
            "launches": launches if host else None,
            "syncs": syncs if host else None,
            "kernels": {k: {"us": v[0], "n": v[1]} for k, v in
                        kernels.items()},
            "breakdown": {"device_ops": [[k, v[0] * 1e-6] for k, v in top],
                          "idle_gaps": labelled}}


# ---------------------------------------------------------------- context
@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads."""
    cell: Cell
    window_s: float              # the measured window, host clock
    units: int                   # frames or steps that ran in it
    spans: Spans
    profile: Optional[dict]      # ``traced``'s summary, --trace 1 only


def kernel_mean_us(ctx: Context, part: str) -> Optional[float]:
    """The mean time of the profiled kernels whose name holds ``part``."""
    if ctx.profile is None:
        return None
    hits = [v for k, v in ctx.profile["kernels"].items() if part in k]
    n = sum(v["n"] for v in hits)
    return sum(v["us"] for v in hits) / n if n else None


def device_idle_pct(ctx: Context) -> Optional[float]:
    """100 minus the share of the traced window in which a kernel, copy or
    set ran on the card (the union of their intervals), in %."""
    p = ctx.profile
    if not p or p["window_us"] <= 0:
        return None
    return 100.0 - 100.0 * p["busy_us"] / p["window_us"]


def forbidden_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN_MODULES))


@dataclasses.dataclass
class DriverResult:
    """What a driver hands back to ``run.py``."""
    e2e: Dict[str, float]            # end-to-end metrics by name
    window_s: float
    units: int                       # frames or steps in the window
    spans: Spans
    profile: Optional[dict]
    checks: Dict[str, Tuple[float, float]]   # name -> (value, limit)
    correct: bool
    attempted: int
    failed: int
    memory_peak_bytes: int
    control: Optional[Dict[str, float]] = None   # the control's numbers
    values: Optional[Dict[str, float]] = None    # every number computed


MISSING = 1e300     # a compared number with no finite value (JSON has no inf)


def judge(values: Dict[str, float], limits: Dict[str, float]):
    """Each compared number beside its limit, and whether all are within
    (a number that is not finite reads ``MISSING`` and fails)."""
    checks = {}
    for k in limits:
        v = float(values[k])
        checks[k] = (v if math.isfinite(v) else MISSING, float(limits[k]))
    ok = all(v <= lim for v, lim in checks.values())
    return checks, ok
