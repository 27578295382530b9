"""Run one cell of the benchmark once and print its result line.

    python3 mfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The run loads and warms up (``setup_s``: from the process's start to the
window's start), measures for ``--seconds`` seconds, checks what the timed
path produced against the plain reference, and prints, as the last line of
its standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics; with ``--trace 1``
its per-layer metrics instead), ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``, each number compared beside its limit.
The same numbers close its standard error.  It refuses to run (a non-zero
exit, no result) without enough CUDA cards, and prints no result if
``jax``, ``jaxlib``, ``flax`` or ``maskfusion_tpu`` is loaded once the
window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# kernel and compile caches live at fixed paths inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "mfbench_cache" / sub)

from mfbench import harness  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(cell: harness.Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float) -> dict:
    """Drive the cell and assemble its result (not yet printed)."""
    import torch

    driver = importlib.import_module(
        f"mfbench.drivers.{cell.workload['driver']}")
    res = driver.run(cell, seed, seconds, trace, device, t_start)
    metrics = {}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        ctx = harness.Context(cell, res.window_s, res.units, res.spans,
                              res.profile)
        for m in cell.per_layer:
            v = harness.load_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] in res.e2e:
                metrics[m["name"]] = {"value": float(res.e2e[m["name"]]),
                                      "unit": units[m["name"]]}
    dev = torch.device(device)
    if dev.type == "cuda":
        device_info = {"platform": "gpu",
                       "kind": torch.cuda.get_device_name(dev),
                       "count": int(cell.entry.get("chips", 1)),
                       "memory_peak_bytes": int(res.memory_peak_bytes)}
    else:
        device_info = {"platform": "cpu", "kind": "cpu", "count": 1,
                       "memory_peak_bytes": 0}
    out = {"correct": bool(res.correct), "attempted": int(res.attempted),
           "failed": int(res.failed), "metrics": metrics,
           "device": device_info}
    if trace and res.profile is not None:
        device_info["busy_s"] = res.profile["busy_us"] * 1e-6
        device_info["window_s"] = res.profile["window_us"] * 1e-6
        out["breakdown"] = res.profile["breakdown"]
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in res.checks.items()}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    cell = harness.load_cell(args.workload)
    chips = int(cell.entry.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"mfbench: cell {args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 3
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   T_START)
    bad = harness.forbidden_loaded()
    if bad:
        print(f"mfbench: the run loaded {bad}; no result", file=sys.stderr)
        return 4
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
