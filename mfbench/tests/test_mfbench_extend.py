"""A later change adds a cell and a per-layer metric by adding files and
entries alone: here from a temporary directory on ``MFBENCH_PATH``, with
no file of ``mfbench/`` touched."""

import hashlib
import json

from mfbench import harness
from mfbench.tests import tiny


def _digest():
    h = hashlib.sha256()
    for p in sorted(harness.HERE.rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts:
            h.update(str(p.relative_to(harness.HERE)).encode())
            h.update(p.read_bytes())
    return h.hexdigest()


def test_a_new_cell_and_metric_from_files(tmp_path, monkeypatch):
    before = _digest()
    monkeypatch.setenv("MFBENCH_PATH", str(tmp_path))
    bench_path = tiny.make(tmp_path)
    # the new cell: a workload file over an existing configuration
    w = json.loads((tmp_path / "workloads" / "tiny_slam.json").read_text())
    w["traffic"]["loop_frames"] = 12
    (tmp_path / "workloads" / "dummy_cell.json").write_text(json.dumps(w))
    # the new metric: a reader of its own
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "dummy.frames.py").write_text(
        "def read(ctx):\n    return float(ctx.units)\n")
    (tmp_path / "metrics" / "dummy.silent.py").write_text(
        "def read(ctx):\n    return None\n")
    bench = json.loads(bench_path.read_text())
    bench["workloads"].append({"name": "dummy_cell", "config": "tiny_vga",
                               "traffic": "dummy", "chips": 1,
                               "why": "a cell added by files alone"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "tiny_slam" in m["workloads"]:
            m["workloads"].append("dummy_cell")
    for name in ("dummy.frames", "dummy.silent"):
        bench["per_layer"].append({
            "name": name, "unit": "frames", "better": "higher",
            "source": "program_counter", "layer": "Engine", "moves":
            "slam_fps", "workloads": ["dummy_cell"]})
    bench_path.write_text(json.dumps(bench))

    out = tiny.run("dummy_cell", bench_path, seed=2 ** 35 + 7,
                   seconds=2.0, trace=True)
    assert out["metrics"]["dummy.frames"]["value"] >= 1
    assert out["metrics"]["dummy.frames"]["unit"] == "frames"
    assert "dummy.silent" not in out["metrics"]   # nothing to read: left out
    assert list(out)[-1] == "checks"
    plain = tiny.run("dummy_cell", bench_path, seed=2 ** 35 + 7,
                     seconds=2.0)
    assert set(plain["metrics"]) == {"slam_fps", "setup_s"}
    assert _digest() == before
