"""Nothing a cell runs loads JAX or the JAX package, and the plain reference
loads nothing of the program either.

Each driver runs at a tiny size on the CPU in a fresh process, which then
lists the top-level names of ``sys.modules``: ``jax``, ``jaxlib``, ``flax``
and ``maskfusion_tpu`` are refused, ``maskfusion_tpu_torch`` passes.
(This test process itself has JAX loaded by the repository's conftest.)
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from mfbench import harness

ROOT = str(harness.ROOT)


def _top_level(names):
    return {n.split(".")[0] for n in names}


@pytest.mark.parametrize("cell", ["tiny_slam", "tiny_train", "tiny_nn"])
def test_a_cell_loads_no_jax(cell, tmp_path):
    env = dict(os.environ, MFBENCH_PATH=str(tmp_path), PYTHONPATH=ROOT)
    code = ("import json, sys\n"
            "from mfbench.tests import tiny\n"
            f"p = tiny.make({str(tmp_path)!r})\n"
            f"out = tiny.run({cell!r}, p, seconds=2.0)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    top = _top_level(json.loads(r.stdout.strip().splitlines()[-1]))
    assert "maskfusion_tpu_torch" in top          # the program did run
    assert not top & {"jax", "jaxlib", "flax", "maskfusion_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    mods = sorted(p.stem for p in (Path(ROOT) / "mfbench" / "reference")
                  .glob("*.py") if p.stem != "__init__")
    code = ("import json, sys\n"
            + "".join(f"import mfbench.reference.{m}\n" for m in mods)
            + "print(json.dumps(sorted(sys.modules)))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    top = _top_level(json.loads(r.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "maskfusion_tpu",
                      "maskfusion_tpu_torch"}


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "maskfusion_tpu_torch_x", sys)
    assert "jax" in harness.forbidden_loaded()        # this process: conftest
    only = {k: v for k, v in sys.modules.items()
            if k.split(".")[0] not in harness.FORBIDDEN_MODULES}
    monkeypatch.setattr(sys, "modules", only)
    assert harness.forbidden_loaded() == []


def test_run_refuses_without_a_card(tmp_path):
    r = subprocess.run(
        [sys.executable, "mfbench/run.py", "--workload", "slam_two_objects",
         "--seed", str(2 ** 33 + 1), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0
    assert r.stdout.strip() == ""
