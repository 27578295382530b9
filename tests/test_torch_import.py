"""The port stands alone: importing it (or chip_smoke.py) loads neither jax
nor the JAX package, and chip_smoke.py refuses to run without a card."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

_CHECK = """
import sys
{imports}
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.") or m == "jaxlib"
       or m.startswith("jaxlib.") or m == "maskfusion_tpu"
       or m.startswith("maskfusion_tpu.")]
print(",".join(bad))
"""

PORT_IMPORTS = """
import maskfusion_tpu_torch
import maskfusion_tpu_torch.engine
import maskfusion_tpu_torch.convert
import maskfusion_tpu_torch.ops.kernels
import maskfusion_tpu_torch.ops.seg_ops
import maskfusion_tpu_torch.segmentation
import maskfusion_tpu_torch.segmentation.components
import maskfusion_tpu_torch.segmentation.mf_segmentation
import maskfusion_tpu_torch.segmentation.pre_segmentation
import maskfusion_tpu_torch.segmentation.result
"""


def _run(code, cwd=ROOT, args=()):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, *args] if args else
                          [sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("imports", [
    PORT_IMPORTS,
    "import importlib.util\n"
    "spec = importlib.util.spec_from_file_location('chip_smoke', "
    "'chip_smoke.py')\n"
    "spec.loader.exec_module(importlib.util.module_from_spec(spec))",
], ids=["package", "chip_smoke"])
def test_no_jax_loaded(imports):
    r = _run(_CHECK.format(imports=imports))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "", f"loaded: {r.stdout.strip()}"


def _assert_refused(r):
    assert r.returncode != 0
    last = (r.stdout.strip().splitlines() or [""])[-1]
    try:
        assert not json.loads(last).get("ok")
    except (json.JSONDecodeError, AttributeError):
        pass


def test_chip_smoke_fails_without_a_card():
    """Here torch has no CUDA: the script must exit non-zero, no result."""
    _assert_refused(_run(None, args=("chip_smoke.py",)))


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    _assert_refused(_run(None, cwd=tmp_path, args=("chip_smoke.py",)))
