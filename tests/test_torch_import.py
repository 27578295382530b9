"""The port stands alone: importing it (or chip_smoke.py) loads neither jax
nor flax, optax, h5py, msgpack or the JAX package, its -l path, its Mask
R-CNN serving path and its training step need no OpenCV (nor flax, optax,
h5py or msgpack, which the card's machine lacks), and chip_smoke.py refuses
to run without a card."""

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
bad = [m for m, mod in list(sys.modules.items())
       if mod is not None and m.split(".")[0] in ("jax", "jaxlib", "maskfusion_tpu", "flax",
                              "optax", "h5py", "msgpack")]
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
import maskfusion_tpu_torch.main
import maskfusion_tpu_torch.bench
import maskfusion_tpu_torch.io.log_reader
import maskfusion_tpu_torch.io.exr
import maskfusion_tpu_torch.io.klg_reader
import maskfusion_tpu_torch.io.image_reader
import maskfusion_tpu_torch.io.ground_truth
import maskfusion_tpu_torch.io.export
import maskfusion_tpu_torch.utils.stopwatch
import maskfusion_tpu_torch.utils.diag_export
import maskfusion_tpu_torch.cpp
import maskfusion_tpu_torch.maskrcnn.model
import maskfusion_tpu_torch.maskrcnn.checkpoint_io
import maskfusion_tpu_torch.maskrcnn.resize
import maskfusion_tpu_torch.maskrcnn.inference
import maskfusion_tpu_torch.maskrcnn.synthetic_shapes
import maskfusion_tpu_torch.maskrcnn.offline_runner
import maskfusion_tpu_torch.maskrcnn.optim
import maskfusion_tpu_torch.maskrcnn.convert
import maskfusion_tpu_torch.maskrcnn.train_checkpoint
import maskfusion_tpu_torch.parallel
import maskfusion_tpu_torch.parallel.train
import maskfusion_tpu_torch.parallel.mesh
import maskfusion_tpu_torch.parallel.multimodel
import maskfusion_tpu_torch.parallel.launch
import maskfusion_tpu_torch.parallel.dryrun
import maskfusion_tpu_torch.ops.slic
import maskfusion_tpu_torch.segmentation.cf_segmentation
import maskfusion_tpu_torch.reloc.ferns
import maskfusion_tpu_torch.reloc.deformation
import maskfusion_tpu_torch.mapping.model_matching
import maskfusion_tpu_torch.io.checkpoint
import maskfusion_tpu_torch.tools.evaluate
import maskfusion_tpu_torch.tools.make_sequence
import maskfusion_tpu_torch.tools.sequence_add_bbox_labels
import maskfusion_tpu_torch.viewer
import maskfusion_tpu_torch.gui
import maskfusion_tpu_torch.io.live_readers
"""

# the -l path needs no OpenCV (the card's machine has none): with cv2
# unimportable, the CLI and the KLG reader import, and a raw log is written
# and read back; with flax, optax, h5py and msgpack unimportable too, the
# serving path runs, a train step runs and a checkpoint is written
WITHOUT_CV2 = """
for name in ("cv2", "flax", "optax", "h5py", "msgpack"):
    sys.modules[name] = None
import tempfile, os
import numpy as np
import maskfusion_tpu_torch.main
import maskfusion_tpu_torch.viewer
import maskfusion_tpu_torch.gui
import maskfusion_tpu_torch.io.live_readers
import maskfusion_tpu_torch.tools.sequence_add_bbox_labels
from maskfusion_tpu_torch.frame import FrameData
from maskfusion_tpu_torch.io.klg_reader import KlgLogReader, write_klg
path = os.path.join(tempfile.mkdtemp(), "raw.klg")
rgb = np.arange(12 * 16 * 3, dtype=np.uint8).reshape(12, 16, 3)
depth = np.arange(12 * 16, dtype=np.uint16).reshape(12, 16)
write_klg(path, [FrameData(rgb=rgb, depth=depth, timestamp=5.0)] * 2,
          compress=False)
f = KlgLogReader(path, 16, 12).get_next()
assert (f.rgb == rgb).all() and (f.depth == depth).all()
# the Mask R-CNN serving path needs no OpenCV either
import torch
from maskfusion_tpu_torch.maskrcnn import inference, synthetic_shapes
net = inference.MaskRCNNInference(synthetic_shapes.micro_config(64),
                                  device="cpu")
net.execute(f)
assert f.mask.shape == (12, 16) and f.class_ids[0] == 0
# one training step and its checkpoint
from maskfusion_tpu_torch.maskrcnn import checkpoint_io
from maskfusion_tpu_torch.parallel.train import create_train_step
cfg = synthetic_shapes.micro_config(64)
init_fn, step_fn = create_train_step(cfg, device="cpu")
state = init_fn(0, 1)
batch = [torch.from_numpy(a) for a in
         synthetic_shapes.make_batch(np.random.default_rng(0), 1, 64)]
state, loss = step_fn(state, torch.Generator().manual_seed(0), *batch)
assert torch.isfinite(loss)
from maskfusion_tpu_torch.convert import maskrcnn_flax_tree
checkpoint_io.save_params(os.path.join(tempfile.mkdtemp(), "c.npz"),
                          maskrcnn_flax_tree(state.params.state_dict(), cfg))
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
    WITHOUT_CV2,
], ids=["package", "chip_smoke", "without_cv2"])
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
