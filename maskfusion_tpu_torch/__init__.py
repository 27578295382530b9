"""maskfusion_tpu_torch — the PyTorch/CUDA port of ``maskfusion_tpu``.

The JAX package ``maskfusion_tpu`` stays the reference; this package does
the same work with PyTorch on one NVIDIA Hopper card.  Its modules mirror the
JAX package's paths and names.  The TPU's Pallas kernels become hand-written
CUDA kernels (``csrc/``, bound in ``ops/kernels.py``); everything the JAX
package left to XLA is written as torch ops.

This package imports neither ``jax`` nor anything of ``maskfusion_tpu``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

import torch as _torch

# The geometry code is written against f32 semantics (the JAX package pins
# f32 matmuls, maskfusion_tpu/__init__.py:27-30).  Matmuls and cuDNN convs
# would otherwise run in TF32 on Hopper, which keeps ~3 decimal digits.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from maskfusion_tpu_torch.camera import CameraIntrinsics, Resolution  # noqa: E402
from maskfusion_tpu_torch.config import Config  # noqa: E402


def default_device() -> _torch.device:
    """The port's device: the first CUDA card.  There is no fallback to the
    CPU — a caller that wants the CPU passes ``device="cpu"``."""
    return _torch.device("cuda")


def resolve_device(device, who: str) -> _torch.device:
    """``device``, or the default card; raises when that is a CUDA device
    and no card is found (``who`` names the entry point)."""
    dev = _torch.device(device) if device is not None else default_device()
    if dev.type == "cuda" and not _torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA card; pass device='cpu' to run "
                           "on the CPU")
    return dev


__all__ = ["CameraIntrinsics", "Resolution", "Config", "default_device",
           "resolve_device", "__version__"]
