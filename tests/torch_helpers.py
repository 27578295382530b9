"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

The same numpy inputs go through a JAX function of ``maskfusion_tpu`` and its
counterpart in ``maskfusion_tpu_torch``; results come back as numpy arrays.
The port runs on the CPU here, where its kernel wrappers take their plain
PyTorch versions.
"""

from __future__ import annotations

import numpy as np
import torch

from maskfusion_tpu_torch.camera import CameraIntrinsics as TorchIntrinsics

CPU = torch.device("cpu")

# the suite runs in several worker processes at once; the port's tests use
# 160x120 images, where intra-op threads only contend (measured: the engine
# tests take the same time alone on 1 thread as on 8)
torch.set_num_threads(1)


def t(a, dtype=None) -> torch.Tensor:
    """numpy (or JAX) array -> CPU torch tensor."""
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True, order="C"))


def n(x) -> np.ndarray:
    """torch tensor / JAX array / tuple -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def tintr(intr) -> TorchIntrinsics:
    """The port's copy of a JAX-package CameraIntrinsics."""
    return TorchIntrinsics(intr.fx, intr.fy, intr.cx, intr.cy)


def assert_close_nan(a, b, atol, rtol=0.0):
    """allclose that also requires NaN in the same places."""
    a, b = n(a), n(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(a, b, atol=atol, rtol=rtol, equal_nan=True)
