"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

The same numpy inputs go through a JAX function of ``maskfusion_tpu`` and its
counterpart in ``maskfusion_tpu_torch``; results come back as numpy arrays.
The port runs on the CPU here, where its kernel wrappers take their plain
PyTorch versions.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from maskfusion_tpu_torch import cpp as tnative
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


JAX_RECORD_KEYS = ("hostvec", "ids", "nonedge", "cov", "jumps", "counts")


def jax_record_ready(P) -> bool:
    """A JAX engine's pending pipelined record, once its device results are
    ready (waits for them).  In place of the JAX engine's non-blocking poll,
    it makes every frame finish each pending frame first, as the port does
    on the CPU, where its records are always ready: the run no longer
    depends on timing."""
    import jax

    jax.block_until_ready([P[k] for k in JAX_RECORD_KEYS
                           if P.get(k) is not None])
    return True


def wait_for_jax_pending(engine) -> None:
    """jax_record_ready for each of a JAX engine's pending records."""
    for P in engine._pending:
        jax_record_ready(P)


@contextlib.contextmanager
def numpy_paths():
    """Both packages on the numpy / scipy versions of their native host
    library (mfcore): the JAX package's unloaded (the pattern of
    tests/test_components_native.py), the port's ``cpp.disabled()``."""
    import maskfusion_tpu.cpp as jnative

    saved = jnative._lib, jnative._tried
    jnative._lib, jnative._tried = None, True
    try:
        with tnative.disabled():
            yield
    finally:
        jnative._lib, jnative._tried = saved
