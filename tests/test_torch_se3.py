"""Port parity of se3: the cases of tests/test_se3.py through both packages.
Tolerances are f32 rounding (1e-6) unless stated."""

import numpy as np
import jax.numpy as jnp
import pytest

from maskfusion_tpu import se3 as jse3
from maskfusion_tpu_torch import se3 as tse3
from tests.torch_helpers import n, t


def _rvecs(seed, k, scale):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=3) * scale).astype(np.float32) for _ in range(k)]


@pytest.mark.parametrize("rvec", _rvecs(0, 6, 0.5) + [np.zeros(3, np.float32)])
def test_rodrigues_parity(rvec):
    np.testing.assert_allclose(n(tse3.rodrigues(t(rvec))),
                               n(jse3.rodrigues(jnp.asarray(rvec))),
                               atol=1e-6)


@pytest.mark.parametrize("seed", range(4))
def test_so3_log_parity(seed):
    rng = np.random.default_rng(seed)
    rvec = rng.normal(size=3)
    rvec = (rvec / np.linalg.norm(rvec) * rng.uniform(0.01, 2.5)).astype(
        np.float32)
    R = n(jse3.rodrigues(jnp.asarray(rvec)))
    ours = n(tse3.so3_log(t(R)))
    np.testing.assert_allclose(ours, n(jse3.so3_log(jnp.asarray(R))),
                               atol=1e-5)
    np.testing.assert_allclose(ours, rvec, atol=1e-3)


def test_pose_inverse_and_exp_update_parity():
    rng = np.random.default_rng(2)
    rvec = rng.normal(size=3).astype(np.float32)
    tv = rng.normal(size=3).astype(np.float32)
    T = n(jse3.make_pose(jse3.rodrigues(jnp.asarray(rvec)), jnp.asarray(tv)))
    np.testing.assert_allclose(n(tse3.pose_inverse(t(T))),
                               n(jse3.pose_inverse(jnp.asarray(T))),
                               atol=1e-6)
    np.testing.assert_allclose(n(t(T) @ tse3.pose_inverse(t(T))), np.eye(4),
                               atol=1e-5)
    x = (rng.normal(size=6) * 0.05).astype(np.float32)
    np.testing.assert_allclose(
        n(tse3.se3_exp_update(t(T), t(x))),
        n(jse3.se3_exp_update(jnp.asarray(T), jnp.asarray(x))), atol=2e-6)
    np.testing.assert_allclose(
        n(tse3.se3_exp_update(t(np.eye(4, dtype=np.float32)),
                              t(np.zeros(6, np.float32)))),
        np.eye(4), atol=1e-7)


@pytest.mark.parametrize("dim", [3, 6])
def test_solve_and_inverse_parity(dim):
    # the JAX package solves with an unrolled scalar Cholesky, the port with
    # cholesky_ex: the same damped SPD system, so f32 solve rounding only
    # (relative 1e-4 for this conditioning)
    rng = np.random.default_rng(3)
    J = rng.normal(size=(40, dim))
    A = (J.T @ J).astype(np.float32)
    b = (A @ rng.normal(size=dim)).astype(np.float32)
    x_j = n(jse3.solve_6x6_ldlt(jnp.asarray(A), jnp.asarray(b)))
    x_t = n(tse3.solve_6x6_ldlt(t(A), t(b)))
    np.testing.assert_allclose(x_t, x_j, rtol=1e-4, atol=1e-5)
    inv_j = n(jse3.spd_inverse_small(jnp.asarray(A)))
    inv_t = n(tse3.spd_inverse_small(t(A)))
    np.testing.assert_allclose(inv_t, inv_j, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("rvec", _rvecs(4, 5, 1.0))
def test_quaternion_parity(rvec):
    R = n(jse3.rodrigues(jnp.asarray(rvec)))
    np.testing.assert_allclose(n(tse3.to_quaternion(t(R))),
                               n(jse3.to_quaternion(jnp.asarray(R))),
                               atol=1e-6)


@pytest.mark.parametrize("fn", ["transform_points", "rotate_vectors"])
def test_transform_points_and_rotate_vectors(fn):
    """se3.transform_points and rotate_vectors, which no code path calls,
    on (..., 3) batches in f32 (the JAX package's precision="highest";
    TF32 is off in the port)."""
    rng = np.random.default_rng(5)
    rvec, tv = rng.normal(size=(2, 3)).astype(np.float32)
    T = n(jse3.make_pose(jse3.rodrigues(jnp.asarray(rvec)), jnp.asarray(tv)))
    pts = rng.normal(size=(7, 11, 3)).astype(np.float32)
    out = n(getattr(tse3, fn)(t(T), t(pts)))
    ref = n(getattr(jse3, fn)(jnp.asarray(T), jnp.asarray(pts)))
    assert out.shape == pts.shape
    np.testing.assert_allclose(out, ref, atol=1e-6)
    want = pts @ T[:3, :3].T.astype(np.float64)
    if fn == "transform_points":
        want = want + T[:3, 3]
    np.testing.assert_allclose(out, want, atol=1e-5)
