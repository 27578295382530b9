"""SE(3)/SO(3) helpers in PyTorch.

Port of ``maskfusion_tpu/se3.py`` (the reference's OdometryProvider,
Core/Utils/OdometryProvider.h:31-93, and Model::rodrigues2,
Core/Model/Model.cpp:891-932).  Everything is float32 and branch-free
(``torch.where``) so that no function here waits on the device.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def _skew(r: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(r[0])
    return torch.stack([
        torch.stack([z, -r[2], r[1]]),
        torch.stack([r[2], z, -r[0]]),
        torch.stack([-r[1], r[0], z]),
    ])


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle (3,) -> rotation matrix (3,3).

    R = cos(t) I + (1-cos t) rr^T + sin(t) [r]_x, identity for tiny angles
    (OdometryProvider.h:32-67)."""
    theta = torch.linalg.vector_norm(rvec)
    small = theta < _EPS
    safe_theta = torch.where(small, torch.ones_like(theta), theta)
    r = rvec / safe_theta
    c = torch.cos(theta)
    s = torch.sin(theta)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    R = c * eye + (1.0 - c) * torch.outer(r, r) + s * _skew(r)
    return torch.where(small, eye, R)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle (3,); inverse of `rodrigues`
    (Model.cpp:891-932)."""
    rx = R[2, 1] - R[1, 2]
    ry = R[0, 2] - R[2, 0]
    rz = R[1, 0] - R[0, 1]
    s = 0.5 * torch.sqrt(rx * rx + ry * ry + rz * rz + _EPS)
    c = torch.clamp(0.5 * (torch.trace(R) - 1.0), -1.0, 1.0)
    theta = torch.arccos(c)
    vth = 0.5 / torch.clamp(s, min=_EPS)
    generic = theta * vth * torch.stack([rx, ry, rz])
    # theta ~ pi: axis from the diagonal, sign from one off-diagonal pair
    axis = torch.sqrt(torch.clamp((torch.diagonal(R) + 1.0) * 0.5, min=0.0))
    one = torch.ones_like(rx)
    sx = torch.where(R[2, 1] + R[1, 2] < 0, -one, one)
    pi_case = theta * axis * torch.stack([one, sx, sx])
    zero = torch.zeros_like(generic)
    return torch.where(s < 1e-5, torch.where(c > 0, zero, pi_case), generic)


def make_pose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    bottom = torch.zeros((1, 4), dtype=R.dtype, device=R.device)
    bottom[0, 3] = 1.0
    return torch.cat([torch.cat([R, t[:, None]], dim=1), bottom], dim=0)


def se3_exp_update(result_rt: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Left-multiply the incremental GN solution x = [t(3), rvec(3)] onto the
    running transform (OdometryProvider::computeUpdateSE3, :69-85)."""
    return make_pose(rodrigues(x[3:6]), x[:3]) @ result_rt


def pose_inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = T[:3, :3].T
    return make_pose(Rt, -(Rt @ T[:3, 3]))


def _cholesky(A: torch.Tensor) -> torch.Tensor:
    # cholesky_ex reports failure in a device tensor instead of raising,
    # so the solve never waits on the device; callers screen the result
    # with isfinite like the JAX package does
    L, _ = torch.linalg.cholesky_ex(A)
    return L


def solve_6x6_ldlt(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Small dense SPD solve inside the GN loop, kept on the device
    (the reference downloads JtJ and runs Eigen LDLT, RGBDOdometry.cpp:451).

    Relative Tikhonov damping (1e-4 * trace / n) pins the directions a
    near-flat model leaves unconstrained, exactly as the JAX package does;
    a non-finite solution becomes zero."""
    dim = A.shape[0]
    lam = 1e-4 * torch.trace(A) / dim + 1e-12
    A = A + lam * torch.eye(dim, dtype=A.dtype, device=A.device)
    x = torch.cholesky_solve(b[:, None], _cholesky(A))[:, 0]
    ok = torch.isfinite(x).all()
    return torch.where(ok, x, torch.zeros_like(x))


def spd_inverse_small(A: torch.Tensor) -> torch.Tensor:
    """Inverse of a small SPD matrix through its Cholesky factor (the
    GN covariance, RGBDOdometry.cpp:499)."""
    return torch.cholesky_inverse(_cholesky(A))


def to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (qx, qy, qz, qw), TUM export order."""
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22

    def root(v):
        return torch.sqrt(torch.clamp(v, min=0.0)) * 2.0

    s = root(tr + 1.0)
    qw = torch.stack([(m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s,
                      0.25 * s])
    s = root(1.0 + m00 - m11 - m22)
    qx = torch.stack([0.25 * s, (m01 + m10) / s, (m02 + m20) / s,
                      (m21 - m12) / s])
    s = root(1.0 + m11 - m00 - m22)
    qy = torch.stack([(m01 + m10) / s, 0.25 * s, (m12 + m21) / s,
                      (m02 - m20) / s])
    s = root(1.0 + m22 - m00 - m11)
    qz = torch.stack([(m02 + m20) / s, (m12 + m21) / s, 0.25 * s,
                      (m10 - m01) / s])
    idx = torch.argmax(torch.stack([tr, m00, m11, m22]))
    case = torch.where(tr > 0, torch.zeros_like(idx), (idx + 1) % 4)
    q = torch.stack([qw, qx, qy, qz])[case]
    return q / torch.linalg.vector_norm(q)
