"""Frozen copy of ``maskfusion_tpu_torch/se3.py``,
the plain PyTorch version the benchmark judges the program against
(imports rewritten to this folder; nothing of the program is imported).

SE(3)/SO(3) helpers in PyTorch.

Port of ``maskfusion_tpu/se3.py`` (the reference's OdometryProvider,
Core/Utils/OdometryProvider.h:31-93, and Model::rodrigues2,
Core/Model/Model.cpp:891-932).  Everything is float32 and branch-free
(``torch.where``) so that no function here waits on the device.

Every function except `so3_log` and `to_quaternion` also takes a leading
slot axis (one pose, vector or system per object model) and works slot by
slot, so the batched object tracker solves all its objects in one call.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def _skew(r: torch.Tensor) -> torch.Tensor:
    r0, r1, r2 = r.unbind(-1)
    z = torch.zeros_like(r0)
    return torch.stack([
        torch.stack([z, -r2, r1], -1),
        torch.stack([r2, z, -r0], -1),
        torch.stack([-r1, r0, z], -1),
    ], -2)


def trace(A: torch.Tensor) -> torch.Tensor:
    """The trace of a matrix, or of each with a leading slot axis."""
    if A.dim() == 2:
        return torch.trace(A)
    return A.diagonal(dim1=-2, dim2=-1).sum(-1)


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3).

    R = cos(t) I + (1-cos t) rr^T + sin(t) [r]_x, identity for tiny angles
    (OdometryProvider.h:32-67)."""
    theta = torch.linalg.vector_norm(rvec, dim=-1)
    small = theta < _EPS
    safe_theta = torch.where(small, torch.ones_like(theta), theta)
    r = rvec / safe_theta[..., None]
    c = torch.cos(theta)[..., None, None]
    s = torch.sin(theta)[..., None, None]
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    R = c * eye + (1.0 - c) * (r[..., :, None] * r[..., None, :]) \
        + s * _skew(r)
    return torch.where(small[..., None, None], eye, R)


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
    # the bottom row [0, 0, 0, 1] made on the device: writing a Python
    # scalar into a card's tensor waits for the device's queue
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:]
    bottom = bottom.expand(R.shape[:-2] + (1, 4))
    return torch.cat([torch.cat([R, t[..., None]], dim=-1), bottom], dim=-2)


def se3_exp_update(result_rt: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Left-multiply the incremental GN solution x = [t(3), rvec(3)] onto the
    running transform (OdometryProvider::computeUpdateSE3, :69-85)."""
    return make_pose(rodrigues(x[..., 3:6]), x[..., :3]) @ result_rt


def pose_inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].mT
    if T.dim() == 2:
        return make_pose(Rt, -(Rt @ T[:3, 3]))
    return make_pose(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 pose to (..., 3) points (f32; TF32 is off)."""
    return torch.einsum("...i,ji->...j", pts, T[:3, :3]) + T[:3, 3]


def rotate_vectors(T: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Rotate (..., 3) vectors by a 4x4 pose's rotation."""
    return torch.einsum("...i,ji->...j", vecs, T[:3, :3])

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
    a non-finite solution becomes zero.  With a leading slot axis each
    slot is solved on its own: the card's batched Cholesky routines wait
    for the device's queue, the one-matrix ones do not
    (tests/torch_slot_axis_probe.py)."""
    if A.dim() > 2:
        return torch.stack([solve_6x6_ldlt(a, c) for a, c in zip(A, b)])
    dim = A.shape[-1]
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
