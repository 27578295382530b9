"""RGB-D traffic for the SLAM cells, rendered on the card from the seed.

The two-object scene is the port bench's (``make_points``,
``camera_pose``, ``render_points``, ``make_two_object_frames``) rewritten
in torch: a textured wavy background and two independently moving textured
patches under an aggressive camera loop, rendered with the same z-buffer
and nearest-centre rule (float64 geometry, as the numpy original promotes
it), so the same pose gives the same arrays.  The static ramp is the port
bench's ``make_frames``.  The seed draws only phases: every seed renders
the same number of frames at the same size.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Rotation matrix of a float64 rotation vector."""
    th = torch.linalg.vector_norm(rvec)
    if float(th) < 1e-12:
        return torch.eye(3, dtype=torch.float64, device=rvec.device)
    k = rvec / th
    z = torch.zeros((), dtype=torch.float64, device=rvec.device)
    K = torch.stack([torch.stack([z, -k[2], k[1]]),
                     torch.stack([k[2], z, -k[0]]),
                     torch.stack([-k[1], k[0], z])])
    eye = torch.eye(3, dtype=torch.float64, device=rvec.device)
    return eye + torch.sin(th) * K + (1 - torch.cos(th)) * K @ K


def camera_pose(s: float, device) -> torch.Tensor:
    """make_sequence's smooth loop over s in [0, 1]: camera to world,
    float64 (4, 4)."""
    w = 2 * math.pi * s
    t = [0.22 * math.sin(w), 0.15 * math.sin(2 * w + 1.0), 0.10 * math.sin(w)]
    rvec = torch.tensor([0.10 * math.sin(w + 0.5), 0.24 * math.sin(w),
                         0.08 * math.sin(2 * w)], dtype=torch.float64,
                        device=device)
    T = torch.eye(4, dtype=torch.float64, device=device)
    T[:3, :3] = rodrigues(rvec)
    T[:3, 3] = torch.tensor(t, dtype=torch.float64, device=device)
    return T


def _lin(a: float, b: float, n: int, device) -> torch.Tensor:
    """np.linspace's float64 values, computed as numpy does (start + i *
    step, the last set to stop); torch.linspace rounds differently."""
    y = torch.arange(n, dtype=torch.float64, device=device) * (
        (b - a) / (n - 1)) + a
    y[-1] = b
    return y


def make_points(width: int, device):
    """The background (~6 points a pixel at VGA) and one object patch:
    (pts float32 (N, 3), cols uint8 (N, 3)) each."""
    n_u = int(width * 3.4)
    n_v = int(n_u * 0.8)
    Y, X = torch.meshgrid(_lin(-1.05, 1.05, n_v, device),
                          _lin(-1.35, 1.35, n_u, device), indexing="ij")
    Z = 2.0 + 0.22 * torch.sin(2.3 * X) * torch.cos(1.9 * Y) \
        + 0.06 * torch.sin(7 * X)
    pts_bg = torch.stack([X, Y, Z], -1).reshape(-1, 3).to(torch.float32)
    r = 127.5 + 90 * torch.sin(9 * X) + 30 * torch.cos(17 * Y)
    g = 127.5 + 90 * torch.cos(7 * Y) + 25 * torch.sin(13 * X)
    b = 127.5 + 80 * torch.sin(5 * (X + Y))
    cols_bg = _u8(torch.stack([r, g, b], -1).reshape(-1, 3))

    n = int(width * 1.6)
    OY, OX = torch.meshgrid(_lin(-0.21, 0.21, int(n * 0.75), device),
                            _lin(-0.28, 0.28, n, device), indexing="ij")
    OZ = 1.45 + 0.10 * torch.sin(4.5 * OX) + 0.08 * torch.cos(5.5 * OY)
    pts_obj = torch.stack([OX + 0.12, OY - 0.06, OZ], -1).reshape(-1, 3).to(
        torch.float32)
    orr = 127.5 + 110 * torch.sin(15 * OX)
    og = 127.5 + 110 * torch.cos(12 * OY)
    ob = torch.full_like(orr, 70.0)
    cols_obj = _u8(torch.stack([orr, og, ob], -1).reshape(-1, 3))
    return pts_bg, cols_bg, pts_obj, cols_obj


def _u8(x: torch.Tensor) -> torch.Tensor:
    # numpy's clip(0, 255).astype(uint8) truncates toward zero
    return torch.clamp(x, 0, 255).to(torch.uint8)


def render_points(pts, cols, pose_c2w, fx, fy, cx, cy, w, h, labels=None):
    """make_sequence.render in torch: a z-buffer point render where, among
    the points within 0.5% of a pixel's nearest depth, the one projecting
    closest to the pixel centre wins (the highest point index among exact
    ties, as numpy's repeated-index assignment leaves the last).  Returns
    rgb uint8 (h, w, 3), metric depth float32 (h, w; 0 = empty)[, labels
    uint8 (h, w)]."""
    dev = pts.device
    T = pose_c2w.to(torch.float64)
    p_cam = (pts.to(torch.float64) - T[:3, 3]) @ T[:3, :3]
    z = p_cam[:, 2]
    uf = p_cam[:, 0] * fx / z + cx
    vf = p_cam[:, 1] * fy / z + cy
    # numpy rounds half to even, as torch.round does
    ur, vr = torch.round(uf), torch.round(vf)
    ok = (z > 0.05) & torch.isfinite(ur) & torch.isfinite(vr)
    ok &= (ur >= 0) & (ur < w) & (vr >= 0) & (vr < h)
    idx = torch.nonzero(ok).squeeze(1)
    u = ur[idx].to(torch.int64)
    v = vr[idx].to(torch.int64)
    lin = v * w + u
    zok = z[idx].to(torch.float32)
    zbuf = torch.full((h * w,), float("inf"), dtype=torch.float32, device=dev)
    zbuf.scatter_reduce_(0, lin, zok, "amin")
    near = zok <= zbuf[lin] * (1 + 5e-3)
    du = uf[idx] - ur[idx]
    dv = vf[idx] - vr[idx]
    key = torch.where(near, (du * du + dv * dv).to(torch.float32),
                      float("inf"))
    best = torch.full((h * w,), float("inf"), dtype=torch.float32, device=dev)
    best.scatter_reduce_(0, lin, key, "amin")
    win = near & (key <= best[lin])
    # among exact ties the last point wins
    last = torch.full((h * w,), -1, dtype=torch.int64, device=dev)
    order = torch.arange(idx.numel(), device=dev)
    last.scatter_reduce_(0, lin[win], order[win], "amax")
    pix = torch.nonzero(last >= 0).squeeze(1)
    src = last[pix]
    rgb = torch.zeros((h * w, 3), dtype=torch.uint8, device=dev)
    rgb[pix] = cols[idx[src]]
    depth = torch.zeros((h * w,), dtype=torch.float32, device=dev)
    depth[pix] = zok[src]
    out = [rgb.reshape(h, w, 3), depth.reshape(h, w)]
    if labels is not None:
        lab = torch.zeros((h * w,), dtype=torch.uint8, device=dev)
        lab[pix] = labels[idx[src]]
        out.append(lab.reshape(h, w))
    return tuple(out)


class TwoObjectScene:
    """The two-object scene at ``width`` x ``height``: the motion spans a
    loop of ``loop`` frames, from the seed's phases ``(camera, object 1,
    object 2)``.  ``render(i)`` gives frame i of the loop on the card;
    ``camera(i)`` its camera-to-world pose; ``object_offset(i, k)``
    object k's translation (k = 1, 2)."""

    CLASS_IDS = [0, 7, 8]

    def __init__(self, width: int, height: int, loop: int,
                 phases: Tuple[float, float, float], device,
                 camera_span: float = 0.25):
        self.width, self.height, self.loop = width, height, loop
        self.phases = phases
        self.camera_span = camera_span
        self.device = torch.device(device)
        pts_bg, cols_bg, pts_o1, cols_o1 = make_points(width, self.device)
        shift = torch.tensor([-0.55, 0.18, 0.05], dtype=torch.float32,
                             device=self.device)
        pts_o2 = pts_o1 + shift
        cols_o2 = cols_o1.flip(-1)
        self.labels = torch.cat([
            torch.zeros(len(pts_bg), dtype=torch.uint8, device=self.device),
            torch.full((len(pts_o1),), 1, dtype=torch.uint8,
                       device=self.device),
            torch.full((len(pts_o2),), 2, dtype=torch.uint8,
                       device=self.device)])
        self.cols = torch.cat([cols_bg, cols_o1, cols_o2])
        self.base = (pts_bg, pts_o1, pts_o2)
        self.fx = self.fy = 0.825 * width
        self.cx, self.cy = width / 2.0, height / 2.0

    def s(self, i: int) -> float:
        return i / max(self.loop - 1, 1)

    def camera(self, i: int) -> torch.Tensor:
        return camera_pose(self.phases[0] + self.camera_span * self.s(i),
                           self.device)

    def object_offset(self, i: int, k: int) -> torch.Tensor:
        s = self.s(i)
        off = torch.zeros(3, dtype=torch.float32, device=self.device)
        if k == 1:
            off[0] = 0.10 * math.sin(2 * math.pi * s + self.phases[1])
        else:
            off[1] = 0.06 * math.sin(2 * math.pi * s + 1.0 + self.phases[2])
        return off

    def render(self, i: int):
        pts_bg, pts_o1, pts_o2 = self.base
        pts = torch.cat([pts_bg, pts_o1 + self.object_offset(i, 1),
                         pts_o2 + self.object_offset(i, 2)])
        return render_points(pts, self.cols, self.camera(i), self.fx,
                             self.fy, self.cx, self.cy, self.width,
                             self.height, self.labels)

    def intrinsics(self) -> Tuple[float, float, float, float]:
        return (self.fx, self.fy, self.cx, self.cy)


def ping_pong_index(k: int, loop: int) -> int:
    """Frame k of the loop played forward then back: 0 .. loop-1, loop-2 ..
    1, 0 ..., so consecutive frames never jump."""
    period = 2 * (loop - 1)
    j = k % period
    return j if j < loop else period - j


def static_ramp(width: int, height: int, n: int, phase: float,
                device) -> List[Dict[str, torch.Tensor]]:
    """The port bench's make_frames with a phase: a tilted wavy depth ramp
    as uint16 millimetres and a textured colour ramp, frame i of n."""
    dev = torch.device(device)
    v, u = torch.meshgrid(torch.arange(height, device=dev, dtype=torch.int64),
                          torch.arange(width, device=dev, dtype=torch.int64),
                          indexing="ij")
    uf, vf = u.to(torch.float64), v.to(torch.float64)
    frames = []
    for i in range(n):
        depth = (1.5 + 0.0004 * uf + 0.0003 * vf
                 + 0.08 * torch.sin(uf * 0.03 + i * 0.02 + phase)
                 * torch.cos(vf * 0.04)).to(torch.float32)
        # float32 millimetres, rounded half to even, as numpy rounds them
        depth_mm = torch.round(depth * 1000.0).to(torch.int32)
        rgb = torch.stack([(u * 3 + 5 * i) % 256, (v * 2) % 256,
                           (u + v) % 256], -1).to(torch.uint8)
        frames.append({"rgb": rgb, "depth_mm": depth_mm})
    return frames
