"""The traffic generators against numpy copies of the port bench's.

The torch renderer (``mfbench.traffic.scenes``) must give the arrays that
the numpy ``render_points`` of ``maskfusion_tpu_torch/bench.py`` gives for
the same points and pose (copied below, so that the check outlives that
file); the shapes batches must be the seed's alone.
"""

import math

import numpy as np
import pytest
import torch

from mfbench.traffic import scenes, shapes, weights

# --------------------------------------------------------------------------
# numpy copies of maskfusion_tpu_torch/bench.py's generators
# --------------------------------------------------------------------------

def rodrigues(rvec):
    """Rotation matrix of a rotation vector (make_sequence._rot)."""
    th = np.linalg.norm(rvec)
    if th < 1e-12:
        return np.eye(3)
    k = np.asarray(rvec) / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def camera_pose(s: float) -> np.ndarray:
    """make_sequence.camera_pose: an aggressive smooth loop over s in
    [0, 1]."""
    w = 2 * np.pi * s
    t = np.array([0.22 * np.sin(w), 0.15 * np.sin(2 * w + 1.0),
                  0.10 * np.sin(w)])
    rvec = np.array([0.10 * np.sin(w + 0.5), 0.24 * np.sin(w),
                     0.08 * np.sin(2 * w)])
    T = np.eye(4, dtype=np.float64)
    T[:3, :3] = rodrigues(rvec)
    T[:3, 3] = t
    return T


def make_points(width: int):
    """make_sequence.make_points: a dense wavy textured background and a
    textured object patch, ~6 points a pixel at VGA."""
    n_u = int(width * 3.4)
    n_v = int(n_u * 0.8)
    x = np.linspace(-1.35, 1.35, n_u)
    y = np.linspace(-1.05, 1.05, n_v)
    X, Y = np.meshgrid(x, y)
    Z = 2.0 + 0.22 * np.sin(2.3 * X) * np.cos(1.9 * Y) + 0.06 * np.sin(7 * X)
    pts_bg = np.stack([X, Y, Z], -1).reshape(-1, 3).astype(np.float32)
    r = 127.5 + 90 * np.sin(9 * X) + 30 * np.cos(17 * Y)
    g = 127.5 + 90 * np.cos(7 * Y) + 25 * np.sin(13 * X)
    b = 127.5 + 80 * np.sin(5 * (X + Y))
    cols_bg = np.stack([r, g, b], -1).reshape(-1, 3).clip(0, 255).astype(
        np.uint8)

    n = int(width * 1.6)
    ox = np.linspace(-0.28, 0.28, n)
    oy = np.linspace(-0.21, 0.21, int(n * 0.75))
    OX, OY = np.meshgrid(ox, oy)
    OZ = 1.45 + 0.10 * np.sin(4.5 * OX) + 0.08 * np.cos(5.5 * OY)
    pts_obj = np.stack([OX + 0.12, OY - 0.06, OZ], -1).reshape(-1, 3).astype(
        np.float32)
    orr = 127.5 + 110 * np.sin(15 * OX)
    og = 127.5 + 110 * np.cos(12 * OY)
    ob = np.full_like(orr, 70.0)
    cols_obj = np.stack([orr, og, ob], -1).reshape(-1, 3).clip(0, 255).astype(
        np.uint8)
    return pts_bg, cols_bg, pts_obj, cols_obj


def render_points(pts, cols, pose_c2w, fx, fy, cx, cy, w, h, labels=None):
    """make_sequence.render (and tests/synthetic.py's render): a z-buffer
    point render where, among the points within 0.5% of a pixel's nearest
    depth, the one projecting closest to the pixel centre wins.  Returns
    rgb uint8, metric depth (0 = empty)[, labels]."""
    T = np.asarray(pose_c2w, np.float64)
    p_cam = (pts - T[:3, 3]) @ T[:3, :3]
    z = p_cam[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        uf = p_cam[:, 0] * fx / z + cx
        vf = p_cam[:, 1] * fy / z + cy
        u = np.round(uf).astype(np.int64)
        v = np.round(vf).astype(np.int64)
    ok = (z > 0.05) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    lin = v[ok] * w + u[ok]
    zok = z[ok].astype(np.float32)
    zbuf = np.full(h * w, np.inf, np.float32)
    np.minimum.at(zbuf, lin, zok)
    near = zok <= zbuf[lin] * (1 + 5e-3)
    du = uf[ok] - np.round(uf[ok])
    dv = vf[ok] - np.round(vf[ok])
    key = np.where(near, (du * du + dv * dv).astype(np.float32), np.inf)
    best = np.full(h * w, np.inf, np.float32)
    np.minimum.at(best, lin, key)
    win = near & (key <= best[lin])
    rgb = np.zeros((h * w, 3), np.uint8)
    rgb[lin[win]] = cols[ok][win]
    depth = np.zeros(h * w, np.float32)
    depth[lin[win]] = zok[win]
    out = [rgb.reshape(h, w, 3), depth.reshape(h, w)]
    if labels is not None:
        lab = np.zeros(h * w, np.uint8)
        lab[lin[win]] = labels[ok][win]
        out.append(lab.reshape(h, w))
    return tuple(out)


def make_frames(width: int, height: int, n: int, phase: float = 0.0):
    """bench.py's make_frames: a tilted wavy depth ramp as uint16
    millimetres (the sensor's wire format, uploaded raw) and a textured
    colour ramp, timestamped by index."""
    u, v = np.meshgrid(np.arange(width), np.arange(height))
    frames = []
    for i in range(n):
        depth = (
            1.5 + 0.0004 * u + 0.0003 * v
            + 0.08 * np.sin(u * 0.03 + i * 0.02 + phase) * np.cos(v * 0.04)
        ).astype(np.float32)
        depth_mm = np.round(depth * 1000.0).astype(np.uint16)
        rgb = np.stack(
            [(u * 3 + 5 * i) % 256, (v * 2) % 256, (u + v) % 256], -1
        ).astype(np.uint8)
        frames.append((rgb, depth_mm))
    return frames


# --------------------------------------------------------------------------

@pytest.mark.parametrize("s", [0.0, 0.37, 0.81])
def test_render_matches_numpy_at_160x120(s):
    W, H = 160, 120
    pts_bg, cols_bg, pts_o, cols_o = make_points(W)
    tb = scenes.make_points(W, "cpu")
    for a, b in zip((pts_bg, cols_bg, pts_o, cols_o), tb):
        np.testing.assert_array_equal(a, b.numpy())
    pts = np.concatenate([pts_bg, pts_o + np.float32(0.02)])
    cols = np.concatenate([cols_bg, cols_o])
    labels = np.concatenate([np.zeros(len(pts_bg), np.uint8),
                             np.ones(len(pts_o), np.uint8)])
    fx = fy = 0.825 * W
    pose = camera_pose(0.25 * s)
    want = render_points(pts, cols, pose, fx, fy, W / 2, H / 2, W, H, labels)
    got = scenes.render_points(
        torch.from_numpy(pts), torch.from_numpy(cols),
        torch.from_numpy(pose), fx, fy, W / 2, H / 2, W, H,
        torch.from_numpy(labels))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b.numpy())


def test_scene_camera_and_frames_match_the_bench_loop():
    W, H, n = 160, 120, 6
    scene = scenes.TwoObjectScene(W, H, n, (0.0, 0.0, 0.0), "cpu")
    pts_bg, cols_bg, pts_o1, cols_o1 = make_points(W)
    pts_o2 = pts_o1 + np.array([-0.55, 0.18, 0.05], np.float32)
    cols = np.concatenate([cols_bg, cols_o1, cols_o1[:, ::-1]])
    labels = np.concatenate([np.zeros(len(pts_bg), np.uint8),
                             np.full(len(pts_o1), 1, np.uint8),
                             np.full(len(pts_o2), 2, np.uint8)])
    for i in (0, 3):
        s = i / (n - 1)
        np.testing.assert_allclose(scene.camera(i).numpy(),
                                   camera_pose(0.25 * s), atol=1e-15)
        off1 = np.array([0.10 * np.sin(2 * np.pi * s), 0, 0], np.float32)
        off2 = np.array([0, 0.06 * np.sin(2 * np.pi * s + 1.0), 0],
                        np.float32)
        pts = np.concatenate([pts_bg, pts_o1 + off1, pts_o2 + off2])
        want = render_points(pts, cols, camera_pose(0.25 * s), 0.825 * W,
                             0.825 * W, W / 2, H / 2, W, H, labels)
        for a, b in zip(want, scene.render(i)):
            np.testing.assert_array_equal(a, b.numpy())


def test_static_ramp_matches_make_frames():
    want = make_frames(64, 48, 3, phase=0.5)
    got = scenes.static_ramp(64, 48, 3, 0.5, "cpu")
    for (rgb, d), g in zip(want, got):
        np.testing.assert_array_equal(rgb, g["rgb"].numpy())
        np.testing.assert_array_equal(d.astype(np.int32),
                                      g["depth_mm"].numpy())


def test_ping_pong_never_jumps():
    seq = [scenes.ping_pong_index(k, 5) for k in range(12)]
    assert seq == [0, 1, 2, 3, 4, 3, 2, 1, 0, 1, 2, 3]


def test_shapes_batches_are_the_seeds_alone():
    kw = dict(batch=2, size=64, max_instances=6, min_instances=1,
              num_classes=81, min_side=0.1, max_side=0.3)
    a = shapes.make_pool(2 ** 40 + 3, "cpu", 2, **kw)
    b = shapes.make_pool(2 ** 40 + 3, "cpu", 2, **kw)
    c = shapes.make_pool(2 ** 40 + 4, "cpu", 2, **kw)
    for x, y in zip(a, b):
        for k in x:
            assert torch.equal(x[k], y[k])
    assert not torch.equal(a[0]["images"], c[0]["images"])
    for bt in a:
        assert bt["images"].shape == (2, 64, 64, 3)
        assert bt["gt_masks"].shape == (2, 6, 64, 64)
        n = bt["gt_valid"].sum(1)
        assert bool(((n >= 1) & (n <= 6)).all())
        cls = bt["gt_classes"][bt["gt_valid"]]
        assert bool(((cls >= 1) & (cls <= 80)).all())
        assert not bool(bt["gt_masks"][~bt["gt_valid"]].any())
        # each mask lies inside its box (one pixel of rounding)
        for i in range(2):
            for g in range(6):
                m = bt["gt_masks"][i, g]
                if not bool(m.any()):
                    continue
                ys, xs = torch.nonzero(m, as_tuple=True)
                y1, x1, y2, x2 = (bt["gt_boxes"][i, g] * 64).tolist()
                assert ys.min() >= math.floor(y1) - 1
                assert ys.max() <= math.ceil(y2) + 1
                assert xs.min() >= math.floor(x1) - 1
                assert xs.max() <= math.ceil(x2) + 1


def test_weights_follow_the_layout_and_the_seed():
    from mfbench.reference import maskrcnn as mm
    from mfbench.reference import train as ref_train

    net = {"num_classes": 3, "image_size": 64, "fpn_channels": 32,
           "box_head_dim": 64, "mask_head_channels": 32,
           "backbone_blocks": [1, 1, 1, 1]}
    model = mm.MaskRCNN(ref_train.network_config(net, torch.float32))
    w1 = weights.make_weights(model, 5, "cpu")
    w2 = weights.make_weights(model, 5, "cpu")
    w3 = weights.make_weights(model, 6, "cpu")
    names = [n for n, _ in model.named_parameters()]
    assert sorted(w1) == sorted(names)
    assert all(torch.equal(w1[n], w2[n]) for n in names)
    assert not torch.equal(w1["backbone.stem.weight"],
                           w3["backbone.stem.weight"])
    stem = w1["backbone.stem.weight"]
    std = math.sqrt(1 / weights.fan_in("backbone.stem.weight",
                                       stem.shape)) / 0.8796
    assert abs(float(stem.std()) / std - 0.88) < 0.1      # clipped at 2 std
    assert float(stem.abs().max()) <= 2 * std * 1.0001
    assert bool((w1["backbone.stem_norm.scale"] == 1).all())
    assert bool((w1["backbone.stem.bias"] == 0).all())
