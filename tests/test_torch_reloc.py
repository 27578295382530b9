"""Relocalisation and loop closure in the port: the fern database and the
deformation graph of tests/test_reloc.py held against the JAX package on
the same numpy inputs, and the device blend's tie order (the engine
scenarios are tests/test_torch_reloc_engine.py's).

Bounds: the fern databases keep the same frames, codes bit-equal; a
verified fern pose within 1e-4 m / 1e-4 of the JAX package's (the
verification solve is the tracking core, held to the odometry parity
bounds); with both packages on the same solver (``numpy_paths``: scipy's
CG in both), the deformation graph's (total, mean_cons) and node A, t
within 1e-4 relative and 1e-5 absolute and the same accept decision; the
device blend within 1e-5 of the host blend and of the JAX package's; dead
map rows bit-equal."""

import time

import numpy as np
import torch

from maskfusion_tpu.camera import Resolution as JResolution
from maskfusion_tpu.reloc.deformation import DeformationGraph as JGraph
from maskfusion_tpu.reloc.ferns import Ferns as JFerns
from maskfusion_tpu_torch import cpp as tnative
from maskfusion_tpu_torch.camera import Resolution
from maskfusion_tpu_torch.reloc import deformation as tdef
from maskfusion_tpu_torch.reloc.deformation import DeformationGraph
from maskfusion_tpu_torch.reloc.ferns import Ferns
from tests import synthetic as syn
from tests.test_reloc import small_maps
from tests.torch_helpers import CPU, numpy_paths, tintr

def fern_pair():
    """tests/test_reloc.py's make_ferns in both packages."""
    j = JFerns(300, JResolution(syn.W, syn.H), syn.DEFAULT_INTR,
               max_depth=5.0, factor=1, seed=1)
    t = Ferns(300, Resolution(syn.W, syn.H), tintr(syn.DEFAULT_INTR),
              max_depth=5.0, factor=1, seed=1, device=CPU)
    for k in ("pos_x", "pos_y", "thresh_rgb", "thresh_d"):
        np.testing.assert_array_equal(getattr(t, k), getattr(j, k))
    return j, t


def assert_same_db(t: Ferns, j: JFerns, code_flips: float = 0.0) -> None:
    """The same kept frames.  Their codes are bit-equal when both databases
    were fed the same maps; an engine's maps are its own prediction, whose
    colours and depths differ from the JAX engine's in their last digits,
    so up to `code_flips` of its codes may flip a threshold bit."""
    assert len(t.frames) == len(j.frames)
    for a, b in zip(t.frames, j.frames):
        assert (a.frame_id, a.src_time) == (b.frame_id, b.src_time)
        assert abs(a.good_codes - b.good_codes) <= code_flips * len(a.codes)
        assert (a.codes != b.codes).mean() <= code_flips


def assert_same_find(rt, rj, atol=1e-4) -> None:
    assert rt.closest_id == rj.closest_id
    assert (rt.pose is None) == (rj.pose is None)
    if rj.pose is None:
        return
    np.testing.assert_allclose(rt.pose, rj.pose, atol=atol)
    assert len(rt.constraints) == len(rj.constraints)
    for a, b in zip(rt.constraints, rj.constraints):
        np.testing.assert_allclose(a.source_point, b.source_point,
                                   atol=1e-6)
        np.testing.assert_allclose(a.target_point, b.target_point,
                                   atol=atol)


# ------------------------------------------------------------------ ferns
def test_fern_db_novelty_gating():
    j, t = fern_pair()
    rgb, vm, nm = small_maps(np.eye(4))
    pose2 = syn.pose_from(np.array([0, 0.3, 0]), np.array([0.4, 0, 0.2]))
    rgb2, vm2, nm2 = small_maps(pose2)
    adds = [(rgb, vm, nm, np.eye(4), 0), (rgb, vm, nm, np.eye(4), 1),
            (rgb2, vm2, nm2, pose2, 2)]
    got = [(t.add_frame(*a, threshold=0.3095),
            j.add_frame(*a, threshold=0.3095)) for a in adds]
    assert got == [(True, True), (False, False), (True, True)]
    assert_same_db(t, j)


def test_fern_find_frame_recovers_pose():
    j, t = fern_pair()
    pose0 = np.eye(4, dtype=np.float32)
    rgb, vm, nm = small_maps(pose0)
    assert t.add_frame(rgb, vm, nm, pose0, 0, threshold=0.3095)
    assert j.add_frame(rgb, vm, nm, pose0, 0, threshold=0.3095)
    poseq = syn.pose_from(np.array([0.0, 0.004, 0.0]),
                          np.array([0.006, 0, 0]))
    rgbq, vmq, nmq = small_maps(poseq)
    args = (np.eye(4, dtype=np.float32), rgbq, vmq, nmq)
    rt = t.find_frame(*args, time=400, lost=False)
    rj = j.find_frame(*args, time=400, lost=False)
    assert rt.pose is not None, "loop closure not accepted"
    t_err = np.linalg.norm(rt.pose[:3, 3] - poseq[:3, 3])
    assert t_err < 5e-3, f"recovered pose error {t_err * 1000:.1f}mm"
    assert len(rt.constraints) > 10
    assert_same_find(rt, rj)
    assert t.last_closest == j.last_closest == 0
    # too recent for the time gap: nothing is retrieved
    assert t.find_frame(*args, time=100, lost=False).closest_id == -1


def test_fern_find_rejects_unrelated_scene():
    j, t = fern_pair()
    rgb, vm, nm = small_maps(np.eye(4))
    t.add_frame(rgb, vm, nm, np.eye(4), 0, threshold=0.3095)
    j.add_frame(rgb, vm, nm, np.eye(4), 0, threshold=0.3095)
    pts, cols = syn.make_scene(seed=5)
    rgb2, vm2, nm2 = small_maps(np.eye(4), scene=(pts, 255 - cols))
    rt = t.find_frame(np.eye(4), rgb2, vm2, nm2, time=400, lost=False)
    rj = j.find_frame(np.eye(4), rgb2, vm2, nm2, time=400, lost=False)
    assert rt.pose is None and rj.pose is None
    assert rt.closest_id == rj.closest_id == -1


# ------------------------------------------------------ deformation graph
def graph_pair(pts, max_nodes, constraints, iterations=3):
    """The same graph in both packages, optimised on the same solver
    (scipy's CG in both); returns (port graph, JAX graph, port result,
    JAX result)."""
    with numpy_paths():
        gj = JGraph.sample_from_map(pts, np.arange(float(len(pts))),
                                    max_nodes=max_nodes)
        gt = DeformationGraph.sample_from_map(
            pts, np.arange(float(len(pts))), max_nodes=max_nodes,
            device=CPU)
        for src, dst in constraints:
            gj.add_constraint(src, dst)
            gt.add_constraint(src, dst)
        rj = gj.optimise(iterations)
        rt = gt.optimise(iterations)
    assert gt.last_solver == "cg"
    assert_same_graph(gt, gj, rt, rj)
    return gt, gj, rt, rj


def assert_same_graph(gt, gj, rt, rj, rtol=1e-4, atol=1e-5) -> None:
    np.testing.assert_array_equal(gt.neighbours, gj.neighbours)
    np.testing.assert_allclose(rt, rj, rtol=rtol, atol=atol)
    np.testing.assert_allclose(gt.A, gj.A, rtol=rtol, atol=atol)
    np.testing.assert_allclose(gt.t, gj.t, rtol=rtol, atol=atol)


def accepted(res) -> bool:
    total, mean_cons = res
    return mean_cons < 0.0003 and total < 0.12


def test_deformation_identity_when_no_motion():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (400, 3))
    gt, gj, (total, mean_cons), rj = graph_pair(
        pts, 32, [(pts[i * 3], pts[i * 3]) for i in range(8)])
    assert mean_cons < 1e-4
    out = gt.apply_to_points(pts)
    np.testing.assert_allclose(out, pts, atol=1e-3)
    np.testing.assert_allclose(out, gj.apply_to_points(pts), atol=1e-6)


def test_deformation_rigid_translation():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1, 1, (300, 3))
    shift = np.array([0.05, -0.02, 0.03])
    gt, gj, (total, mean_cons), rj = graph_pair(
        pts, 24, [(pts[i * 7], pts[i * 7] + shift) for i in range(10)])
    assert mean_cons < 5e-3
    out = gt.apply_to_points(pts)
    err = np.linalg.norm(out - (pts + shift), axis=1)
    assert np.median(err) < 0.02
    assert accepted((total, mean_cons)) == accepted(rj)


def test_deformation_applies_normals_and_pose():
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1, 1, (200, 3))
    gt, gj, _, _ = graph_pair(
        pts, 16, [(pts[i * 5], pts[i * 5] + np.array([0.02, 0, 0]))
                  for i in range(6)])
    normals = np.tile(np.array([0.0, 0.0, 1.0]), (200, 1))
    out, n_out = gt.apply_to_points(pts, normals)
    np.testing.assert_allclose(np.linalg.norm(n_out, axis=1), 1.0,
                               atol=1e-6)
    oj, nj = gj.apply_to_points(pts, normals)
    np.testing.assert_allclose(out, oj, atol=1e-6)
    np.testing.assert_allclose(n_out, nj, atol=1e-6)
    new_pose = gt.apply_to_pose(np.eye(4))
    R = new_pose[:3, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-6)
    assert np.linalg.norm(new_pose[:3, 3]) > 0.005
    np.testing.assert_allclose(new_pose, gj.apply_to_pose(np.eye(4)),
                               atol=1e-6)


def test_deformation_native_solver_speed():
    """tests/test_reloc.py's 1024-node solve.  With mfcore's sparse
    Cholesky (built only where Eigen's headers are found) the second
    optimise() reuses the cached symbolic analysis and stays under the JAX
    test's 0.30 s; without it the port takes scipy's CG.  Either way the
    result is held against the JAX package's on whatever solver its own
    native library gives it: the same accept decision, the errors within
    1e-4 relative and 2e-5 absolute (CG stops at a relative residual of
    1e-4, a direct solve does not)."""
    rng = np.random.default_rng(0)
    pos = rng.uniform(-1, 1, (100000, 3)).astype(np.float32)
    cons = []
    for i in range(8):
        p = pos[rng.integers(0, len(pos))]
        cons.append((p, p + rng.normal(0, 0.003, 3)))
    graphs = {}
    for name, cls, kw in (("port", DeformationGraph, {"device": CPU}),
                          ("jax", JGraph, {})):
        g = cls.sample_from_map(pos, np.arange(100000.0), max_nodes=1024,
                                **kw)
        for src, dst in cons:
            g.add_constraint(src, dst)
        g.optimise()                   # warms a native symbolic analysis
        t0 = time.perf_counter()
        res = g.optimise()
        graphs[name] = (g, res, time.perf_counter() - t0)
    (gt, rt, dt), (gj, rj, _) = graphs["port"], graphs["jax"]
    lib = tnative.active()
    if getattr(lib, "has_chol", False):
        assert gt.last_solver == "cholesky"
        assert getattr(gt, "_chol_handle", None) is not None
        assert dt < 0.30
    else:
        assert gt.last_solver == "cg"
    assert accepted(rt) == accepted(rj)
    np.testing.assert_allclose(rt, rj, rtol=1e-4, atol=2e-5)


def test_deformation_device_apply_large():
    """apply_to_points takes the device path for 4096 points or more: the
    torch blend (here on the CPU) against the host blend and against the
    JAX package's device path."""
    rng = np.random.default_rng(1)
    pos = rng.uniform(-1, 1, (50000, 3))
    gt, gj, _, _ = graph_pair(pos, 256, [(pos[5], pos[5] + [0.01, 0, 0])],
                              iterations=1)
    nrm = np.tile([0.0, 0.0, 1.0], (len(pos), 1))
    o_d, n_d = gt.apply_to_points(pos, nrm)           # auto device path
    o_h, n_h = gt._apply_points_host(pos, nrm)
    assert np.abs(o_d - o_h).max() < 1e-5
    assert np.abs(n_d - n_h).max() < 1e-5
    o_j, n_j = gj.apply_to_points(pos, nrm, device=True)
    assert np.abs(o_d - o_j).max() < 1e-5
    assert np.abs(n_d - n_j).max() < 1e-5


def test_deformation_apply_to_map_device():
    """apply_to_map_device deforms the live prefix of the map's tensors in
    place: rows < count match the host blend and the JAX package's device
    blend; dead rows are bit-equal to their inputs."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    cap, count = 4096, 3000
    pos = np.zeros((cap, 3), np.float32)
    pos[:count] = rng.uniform(-1, 1, (count, 3))
    pos[count:] = rng.uniform(-1, 1, (cap - count, 3))   # stale dead rows
    nrm = np.zeros((cap, 3), np.float32)
    nrm[:count] = [0.0, 0.0, 1.0]
    gt, gj, _, _ = graph_pair(pos[:count], 64,
                              [(pos[7], pos[7] + [0.015, 0.0, 0.0])],
                              iterations=1)
    pos_t, nrm_t = torch.from_numpy(pos.copy()), torch.from_numpy(nrm.copy())
    new_p, new_n = gt.apply_to_map_device(pos_t, nrm_t, count)
    assert new_p is pos_t and new_n is nrm_t           # in place
    new_p, new_n = new_p.numpy(), new_n.numpy()
    ref_p, ref_n = gt.apply_to_points(pos[:count], nrm[:count], device=False)
    assert np.abs(new_p[:count] - ref_p).max() < 1e-5
    assert np.abs(new_n[:count] - ref_n).max() < 1e-5
    jp, jn = gj.apply_to_map_device(jnp.asarray(pos), jnp.asarray(nrm),
                                    count)
    assert np.abs(new_p[:count] - np.asarray(jp)[:count]).max() < 1e-5
    assert np.abs(new_n[:count] - np.asarray(jn)[:count]).max() < 1e-5
    np.testing.assert_array_equal(new_p[count:], pos[count:])
    np.testing.assert_array_equal(new_n[count:], nrm[count:])


def test_deformation_knn_ties_lowest_index_first():
    """Nodes on a regular grid and points on its symmetry planes: the k
    nearest nodes tie, and the device blend picks them lowest index first,
    as jax.lax.top_k does.  Coordinates are multiples of 1/2, so every
    squared distance of the GEMM form is exact in f32 and the ties are
    exact.  The blend, with random node transforms, matches the JAX
    package's device blend."""
    import jax
    import jax.numpy as jnp

    ax = np.arange(4.0)
    nodes = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    half = np.arange(7) * 0.5
    pts = np.stack(np.meshgrid(half, half, [0.5, 1.0, 1.5], indexing="ij"),
                   -1).reshape(-1, 3).astype(np.float32)
    pts = np.concatenate([pts] * 40)                    # >= 4096 rows
    g32 = nodes.astype(np.float32)
    d2 = ((pts * pts).sum(1)[:, None] + (g32 * g32).sum(1)[None]
          - 2.0 * pts @ g32.T)
    srt = np.sort(d2, 1)
    assert (srt[:, 3] == srt[:, 4]).mean() > 0.3       # ties at the k-th
    v, ids = tdef._nearest_k(torch.from_numpy(d2.copy()), 4)
    jneg, jids = jax.lax.top_k(-jnp.asarray(d2), 4)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(v.numpy(), -np.asarray(jneg))

    rng = np.random.default_rng(4)
    gt = DeformationGraph(nodes, device=CPU)
    gj = JGraph(nodes)
    A = np.eye(3) + rng.normal(0, 0.05, (len(nodes), 3, 3))
    t = rng.normal(0, 0.02, (len(nodes), 3))
    for g in (gt, gj):
        g.A, g.t = A.copy(), t.copy()
    nrm = np.tile([0.0, 0.6, 0.8], (len(pts), 1))
    o_t, n_t = gt.apply_to_points(pts, nrm, device=True)
    o_j, n_j = gj.apply_to_points(pts, nrm, device=True)
    assert np.abs(o_t - o_j).max() < 1e-5
    assert np.abs(n_t - n_j).max() < 1e-5
