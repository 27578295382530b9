"""Port parity of ops/seg_ops: the geometric edge map (kernel 3's plain
version on the CPU) against the JAX package's XLA twin and its Pallas kernel
in interpret mode, and the threshold and morphology passes bit for bit.

Tolerance of the edge map, as tests/test_pallas.py:22-35: fewer than 3e-3
of the pixels differ by more than 1e-5 (the concavity gate on sign(side)
flips on knife-edge neighbours under another summation order)."""

import numpy as np
import jax.numpy as jnp
import pytest

from maskfusion_tpu.ops import pallas_kernels as jpk
from maskfusion_tpu.ops import preprocess as jpp
from maskfusion_tpu.ops import seg_ops as jseg
from maskfusion_tpu_torch.ops import kernels
from maskfusion_tpu_torch.ops import seg_ops as tseg
from tests import synthetic as syn
from tests.torch_helpers import n, t


def _maps(two_objects: bool):
    """Level-0 vertex and normal maps of a rendered object frame, with a
    depth hole, as numpy arrays (NaN for invalid)."""
    if two_objects:
        pts, cols, labels = syn.make_scene_with_two_objects(
            np.array([0.01, 0.0, 0.0]), np.array([0.0, -0.01, 0.0]))
    else:
        pts, cols, labels = syn.make_scene_with_object()
    _, depth, _ = syn.render(pts, cols, np.eye(4), syn.DEFAULT_INTR,
                             labels=labels)
    depth[20:24, 30:40] = 0.0
    vmap = jpp.create_vmap(jnp.asarray(depth), syn.DEFAULT_INTR, 5.0)
    nmap = jpp.create_nmap(vmap)
    return np.asarray(vmap), np.asarray(nmap)


def _differing(a, b):
    return float((np.abs(n(a) - n(b)) > 1e-5).mean())


@pytest.mark.parametrize("two_objects", [False, True],
                         ids=["one_object", "two_objects"])
@pytest.mark.parametrize("wd,wc", [(150.0, 2.8), (40.0, 6.0)])
def test_edge_map_matches_jax(two_objects, wd, wc):
    """Against the XLA twin at the engine's weights and at weights where
    the concavity term decides more pixels; against the Pallas kernel at the
    engine's weights, the bound of tests/test_pallas.py.  (At (40, 6) the
    Pallas kernel itself differs from its twin at ~5% of these pixels: the
    gate flips where side is exactly 0 in the twin's rounding, and the
    concavity term then decides the pixel.)"""
    vmap, nmap = _maps(two_objects)
    ours = n(tseg.geometric_edge_map(t(vmap), t(nmap), wd, wc))
    twin = np.asarray(jseg.geometric_edge_map(jnp.asarray(vmap),
                                              jnp.asarray(nmap), wd, wc))
    assert ours.shape == (syn.H, syn.W) and ours.dtype == np.float32
    assert np.isfinite(ours).all() and ours.min() >= 0 and ours.max() <= 1
    assert _differing(ours, twin) < 3e-3
    if (wd, wc) == (150.0, 2.8):
        pallas = np.asarray(jpk.geometric_edge_map_pallas(
            jnp.asarray(vmap), jnp.asarray(nmap), wd, wc, interpret=True))
        assert _differing(ours, pallas) < 3e-3
    # border and invalid pixels are edges
    assert (ours[0] == 1).all() and (ours[:, -1] == 1).all()
    assert (ours[np.isnan(vmap[..., 0])] == 1).all()


def test_edge_map_cpu_wrapper_is_plain_version():
    """On a CPU tensor the wrapper takes the plain version and counts no
    launch."""
    vmap, nmap = _maps(True)
    before = kernels.geometric_edge_map.launches
    out = kernels.geometric_edge_map(t(vmap), t(nmap), 150.0, 2.8)
    ref = kernels.geometric_edge_map_plain(t(vmap), t(nmap), 150.0, 2.8)
    np.testing.assert_array_equal(n(out), n(ref))
    assert kernels.geometric_edge_map.launches == before


@pytest.mark.parametrize("two_objects", [False, True],
                         ids=["one_object", "two_objects"])
@pytest.mark.parametrize("wd,wc", [(150.0, 2.8), (40.0, 6.0)])
def test_edge_map_plain_rounds_as_the_twin(two_objects, wd, wc):
    """The plain version sums each dot product ((a0 b0 + a1 b1) + a2 b2), as
    the XLA twin's sum rounds on the CPU (and as kernel 3 rounds): on the
    CPU the two agree bit for bit, gate flips included."""
    vmap, nmap = _maps(two_objects)
    ours = n(kernels.geometric_edge_map_plain(t(vmap), t(nmap), wd, wc))
    twin = np.asarray(jseg.geometric_edge_map(jnp.asarray(vmap),
                                              jnp.asarray(nmap), wd, wc))
    np.testing.assert_array_equal(ours, twin)


@pytest.mark.parametrize("threshold", [0.1, 0.3, 0.9])
def test_threshold_map_exact(threshold):
    vmap, nmap = _maps(True)
    edge = np.asarray(jseg.geometric_edge_map(jnp.asarray(vmap),
                                              jnp.asarray(nmap), 150.0, 2.8))
    np.testing.assert_array_equal(
        n(tseg.threshold_map(t(edge), threshold)),
        np.asarray(jseg.threshold_map(jnp.asarray(edge), threshold)))


@pytest.mark.parametrize("radius,iterations", [(1, 1), (1, 2), (2, 1)])
def test_morph_binary_exact(radius, iterations):
    rng = np.random.default_rng(radius * 10 + iterations)
    mask = rng.random((syn.H, syn.W)) > 0.6
    ours = n(tseg.morph_binary(t(mask), radius, iterations))
    ref = np.asarray(jseg.morph_binary(jnp.asarray(mask), radius,
                                       iterations))
    assert ours.dtype == np.bool_
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("radius,sigmas", [(8, (0.1, 40.0, 5.0)),
                                           (3, (0.05, 20.0, 2.0))],
                         ids=["gui_defaults", "narrow"])
def test_joint_bilateral_filter_matches_jax(radius, sigmas):
    """seg_ops.joint_bilateral_filter, which no code path calls, against
    the JAX package's on a rendered frame with a depth hole: the taps sum
    in the same row-major order; the two exps round apart, so 1e-5 (both
    are finite everywhere)."""
    pts, cols, labels = syn.make_scene_with_object()
    rgb, depth, _ = syn.render(pts, cols, np.eye(4), syn.DEFAULT_INTR,
                               labels=labels)
    depth = depth.astype(np.float32)
    depth[20:24, 30:40] = 0.0
    sd, sc, sl = sigmas
    ref = n(jseg.joint_bilateral_filter(jnp.asarray(rgb), jnp.asarray(depth),
                                        radius, sd, sc, sl))
    out = n(tseg.joint_bilateral_filter(t(rgb), t(depth), radius, sd, sc,
                                        sl))
    assert out.dtype == np.float32 and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=1e-5)
