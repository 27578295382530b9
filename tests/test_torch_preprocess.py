"""Port parity of ops/preprocess: the cases of tests/test_preprocess.py and
the bilateral kernel's hold of tests/test_pallas.py, through both packages.

Tolerances: 1e-5 where the two packages sum the same taps in another order
(the bilateral, the tent resize); 1e-6 or exact where the arithmetic is the
same."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from maskfusion_tpu.camera import CameraIntrinsics
from maskfusion_tpu.ops import pallas_kernels as jpk
from maskfusion_tpu.ops import preprocess as jpp
from maskfusion_tpu_torch.ops import kernels
from maskfusion_tpu_torch.ops import preprocess as tpp
from tests import synthetic as syn
from tests.torch_helpers import assert_close_nan, n, t, tintr

INTR = CameraIntrinsics(fx=100.0, fy=120.0, cx=32.0, cy=24.0)
TINTR = tintr(INTR)


def synth_depth(h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    return (1.0 + 0.5 * rng.random((h, w))).astype(np.float32)


def _scene_depth():
    pts, cols = syn.make_scene()
    _, depth = syn.render(pts, cols, np.eye(4), syn.DEFAULT_INTR)
    depth[20:24, 30:40] = 0.0
    return depth


@pytest.mark.parametrize("radius", [2, 6])
def test_bilateral_matches_pallas_kernel(radius):
    """The port's bilateral (its plain version on the CPU) against the TPU
    kernel in interpret mode and its XLA twin, at atol 1e-5
    (tests/test_pallas.py:12-19)."""
    depth = _scene_depth()
    ours = n(tpp.bilateral_filter_depth(t(depth), radius=radius))
    pallas = n(jpk.bilateral_filter_depth_pallas(
        jnp.asarray(depth), radius=radius, interpret=True))
    twin = n(jpp.bilateral_filter_depth(jnp.asarray(depth), radius=radius))
    np.testing.assert_allclose(ours, pallas, atol=1e-5)
    np.testing.assert_allclose(ours, twin, atol=1e-5)


def test_bilateral_engine_params():
    """The engine's width-scaled parameters at 160 px: R=2, sigma x16."""
    depth = _scene_depth()
    ss = 0.024691358 / 0.25 ** 2
    ours = n(kernels.bilateral_depth(t(depth), 2, ss, 555.556, 0.03))
    ref = n(jpp.bilateral_filter_depth(jnp.asarray(depth), radius=2,
                                       sigma_space2_inv_half=ss))
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def _bilateral_as_the_kernel(depth, radius, ss, sc, min_valid):
    """The arithmetic of csrc/bilateral_depth.cu in float32 torch: the
    weight ex2(S - diff^2 * sc*log2e) with the spatial table
    S = -(dy^2+dx^2) * ss*log2e, the fused multiply-adds (one rounding,
    taken from float64), ex2's flush below 2^-126; taps outside the image
    and non-finite ones staged as FLT_MAX on the fast path; centres that are
    non-finite or above 1e18 on the exact path, which skips non-finite taps.
    (The card's ex2 differs from torch.exp2 by its own 2 ulp.)"""
    f32 = torch.float32
    d = torch.from_numpy(depth)
    H, W = d.shape
    log2e = torch.tensor(1.4426950408889634, dtype=f32)
    ssl = torch.tensor(ss, dtype=f32) * log2e
    scl = torch.tensor(sc, dtype=f32) * log2e
    big = torch.finfo(f32).max
    staged = torch.where(torch.isfinite(d), d, big)
    pad_fast = torch.nn.functional.pad(staged[None], (radius,) * 4,
                                       value=big)[0]
    pad_raw = torch.nn.functional.pad(d[None], (radius,) * 4,
                                      value=float("inf"))[0]

    def fma(a, b, c):
        return (a.double() * b.double() + c.double()).to(f32)

    def ex2(e):
        w = torch.exp2(e)
        return torch.where(w < 2.0 ** -126, 0.0, w)

    zero = torch.zeros_like(d)
    s1f, s2f, s1e, s2e = zero, zero, zero, zero
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            S = -(torch.tensor(float(dy * dy + dx * dx), dtype=f32) * ssl)
            win = (slice(radius + dy, radius + dy + H),
                   slice(radius + dx, radius + dx + W))
            nb = pad_fast[win]
            diff = staged - nb
            w = ex2(fma(diff * diff, -scl, S))
            s1f, s2f = fma(nb, w, s1f), s2f + w
            nb = pad_raw[win]
            ok = torch.isfinite(nb)
            diff = d - nb
            w = ex2(fma(diff * diff, -scl, S))
            s1e = torch.where(ok, fma(nb, w, s1e), s1e)
            s2e = torch.where(ok, s2e + w, s2e)
    fast = bool(scl > 0) and bool(torch.isfinite(ssl))
    fast = fast & (staged.abs() < 1e18)
    s1 = torch.where(fast, s1f, s1e)
    s2 = torch.where(fast, s2f, s2e)
    out = s1 / torch.clamp(s2, min=1e-20)
    return torch.where(d <= min_valid, 0.0, out)


@pytest.mark.parametrize("radius,ss", [(2, 0.024691358 / 0.25 ** 2),
                                       (6, 0.024691358)])
def test_bilateral_kernel_arithmetic(radius, ss):
    """The bilateral kernel's reformulated weight, rehearsed on the CPU,
    against the JAX package's filter at atol 1e-5 on the 160x120 scene with
    its zero holes, an inf and a NaN pixel."""
    depth = _scene_depth()
    depth[60, 80] = np.inf
    depth[90, 20] = np.nan
    ours = n(_bilateral_as_the_kernel(depth, radius, ss, 555.556, 0.03))
    ref = n(jpp.bilateral_filter_depth(jnp.asarray(depth), radius=radius,
                                       sigma_space2_inv_half=ss))
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    assert ours[60, 80] == 0.0 and np.isnan(ours[90, 20])


@pytest.mark.parametrize("case", ["constant", "step", "hole"])
def test_bilateral_cases(case):
    rng = np.random.default_rng(0)
    if case == "constant":
        d = np.full((40, 40), 1.5, np.float32)
    elif case == "step":
        d = np.full((40, 60), 1.0, np.float32)
        d[:, 30:] = 2.0
        d += rng.normal(scale=0.005, size=d.shape).astype(np.float32)
    else:
        d = np.full((20, 20), 1.0, np.float32)
        d[3, 3] = 0.0
    ours = n(tpp.bilateral_filter_depth(t(d)))
    np.testing.assert_allclose(
        ours, n(jpp.bilateral_filter_depth(jnp.asarray(d))), atol=1e-5)
    if case == "hole":
        assert ours[3, 3] == 0.0


def test_vmap_nmap_parity():
    d = synth_depth()
    d[5, 5] = 0.0
    d[6, 6] = 99.0  # beyond cutoff
    vj = jpp.create_vmap(jnp.asarray(d), INTR, 5.0)
    vt = tpp.create_vmap(t(d), TINTR, 5.0)
    assert_close_nan(vt, vj, atol=1e-6)
    assert_close_nan(tpp.create_nmap(vt), jpp.create_nmap(vj), atol=1e-5)
    plane = np.full((32, 32), 2.0, np.float32)
    assert_close_nan(
        tpp.create_nmap(tpp.create_vmap(t(plane), TINTR, 5.0)),
        jpp.create_nmap(jpp.create_vmap(jnp.asarray(plane), INTR, 5.0)),
        atol=1e-6)


def test_transform_and_resize_parity():
    d = synth_depth(32, 32)
    d[7:9, 3:6] = 0.0
    vj = jpp.create_vmap(jnp.asarray(d), INTR, 5.0)
    nj = jpp.create_nmap(vj)
    vt, nt = t(vj), t(nj)
    rng = np.random.default_rng(1)
    from maskfusion_tpu import se3 as jse3
    R = n(jse3.rodrigues(jnp.asarray(rng.normal(size=3) * 0.3,
                                     jnp.float32)))
    tv = np.array([1.0, -2.0, 0.5], np.float32)
    for a, b in zip(tpp.transform_maps(vt, nt, t(R), t(tv)),
                    jpp.transform_maps(vj, nj, jnp.asarray(R),
                                       jnp.asarray(tv))):
        assert_close_nan(a, b, atol=1e-5)
    assert_close_nan(tpp.resize_vmap(vt), jpp.resize_vmap(vj), atol=1e-6)
    assert_close_nan(tpp.resize_nmap(nt), jpp.resize_nmap(nj), atol=1e-5)


def test_pyramid_downsample_parity():
    d = synth_depth(48, 64)
    d[10:12, 10:12] = 0.0
    d[30, 40] = np.nan
    assert_close_nan(tpp.pyr_down_gauss_depth(t(d)),
                     jpp.pyr_down_gauss_depth(jnp.asarray(d)), atol=1e-6)
    img = np.random.default_rng(2).integers(0, 256, (32, 48)).astype(np.uint8)
    img[4:9, 4:9] = 0
    np.testing.assert_array_equal(
        n(tpp.pyr_down_uchar_gauss(t(img))),
        n(jpp.pyr_down_uchar_gauss(jnp.asarray(img))))
    np.testing.assert_array_equal(
        n(tpp.pyr_down_mask_nearest(t(img))),
        n(jpp.pyr_down_mask_nearest(jnp.asarray(img))))


def test_intensity_and_derivatives_parity():
    rgb = np.random.default_rng(3).integers(0, 256, (24, 40, 3)).astype(
        np.uint8)
    gt = tpp.rgb_to_intensity(t(rgb))
    gj = jpp.rgb_to_intensity(jnp.asarray(rgb))
    np.testing.assert_array_equal(n(gt), n(gj))
    for a, b in zip(tpp.compute_derivative_images(gt),
                    jpp.compute_derivative_images(gj)):
        np.testing.assert_array_equal(n(a), n(b))
    ramp = np.tile(np.arange(32, dtype=np.uint8) * 4, (16, 1))
    for a, b in zip(tpp.compute_derivative_images(t(ramp)),
                    jpp.compute_derivative_images(jnp.asarray(ramp))):
        np.testing.assert_array_equal(n(a), n(b))


def test_build_frame_pyramids_parity():
    pts, cols = syn.make_scene()
    rgb, depth = syn.render(pts, cols, np.eye(4), syn.DEFAULT_INTR)
    filt = jpp.bilateral_filter_depth(jnp.asarray(depth), radius=2)
    gray = jpp.rgb_to_intensity(jnp.asarray(rgb))
    mask = np.zeros(depth.shape, np.uint8)
    lj = jpp.build_frame_pyramids(filt, gray, jnp.asarray(mask),
                                  syn.DEFAULT_INTR, 5.0, 3)
    lt = tpp.build_frame_pyramids(t(filt), t(gray), t(mask),
                                  tintr(syn.DEFAULT_INTR), 5.0, 3)
    assert len(lt) == 3
    for a, b in zip(lt, lj):
        assert_close_nan(a["depth"], b["depth"], atol=1e-6)
        np.testing.assert_array_equal(n(a["intensity"]), n(b["intensity"]))
        np.testing.assert_array_equal(n(a["mask"]), n(b["mask"]))
        assert_close_nan(a["vmap"], b["vmap"], atol=1e-6)
        assert_close_nan(a["nmap"], b["nmap"], atol=1e-5)


def test_project_to_pointcloud_exact():
    """preprocess.project_to_pointcloud, which no code path calls: the same
    f32 arithmetic, so bit-equal (no validity gating: zero depth gives
    zero points)."""
    depth = _scene_depth()
    out = n(tpp.project_to_pointcloud(t(depth), TINTR))
    ref = n(jpp.project_to_pointcloud(jnp.asarray(depth), INTR))
    assert out.shape == depth.shape + (3,)
    np.testing.assert_array_equal(out, ref)
    assert (out[20:24, 30:40] == 0).all()
