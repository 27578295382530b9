"""Port parity of the mapping layer: surfel_map, the sort_utils contracts,
splat (render, patch, combined_predict with the level-0 scan kernel's plain
version), fuse, clean and fill_in, on the synthetic 160x120 scene of
tests/test_mapping.py.

The scan is held at the bounds of tests/test_pallas.py:38-103: fewer than
3e-3 of the pixels may differ (knife-edge ties between taps flip with the
summation order), depth to 1e-5 elsewhere."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from maskfusion_tpu.mapping import surfel_map as jsm
from maskfusion_tpu.ops import clean as jclean
from maskfusion_tpu.ops import fill_in as jfill
from maskfusion_tpu.ops import fuse as jfuse
from maskfusion_tpu.ops import preprocess as jpp
from maskfusion_tpu.ops import splat as jsplat
from maskfusion_tpu_torch.mapping import surfel_map as tsm
from maskfusion_tpu_torch.ops import clean as tclean
from maskfusion_tpu_torch.ops import fill_in as tfill
from maskfusion_tpu_torch.ops import fuse as tfuse
from maskfusion_tpu_torch.ops import kernels
from maskfusion_tpu_torch.ops import sort_utils
from maskfusion_tpu_torch.ops import splat as tsplat
from tests import synthetic as syn
from tests.torch_helpers import CPU, assert_close_nan, n, t, tintr

INTR = syn.DEFAULT_INTR
TINTR = tintr(INTR)
H, W = syn.H, syn.W
CAP = 1 << 16
EYE = np.eye(4, dtype=np.float32)


def _frame(pose=EYE):
    """One frame's fusion inputs, made by the JAX package, as numpy."""
    pts, cols = syn.make_scene()
    rgb, depth = syn.render(pts, cols, pose, INTR)
    filt = jpp.bilateral_filter_depth(jnp.asarray(depth))
    vmap_raw = jpp.create_vmap(jnp.asarray(depth), INTR, 5.0)
    vmap_f = jpp.create_vmap(filt, INTR, 5.0)
    nmap_f = jpp.create_nmap(vmap_f)
    return {k: np.asarray(v) for k, v in dict(
        rgb=rgb, depth=depth, filt=filt, vmap_raw=vmap_raw, vmap_f=vmap_f,
        nmap_f=nmap_f, pose=np.asarray(pose, np.float32)).items()}


def _jmap(f):
    return jsm.init_from_frame(
        CAP, jnp.asarray(f["vmap_raw"]), jnp.asarray(f["vmap_f"]),
        jnp.asarray(f["nmap_f"]), jnp.asarray(f["rgb"]),
        jnp.zeros((H, W), jnp.uint8), jnp.uint8(0), jnp.asarray(f["pose"]),
        INTR, time=1.0)


def _tmap(f):
    return tsm.init_from_frame(
        CAP, t(f["vmap_raw"]), t(f["vmap_f"]), t(f["nmap_f"]), t(f["rgb"]),
        torch.zeros((H, W), dtype=torch.uint8), 0, t(f["pose"]), TINTR,
        time=1.0)


def _tmap_from_jax(m):
    return tsm.SurfelMap(*(t(a) for a in m[:7]),
                         count=torch.tensor(int(m.count), dtype=torch.int32))


def _assert_maps_close(mt, mj, atol=1e-5):
    c = int(mj.count)
    assert int(mt.count) == c
    for a, b in zip(mt[:7], mj[:7]):
        np.testing.assert_allclose(n(a)[:c], n(b)[:c], atol=atol)
        assert not n(a)[c:].any()


def test_init_from_frame_parity():
    f = _frame()
    _assert_maps_close(_tmap(f), _jmap(f))


def test_compaction_overflow_and_order():
    m = tsm.empty(16, CPU)
    vals = torch.arange(32, dtype=torch.float32)
    out = tsm.compact_into(m, torch.ones(32, dtype=torch.bool),
                           torch.stack([vals] * 3, -1), vals,
                           torch.stack([vals] * 3, -1), vals, vals,
                           torch.stack([vals] * 3, -1), vals)
    assert int(out.count) == 16          # clamped, no wraparound
    np.testing.assert_allclose(n(out.conf), np.arange(16))
    # stable: kept elements first, in order, zeros after
    keep = torch.tensor([0, 1, 1, 0, 1, 0, 0, 1], dtype=torch.bool)
    (vals_c,), count = sort_utils.compact(keep, [torch.arange(8.0) + 1])
    assert int(count) == 4
    np.testing.assert_array_equal(n(vals_c), [2, 3, 5, 8, 0, 0, 0, 0])


def test_zbuffer_ties_to_lowest_slot():
    lin = torch.tensor([3, 3, 3, 1, 1, 0], dtype=torch.int64)
    z = torch.tensor([2.0, 1.0, 1.0, 5.0, 5.0, 7.0])
    valid = torch.tensor([1, 1, 1, 1, 1, 0], dtype=torch.bool)
    idx, zz = sort_utils.zbuffer_render(lin, z, valid, 4)
    np.testing.assert_array_equal(n(idx), [-1, 3, -1, 1])
    np.testing.assert_array_equal(n(zz), [np.inf, 5.0, np.inf, 1.0])


def _renders(f, time=1.0):
    mj = _jmap(f)
    mt = _tmap_from_jax(mj)
    imj = jsplat.render_index_map(mj, jnp.eye(4), INTR, H, W, time=time,
                                  time_delta=200, max_depth=5.0)
    imt = tsplat.render_index_map(mt, torch.eye(4), TINTR, H, W, time=time,
                                  time_delta=200, max_depth=5.0)
    return mj, mt, imj, imt


def test_render_index_map_parity():
    mj, mt, imj, imt = _renders(_frame())
    same = n(imt.index) == n(imj.index)
    assert same.mean() > 1 - 1e-3
    for a, b in zip(imt[1:], imj[1:]):
        a, b = n(a), n(b)
        np.testing.assert_allclose(a[same], b[same], atol=1e-5)
    # the coarse render of combined_predict
    cj = jsplat.render_index_map(mj, jnp.eye(4), INTR.level(2), H >> 2,
                                 W >> 2, time=1.0, time_delta=200,
                                 max_depth=5.0)
    ct = tsplat.render_index_map(mt, torch.eye(4), TINTR.level(2), H >> 2,
                                 W >> 2, time=1.0, time_delta=200,
                                 max_depth=5.0)
    assert (n(ct.index) == n(cj.index)).mean() > 1 - 1e-3


def _tim_from_jax(im):
    return tsplat.IndexMap(*(t(a) for a in im))


def _hold_prediction(out, ref):
    rd, od = n(ref.depth), n(out.depth)
    mismatch = np.abs(rd - od) > 1e-5
    assert mismatch.mean() < 3e-3, f"{mismatch.sum()} mismatching pixels"
    same = ~mismatch
    np.testing.assert_allclose(n(out.conf)[same], n(ref.conf)[same],
                               atol=1e-5)
    np.testing.assert_allclose(n(out.rgb)[same], n(ref.rgb)[same], atol=1e-4)
    rn, on = n(ref.nmap), n(out.nmap)
    both = same & np.isfinite(rn[..., 0]) & np.isfinite(on[..., 0])
    np.testing.assert_allclose(on[both], rn[both], atol=1e-5)
    rv, ov = n(ref.vmap), n(out.vmap)
    both = same & np.isfinite(rv[..., 0]) & np.isfinite(ov[..., 0])
    np.testing.assert_allclose(ov[both], rv[both], atol=1e-5)


@pytest.mark.parametrize("coarse", [False, True])
def test_combined_predict_matches_pallas_scan(coarse):
    """The port's combined_predict (the scan kernel's plain version on the
    CPU) against the JAX package's with the Pallas scan in interpret mode,
    and against its XLA tap loop, on the same index maps."""
    mj, _, imj, _ = _renders(_frame())
    cj = jsplat.render_index_map(mj, jnp.eye(4), INTR.level(2), H >> 2,
                                 W >> 2, time=1.0, time_delta=200,
                                 max_depth=5.0) if coarse else None
    jkw = dict(coarse=(cj, 2)) if coarse else {}
    tkw = dict(coarse=(_tim_from_jax(cj), 2)) if coarse else {}
    out = tsplat.combined_predict(_tim_from_jax(imj), TINTR, 5.0, **tkw)
    pallas = jsplat.combined_predict(imj, INTR, 5.0, pallas=True,
                                     pallas_interpret=True, **jkw)
    twin = jsplat.combined_predict(imj, INTR, 5.0, **jkw)
    _hold_prediction(out, pallas)
    _hold_prediction(out, twin)


def test_scan_plain_matches_pallas_outputs():
    """Kernel 2's plain version against predict_l0_scan_pallas itself:
    best_src as the exact winning pixel, best_z to 1e-5."""
    from maskfusion_tpu.ops import pallas_kernels as jpk

    _, _, imj, _ = _renders(_frame())
    zj, sj = jpk.predict_l0_scan_pallas(
        imj.pos, imj.normal, imj.radius, imj.index >= 0, INTR.fx, INTR.fy,
        INTR.cx, INTR.cy, 5.0, interpret=True)
    zt, st = kernels.predict_l0_scan(
        t(imj.pos), t(imj.normal), t(imj.radius), t(imj.index) >= 0,
        kernels.intrinsics(INTR, CPU), 5.0)
    assert st.dtype == torch.int32
    differ = (n(st) != n(sj).astype(np.int32))
    assert differ.mean() < 3e-3
    np.testing.assert_allclose(n(zt)[~differ], n(zj)[~differ], atol=1e-5)


def _fuse_both(time=2.0, parity=None, perturb=False):
    f = _frame()
    mj, mt, imj, _ = _renders(f, time=time)
    imt = _tim_from_jax(imj)
    vmap_raw = f["vmap_raw"].copy()
    if perturb:
        vmap_raw[10:14, 10:14] = np.nan
        vmap_raw[10:14, 10:14, 2] = 0.0
    args_j = (jnp.asarray(vmap_raw), jnp.asarray(f["vmap_f"]),
              jnp.asarray(f["nmap_f"]), jnp.asarray(f["rgb"]),
              jnp.zeros((H, W), jnp.uint8), jnp.uint8(0), jnp.eye(4), INTR)
    args_t = (t(vmap_raw), t(f["vmap_f"]), t(f["nmap_f"]), t(f["rgb"]),
              torch.zeros((H, W), dtype=torch.uint8), 0, torch.eye(4), TINTR)
    rj = jfuse.fuse(mj, imj, *args_j, time, 0.8, 5.0, parity=parity)
    rt = tfuse.fuse(mt, imt, *args_t, time, torch.tensor(0.8), 5.0,
                    parity=parity)
    return f, mj, imj, rj, rt, vmap_raw


@pytest.mark.parametrize("parity", [None, 0, 1])
def test_fuse_parity(parity):
    _, mj, _, rj, rt, _ = _fuse_both(time=2.0 + (parity or 0),
                                     parity=parity)
    np.testing.assert_array_equal(n(rt.matched_pixels),
                                  n(rj.matched_pixels))
    np.testing.assert_array_equal(n(rt.new_pixels), n(rj.new_pixels))
    # the JAX package's segment sums are cumsum differences over the whole
    # bucket: absolute error ~ulp of the running total, ~1e-4 of a conf
    # unit, so a slot with no matched pixel can read a tiny positive sum and
    # count as updated (last_seen := time).  The port adds per slot, exactly.
    # Those slots are the only allowed difference in the update set.
    c = int(rj.map.count)
    assert int(rt.map.count) == c
    conf0 = n(mj.conf)[:c]
    gain_t = n(rt.map.conf)[:c] - conf0
    gain_j = n(rj.map.conf)[:c] - conf0
    spurious = n(rt.map.last_seen)[:c] != n(rj.map.last_seen)[:c]
    assert spurious.mean() < 5e-3
    assert (gain_t[spurious] == 0).all()
    assert (np.abs(gain_j[spurious]) < 1e-3).all()
    same = ~spurious
    for name, atol in (("pos", 2e-3), ("conf", 2e-3), ("color", 0.5),
                       ("init_time", 0), ("last_seen", 0),
                       ("normal", 2e-3), ("radius", 1e-4)):
        np.testing.assert_allclose(n(getattr(rt.map, name))[:c][same],
                                   n(getattr(rj.map, name))[:c][same],
                                   atol=atol, err_msg=name)


def test_patch_index_map_parity():
    f, mj, imj, rj, rt, vmap_raw = _fuse_both(perturb=True)
    conf_px = jsm.pixel_confidence(H, W, INTR, 1.0) * 0.8
    rad_px = jsm.radius_from_depth(jnp.asarray(f["vmap_f"][..., 2]),
                                   jnp.asarray(f["nmap_f"][..., 2]), INTR)
    pj = jsplat.patch_index_map(
        imj, rj.map, rj.new_pixels, jnp.asarray(vmap_raw),
        jnp.asarray(f["nmap_f"]), conf_px, jnp.asarray(f["rgb"]),
        rad_px, jnp.eye(4), 2.0, mj.count)
    pt = tsplat.patch_index_map(
        _tim_from_jax(imj), _tmap_from_jax(rj.map), t(rj.new_pixels),
        t(vmap_raw), t(f["nmap_f"]), t(conf_px), t(f["rgb"]), t(rad_px),
        torch.eye(4), 2.0, torch.tensor(int(mj.count), dtype=torch.int32))
    np.testing.assert_array_equal(n(pt.index), n(pj.index))
    for a, b in zip(pt[1:], pj[1:]):
        assert_close_nan(a, b, atol=1e-5)


@pytest.mark.parametrize("time,compact", [(5.0, True), (30.0, True),
                                          (2.0, False)])
def test_clean_parity(time, compact):
    """Clean computes in f32 where the JAX package packs f16 hi/lo taps:
    parity is counted in surfels kept (same set up to 1e-3 of the map)."""
    f = _frame()
    mj, mt, imj, imt = _renders(f, time=time)
    mask = np.zeros((H, W), np.uint8)
    mask[:, : W // 2] = 1
    cj = jclean.clean(mj, imj, jnp.asarray(f["filt"]), jnp.asarray(mask),
                      jnp.uint8(0), jnp.eye(4), INTR, time=time,
                      time_delta=200, conf_threshold=10.0, max_depth=5.0,
                      outlier_coeff=3.0, compact=compact)
    ct = tclean.clean(mt, _tim_from_jax(imj), t(f["filt"]), t(mask), 0,
                      torch.eye(4), TINTR, time=time, time_delta=200,
                      conf_threshold=10.0, max_depth=5.0, outlier_coeff=3.0,
                      compact=compact)
    kj, kt = n(cj.keep), n(ct.keep)
    assert (kj != kt).sum() <= 1e-3 * int(mj.count)
    assert abs(int(ct.removed) - int(cj.removed)) <= 1e-3 * int(mj.count)
    same = kj == kt
    np.testing.assert_allclose(n(ct.conf)[same], n(cj.conf)[same], atol=1e-6)
    if time == 30.0:
        assert int(ct.map.count) == 0     # everything unstable timed out
    if compact and time == 5.0:
        _assert_maps_close(ct.map, cj.map)


def test_fill_in_parity():
    f = _frame()
    _, _, imj, imt = _renders(f)
    pj = jsplat.combined_predict(imj, INTR, 5.0)
    pt = tsplat.combined_predict(_tim_from_jax(imj), TINTR, 5.0)
    fj = jfill.fill_in(pj, jnp.asarray(f["rgb"]), jnp.asarray(f["vmap_f"]),
                       jnp.asarray(f["nmap_f"]))
    ft = tfill.fill_in(pt, t(f["rgb"]), t(f["vmap_f"]), t(f["nmap_f"]))
    differ = np.abs(n(pt.depth) - n(pj.depth)) > 1e-5
    for a, b in zip(ft, fj):
        a, b = n(a), n(b)
        assert_close_nan(a[~differ], b[~differ], atol=1e-4)
    assert abs(float(tfill.coverage(pt)) - float(jfill.coverage(pj))) < 3e-3


def test_synthesize_depth_parity():
    """splat.synthesize_depth, which no code path calls: the prediction's
    depth image (0 in holes), against the JAX package's on the same index
    map at the scan's bound."""
    _, _, imj, _ = _renders(_frame())
    out = tsplat.synthesize_depth(tsplat.combined_predict(
        _tim_from_jax(imj), TINTR, 5.0))
    ref = n(jsplat.synthesize_depth(jsplat.combined_predict(imj, INTR, 5.0)))
    out = n(out)
    assert out.shape == (H, W) and out.dtype == np.float32
    assert (out > 0).mean() > 0.5
    assert (np.abs(out - ref) > 1e-5).mean() < 3e-3
    np.testing.assert_array_equal(out == 0, ref == 0)
