"""The hand-written kernels' wrappers (ops/kernels).

On the CPU a wrapper takes its plain version; the tests marked `cuda`
compare the CUDA kernels with their plain versions on the card and skip
where there is none.  This file imports nothing of JAX, so it also runs
where JAX is absent: `pytest --noconftest -m cuda tests/test_torch_kernels.py`
(the root conftest.py configures JAX).  Bounds: the bilateral to atol 1e-5; the scan
to fewer than 3e-3 pixels differing in depth by more than 1e-5
(tests/test_pallas.py), and its winner ids as chip_smoke.check_scan holds
them."""

import numpy as np
import pytest
import torch

import chip_smoke
from maskfusion_tpu_torch.ops import kernels

CPU = torch.device("cpu")


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def n(x) -> np.ndarray:
    return x.detach().cpu().numpy()


@pytest.fixture
def cuda_device():
    """A CUDA device for the tests marked `cuda`; they skip where there is
    none.  The decision is taken here, never while the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on a machine with one: pytest "
                    "--noconftest -m cuda tests/test_torch_kernels.py)")
    return torch.device("cuda")

H, W = 120, 160


def _depth():
    """The synthetic scene of tests/synthetic.py at the identity pose (its
    JAX-free copy in chip_smoke.py), with a hole."""
    rgb, depth, _ = chip_smoke.synthetic_depth()
    return rgb, depth


def test_cpu_wrappers_take_plain_versions():
    _, depth = _depth()
    before = (kernels.bilateral_depth.launches,
              kernels.predict_l0_scan.launches)
    out = kernels.bilateral_depth(t(depth), 2, 0.4, 555.556, 0.03)
    ref = kernels.bilateral_depth_plain(t(depth), 2, 0.4, 555.556, 0.03)
    np.testing.assert_array_equal(n(out), n(ref))
    args = chip_smoke.synthetic_scan_args(CPU)
    z, s = kernels.predict_l0_scan(*args)
    zp, sp = kernels.predict_l0_scan_plain(*args)
    np.testing.assert_array_equal(n(z), n(zp))
    np.testing.assert_array_equal(n(s), n(sp))
    # plain-version calls are no kernel launches
    assert (kernels.bilateral_depth.launches,
            kernels.predict_l0_scan.launches) == before


def test_library_is_keyed_by_sources():
    p = kernels.library_path()
    assert p == kernels.library_path()
    assert p.parent.name == "kernels" and p.parent.parent.name == "build"
    assert p.name.startswith("libmft_kernels_") and p.suffix == ".so"
    assert {s.name for s in kernels._sources()} == {
        "bilateral_depth.cu", "predict_l0_scan.cu", "geometric_edge_map.cu"}


@pytest.mark.cuda
@pytest.mark.parametrize("radius,h,w", [(2, H, W), (6, H, W), (6, 37, 53)])
def test_bilateral_kernel_matches_plain(cuda_device, radius, h, w):
    _, depth = _depth()
    d = t(depth[:h, :w]).to(cuda_device)
    before = kernels.bilateral_depth.launches
    out = kernels.bilateral_depth(d, radius, 0.024691358, 555.556, 0.03)
    torch.cuda.synchronize()
    assert kernels.bilateral_depth.launches == before + 1
    ref = kernels.bilateral_depth_plain(d, radius, 0.024691358, 555.556,
                                        0.03)
    np.testing.assert_allclose(n(out), n(ref), atol=1e-5)


def _hard_depth(h, w):
    """The synthetic depth cropped to h x w, with its zero holes, plus a
    NaN, a +inf, a -inf and a huge finite pixel, each a centre of its own
    and a tap of its neighbours'."""
    _, depth = _depth()
    d = depth[:h, :w].copy()
    d[5, 7] = np.nan
    d[h // 2, w // 3] = np.inf
    d[h - 3, w - 4] = -np.inf
    d[h // 3, w - 9] = 1e20
    return d


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(H, W), (37, 53)])
@pytest.mark.parametrize("radius", [1, 2, 3, 4, 5, 6, 7, 8, 11])
def test_bilateral_kernel_every_radius(cuda_device, radius, h, w):
    """Radii 1-8 (the compiled instances) and 11 (the runtime radius), at
    sizes that leave part tiles (the kernel's tiles are 32x16), with zero
    holes, non-finite centres and taps and a huge centre: the exact path
    and the FLT_MAX sentinel taps against the plain version, to atol 1e-5
    (NaN where the plain version gives NaN)."""
    d = t(_hard_depth(h, w)).to(cuda_device)
    ss = 0.024691358 * (6.0 / radius) ** 2
    out = kernels.bilateral_depth(d, radius, ss, 555.556, 0.03)
    torch.cuda.synchronize()
    ref = kernels.bilateral_depth_plain(d, radius, ss, 555.556, 0.03)
    np.testing.assert_allclose(n(out), n(ref), atol=1e-5)
    assert np.isnan(n(ref)[5, 7]) and n(ref)[h // 2, w // 3] == 0.0


def _scan_live_variant(args, which):
    """synthetic_scan_args with its live map cut to `which`."""
    pos, normal, radius, live = args[:4]
    h, w = live.shape
    yy = torch.arange(h, device=live.device)[:, None].expand(h, w)
    xx = torch.arange(w, device=live.device)[None, :].expand(h, w)
    if which == "dead":
        cut = torch.zeros_like(live)
    elif which == "halo":
        # live only on column 31 / 96 and row 14 / 62: the tiles beside
        # them (x 32-63, 64-95; y 16-31, 64-79 for the kernel's 32x16
        # tiles) hold no live texel but have live ones in their +-2 halo
        cut = (xx == 31) | (xx == 96) | (yy == 14) | (yy == 62)
    else:   # "sparse": 5% of the texels, from a seed
        rng = np.random.default_rng(4)
        cut = t(rng.random((h, w)) < 0.05).to(live.device)
    return (pos, normal, radius, live & cut) + tuple(args[4:])


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(H, W), (37, 53)])
@pytest.mark.parametrize("which", ["dead", "halo", "sparse"])
def test_scan_kernel_on_sparse_maps(cuda_device, which, h, w):
    """The scan's empty-tile exit: an all-dead map gives +inf / -1
    everywhere; a map live only in the halo of dead tiles, and a sparse one,
    agree with the plain version as check_scan holds it."""
    args = _scan_live_variant(chip_smoke.synthetic_scan_args(cuda_device, h,
                                                              w), which)
    before = kernels.predict_l0_scan.launches
    z, s = kernels.predict_l0_scan(*args)
    torch.cuda.synchronize()
    assert kernels.predict_l0_scan.launches == before + 1
    zp, sp = kernels.predict_l0_scan_plain(*args)
    if which == "dead":
        assert bool(torch.isinf(z).all()) and bool((s == -1).all())
    if which == "halo" and w > 96:
        # the dead tiles' rays do meet the halo's disks
        assert bool(torch.isfinite(zp[:, 32:34]).any())
    chip_smoke.check_scan(args, z, s, zp, sp,
                          max_flips=chip_smoke.SYNTHETIC_SCAN_MAX_FLIPS)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["full", "sparse", "window3"])
def test_scan_fast_division_is_exact(cuda_device, which):
    """The scan's fast division gives what __fdiv_rn gives: both paths of
    the kernel agree bit for bit."""
    args = chip_smoke.synthetic_scan_args(cuda_device, 37, 53)
    kw = {}
    if which == "sparse":
        args = _scan_live_variant(args, "sparse")
    elif which == "window3":
        kw = {"window": 3}
    z, s = kernels.predict_l0_scan(*args, **kw)
    ze, se = kernels.predict_l0_scan(*args, exact_division=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(z, ze) and torch.equal(s, se)


@pytest.mark.cuda
def test_scan_kernel_out_of_range_texel(cuda_device):
    """A live texel whose normal is out of the fast division's range sends
    its block to the exact division; the scan still holds against the
    plain version."""
    pos, normal, radius, live, *rest = chip_smoke.synthetic_scan_args(
        cuda_device)
    normal = normal.clone()
    normal[3, 3] = torch.tensor([0.0, 0.0, 2.0 ** 60], device=cuda_device)
    live = live.clone()
    live[3, 3] = True
    args = (pos, normal, radius, live, *rest)
    z, s = kernels.predict_l0_scan(*args)
    torch.cuda.synchronize()
    zp, sp = kernels.predict_l0_scan_plain(*args)
    chip_smoke.check_scan(args, z, s, zp, sp,
                          max_flips=chip_smoke.SYNTHETIC_SCAN_MAX_FLIPS)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [1, 3])
def test_scan_kernel_runtime_window(cuda_device, window):
    """A window other than the compiled 2 runs the runtime-window kernel."""
    args = chip_smoke.synthetic_scan_args(cuda_device, 37, 53)
    z, s = kernels.predict_l0_scan(*args, window=window)
    torch.cuda.synchronize()
    zp, sp = kernels.predict_l0_scan_plain(*args, window=window)
    chip_smoke.check_scan(args, z, s, zp, sp, window=window,
                          max_flips=chip_smoke.SYNTHETIC_SCAN_MAX_FLIPS)


@pytest.mark.cuda
def test_launch_shapes(cuda_device):
    """Each source reports its grid and a resident count the card takes."""
    for name, param in (("bilateral_depth", 6), ("bilateral_depth", 11),
                        ("predict_l0_scan", 2), ("geometric_edge_map", 0)):
        shape = kernels.launch_shape(name, 480, 640, param)
        assert shape["grid"][0] * shape["grid"][1] > 0
        assert shape["blocks_per_sm"] >= 1, (name, shape)


def test_kernel_resources_parses_ptxas():
    log = """== bilateral_depth.cu
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6kernelILi6EEvPf' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi6EEvPf
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Function properties for _Z10exact_sumsv
    16 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_Z4edgev' for 'sm_90a'
ptxas info    : Function properties for _Z4edgev
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers, 8160 bytes smem, \
400 bytes cmem[0]
"""
    res = kernels.kernel_resources(log)
    assert res == {
        "_Z6kernelILi6EEvPf": {"regs": 72, "smem_static": 0, "stack": 0,
                               "spill_stores": 8, "spill_loads": 4},
        "_Z4edgev": {"regs": 32, "smem_static": 8160, "stack": 0,
                     "spill_stores": 0, "spill_loads": 0}}


def test_scan_bound_counts_live_texels_only():
    """scan_bound: every pixel's live byte and 8 output bytes, pos, normal
    and radius (28 B) for live texels only; operations per pixel and per
    live tap."""
    live = torch.zeros((30, 40), dtype=torch.bool)
    live[10, 10] = True
    live[0, 0] = True
    b = chip_smoke.scan_bound(live)
    assert b["bytes"] == 30 * 40 * 9 + 2 * 28
    # the +-2 window of (10, 10) is whole, that of (0, 0) 3 x 3
    assert b["ops"] == (chip_smoke.SCAN_OPS_PER_PIXEL * 30 * 40
                        + chip_smoke.SCAN_OPS_PER_LIVE_TAP * (25 + 9))
    empty = chip_smoke.scan_bound(torch.zeros((30, 40), dtype=torch.bool))
    assert empty["bytes"] == 30 * 40 * 9 and empty["bound_by"] == "bytes"


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(H, W), (37, 53)])
def test_scan_kernel_matches_plain(cuda_device, h, w):
    args = chip_smoke.synthetic_scan_args(cuda_device, h, w)
    z, s = kernels.predict_l0_scan(*args)
    torch.cuda.synchronize()
    zp, sp = kernels.predict_l0_scan_plain(*args)
    # depth as tests/test_pallas.py; every winner id must be a live tap of
    # the pixel's window hit at the kernel's depth (a true tie where it is
    # not the plain version's)
    chip_smoke.check_scan(args, z, s, zp, sp,
                           max_flips=chip_smoke.SYNTHETIC_SCAN_MAX_FLIPS)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(H, W), (37, 53)])
def test_edge_map_kernel_matches_plain(cuda_device, h, w):
    """Kernel 3 against its plain version on the synthetic scene's vertex
    and normal maps (with a depth hole), at chip_smoke.check_edge_map's
    bound: fewer than 3e-3 of the pixels differ by more than 1e-5."""
    vmap, nmap = chip_smoke.synthetic_edge_args(cuda_device, h, w)
    before = kernels.geometric_edge_map.launches
    out = kernels.geometric_edge_map(vmap, nmap, 150.0, 2.8)
    torch.cuda.synchronize()
    assert kernels.geometric_edge_map.launches == before + 1
    ref = kernels.geometric_edge_map_plain(vmap, nmap, 150.0, 2.8)
    chip_smoke.check_edge_map(out, ref)


@pytest.mark.parametrize("wrong", ["centre", "transposed", "none"])
def test_scan_check_catches_wrong_winner(wrong):
    """check_scan refuses a best_src that names another tap than the one
    whose hit gives best_z, and passes the plain version's own."""
    args = chip_smoke.synthetic_scan_args(CPU)
    z, s = kernels.predict_l0_scan_plain(*args)
    chip_smoke.check_scan(args, z, s, z, s, max_flips=0.0)
    won = s >= 0
    lin = torch.arange(H * W, dtype=torch.int32).reshape(H, W)
    if wrong == "centre":
        bad = torch.where(won, lin, s)
    elif wrong == "transposed":
        bad = torch.where(won, (s % W) * W + s // W, s)
    else:
        bad = torch.where(won & (lin % 7 == 0), -1, s)
    assert bool((bad != s).any())
    with pytest.raises(AssertionError):
        chip_smoke.check_scan(args, z, bad, z, s)


@pytest.mark.cuda
def test_wrappers_refuse_what_kernels_do_not_take(cuda_device):
    d = torch.zeros((8, 8), dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError):
        kernels.bilateral_depth(d)
    with pytest.raises(ValueError):
        kernels.bilateral_depth(torch.zeros((8, 16), device=cuda_device).T)
    v = torch.zeros((8, 8, 3), device=cuda_device)
    with pytest.raises(ValueError):
        kernels.geometric_edge_map(v, v[:, :4])
    with pytest.raises(ValueError):
        kernels.geometric_edge_map(v.double(), v.double())
