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


# ---------------------------------------------------------------------------
# kernel 3's tiling: a warp owns 30 columns and walks down a band of rows,
# neighbours from the lanes beside; lanes and rows outside the image take
# zeros (only the border reads them)

def _edge_maps(h, w, device, holes=True, seed=5):
    """Vertex and normal maps (the port's create_vmap / create_nmap) of a
    wavy surface with step edges, h x w, with NaN holes from a seed (2% of
    the pixels) and holes across the seams of the kernel's 30-column groups
    (columns 28-31 and 58-61) and across every tenth row."""
    v, u = np.mgrid[0:h, 0:w]
    depth = (1.5 + 0.0004 * u + 0.0003 * v
             + 0.08 * np.sin(u * 0.03) * np.cos(v * 0.04)).astype(np.float32)
    depth[(u // 23 + v // 17) % 5 == 0] += np.float32(0.05)
    if holes:
        rng = np.random.default_rng(seed)
        depth[rng.random((h, w)) < 0.02] = 0.0
        seam = ((u >= 28) & (u <= 31)) | ((u >= 58) & (u <= 61))
        depth[seam & (v % 7 < 2)] = 0.0
        depth[(v % 10 >= 9) & (u % 13 < 4)] = 0.0
    from maskfusion_tpu_torch.camera import CameraIntrinsics
    from maskfusion_tpu_torch.ops import preprocess as pp

    intr = CameraIntrinsics(0.825 * max(w, 2), 0.825 * max(w, 2), w / 2.0,
                            h / 2.0)
    vmap = pp.create_vmap(t(depth).to(device), intr, 5.0).contiguous()
    return vmap, pp.create_nmap(vmap).contiguous()


def _offset_copy(x, k):
    """A contiguous copy of x whose data starts k floats past a fresh
    allocation (so 4k bytes past a 16-byte boundary)."""
    flat = torch.empty(x.numel() + 4, dtype=x.dtype, device=x.device)
    view = flat[k:k + x.numel()].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4 * k % 16
    return view


def _hold_edge(vmap, nmap):
    """Kernel 3 against its plain version (chip_smoke.check_edge_map); the
    border and the invalid pixels exactly 1, as the plain version."""
    before = kernels.geometric_edge_map.launches
    out = kernels.geometric_edge_map(vmap, nmap, 150.0, 2.8)
    torch.cuda.synchronize()
    assert kernels.geometric_edge_map.launches == before + 1
    ref = kernels.geometric_edge_map_plain(vmap, nmap, 150.0, 2.8)
    chip_smoke.check_edge_map(out, ref)
    h, w = out.shape
    ones = torch.ones((h, w), dtype=torch.bool, device=out.device)
    ones[1:-1, 1:-1] = False
    ones |= ~torch.isfinite(vmap[..., 0]) | (vmap[..., 2] <= 0)
    assert bool((out[ones] == 1.0).all()) and bool((ref[ones] == 1.0).all())
    return out, ref


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(1, 1), (2, 2), (1, 70), (70, 2)])
def test_edge_map_kernel_all_border(cuda_device, h, w):
    """Images with no interior pixel: every output is exactly 1."""
    out, _ = _hold_edge(*_edge_maps(h, w, cuda_device, holes=False))
    assert bool((out == 1.0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [
    (3, 3), (3, 64), (37, 53), (41, 641),
    (30, 31), (17, 61),       # one column past one and two 30-column groups
    (481, 640),               # one row past VGA: warps' shares cross the
                              # end of a column group
    (1081, 1921),             # bands of ~33 rows a warp
])
def test_edge_map_kernel_tiling(cuda_device, h, w):
    """Shapes that hit every edge of the kernel's tiling: widths whose rows
    (3 W floats) are no multiple of 16 bytes, part column groups, warps
    whose rows cross the end of a column group, long bands; NaN holes
    straddle the group seams and the rows."""
    _hold_edge(*_edge_maps(h, w, cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(37, 53), (41, 641)])
@pytest.mark.parametrize("kv,kn", [(1, 2), (2, 3), (3, 0), (0, 1)])
def test_edge_map_kernel_unaligned_inputs(cuda_device, h, w, kv, kn):
    """Maps that start 4, 8 or 12 bytes past a 16-byte boundary (contiguous
    views at a storage offset), each map its own: the same output as the
    aligned maps', bit for bit."""
    vmap, nmap = _edge_maps(h, w, cuda_device)
    aligned = kernels.geometric_edge_map(vmap, nmap, 150.0, 2.8)
    out, _ = _hold_edge(_offset_copy(vmap, kv), _offset_copy(nmap, kn))
    assert torch.equal(out, aligned)


@pytest.mark.cuda
def test_edge_map_kernel_all_invalid(cuda_device):
    """An all-invalid map (no depth anywhere) is 1 everywhere."""
    vmap, nmap = _edge_maps(37, 53, cuda_device)
    vmap = torch.full_like(vmap, float("nan"))
    vmap[..., 2] = 0.0
    out, _ = _hold_edge(vmap, torch.full_like(nmap, float("nan")))
    assert bool((out == 1.0).all())


@pytest.mark.cuda
def test_edge_map_kernel_nan_normal(cuda_device):
    """A NaN normal beside finite vertices: its concavity terms are NaN and
    count as 0 (the NaN -> 0 step), at the pixel and at its neighbours."""
    vmap, nmap = _edge_maps(41, 641, cuda_device, holes=False)
    nmap = nmap.clone()
    for y, x in ((5, 63), (5, 64), (20, 128), (33, 300)):
        nmap[y, x] = float("nan")
    out, ref = _hold_edge(vmap, nmap)
    near = torch.zeros_like(out, dtype=torch.bool)
    for y, x in ((5, 63), (5, 64), (20, 128), (33, 300)):
        near[y - 1:y + 2, x - 1:x + 2] = True
    assert bool(torch.isfinite(ref[near]).all())
    assert float((out - ref).abs()[near].max()) <= 1e-5


# ---------------------------------------------------------------------------
# cold-L2 timing (chip_smoke.time_ms_cold): the copy arithmetic

@pytest.mark.parametrize("nbytes,copies", [
    (480 * 640 * 24, 11),         # the edge map's vmap + nmap at VGA
    (480 * 640 * 4, 64),          # the bilateral filter's depth
    (480 * 640 * 29, 9),          # the scan's pos, normal, radius, live
    (1000, 78644),
    (chip_smoke.L2_BYTES, 2),     # inputs as large as the L2 or larger
    (3 * chip_smoke.L2_BYTES, 2),
])
def test_cold_copies_outgrow_the_l2(nbytes, copies):
    """The rotation holds at least 1.5x the 50 MiB L2 and one copy fewer
    would not; never fewer than 2 copies."""
    n = chip_smoke.cold_copies(nbytes)
    assert n == copies
    l2 = chip_smoke.L2_BYTES
    assert n * nbytes >= chip_smoke.COLD_L2_FACTOR * l2
    assert n == 2 or (n - 1) * nbytes < chip_smoke.COLD_L2_FACTOR * l2
    assert chip_smoke.cold_copies(nbytes, 2 * l2) >= n


def test_cold_rotation_cycles_fresh_copies():
    """Each call gives the next of n copies: distinct storage, equal
    values, the non-tensor arguments shared; the (n+1)-th call the first
    copy again."""
    vmap = torch.arange(2 * 3 * 3, dtype=torch.float32).reshape(2, 3, 3)
    live = torch.ones((2, 3), dtype=torch.bool)
    args = (vmap, live, 150.0, 2)
    assert chip_smoke.tensor_bytes(args) == 2 * 3 * 3 * 4 + 2 * 3
    turn = chip_smoke.cold_rotation(args, 3)
    got = [turn() for _ in range(4)]
    ptrs = [g[0].data_ptr() for g in got]
    assert len(set(ptrs[:3])) == 3 and ptrs[3] == ptrs[0]
    assert vmap.data_ptr() not in ptrs
    for g in got:
        assert torch.equal(g[0], vmap) and torch.equal(g[1], live)
        assert g[2:] == (150.0, 2)


def test_hot_time_under_the_byte_bound_is_l2_resident():
    """A hot time below the HBM byte time is labelled, not a share."""
    rec = chip_smoke.edge_bound(torch.zeros((480, 640, 3)))
    t_bytes = rec["bytes"] / chip_smoke.PEAK_BYTES_S * 1e3
    assert chip_smoke.hot_label({**rec, "ms": 0.5 * t_bytes}) == "L2-resident"
    assert chip_smoke.hot_label({**rec, "ms": 2 * t_bytes}) == \
        "50% of the bound"


@pytest.mark.cuda
def test_cli_static_on_the_card(cuda_device, tmp_path, monkeypatch):
    """`python -m maskfusion_tpu_torch.main -l log.klg -static -ep -em` on a
    160x120 raw KLG log, on the card: one bilateral and one scan launch a
    frame, one TUM pose a frame, each within 1 mm of the same CLI's run on
    the CPU (the log carries one frame more: the KLG reader, as the
    reference's, never returns a log's last frame).  A .klg header holds no
    frame size, so the default preset is set to the log's."""
    from maskfusion_tpu_torch import camera
    from maskfusion_tpu_torch.frame import FrameData
    from maskfusion_tpu_torch.io.klg_reader import write_klg
    from maskfusion_tpu_torch.main import main

    _, frames, (fx, fy, cx, cy, _, _) = chip_smoke.synthetic_trajectory(4)
    fd = [FrameData(rgb=rgb, depth=np.round(d * 1000).astype(np.uint16),
                    timestamp=1000.0 * (i + 1))
          for i, (rgb, d) in enumerate(frames)]
    log = tmp_path / "seq.klg"
    write_klg(str(log), fd + fd[-1:], compress=False)
    h, w = fd[0].depth.shape
    monkeypatch.setitem(camera.PRESETS, "default", (
        camera.Resolution(w, h), camera.CameraIntrinsics(fx, fy, cx, cy)))
    cal = tmp_path / "cal.txt"
    cal.write_text(f"{fx} {fy} {cx} {cy}\n")
    args = ["-l", str(log), "-static", "-q", "-nso", "-cal", str(cal),
            "-ep", "-em", "--global-capacity", str(1 << 16)]
    kernels.reset_launch_counts()
    assert main([*args, "-exportdir", str(tmp_path / "card")]) == 0
    assert kernels.bilateral_depth.launches == len(fd)
    assert kernels.predict_l0_scan.launches == len(fd)
    assert main([*args, "-exportdir", str(tmp_path / "cpu")],
                device="cpu") == 0

    def poses(side):
        lines = (tmp_path / side / "poses-0.txt").read_text().splitlines()
        return np.array([[float(v) for v in line.split()] for line in lines])

    card, cpu = poses("card"), poses("cpu")
    assert card.shape == cpu.shape == (len(fd), 8)
    np.testing.assert_array_equal(card[:, 0], [f.timestamp for f in fd])
    assert np.abs(card[:, 1:4] - cpu[:, 1:4]).max() <= 1e-3


@pytest.mark.cuda
def test_batched_windowed_path_on_the_card(cuda_device, monkeypatch):
    """Six frames of the 160x120 two-object scene (chip_smoke's JAX-free
    copy of tests/synthetic.py's) through the multi-object engine on the
    card, in the configuration of tests/test_torch_object_passes.py (a
    104-pixel object window, margin 24, min_object_slots=2).  From the
    frame after the second spawn on: the objects track in ONE solve (a slot
    axis of 2), fuse in their windows, and the scan kernel launches once
    for each of the frame's projections (3 models) and predictions (3).
    The batched solve itself never waits on the device.  (The solves are
    counted as the engine issues them: on the card each replays a CUDA
    graph, and a replay calls no Python of the solve.)"""
    from maskfusion_tpu_torch.camera import CameraIntrinsics, Resolution
    from maskfusion_tpu_torch.config import Config
    from maskfusion_tpu_torch.engine import MaskFusion
    from maskfusion_tpu_torch.frame import FrameData

    fx, fy, cx, cy, w, h = chip_smoke.SMALL
    eng = MaskFusion(Resolution(w, h), CameraIntrinsics(fx, fy, cx, cy),
                     Config(global_surfel_capacity=1 << 16,
                            object_surfel_capacity=1 << 13,
                            seg_method="maskfusion",
                            pipelined_multiobject=False,
                            model_spawn_offset=0, object_window=104,
                            object_window_margin=24, min_object_slots=2),
                     device=cuda_device)
    solves = []
    graphed = eng._graphed

    def counted(path, is_object, fn, inputs, slots):
        # the slot axis of the solve, from the pose it is given: () for
        # one model's, (N,) batched
        solves.append(tuple(inputs[0].shape[:-2]))
        return graphed(path, is_object, fn, inputs, slots)

    monkeypatch.setattr(eng, "_graphed", counted)
    for i, (rgb, depth, lab) in enumerate(
            chip_smoke.synthetic_two_objects(6)):
        solves.clear()
        kernels.reset_launch_counts()
        before = eng.windowed_fuses
        eng.process_frame(FrameData(rgb=rgb, depth=depth, mask=lab,
                                    class_ids=[0, 7, 8],
                                    timestamp=float(i)))
        torch.cuda.synchronize()
        if i >= 3:
            assert [m.model_id for m in eng.models] == [0, 1, 2]
            assert solves == [(), (2,)], (i, solves)
            assert all(m.window is not None for m in eng.models[1:])
            assert eng.windowed_fuses == before + 1
            assert kernels.predict_l0_scan.launches == 6, i
    assert all(np.isfinite(m.pose_log[-1]["pose"].cpu().numpy()).all()
               for m in eng.models)
    # the batched solve runs without waiting on the device
    from torch.profiler import ProfilerActivity, profile

    rgb, depth, _ = chip_smoke.synthetic_two_objects(7)[6]
    prep = eng.preprocess(torch.from_numpy(rgb).to(cuda_device),
                          torch.from_numpy(depth).to(cuda_device),
                          eng._prev_seg())
    objs = eng.models[1:]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            eng.track_objects([m.state for m in objs],
                              [m.model_id for m in objs], prep)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    waits = [e.name for e in prof.events() if e.name in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize",
        "cudaEventSynchronize")]
    assert waits == []


@pytest.mark.cuda
def test_prefused_frames_never_wait_on_the_card(cuda_device):
    """The prefused schedule (the Config default) on the 160x120
    two-object scene with the 104-pixel window and two object slots: once
    both objects live in their windows, a frame whose previous frame's
    results have landed issues no synchronising call -- none under
    torch.cuda.set_sync_debug_mode("error"), and no cudaStreamSynchronize,
    cudaDeviceSynchronize or cudaEventSynchronize in the profiler's view.
    The three kernels launch on every such frame.  (Only a forced drain,
    pipeline_depth frames in flight, may wait; here each frame starts with
    the device idle.)"""
    from torch.profiler import ProfilerActivity, profile

    from maskfusion_tpu_torch.camera import CameraIntrinsics, Resolution
    from maskfusion_tpu_torch.config import Config
    from maskfusion_tpu_torch.engine import MaskFusion
    from maskfusion_tpu_torch.frame import FrameData

    fx, fy, cx, cy, w, h = chip_smoke.SMALL
    eng = MaskFusion(Resolution(w, h), CameraIntrinsics(fx, fy, cx, cy),
                     Config(global_surfel_capacity=1 << 16,
                            object_surfel_capacity=1 << 13,
                            seg_method="maskfusion", model_spawn_offset=0,
                            object_window=104, object_window_margin=24,
                            min_object_slots=2),
                     device=cuda_device)
    steady = 0
    for i, (rgb, depth, lab) in enumerate(
            chip_smoke.synthetic_two_objects(9)):
        frame = eng.upload_frame(FrameData(rgb=rgb, depth=depth, mask=lab,
                                           class_ids=[0, 7, 8],
                                           timestamp=float(i)))
        torch.cuda.synchronize()
        if i < 5:
            eng.process_frame(frame)
            continue
        assert [m.model_id for m in eng.models] == [0, 1, 2]
        assert all(m.window is not None for m in eng.models[1:])
        kernels.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                eng.process_frame(frame)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        waits = [e.name for e in prof.events() if e.name in (
            "cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaEventSynchronize")]
        assert waits == [], (i, waits)
        assert kernels.bilateral_depth.launches == 1
        assert kernels.geometric_edge_map.launches == 1
        assert kernels.predict_l0_scan.launches >= 6, i
        steady += 1
    assert steady == 4
    eng.drain_pipeline()
    assert all(np.isfinite(m.pose_log[-1]["pose"].numpy()).all()
               for m in eng.models)


@pytest.mark.cuda
def test_maskrcnn_serves_on_its_own_stream(cuda_device):
    """The trained micro Mask R-CNN on the card: the forward issues no
    synchronise (sync debug mode 'error'), runs on the inference's own
    stream, not the default one, and detect() gives the CPU's detections
    (valid slots and classes equal, boxes to 1e-4, mask logits to 1e-3)."""
    from maskfusion_tpu_torch.maskrcnn import checkpoint_io
    from maskfusion_tpu_torch.maskrcnn import synthetic_shapes as ss
    from maskfusion_tpu_torch.maskrcnn.inference import MaskRCNNInference

    params, _ = checkpoint_io.load_params(
        "maskfusion_tpu/maskrcnn/checkpoints/shapes_micro_64.npz")
    cfg = ss.micro_config(64)
    card = MaskRCNNInference(cfg, params=params, device=cuda_device)
    cpu = MaskRCNNInference(cfg, params=params, device="cpu")
    assert card.stream is not None
    assert card.stream != torch.cuda.default_stream(cuda_device)
    img = ss.make_shapes_scene(np.random.default_rng(0), 64)[0]
    rgb = np.clip(img, 0, 255).astype(np.uint8)
    card.detect(rgb)                            # warm: buffers, kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = card.forward(rgb)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert all(v.is_cuda for v in out.values())
    a, b = card.detect(rgb), cpu.detect(rgb)
    np.testing.assert_array_equal(a[4], b[4])
    np.testing.assert_array_equal(a[2][a[4]], b[2][b[4]])
    np.testing.assert_allclose(a[0][a[4]], b[0][b[4]], atol=1e-4)
    np.testing.assert_allclose(a[1][a[4]], b[1][b[4]], atol=1e-3)
    assert a[4].any()


@pytest.mark.cuda
def test_maskrcnn_first_detect_waits_for_its_weights(cuda_device,
                                                     monkeypatch):
    """detect() straight after construction gives what a synchronised
    inference gives, while the weights' channels-last copies wait on the
    caller's stream behind a queued sleep: the inference's own stream waits
    for them before its first forward."""
    from maskfusion_tpu_torch.maskrcnn import checkpoint_io
    from maskfusion_tpu_torch.maskrcnn import model as mm
    from maskfusion_tpu_torch.maskrcnn import synthetic_shapes as ss
    from maskfusion_tpu_torch.maskrcnn.inference import MaskRCNNInference

    params, _ = checkpoint_io.load_params(
        "maskfusion_tpu/maskrcnn/checkpoints/shapes_micro_64.npz")
    cfg = ss.micro_config(64)
    img = ss.make_shapes_scene(np.random.default_rng(0), 64)[0]
    rgb = np.clip(img, 0, 255).astype(np.uint8)
    settled = MaskRCNNInference(cfg, params=params, device=cuda_device)
    torch.cuda.synchronize()
    want = settled.detect(rgb)
    to = mm.MaskRCNN.to

    def late_to(self, *args, **kwargs):
        if "memory_format" in kwargs:
            torch.cuda._sleep(int(1e9))     # about half a second queued
        return to(self, *args, **kwargs)

    monkeypatch.setattr(mm.MaskRCNN, "to", late_to)
    got = MaskRCNNInference(cfg, params=params,
                            device=cuda_device).detect(rgb)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert want[4].any()


@pytest.mark.cuda
def test_nms_tie_order_on_card(cuda_device):
    """The full-width network's tie order on the card is the CPU's
    (chip_smoke.tie_order): RPN scores from bf16 logits over its 65,472
    anchors, many of them equal; the stable sort's first pre_nms_limit and
    the fixed-k NMS of the RPN and of the detections, indices equal."""
    from maskfusion_tpu_torch.maskrcnn import model as mm

    cfg = mm.MaskRCNNConfig()
    A = mm.generate_anchors(cfg).shape[0]
    logits = torch.from_numpy(np.random.default_rng(7).normal(
        0, 1, (A, 2)).astype(np.float32)).bfloat16().float()
    scores = torch.softmax(logits, -1)[:, 1]
    assert chip_smoke.tie_order(scores, cfg, cuda_device) < \
        cfg.pre_nms_limit // 2                               # ties


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_never_waits_on_the_card(cuda_device, dtype):
    """create_train_step on micro_config(64) (in float32, and computing in
    bfloat16 over float32 parameters), a batch of two make_batch scenes
    already on the card and a CUDA generator: after the first step, a
    full-loss step issues no synchronising call (none under
    torch.cuda.set_sync_debug_mode("error"), none in the profiler's view),
    and its loss, read afterwards, is finite; the parameters stay float32."""
    from torch.profiler import ProfilerActivity, profile

    from maskfusion_tpu_torch.maskrcnn import synthetic_shapes as ss
    from maskfusion_tpu_torch.parallel.train import create_train_step

    cfg = ss.micro_config(64)
    if dtype == "bfloat16":
        import dataclasses
        cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
    init_fn, step_fn = create_train_step(cfg, 1e-3, device=cuda_device)
    state = init_fn(0, 2)
    batch = [torch.from_numpy(a).to(cuda_device) for a in
             ss.make_batch(np.random.default_rng(0), 2, 64)]
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    state, loss = step_fn(state, gen, *batch)
    torch.cuda.synchronize()
    losses = []
    for _ in range(2):
        torch.cuda.set_sync_debug_mode("error")
        try:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                state, loss = step_fn(state, gen, *batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        waits = [e.name for e in prof.events() if e.name in (
            "cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaEventSynchronize")]
        assert waits == []
        losses.append(loss)
    assert torch.isfinite(torch.stack(losses)).all()
    assert state.step == 3
    assert all(p.dtype == torch.float32 for p in state.params.parameters())


@pytest.mark.cuda
def test_cofusion_frames_on_the_card(cuda_device):
    """-method cofusion on the 160x120 two-object scene without masks on
    the card, under the Config default pipelined_multiobject: every frame
    runs the synchronous step (the pipelined one needs the edge map, which
    Co-Fusion never launches), the bilateral filter launches once a frame
    and the scan at least once; a frame's synchronises are counted
    (profiler: cudaStreamSynchronize, cudaDeviceSynchronize,
    cudaEventSynchronize) and reported, not bounded."""
    from torch.profiler import ProfilerActivity, profile

    from maskfusion_tpu_torch.camera import CameraIntrinsics, Resolution
    from maskfusion_tpu_torch.config import Config
    from maskfusion_tpu_torch.engine import MaskFusion
    from maskfusion_tpu_torch.frame import FrameData

    fx, fy, cx, cy, w, h = chip_smoke.SMALL
    eng = MaskFusion(Resolution(w, h), CameraIntrinsics(fx, fy, cx, cy),
                     Config(global_surfel_capacity=1 << 16,
                            object_surfel_capacity=1 << 13,
                            seg_method="cofusion", model_spawn_offset=0),
                     device=cuda_device)
    assert eng.cfg.pipelined_multiobject
    syncs = []
    for i, (rgb, depth, _) in enumerate(chip_smoke.synthetic_two_objects(7)):
        kernels.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = eng.process_frame(FrameData(rgb=rgb, depth=depth,
                                              timestamp=float(i)))
        assert not eng._pending
        assert kernels.geometric_edge_map.launches == 0
        assert kernels.bilateral_depth.launches == 1
        if i:
            assert kernels.predict_l0_scan.launches >= 1
            assert eng.last_segmentation.shape == (h, w)
            syncs.append(sum(e.name in ("cudaStreamSynchronize",
                                        "cudaDeviceSynchronize",
                                        "cudaEventSynchronize")
                             for e in prof.events()))
        assert out["tracking_ok"]
    print(f"Co-Fusion synchronises per frame: {syncs}")
    assert all(s > 0 for s in syncs)
    assert np.isfinite(eng.pose_log_numpy(0)[-1]).all()


def _viewer_pair(device):
    """chip_smoke phase 15a's map: the CPU -static engine after two frames
    of the 160x120 wavy scene, and an engine on `device` carried from it."""
    from maskfusion_tpu_torch.camera import CameraIntrinsics, Resolution
    from maskfusion_tpu_torch.config import Config
    from maskfusion_tpu_torch.convert import engine_snapshot, restore_engine
    from maskfusion_tpu_torch.engine import MaskFusion
    from maskfusion_tpu_torch.frame import FrameData

    cpu_eng = chip_smoke.viewer_map(MaskFusion, Config, Resolution,
                                    CameraIntrinsics, FrameData, CPU)
    card = MaskFusion(cpu_eng.res, cpu_eng.intr, cpu_eng.cfg, device=device)
    restore_engine(card, engine_snapshot(cpu_eng))
    return cpu_eng, card


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["live", "orbit"])
def test_viewer_frame_on_the_card(cuda_device, view):
    """render_map_view on the card renders the CPU's view of the same map
    within phase 15a's bound (depth within 1e-5 on all but 3e-3 of the
    pixels, ties on at most fault 4's 3.09%, colour within one level off
    them), and launches the scan kernel once: not its plain version."""
    from maskfusion_tpu_torch import viewer

    cpu_eng, card = _viewer_pair(cuda_device)
    live = cpu_eng.current_pose
    pose = live if view == "live" else chip_smoke.orbit_pose(live)
    w, h = cpu_eng.res.width, cpu_eng.res.height
    ref = viewer.render_map_view(cpu_eng.models[0].state.map, pose,
                                 cpu_eng.intr, w, h)
    before = kernels.predict_l0_scan.launches
    got = viewer.render_map_view(card.models[0].state.map, pose, card.intr,
                                 w, h)
    assert kernels.predict_l0_scan.launches == before + 1
    rec = chip_smoke.hold_viewer_views(got, ref)
    print(f"viewer card against CPU ({view}): {rec}")


@pytest.mark.cuda
def test_live_viewer_frame_on_the_card(cuda_device):
    """One offscreen LiveViewer frame and one viewport on the card: each
    launches the scan kernel once, and the canvas below the HUD bar equals
    the CPU viewer's within the viewer's bound."""
    from maskfusion_tpu_torch import gui

    cpu_eng, card = _viewer_pair(cuda_device)
    views = []
    for eng in (card, cpu_eng):
        v = gui.LiveViewer(eng, offscreen=True)
        before = kernels.predict_l0_scan.launches
        assert v.update()
        views.append((v.last_canvas, kernels.predict_l0_scan.launches
                      - before))
    (got, launched), (ref, _) = views
    assert launched == 1
    h, w = cpu_eng.res.height, cpu_eng.res.width
    assert got.shape == ref.shape == (2 * h + 24, 2 * w, 3)
    diff = np.abs(got[24:].astype(int) - ref[24:].astype(int)).max(-1)
    assert (diff > 1).mean() <= chip_smoke.VIEWER_TIE_SHARE


@pytest.mark.cuda
def test_models_mesh_on_one_card(cuda_device):
    """The prefused schedule of test_prefused_frames_never_wait_on_the_card
    with its two object slots split over ModelMesh(["cuda:0", "cuda:0"]):
    each block solves, projects and fuses on its own; the frames after
    both spawns issue no synchronising call; against the engine without a
    mesh, the same model ids on every frame, the logged poses within
    chip_smoke.MESH_HOLD_M up to frame 4 (phase 16a's bound: the split
    moves no arithmetic), then the global pose within 1 mm and the
    objects' within 8 mm (phase 7's: an object's solve amplifies the
    rounding of the kernels' atomics over frames)."""
    from maskfusion_tpu_torch.camera import CameraIntrinsics, Resolution
    from maskfusion_tpu_torch.config import Config
    from maskfusion_tpu_torch.engine import MaskFusion
    from maskfusion_tpu_torch.frame import FrameData
    from maskfusion_tpu_torch.parallel.multimodel import ModelMesh

    fx, fy, cx, cy, w, h = chip_smoke.SMALL
    frames = chip_smoke.synthetic_two_objects(8)

    def run(mesh):
        eng = MaskFusion(Resolution(w, h), CameraIntrinsics(fx, fy, cx, cy),
                         Config(global_surfel_capacity=1 << 16,
                                object_surfel_capacity=1 << 13,
                                seg_method="maskfusion", model_spawn_offset=0,
                                object_window=104, object_window_margin=24,
                                min_object_slots=2),
                         device=cuda_device, mesh=mesh)
        records = []
        for i, (rgb, depth, lab) in enumerate(frames):
            frame = eng.upload_frame(FrameData(
                rgb=rgb, depth=depth, mask=lab, class_ids=[0, 7, 8],
                timestamp=float(i)))
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error" if i >= 5 else 0)
            try:
                eng.process_frame(frame)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            records.append(([m.model_id for m in eng.models],
                            [n(m.pose_log[-1]["pose"]) if m.pose_log
                             else None for m in eng.models]))
        eng.drain_pipeline()
        return eng, records

    _, ref = run(None)
    eng, split = run(ModelMesh(["cuda:0", "cuda:0"]))
    assert eng._shard_model_axis(2) is not None
    assert ref[-1][0] == [0, 1, 2]
    for i, ((ids, poses), (ref_ids, ref_poses)) in enumerate(zip(split,
                                                                 ref)):
        assert ids == ref_ids, i
        for k, (p, q) in enumerate(zip(poses, ref_poses)):
            assert (p is None) == (q is None), (i, k)
            if p is not None:
                gap = np.linalg.norm(p[:3, 3] - q[:3, 3])
                bound = (chip_smoke.MESH_HOLD_M if i <= 4
                         else 1e-3 if k == 0 else 8e-3)
                assert gap <= bound, (i, k, gap)


@pytest.mark.cuda
def test_models_mesh_across_card_and_cpu(cuda_device):
    """The two object slots split over ModelMesh(["cuda:0", "cpu"]): real
    copies between the devices, the CPU block on the kernels' plain
    versions.  chip_smoke's phase 16a across devices: phase 7's scene in
    the synchronous and the prefused schedule against the unsplit engine on
    the card (the same ids, the global pose at phase 7's bounds, the
    objects and counts up to chip_smoke.ACROSS_HOLD_LAST_FRAME; the second
    slot's state left on the CPU)."""
    from maskfusion_tpu_torch.camera import CameraIntrinsics, Resolution
    from maskfusion_tpu_torch.config import Config
    from maskfusion_tpu_torch.engine import MaskFusion
    from maskfusion_tpu_torch.frame import FrameData

    out = chip_smoke.phase_models_mesh_across(
        cuda_device, MaskFusion, Config, Resolution, CameraIntrinsics,
        FrameData)
    assert set(out) == set(chip_smoke.ACROSS_FORMS)


@pytest.mark.cuda
def test_sharded_step_on_one_card_over_nccl(cuda_device):
    """create_train_step(..., mesh=make_mesh(1)) on one NCCL rank (a (1, 1)
    mesh) against the one-card step on the card, micro_config(64), the
    same batch, seed and draws, two steps: after each, the loss within 1e-5
    relative, every parameter within 2 lr a step taken and all but 1e-4 of
    them within 1e-6 (tests/test_torch_parallel.py's bounds)."""
    from maskfusion_tpu_torch.maskrcnn import synthetic_shapes as ss
    from maskfusion_tpu_torch.parallel.launch import run_ranks
    from maskfusion_tpu_torch.parallel.train import (create_train_step,
                                                     sharded_runs)

    cfg, lr = ss.micro_config(64), 1e-4
    batch = ss.make_batch(np.random.default_rng(0), 2, 64)
    n_draw = cfg.post_nms_proposals + batch[1].shape[1]
    draws = [torch.rand((2, 2, n_draw), generator=torch.Generator()
                        .manual_seed(s)).numpy() for s in range(2)]
    (_, steps), = run_ranks(sharded_runs, 1, "nccl", ([dict(
        cfg=cfg, batch=batch, draws=draws, learning_rate=lr,
        device_type="cuda")],), 300.0)[0]
    init_fn, step_fn = create_train_step(cfg, lr, device=cuda_device)
    state = init_fn(0, 2)
    tensors = [torch.from_numpy(a).to(cuda_device) for a in batch]
    for i, d in enumerate(draws):
        state, loss = step_fn(state, torch.from_numpy(d).to(cuda_device),
                              *tensors)
        assert abs(steps[i][0] - float(loss)) <= 1e-5 * abs(float(loss))
        ref = {k: n(v) for k, v in state.params.state_dict().items()}
        diff = np.concatenate([np.abs(steps[i][2][k] - ref[k]).ravel()
                               for k in ref])
        assert diff.max() <= 2 * lr * (i + 1), (i, diff.max())
        assert (diff > 1e-6).mean() <= 1e-4, (i, (diff > 1e-6).mean())


@pytest.mark.cuda
def test_spans_on_the_card_under_cuda_activity(cuda_device):
    """Under CUDA-only activity, as the benchmark profiles: the span log
    records (the profiler reads as enabled), a span brackets the
    cudaLaunchKernel calls of the kernels it launched on the profiler's
    clock, and the counters' device tensors add no synchronise (none in the
    span; the trace's are the test's closing call and the profiler's)."""
    from torch.profiler import ProfilerActivity, profile

    from maskfusion_tpu_torch.utils import stopwatch

    stopwatch.clear_log()
    g = torch.Generator().manual_seed(4)
    H, W = 120, 160
    live = (torch.rand(H, W, generator=g) < 0.4).to(cuda_device)
    args = [torch.rand(H, W, 3, generator=g).to(cuda_device),
            torch.rand(H, W, 3, generator=g).to(cuda_device),
            torch.rand(H, W, generator=g).to(cuda_device), live,
            torch.tensor([130.0, 130.0, 80.0, 60.0], device=cuda_device),
            5.0]
    a = torch.randn(256, 256, device=cuda_device)
    kernels.predict_l0_scan(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        enabled = bool(stopwatch.recording())
        with stopwatch.span("work", 1):
            b = a @ a
            stopwatch.count("sum", n=b.sum())
            kernels.predict_l0_scan(*args)
        torch.cuda.synchronize()
    assert enabled
    log = stopwatch.read_log()
    assert [(r["name"], r["id"]) for r in log] == \
        [("work", 1), ("sum", 1), ("scan_live", 1)]
    span = log[0]
    events = prof.profiler.kineto_results.events()
    launches = [e for e in events if e.name().startswith(
        ("cudaLaunchKernel", "cuLaunchKernel"))]
    assert len(launches) >= 3, [e.name() for e in events]
    for e in launches:
        assert span["start_ns"] <= e.start_ns() <= e.end_ns() <= \
            span["end_ns"], (e.name(), e.start_ns(), e.end_ns(), span)
    syncs = [e for e in events if e.name() in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize",
        "cudaEventSynchronize")]
    assert not [e.name() for e in syncs
                if e.end_ns() >= span["start_ns"]
                and e.start_ns() <= span["end_ns"]]
    assert syncs, "the closing synchronise is not in the trace"
    lv = live.cpu().numpy()
    assert log[2]["values"]["live"] == int(lv.sum())
    print(f"span {span['end_ns'] - span['start_ns']} ns holds "
          f"{len(launches)} launches; first launch "
          f"{launches[0].start_ns() - span['start_ns']} ns after its start; "
          "synchronises at (ns after the span's end) "
          f"{[e.start_ns() - span['end_ns'] for e in syncs]}")
