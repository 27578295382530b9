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
