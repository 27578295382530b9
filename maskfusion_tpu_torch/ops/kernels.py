"""The port's hand-written Hopper kernels, their plain PyTorch versions and
the build.

One kernel for each of the JAX package's three Pallas kernels:

  bilateral_depth     csrc/bilateral_depth.cu — replaces
                      maskfusion_tpu/ops/pallas_kernels.py:121-161
                      (bilateral_filter_depth_pallas)
  predict_l0_scan     csrc/predict_l0_scan.cu — replaces
                      maskfusion_tpu/ops/pallas_kernels.py:230-338
                      (predict_l0_scan_pallas)
  geometric_edge_map  csrc/geometric_edge_map.cu — replaces
                      maskfusion_tpu/ops/pallas_kernels.py:171-223
                      (geometric_edge_map_pallas)

The first two run on the -static and the multi-object frame, the third on
the multi-object frame's segmentation.

Each source note says what bounds the kernel on the card and what its design
does about it.  Each public wrapper launches its CUDA kernel for a CUDA
tensor and takes its plain version only for a tensor on the CPU (the tests'
path); for a CUDA tensor it launches or raises.  Each wrapper counts its
launches in a plain integer attribute, ``<wrapper>.launches``: one a call,
and one a replay of a CUDA graph that captured the call (a graph's eager
warm-up run is not counted; utils/stopwatch).

The sources are compiled with nvcc into one shared library with a plain C
interface, loaded with ctypes: one ``nvcc -c`` per source, all started
together, then one link.  The library lands in ``build/kernels/`` at the
repository root, named by a hash of the sources, and is built at first use;
ptxas's report of each kernel's registers, shared memory and spills is kept
beside it (``kernel_resources``), and each source answers for its launch
shape (``launch_shape``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional, Tuple

import torch

from maskfusion_tpu_torch.utils import stopwatch
from maskfusion_tpu_torch.utils.stopwatch import count, recording

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib: Optional[ctypes.CDLL] = None
build_log = ""          # nvcc/ptxas output of the build made by this process
build_seconds = 0.0


def _sources():
    return sorted(_CSRC.glob("*.cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit on the machine with the card")
    return nvcc


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    return _BUILD_DIR / f"libmft_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the shared library (if not built yet)."""
    global build_log, build_seconds
    out = library_path()
    log_file = out.with_suffix(".log")
    if out.exists():
        if not build_log and log_file.exists():
            build_log = log_file.read_text()
        return out
    t0 = time.perf_counter()
    nvcc = _nvcc()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *_NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for src, p in procs:
            text, _ = p.communicate()
            logs.append(f"== {src.name}\n{text}")
            if p.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError("nvcc failed on " + ", ".join(failed) + "\n"
                               + "\n".join(logs))
        tmp_so = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-shared", *[str(o) for o in objs], "-o", str(tmp_so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed\n" + link.stdout)
        tmp_log = Path(tmp) / log_file.name
        tmp_log.write_text("\n".join(logs))
        os.replace(tmp_log, log_file)
        os.replace(tmp_so, out)   # atomic: concurrent builds agree
    build_log = "\n".join(logs)
    build_seconds = time.perf_counter() - t0
    return out


def load_library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.mft_bilateral_depth.argtypes = [P, P, I, I, I, F, F, F, P]
        lib.mft_bilateral_depth.restype = I
        for fn in (lib.mft_predict_l0_scan, lib.mft_predict_l0_scan_exact):
            fn.argtypes = [P, P, P, P, P, P, I, I, I, P, F, P]
            fn.restype = I
        lib.mft_geometric_edge_map.argtypes = [P, P, P, I, I, F, F, P]
        lib.mft_geometric_edge_map.restype = I
        for name in _KERNELS:
            fn = getattr(lib, f"mft_{name}_grid")
            fn.argtypes = [I, I, I, P]
            fn.restype = I
        _lib = lib
    return _lib


_KERNELS = ("bilateral_depth", "predict_l0_scan", "geometric_edge_map")


def launch_shape(name: str, H: int, W: int, param: int = 0) -> dict:
    """The launch of kernel `name` (one of _KERNELS) at an (H, W) image
    with its radius or window `param`: grid, threads a block, dynamic
    shared bytes and the blocks the card keeps resident on one SM."""
    info = (ctypes.c_int * 5)()
    err = getattr(load_library(), f"mft_{name}_grid")(H, W, int(param),
                                                      info)
    _raise_on(err, f"{name} launch shape")
    return {"grid": [info[0], info[1]], "threads": info[2],
            "dynamic_smem_bytes": info[3], "blocks_per_sm": info[4]}


_PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_PROPS = re.compile(r"Function properties for (\S+)")
_PTXAS_SPILL = re.compile(
    r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
    r"(\d+) bytes spill loads")
_PTXAS_USED = re.compile(r"Used (\d+) registers")
_PTXAS_SMEM = re.compile(r"(\d+) bytes smem")


def kernel_resources(log: Optional[str] = None) -> dict:
    """Per kernel entry (mangled name) in ptxas -v output (default: this
    build's): registers, static shared bytes, stack and spill bytes."""
    out: dict = {}
    entry = props = None
    for line in (build_log if log is None else log).splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            entry = m.group(1)
            out[entry] = {"regs": 0, "smem_static": 0, "stack": 0,
                          "spill_stores": 0, "spill_loads": 0}
            continue
        m = _PTXAS_PROPS.search(line)
        if m:
            props = m.group(1)
            continue
        m = _PTXAS_SPILL.search(line)
        if m and entry is not None and props == entry:
            out[entry].update(stack=int(m.group(1)),
                              spill_stores=int(m.group(2)),
                              spill_loads=int(m.group(3)))
            continue
        m = _PTXAS_USED.search(line)
        if m and entry is not None:
            smem = _PTXAS_SMEM.search(line)
            out[entry].update(regs=int(m.group(1)),
                              smem_static=int(smem.group(1)) if smem else 0)
    return out


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def _launched(wrapper) -> None:
    """Counts one launch of `wrapper`'s kernel (``stopwatch.replayed``:
    at each replay of a graph that captures it)."""
    def bump():
        wrapper.launches += 1
    stopwatch.replayed(bump)


def reset_launch_counts() -> None:
    bilateral_depth.launches = 0
    predict_l0_scan.launches = 0
    geometric_edge_map.launches = 0


def shift(img: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """img sampled at (y+dy, x+dx) with constant fill outside (leading dims
    H, W).  The plain versions' tap; ops/preprocess re-exports it."""
    H, W = img.shape[:2]
    pad = [0, 0] * (img.dim() - 2) + [max(0, -dx), max(0, dx),
                                      max(0, -dy), max(0, dy)]
    p = torch.nn.functional.pad(img, pad, value=fill)
    return p[max(0, dy):max(0, dy) + H, max(0, dx):max(0, dx) + W]


# ---------------------------------------------------------------------------
# kernel 1: bilateral depth filter
# ---------------------------------------------------------------------------

def bilateral_depth_plain(depth: torch.Tensor, radius: int,
                          sigma_space2_inv_half: float,
                          sigma_color2_inv_half: float,
                          min_valid_depth: float) -> torch.Tensor:
    """Plain PyTorch version: the (2R+1)^2 tap loop over a +inf-padded
    image, as maskfusion_tpu/ops/preprocess.py:66-86."""
    H, W = depth.shape
    padded = torch.nn.functional.pad(depth[None], (radius,) * 4,
                                     value=float("inf"))[0]
    sum1 = torch.zeros_like(depth)
    sum2 = torch.zeros_like(depth)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            nb = padded[radius + dy:radius + dy + H,
                        radius + dx:radius + dx + W]
            space2 = float(dy * dy + dx * dx)
            color2 = (depth - nb) ** 2
            w = torch.exp(-(space2 * sigma_space2_inv_half
                            + color2 * sigma_color2_inv_half))
            ok = torch.isfinite(nb)
            sum1 = sum1 + torch.where(ok, nb * w, 0.0)
            sum2 = sum2 + torch.where(ok, w, 0.0)
    out = sum1 / torch.clamp(sum2, min=1e-20)
    return torch.where(depth <= min_valid_depth, 0.0, out)


def bilateral_depth(depth: torch.Tensor, radius: int = 6,
                    sigma_space2_inv_half: float = 0.024691358,
                    sigma_color2_inv_half: float = 555.556,
                    min_valid_depth: float = 0.03) -> torch.Tensor:
    """(H, W) f32 metric depth -> bilateral-filtered depth (0 where the
    input is <= min_valid_depth).  CUDA kernel csrc/bilateral_depth.cu."""
    if depth.device.type == "cpu":
        return bilateral_depth_plain(depth, radius, sigma_space2_inv_half,
                                     sigma_color2_inv_half, min_valid_depth)
    _check(depth, "depth", torch.float32, depth.shape)
    if depth.dim() != 2:
        raise ValueError("depth: expected an (H, W) tensor")
    H, W = depth.shape
    out = torch.empty_like(depth)
    err = load_library().mft_bilateral_depth(
        depth.data_ptr(), out.data_ptr(), H, W, int(radius),
        float(sigma_space2_inv_half), float(sigma_color2_inv_half),
        float(min_valid_depth), _stream(depth))
    _raise_on(err, "bilateral_depth")
    _launched(bilateral_depth)
    return out


# ---------------------------------------------------------------------------
# kernel 2: level-0 ray-disk winner scan of combined_predict
# ---------------------------------------------------------------------------

def predict_l0_scan_plain(pos, normal, radius, live, intr: torch.Tensor,
                          max_depth, window: int = 2
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the shifted-pad tap loop of
    maskfusion_tpu/ops/splat.py:304-342; `intr` as the kernel's."""
    H, W = radius.shape
    dev = radius.device
    fx, fy, cx, cy = intr.unbind()
    u = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(H, W)
    v = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(H, W)
    lx = (u - cx) / fx
    ly = (v - cy) / fy
    lnorm = torch.sqrt(lx * lx + ly * ly + 1.0)
    l = torch.stack([lx / lnorm, ly / lnorm, 1.0 / lnorm], dim=-1)
    yy = torch.arange(H, device=dev)[:, None].expand(H, W)
    xx = torch.arange(W, device=dev)[None, :].expand(H, W)

    best_z = torch.full((H, W), float("inf"), device=dev)
    best_src = torch.full((H, W), -1, dtype=torch.int32, device=dev)
    packed = torch.cat([pos, normal, radius[..., None],
                        live.to(torch.float32)[..., None]], dim=-1)
    for dy in range(-window, window + 1):
        for dx in range(-window, window + 1):
            t = shift(packed, dy, dx, 0.0)
            cp = t[..., 0:3]
            cn = t[..., 3:6]
            crad = t[..., 6]
            alive = t[..., 7] > 0
            denom = (l * cn).sum(-1)
            z_star = (cp * cn).sum(-1) / torch.where(
                denom.abs() > 1e-12, denom, 1e-12)
            hit = l * z_star[..., None]
            z_cam = hit[..., 2]
            miss2 = ((hit - cp) ** 2).sum(-1)
            ok = (alive & (miss2 <= crad * crad) & (z_cam > 0)
                  & (z_cam <= max_depth) & (z_cam < best_z))
            best_z = torch.where(ok, z_cam, best_z)
            src = ((yy + dy).clamp(0, H - 1) * W
                   + (xx + dx).clamp(0, W - 1)).to(torch.int32)
            best_src = torch.where(ok, src, best_src)
    return best_z, best_src


@functools.lru_cache(maxsize=16)
def _live_weights(H: int, W: int, window: int, device: torch.device
                  ) -> torch.Tensor:
    """(2, H, W) int64: ones, and how many pixels' +-window boxes hold
    each texel; summed against `live`, the live texels and live taps (in
    the dtype of the sum, which casts no input).  Built on the host and
    sent without waiting, so it launches nothing."""
    def cover(n):
        i = torch.arange(n, dtype=torch.int64)
        return (i + window).clamp(max=n - 1) - (i - window).clamp(min=0) + 1
    taps = cover(H)[:, None] * cover(W)[None, :]
    w = torch.stack([torch.ones_like(taps), taps])
    if device.type == "cuda":
        w = w.pin_memory()
    return w.to(device, non_blocking=True)


def scan_constants(H: int, W: int, device, window: int = 2) -> tuple:
    """What a CUDA graph that captured the scan of an (H, W) map reads
    besides its inputs, cached here: the live-tap weights of its
    ``scan_live`` counts.  The graph holds them alive."""
    return (_live_weights(H, W, int(window), torch.device(device)),)


@functools.lru_cache(maxsize=64)
def _host_intrinsics(fx: float, fy: float, cx: float, cy: float,
                     device: torch.device) -> torch.Tensor:
    """(4,) float32 [fx, fy, cx, cy] on `device`, sent without waiting."""
    t = torch.tensor([fx, fy, cx, cy], dtype=torch.float32)
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def intrinsics(intr, device) -> torch.Tensor:
    """The scan's (4,) float32 intrinsics [fx, fy, cx, cy] on `device`.
    A field may be a 0-d device tensor (a graphed pass's principal point,
    filled on each replay): the buffer is then stacked on the device;
    host numbers give one cached upload."""
    fields = (intr.fx, intr.fy, intr.cx, intr.cy)
    if not any(isinstance(v, torch.Tensor) for v in fields):
        return _host_intrinsics(*map(float, fields), torch.device(device))
    return torch.stack([
        v.to(torch.float32) if isinstance(v, torch.Tensor)
        else torch.full((), v, dtype=torch.float32, device=device)
        for v in fields])


def predict_l0_scan(pos: torch.Tensor, normal: torch.Tensor,
                    radius: torch.Tensor, live: torch.Tensor,
                    intr: torch.Tensor, max_depth: float, window: int = 2,
                    exact_division: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest ray-disk hit per pixel over the +-window index-map taps,
    for the camera of `intr`, a (4,) float32 [fx, fy, cx, cy] on the maps'
    device (`intrinsics`), which the kernel reads from the device: a
    window's principal point moves every frame, and a CUDA graph replays
    the launch with what the buffer holds.  Returns best_z (H, W) f32
    (+inf: none) and best_src (H, W) int32, the winning tap's y*W + x (-1:
    none).  CUDA kernel csrc/predict_l0_scan.cu; `exact_division` divides
    every tap with __fdiv_rn in place of its fast division (the check that
    both give the same results).

    While a profiler runs, each call records the counter `scan_live` (the
    work these inputs need, for the kernel's roofline): H, W, `window`,
    `live` the live texels and `live_taps` the live texels over every
    pixel's +-window box, both device tensors read after the run.  A graph
    captures the counts with the scan, and each replay records them."""
    if recording() or stopwatch.in_graph_capture():
        H, W = live.shape
        # two launches: the product and one reduction giving both sums
        n = (live * _live_weights(H, W, int(window), live.device)).sum((1, 2))
        count("scan_live", H=H, W=W, window=int(window), live=n[0],
              live_taps=n[1])
    if radius.device.type == "cpu":
        return predict_l0_scan_plain(pos, normal, radius, live, intr,
                                     max_depth, window)
    H, W = radius.shape
    _check(pos, "pos", torch.float32, (H, W, 3))
    _check(normal, "normal", torch.float32, (H, W, 3))
    _check(radius, "radius", torch.float32, (H, W))
    _check(live, "live", torch.bool, (H, W))
    _check(intr, "intr", torch.float32, (4,))
    if intr.device != radius.device:
        raise ValueError(f"intr: expected a tensor on {radius.device}, "
                         f"got {intr.device}")
    best_z = torch.empty((H, W), dtype=torch.float32, device=radius.device)
    best_src = torch.empty((H, W), dtype=torch.int32, device=radius.device)
    lib = load_library()
    launch = (lib.mft_predict_l0_scan_exact if exact_division
              else lib.mft_predict_l0_scan)
    err = launch(
        pos.data_ptr(), normal.data_ptr(), radius.data_ptr(),
        live.data_ptr(), best_z.data_ptr(), best_src.data_ptr(), H, W,
        int(window), intr.data_ptr(), float(max_depth), _stream(radius))
    _raise_on(err, "predict_l0_scan")
    _launched(predict_l0_scan)
    return best_z, best_src


# ---------------------------------------------------------------------------
# kernel 3: geometric edge map of the segmentation
# ---------------------------------------------------------------------------

_OFFS8 = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)]


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b over the last axis of 3, summed ((a0 b0 + a1 b1) + a2 b2) as
    the twin's sum rounds on the CPU; torch's CUDA reduction over that axis
    sums in another order."""
    return ((a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1])
            + a[..., 2] * b[..., 2])


def geometric_edge_map_plain(vmap: torch.Tensor, nmap: torch.Tensor,
                             weight_distance: float,
                             weight_concavity: float) -> torch.Tensor:
    """Plain PyTorch version: the 8-neighbour tap loop of
    maskfusion_tpu/ops/seg_ops.py:30-67."""
    H, W = vmap.shape[:2]
    dev = vmap.device
    nan = float("nan")
    c_term = torch.zeros((H, W), dtype=torch.float32, device=dev)
    d_term = torch.zeros((H, W), dtype=torch.float32, device=dev)
    for dy, dx in _OFFS8:
        v_n = shift(vmap, dy, dx, nan)
        n_n = shift(nmap, dy, dx, nan)
        # concavity (getConcavityTerm): 0 on the convex side
        side = _dot3(v_n - vmap, nmap)
        conc = 1.0 - _dot3(n_n, nmap)
        conc = torch.where(side < 0, 0.0, conc)
        c_term = torch.maximum(c_term, torch.nan_to_num(conc, nan=0.0))
        # distance discontinuity (getDistanceTerm)
        d_term = torch.maximum(d_term, torch.nan_to_num(side.abs(), nan=0.0))
    edge = torch.clamp(torch.maximum(c_term * weight_concavity,
                                     d_term * weight_distance), max=1.0)
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    border = (xx < 1) | (xx >= W - 1) | (yy < 1) | (yy >= H - 1)
    invalid = ~torch.isfinite(vmap[..., 0]) | (vmap[..., 2] <= 0)
    return torch.where(border | invalid, 1.0, edge)


def geometric_edge_map(vmap: torch.Tensor, nmap: torch.Tensor,
                       weight_distance: float = 150.0,
                       weight_concavity: float = 2.8) -> torch.Tensor:
    """(H, W, 3) f32 vertex and normal maps (NaN: invalid) -> (H, W) f32
    edge strength in [0, 1]; the 1-pixel border and invalid pixels are 1.
    CUDA kernel csrc/geometric_edge_map.cu."""
    if vmap.device.type == "cpu":
        return geometric_edge_map_plain(vmap, nmap, weight_distance,
                                        weight_concavity)
    H, W = vmap.shape[:2]
    _check(vmap, "vmap", torch.float32, (H, W, 3))
    _check(nmap, "nmap", torch.float32, (H, W, 3))
    out = torch.empty((H, W), dtype=torch.float32, device=vmap.device)
    err = load_library().mft_geometric_edge_map(
        vmap.data_ptr(), nmap.data_ptr(), out.data_ptr(), H, W,
        float(weight_distance), float(weight_concavity), _stream(vmap))
    _raise_on(err, "geometric_edge_map")
    _launched(geometric_edge_map)
    return out


reset_launch_counts()
