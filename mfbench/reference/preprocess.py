"""Frozen copy of ``maskfusion_tpu_torch/ops/preprocess.py``,
the plain PyTorch version the benchmark judges the program against
(imports rewritten to this folder; nothing of the program is imported).

Depth/RGB preprocessing ops.

Port of ``maskfusion_tpu/ops/preprocess.py``:
  - bilateral depth filter        (ops/kernels.bilateral_depth; ref
                                   depth_bilateral_metric.frag:31-76)
  - NaN-aware Gaussian pyramids   (ref cudafuncs.cu:333-364, 534-564)
  - vertex / normal maps          (ref cudafuncs.cu:109-205)
  - map transform / 2x resize     (ref cudafuncs.cu:207-269, 366-445)
  - intensity + derivative images (ref cudafuncs.cu:626-715)
  - depth to points               (ref cudafuncs.cu:718-736)

Conventions: images are (H, W[, C]) tensors; vertex/normal maps are (H, W, 3)
float32 with NaN marking invalid entries.  The model-side pyramid ops
(pyr_down_gauss_depth, pyr_down_uchar_gauss, resize_vmap, resize_nmap,
transform_maps, vertices_to_depth, rgb_to_intensity) also take a leading
slot axis, one image per object model.  Strided decimation is plain
slicing here: the JAX package's one-hot convs existed only because TPU
strided slices are slow, and a slice is exact.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from mfbench.reference.camera import CameraIntrinsics
from mfbench.reference import kernels
from mfbench.reference.kernels import shift

_NAN = float("nan")


def _grid(H: int, W: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u, v) float32 pixel coordinates, each (H, W)."""
    u = torch.arange(W, dtype=torch.float32, device=device)[None, :]
    v = torch.arange(H, dtype=torch.float32, device=device)[:, None]
    return u.expand(H, W), v.expand(H, W)


def _shift_edge(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """(..., H, W) float image shifted with edge-replicate padding."""
    H, W = img.shape[-2:]
    p = F.pad(img.reshape((-1, 1, H, W)),
              (max(0, -dx), max(0, dx), max(0, -dy), max(0, dy)),
              mode="replicate").reshape(img.shape[:-2] + (H + abs(dy),
                                                          W + abs(dx)))
    return p[..., max(0, dy):max(0, dy) + H, max(0, dx):max(0, dx) + W]


# ---------------------------------------------------------------------------
# Bilateral depth filter (kernel 1)
# ---------------------------------------------------------------------------

def bilateral_filter_depth(
    depth: torch.Tensor,
    radius: int = 6,
    sigma_space2_inv_half: float = 0.024691358,
    sigma_color2_inv_half: float = 555.556,
    min_valid_depth: float = 0.03,
) -> torch.Tensor:
    """Spatial+range bilateral filter over metric depth
    (depth_bilateral_metric.frag:31-76): the hand-written CUDA kernel on the
    card, its plain version on the CPU."""
    return kernels.bilateral_depth(
        depth.to(torch.float32).contiguous(), radius, sigma_space2_inv_half,
        sigma_color2_inv_half, min_valid_depth)


# ---------------------------------------------------------------------------
# Gaussian pyramid downsampling
# ---------------------------------------------------------------------------

_BINOMIAL5 = (1.0, 4.0, 6.0, 4.0, 1.0)


def _separable_masked_blur(vals: torch.Tensor, valid: torch.Tensor):
    """5-tap binomial blur of (valid*vals) and valid, separably, summed in
    the JAX package's tap order."""
    H, W = vals.shape[-2:]

    def blur_axis(a, axis):
        if axis == 0:
            p = F.pad(a, (0, 0, 2, 2))
        else:
            p = F.pad(a, (2, 2, 0, 0))
        out = torch.zeros_like(a)
        for k, wk in enumerate(_BINOMIAL5):
            if axis == 0:
                out = out + wk * p[..., k:k + H, :]
            else:
                out = out + wk * p[..., k:k + W]
        return out

    v = torch.where(valid, vals, 0.0)
    wsum = valid.to(torch.float32)
    return (blur_axis(blur_axis(v, 0), 1),
            blur_axis(blur_axis(wsum, 0), 1))


def pyr_down_gauss_depth(src: torch.Tensor) -> torch.Tensor:
    """Half-resolution 5x5 binomial downsample of float depth, skipping NaN
    and zero taps and renormalising (ref pyrDownKernelGaussF,
    cudafuncs.cu:333-364)."""
    H, W = src.shape[-2:]
    h, w = H // 2, W // 2
    srcf = src.to(torch.float32)
    valid = torch.isfinite(srcf) & (srcf > 0)
    sum_v, sum_w = _separable_masked_blur(srcf, valid)
    sum_v = sum_v[..., :2 * h:2, :2 * w:2]
    sum_w = sum_w[..., :2 * h:2, :2 * w:2]
    out = sum_v / torch.clamp(sum_w, min=1e-20)
    return torch.where(sum_w > 0, out, 0.0)


def pyr_down_uchar_gauss(src: torch.Tensor) -> torch.Tensor:
    """Half-resolution 5x5 binomial downsample of a uint8 image, counting only
    taps > 0 (ref pyrDownKernelIntensityGauss, cudafuncs.cu:534-564)."""
    H, W = src.shape[-2:]
    h, w = H // 2, W // 2
    srcf = src.to(torch.float32)
    sum_v, sum_w = _separable_masked_blur(srcf, srcf > 0)
    sum_v = sum_v[..., :2 * h:2, :2 * w:2]
    sum_w = sum_w[..., :2 * h:2, :2 * w:2]
    return (sum_v / torch.clamp(sum_w, min=1e-20)).to(src.dtype)


def pyr_down_mask_nearest(src: torch.Tensor) -> torch.Tensor:
    """Half-resolution nearest-neighbour downsample for label images (the
    JAX package's deliberate fix of the reference's averaged ids)."""
    return src[0::2, 0::2]


# ---------------------------------------------------------------------------
# Vertex / normal maps
# ---------------------------------------------------------------------------

def create_vmap(depth: torch.Tensor, intr: CameraIntrinsics,
                depth_cutoff: float) -> torch.Tensor:
    """Back-project depth to a camera-frame vertex map (H, W, 3); invalid
    pixels get NaN x/y and z = 0 (computeVmapKernel, cudafuncs.cu:109-134)."""
    H, W = depth.shape
    u, v = _grid(H, W, depth.device)
    z = depth.to(torch.float32)
    valid = (z > 0.0) & (z < depth_cutoff)
    x = z * (u - intr.cx) / intr.fx
    y = z * (v - intr.cy) / intr.fy
    return torch.stack([torch.where(valid, x, _NAN),
                        torch.where(valid, y, _NAN),
                        torch.where(valid, z, 0.0)], dim=-1)


def create_nmap(vmap: torch.Tensor) -> torch.Tensor:
    """Cross-product normal map n = normalize((v[y,x+1]-v) x (v[y+1,x]-v)),
    NaN on the last row/col or missing data (cudafuncs.cu:152-189)."""
    v01 = shift(vmap, 0, 1, _NAN)
    v10 = shift(vmap, 1, 0, _NAN)
    valid = (torch.isfinite(vmap[..., 0]) & torch.isfinite(v01[..., 0])
             & torch.isfinite(v10[..., 0]))
    c = torch.linalg.cross(v01 - vmap, v10 - vmap, dim=-1)
    norm = torch.linalg.vector_norm(c, dim=-1, keepdim=True)
    n = c / torch.clamp(norm, min=1e-20)
    return torch.where(valid[..., None], n, _NAN)


def transform_maps(vmap: torch.Tensor, nmap: torch.Tensor, R: torch.Tensor,
                   t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """SE(3)-transform a vertex map, rotate a normal map; NaN entries stay
    NaN (tranformMapsKernel, cudafuncs.cu:207-248)."""
    v_valid = torch.isfinite(vmap[..., 0])
    n_valid = torch.isfinite(nmap[..., 0])
    if R.dim() > 2:     # one pose per slot: (N, 3, 3) against (N, H, W, 3)
        R, t = R[..., None, :, :], t[..., None, None, :]
    v_out = vmap @ R.mT + t
    n_out = nmap @ R.mT
    return (torch.where(v_valid[..., None], v_out, _NAN),
            torch.where(n_valid[..., None], n_out, _NAN))


_TENT = ((1.0, 2.0, 1.0), (2.0, 4.0, 2.0), (1.0, 2.0, 1.0))


def _resize_half(m: torch.Tensor, normalize: bool) -> torch.Tensor:
    """Centre-registered 2x downsample of a (..., H, W, 3) map: a 3x3 tent
    (stride 2, NaN pad 1), NaN where any tap is NaN.  This is the JAX
    package's deliberate fix of the reference's half-texel-shifted
    resizeMapKernel (maskfusion_tpu/ops/preprocess.py:229-259): it registers
    the model pyramid with the frame pyramid exactly.  The nine taps are
    summed explicitly — a conv algorithm that mixes a tile's inputs
    (Winograd, FFT) would spread NaN where it does not belong."""
    H, W = m.shape[-3:-1]
    h, w = (H - 1) // 2 + 1, (W - 1) // 2 + 1
    p = F.pad(m, (0, 0, 1, 1, 1, 1), value=_NAN)
    avg = torch.zeros(m.shape[:-3] + (h, w, m.shape[-1]), dtype=m.dtype,
                      device=m.device)
    for i in range(3):
        for j in range(3):
            avg = avg + (_TENT[i][j] / 16.0) * \
                p[..., i:i + 2 * h:2, j:j + 2 * w:2, :]
    if normalize:
        avg = avg / torch.clamp(
            torch.linalg.vector_norm(avg, dim=-1, keepdim=True), min=1e-20)
    return avg


def resize_vmap(m: torch.Tensor) -> torch.Tensor:
    return _resize_half(m, normalize=False)


def resize_nmap(m: torch.Tensor) -> torch.Tensor:
    return _resize_half(m, normalize=True)


def vertices_to_depth(vmap: torch.Tensor, cutoff: float) -> torch.Tensor:
    """z plane of a vertex map with NaN outside (0, cutoff]
    (verticesToDepthKernel, cudafuncs.cu:602-613)."""
    z = vmap[..., 2]
    return torch.where((z > 0) & (z <= cutoff) & torch.isfinite(z), z, _NAN)


# ---------------------------------------------------------------------------
# Intensity + gradients
# ---------------------------------------------------------------------------

def rgb_to_intensity(rgb: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) uint8 RGB -> (H, W) uint8 luminance 0.587R + 0.299G + 0.114B
    (bgr2IntensityKernel's weights on BGR frames, cudafuncs.cu:626-639)."""
    f = rgb.to(torch.float32)
    val = f[..., 0] * 0.587 + f[..., 1] * 0.299 + f[..., 2] * 0.114
    return val.to(torch.uint8)


_GSOBEL_X = (
    (0.52201, 0.00000, -0.52201),
    (0.79451, -0.00000, -0.79451),
    (0.52201, 0.00000, -0.52201),
)
_GSOBEL_Y = (
    (0.52201, 0.79451, 0.52201),
    (0.00000, 0.00000, 0.00000),
    (-0.52201, -0.79451, -0.52201),
)


def compute_derivative_images(
        intensity: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smoothed image gradients dI/dx, dI/dy as float32, truncated toward
    zero like the reference's int16 stores (applyKernel,
    cudafuncs.cu:658-683); edge-replicated border."""
    src = intensity.to(torch.float32)
    dx = torch.zeros_like(src)
    dy = torch.zeros_like(src)
    # the reference indexes its kernel back to front (kernelIndex 8 ... 0)
    for j in (-1, 0, 1):
        for i in (-1, 0, 1):
            tap = _shift_edge(src, j, i)
            dx = dx + tap * _GSOBEL_X[1 - j][1 - i]
            dy = dy + tap * _GSOBEL_Y[1 - j][1 - i]
    return torch.trunc(dx), torch.trunc(dy)


def project_to_pointcloud(depth: torch.Tensor,
                          intr: CameraIntrinsics) -> torch.Tensor:
    """Depth -> (H, W, 3) camera-frame points, no validity gating
    (ref projectPointsKernel, cudafuncs.cu:718-736)."""
    H, W = depth.shape
    u, v = _grid(H, W, depth.device)
    z = depth.to(torch.float32)
    x = (u - intr.cx) * z / intr.fx
    y = (v - intr.cy) * z / intr.fy
    return torch.stack([x, y, z], dim=-1)


# ---------------------------------------------------------------------------
# Frame pyramid bundle
# ---------------------------------------------------------------------------

def build_frame_pyramids(filtered_depth: torch.Tensor,
                         intensity: torch.Tensor, mask: torch.Tensor,
                         intr: CameraIntrinsics, depth_cutoff: float,
                         num_levels: int = 3):
    """Per-frame pyramid stack (Model::generateCUDATextures,
    Model.cpp:350-389): a tuple of per-level dicts with depth, intensity,
    mask, vmap and nmap."""
    levels = []
    d, g, m = filtered_depth, intensity, mask
    for i in range(num_levels):
        if i > 0:
            d = pyr_down_gauss_depth(d)
            g = pyr_down_uchar_gauss(g)
            m = pyr_down_mask_nearest(m)
        vmap = create_vmap(d, intr.level(i), depth_cutoff)
        levels.append(dict(depth=d, intensity=g, mask=m, vmap=vmap,
                           nmap=create_nmap(vmap)))
    return tuple(levels)
