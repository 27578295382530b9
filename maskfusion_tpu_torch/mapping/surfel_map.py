"""Device-resident surfel maps.

Port of ``maskfusion_tpu/mapping/surfel_map.py``: one SoA set of tensors
per model plus a live count (an int32 device scalar, so that growth never
waits on the device).  Surfels are kept compacted in [0, count); per-surfel
passes run on a prefix "bucket" of the capacity.

Unlike the JAX package, which is functional with donated buffers, the
append and write-back here update the map's tensors IN PLACE (at 2^22
slots a map is ~235 MB; copying it each frame would double the frame's
traffic).  Each function that does so says so.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from maskfusion_tpu_torch.camera import CameraIntrinsics
from maskfusion_tpu_torch.ops import preprocess as pp
from maskfusion_tpu_torch.ops import sort_utils


class SurfelMap(NamedTuple):
    pos: torch.Tensor        # (N, 3) float32 — world frame
    conf: torch.Tensor       # (N,)   float32 — 0 marks a free slot
    color: torch.Tensor      # (N, 3) float32 — 0..255 RGB
    init_time: torch.Tensor  # (N,)   float32
    last_seen: torch.Tensor  # (N,)   float32
    normal: torch.Tensor     # (N, 3) float32 — world frame, unit
    radius: torch.Tensor     # (N,)   float32
    count: torch.Tensor      # ()     int32 — live surfels in [0, count)

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    def slot_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, device=self.pos.device) < self.count


def empty(capacity: int, device) -> SurfelMap:
    # the JAX package routes slot ids through f32 (exact below 2^24); the
    # guard is kept so that both packages accept the same configs
    if capacity >= 1 << 24:
        raise ValueError(
            f"surfel capacity {capacity} >= 2^24 would break f32-exact "
            "slot-index routing (ops/fuse._subgrid2, splat.pack_index_fields)")

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return SurfelMap(pos=z(capacity, 3), conf=z(capacity),
                     color=z(capacity, 3), init_time=z(capacity),
                     last_seen=z(capacity), normal=z(capacity, 3),
                     radius=z(capacity),
                     count=torch.zeros((), dtype=torch.int32, device=device))


def host_or_device(x):
    """A frame value (the time, a threshold) as the passes take it: a host
    number as a float; a 0-d device tensor, a graphed pass's (filled on
    each replay, tracking/graphs), as it is."""
    return x if isinstance(x, torch.Tensor) else float(x)


def stamp(n: int, x, device) -> torch.Tensor:
    """(n,) float32 filled with the frame value `x` (`host_or_device`)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).expand(n)
    return torch.full((n,), float(x), device=device)


def radius_from_depth(z: torch.Tensor, norm_z: torch.Tensor,
                      intr: CameraIntrinsics) -> torch.Tensor:
    """Surfel radius (surfels.glsl getRadius:19-34): sqrt2 * z / meanFocal,
    inflated by view obliquity but capped at 2x."""
    mean_focal = (abs(intr.fx) + abs(intr.fy)) / 2.0
    r = z * (1.4142135623730951 / mean_focal)
    rn = r / torch.clamp(norm_z.abs(), min=1e-6)
    return torch.minimum(2.0 * r, rn)


def pixel_confidence(H: int, W: int, intr: CameraIntrinsics, weighting,
                     device) -> torch.Tensor:
    """Radial confidence falloff (surfels.glsl confidence:36-46)."""
    u, v = pp._grid(H, W, device)
    dx = u - intr.cx
    dy = v - intr.cy
    radial = torch.sqrt(dx * dx + dy * dy) / 400.0
    return torch.exp(-(radial * radial) / 0.72) * weighting


def init_from_frame(capacity: int, vmap_raw, vmap_filt, nmap_filt, rgb,
                    mask, mask_id, pose, intr: CameraIntrinsics,
                    time: float = 1.0, weighting: float = 1.0) -> SurfelMap:
    """First observation: every valid masked pixel becomes a surfel
    (Model::initialise, Model.cpp:240-285)."""
    H, W = vmap_raw.shape[:2]
    dev = vmap_raw.device
    R = pose[:3, :3]
    t = pose[:3, 3]
    valid = (torch.isfinite(vmap_raw[..., 0]) & torch.isfinite(nmap_filt[..., 0])
             & (vmap_raw[..., 2] > 0) & (mask == mask_id)).reshape(-1)
    pos_w = vmap_raw.reshape(-1, 3) @ R.T + t
    norm_w = nmap_filt.reshape(-1, 3) @ R.T
    conf = pixel_confidence(H, W, intr, 1.0, dev).reshape(-1) * weighting
    rad = radius_from_depth(vmap_filt[..., 2].reshape(-1),
                            nmap_filt[..., 2].reshape(-1), intr)
    col = rgb.reshape(-1, 3).to(torch.float32)
    t = stamp(H * W, time, dev)
    return compact_into(empty(capacity, dev), valid, pos_w, conf, col, t, t,
                        norm_w, rad)


def compact_into(m: SurfelMap, keep: torch.Tensor, pos, conf, color,
                 init_time, last_seen, normal, radius) -> SurfelMap:
    """Append the `keep`-masked candidates after m.count in their order;
    overflow beyond capacity is dropped.  Writes m's tensors IN PLACE and
    returns them with the new count.

    The append window is the P rows at offset min(count, cap - P) — the JAX
    package's window (surfel_map.py:170-193), addressed with device indices
    so that the count never leaves the device."""
    cap = m.capacity
    P = keep.shape[0]
    dev = keep.device
    compacted, n_new = sort_utils.compact(
        keep, [pos, conf, color, init_time, last_seen, normal, radius])
    packed, slices = sort_utils.pack_columns(compacted)
    new_count = torch.clamp(m.count + n_new, max=cap).to(torch.int32)
    if P >= cap:
        widx = torch.arange(cap, device=dev)
        src = torch.clamp(widx - m.count, 0, P - 1)
    else:
        offset = torch.clamp(m.count, max=cap - P)
        widx = offset + torch.arange(P, device=dev)
        src = torch.clamp(widx - m.count, min=0)
    take_new = (widx >= m.count) & (widx < new_count)
    cand = sort_utils.unpack_columns(packed[src], slices)
    for old, new in zip(m[:7], cand):
        mask = take_new if old.dim() == 1 else take_new[:, None]
        old.index_copy_(0, widx, torch.where(mask, new, old[widx]))
    return m._replace(count=new_count)


def compact_self(m: SurfelMap, keep: torch.Tensor) -> SurfelMap:
    """Stream-compact the map into a fresh buffer (Model::clean's copy into
    the other VBO, copy_unstable.vert + Model.cpp:649-772)."""
    keep = keep & m.slot_mask()
    return compact_into(empty(m.capacity, m.pos.device), keep, *m[:7])


def prefix_view(m: SurfelMap, bucket: int) -> SurfelMap:
    """The first `bucket` slots (views, not copies).  Surfels are kept
    compacted in [0, count), so per-surfel passes run on a bucket >= count
    instead of the full capacity."""
    if bucket >= m.capacity:
        return m
    return SurfelMap(*(a[:bucket] for a in m[:7]), count=m.count)


def write_back(full: SurfelMap, pref: SurfelMap) -> SurfelMap:
    """Copy a processed prefix back into the full-capacity tensors IN PLACE
    (slots beyond the bucket are zero by the compaction invariant)."""
    if pref.capacity >= full.capacity:
        return pref
    for f, p in zip(full[:7], pref[:7]):
        f[:p.shape[0]].copy_(p)
    return full._replace(count=pref.count)


def choose_bucket(count: int, capacity: int, headroom: int = 81920,
                  minimum: int = 1 << 18, current: int = 0,
                  pow2_steps: bool = False) -> int:
    """Host-side bucket policy: smallest 1.25x-step bucket covering count
    plus one frame's appends, with shrink hysteresis against `current`
    (maskfusion_tpu/mapping/surfel_map.py:255-278)."""
    need = max(int(count) + headroom, minimum)
    b = minimum
    while b < need:
        b += b if pow2_steps else b >> 2
    b = min(b, capacity)
    if current and b < current <= capacity and need > int(current * 0.7):
        return current
    return b


def download(m: SurfelMap):
    """Host copy of the live surfels (Model::downloadMap, Model.cpp:943-974),
    skipping killed-in-place holes (radius == 0 below count)."""
    n = int(m.count)
    radius = m.radius[:n].cpu().numpy()
    live = radius > 0

    def host(a):
        return a[:n].cpu().numpy()[live]

    return {"pos": host(m.pos), "conf": host(m.conf), "color": host(m.color),
            "init_time": host(m.init_time), "last_seen": host(m.last_seen),
            "normal": host(m.normal), "radius": radius[live]}
