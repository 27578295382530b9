"""Scatter primitives of the mapping layer.

A frozen copy of ``maskfusion_tpu_torch/ops/sort_utils.py`` (imports rewritten
to this folder; nothing of the program is imported).

Port of the OUTPUT CONTRACTS of ``maskfusion_tpu/ops/sort_utils.py``, not of
its sorts (the JAX package builds every scatter from sorts because XLA's TPU
scatter serialises).  On the card a scatter is the natural form:

  zbuffer_render    — per pixel the nearest valid element, ties to the
                      LOWEST slot: one scatter_reduce(amin) over a packed
                      (depth bits, slot) int64 key, deterministic whatever
                      order the atomics run in
  segment_sum_dense — per-slot sums: index_add_
  compact           — stable stream compaction (kept elements first in
                      their original order, the rest zero): a cumsum rank
                      and one scatter

None of these waits on the device: the kept count stays a device tensor.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

_SLOT_BITS = 32
_EMPTY = torch.iinfo(torch.int64).max


def zbuffer_render(lin: torch.Tensor, z: torch.Tensor, valid: torch.Tensor,
                   n_pixels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest-depth visibility: per pixel the slot index of the smallest-z
    valid element (-1 if none) and its depth (inf if none).

    Valid depths are positive f32, whose bit patterns order like the values,
    so (bits << 32 | slot) orders by depth, then by slot."""
    n = lin.shape[0]
    dev = lin.device
    slot = torch.arange(n, dtype=torch.int64, device=dev)
    zbits = z.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    key = torch.where(valid, (zbits << _SLOT_BITS) | slot, _EMPTY)
    target = torch.where(valid, lin.to(torch.int64), n_pixels)
    best = torch.full((n_pixels + 1,), _EMPTY, dtype=torch.int64, device=dev)
    best.scatter_reduce_(0, target, key, reduce="amin", include_self=True)
    best = best[:n_pixels]
    hit = best != _EMPTY
    idx = torch.where(hit, best & ((1 << _SLOT_BITS) - 1), -1).to(torch.int32)
    win_z = (best >> _SLOT_BITS).to(torch.int32).view(torch.float32)
    win_z = torch.where(hit, win_z, float("inf"))
    return idx, win_z


def pack_columns(arrays: Sequence[torch.Tensor]):
    """Stack 1-D/2-D arrays into one (N, C) f32 matrix; returns the matrix
    and the column slices for unpacking."""
    cols, slices, at = [], [], 0
    for a in arrays:
        a2 = a[:, None] if a.dim() == 1 else a
        cols.append(a2.to(torch.float32))
        slices.append((at, at + a2.shape[1], a.dim() == 1))
        at += a2.shape[1]
    return torch.cat(cols, dim=1), slices


def unpack_columns(mat: torch.Tensor, slices) -> List[torch.Tensor]:
    return [mat[:, a] if was_1d else mat[:, a:b]
            for (a, b, was_1d) in slices]


def segment_sum_dense(slots: torch.Tensor, valid: torch.Tensor,
                      values: Sequence[torch.Tensor], cap: int) -> list:
    """Sum each value array per slot into dense (cap, ...) outputs; invalid
    records go to a dropped extra row."""
    mat, slices = pack_columns(values)
    target = torch.where(valid, slots.to(torch.int64), cap)
    sums = torch.zeros((cap + 1, mat.shape[1]), dtype=torch.float32,
                       device=mat.device)
    sums.index_add_(0, target, torch.where(valid[:, None], mat, 0.0))
    return unpack_columns(sums[:cap], slices)


def compact(keep: torch.Tensor, arrays: Sequence[torch.Tensor]
            ) -> Tuple[list, torch.Tensor]:
    """Stable stream compaction: kept elements first (original order),
    remaining rows zero-filled.  Returns (compacted arrays, kept count)."""
    n = keep.shape[0]
    rank = torch.cumsum(keep.to(torch.int64), 0) - 1
    dest = torch.where(keep, rank, n)
    mat, slices = pack_columns(arrays)
    out = torch.zeros((n + 1, mat.shape[1]), dtype=torch.float32,
                      device=mat.device)
    # dropped rows all land on the extra row n, which is cut off below
    out.index_copy_(0, dest, mat)
    count = keep.sum(dtype=torch.int32)
    outs = [o.to(a.dtype) for o, a in zip(unpack_columns(out[:n], slices),
                                          arrays)]
    return outs, count
