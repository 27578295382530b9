"""Training batches for the Mask R-CNN cell, made on the card from the seed.

The port's shapes scene (``synthetic_shapes.make_shapes_scene``: a noisy
dark background with filled rectangles and disks, each an instance with
its box, class and mask) rewritten in torch and widened to the COCO label
space: every image holds between ``min_instances`` and ``max_instances``
instances of classes 1..``num_classes - 1``, drawn from the seed, padded to
``max_instances``.  Every seed makes the same number of batches of the same
shapes; only the drawn contents differ.
"""

from __future__ import annotations

from typing import Dict, List

import torch


def make_batch(gen: torch.Generator, batch: int, size: int,
               max_instances: int, min_instances: int, num_classes: int,
               min_side: float, max_side: float) -> Dict[str, torch.Tensor]:
    """One batch on ``gen``'s device: images (B, S, S, 3) float32 in
    [0, 255], gt_boxes (B, G, 4) normalised [y1, x1, y2, x2], gt_classes
    (B, G) int32, gt_valid (B, G) bool, gt_masks (B, G, S, S) float32."""
    dev = gen.device
    B, G, S = batch, max_instances, size

    def uniform(*shape, lo=0.0, hi=1.0):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    images = uniform(B, S, S, 3, hi=50.0)
    count = torch.randint(min_instances, max_instances + 1, (B,),
                          generator=gen, device=dev)
    valid = torch.arange(G, device=dev)[None, :] < count[:, None]
    classes = torch.randint(1, num_classes, (B, G), generator=gen,
                            device=dev, dtype=torch.int32)
    is_rect = uniform(B, G) < 0.5
    h = uniform(B, G, lo=min_side, hi=max_side) * S
    w = torch.where(is_rect, uniform(B, G, lo=min_side, hi=max_side) * S, h)
    cy = uniform(B, G) * (S - h - 2) + h / 2 + 1
    cx = uniform(B, G) * (S - w - 2) + w / 2 + 1
    colour = uniform(B, G, 3, lo=90.0, hi=255.0)
    jitter = uniform(B, G, 3, lo=-10.0, hi=10.0)

    yy = torch.arange(S, device=dev, dtype=torch.float32)
    dy = yy[None, None, :, None] - cy[..., None, None]       # (B, G, S, 1)
    dx = yy[None, None, None, :] - cx[..., None, None]       # (B, G, 1, S)
    rect = (dy.abs() <= h[..., None, None] / 2) & (
        dx.abs() <= w[..., None, None] / 2)
    r = (h / 2)[..., None, None]
    disk = dy * dy + dx * dx <= r * r
    masks = torch.where(is_rect[..., None, None], rect, disk) & valid[
        ..., None, None]
    # later instances paint over earlier ones; a mask keeps what shows
    for g in range(G):
        m = masks[:, g]
        images = torch.where(m[..., None], (colour[:, g] + jitter[:, g])[
            :, None, None, :], images)
        if g + 1 < G:
            later = masks[:, g + 1:].any(1)
            masks[:, g] &= ~later
    boxes = torch.stack([torch.clamp(cy - h / 2, min=0) / S,
                         torch.clamp(cx - w / 2, min=0) / S,
                         torch.clamp(cy + h / 2, max=S) / S,
                         torch.clamp(cx + w / 2, max=S) / S], -1)
    boxes = torch.where(valid[..., None], boxes, 0.0)
    classes = torch.where(valid, classes, 0)
    return {"images": images.contiguous(), "gt_boxes": boxes.contiguous(),
            "gt_classes": classes.contiguous(), "gt_valid": valid,
            "gt_masks": masks.to(torch.float32).contiguous()}


def make_pool(seed: int, device, n_batches: int, **params
              ) -> List[Dict[str, torch.Tensor]]:
    """``n_batches`` batches from a generator on ``device`` seeded with
    ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [make_batch(gen, **params) for _ in range(n_batches)]
