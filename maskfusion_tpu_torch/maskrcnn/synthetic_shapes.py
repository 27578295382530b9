"""Synthetic shapes domain for Mask R-CNN: scenes, recipes, evaluations.

Port of ``maskfusion_tpu/maskrcnn/synthetic_shapes.py``: the scene
generators (numpy, the same arrays for the same generator), the two
domains' configs, the training recipes behind the repository's two
checkpoints (``train_shapes``, ``train_rich``; the checkpoints themselves
are ``maskfusion_tpu/maskrcnn/checkpoints``) and the held-out evaluations.
Recipes and evaluations run the port's model on the first CUDA card unless
``device="cpu"``; both take and give the JAX package's parameter tree
(``convert.maskrcnn_state_dict`` / ``maskrcnn_flax_tree``), so a tree
trained here is what ``checkpoint_io.save_params`` writes and the JAX
package loads.  Class ids: 1 = rectangle, 2 = disk (3 = triangle in the
rich domain); 0 = background.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.utils.deterministic


NUM_SHAPE_CLASSES = 3   # bg, rectangle, disk


def make_shapes_scene(
    rng: np.random.Generator,
    size: int,
    max_objects: int = 2,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One scene.  Returns (image (S,S,3) f32 0..255, boxes (M,4) normalised
    [y1,x1,y2,x2], classes (M,) i32, valid (M,) bool, masks (M,S,S) f32)."""
    S = size
    img = rng.uniform(0.0, 50.0, (S, S, 3)).astype(np.float32)
    n = int(rng.integers(1, max_objects + 1))
    boxes = np.zeros((max_objects, 4), np.float32)
    classes = np.zeros((max_objects,), np.int32)
    valid = np.zeros((max_objects,), bool)
    masks = np.zeros((max_objects, S, S), np.float32)

    yy, xx = np.mgrid[0:S, 0:S]
    for i in range(n):
        cls = int(rng.integers(1, NUM_SHAPE_CLASSES))
        h = rng.uniform(0.25, 0.5) * S
        w = rng.uniform(0.25, 0.5) * S
        cy = rng.uniform(h / 2 + 1, S - h / 2 - 1)
        cx = rng.uniform(w / 2 + 1, S - w / 2 - 1)
        if cls == 1:
            m = ((np.abs(yy - cy) <= h / 2) & (np.abs(xx - cx) <= w / 2))
        else:
            r = min(h, w) / 2
            m = ((yy - cy) ** 2 + (xx - cx) ** 2) <= r * r
            h = w = 2 * r
        color = np.zeros(3, np.float32)
        color[cls - 1] = rng.uniform(180, 255)          # channel encodes class
        color[2] = rng.uniform(120, 200)
        img[m] = color + rng.uniform(-10, 10, 3).astype(np.float32)
        masks[i][m] = 1.0
        boxes[i] = [max(cy - h / 2, 0) / S, max(cx - w / 2, 0) / S,
                    min(cy + h / 2, S) / S, min(cx + w / 2, S) / S]
        classes[i] = cls
        valid[i] = True
    return img, boxes, classes, valid, masks


def make_batch(rng: np.random.Generator, batch: int, size: int,
               max_objects: int = 2):
    """Stacked batch of scenes (for the train step)."""
    outs = [make_shapes_scene(rng, size, max_objects) for _ in range(batch)]
    return tuple(np.stack([o[k] for o in outs]) for k in range(5))


def box_iou_np(a: np.ndarray, b: np.ndarray) -> float:
    y1 = max(a[0], b[0]); x1 = max(a[1], b[1])
    y2 = min(a[2], b[2]); x2 = min(a[3], b[3])
    inter = max(y2 - y1, 0.0) * max(x2 - x1, 0.0)
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return float(inter / max(ua, 1e-10))


def micro_config(image_size: int = 64):
    """The shapes-domain training config (3 classes: BG/square/circle).
    Shared by the checkpoint-training script and the test suite."""
    from maskfusion_tpu_torch.maskrcnn.model import MaskRCNNConfig

    return MaskRCNNConfig(
        num_classes=3, image_size=image_size,
        anchor_scales=(8, 16, 32, 64, 128), anchor_ratios=(1.0,),
        pre_nms_limit=128, post_nms_proposals=32, max_detections=4,
        roi_pool_size=7, mask_pool_size=7,
        fpn_channels=32, box_head_dim=64, mask_head_channels=32,
        backbone_blocks=(1, 1, 1, 1),
        train_rois=16, roi_positive_ratio=0.5, score_threshold=0.0,
        rpn_positive_iou=0.5, dtype=torch.float32,
    )


def forward_fn(cfg, params, device=None):
    """The port's network for ``cfg`` with the JAX parameter tree
    ``params``: a function from an (S, S, 3) float32 image to the output
    dict as numpy arrays."""
    from maskfusion_tpu_torch.maskrcnn.inference import MaskRCNNInference

    net = MaskRCNNInference(cfg, params=params, device=device)

    def fwd(img):
        x = torch.from_numpy(np.ascontiguousarray(img, np.float32))
        with torch.no_grad():
            out = net.model(x.to(net.device)[None])
        return {k: v.cpu().numpy() for k, v in out.items()}

    return fwd


def train(cfg, scene, steps: int, seed: int, lr, clip_norm=None,
          log_every: int = 0, device=None):
    """The recipes' loop (synthetic_shapes.py:113-134, 318-340 of the JAX
    package): a network initialised from ``seed``, one scene a step from
    ``np.random.default_rng(seed)`` (``scene(rng)``), the proposal
    sampling's draws of step i from a torch.Generator seeded with i, the
    full loss, one Adam update (``optim.Optimizer(lr, clip_norm)``).
    Returns (params, losses): the JAX parameter tree and each step's
    total loss.  The losses are fetched at the end (and every
    ``log_every`` steps when logging).

    On a card the loop runs under torch's deterministic algorithms
    (restored afterwards), so a seed gives the same network run after run,
    as the JAX recipe does under XLA: otherwise the atomic adds of
    ROIAlign's backward make each card run its own, and 700 steps from one
    seed end anywhere in a spread as wide as the seeds'
    (tests/torch_recipe_spread.py measures it).  The CPU's kernels are
    deterministic already."""
    from maskfusion_tpu_torch import resolve_device
    from maskfusion_tpu_torch.convert import maskrcnn_flax_tree
    from maskfusion_tpu_torch.maskrcnn.model import MaskRCNN, init_params_
    from maskfusion_tpu_torch.maskrcnn.optim import Optimizer

    dev = resolve_device(device, "synthetic_shapes.train")
    model = init_params_(MaskRCNN(cfg), seed).to(dev)
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    opt = Optimizer(model.parameters(), lr, clip_norm)
    rng = np.random.default_rng(seed)
    losses = []
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled(),
           torch.utils.deterministic.fill_uninitialized_memory)
    if dev.type == "cuda":
        # warn_only: cuBLAS is deterministic on one stream without the
        # workspace setting that the strict mode asks for; no op here reads
        # memory it did not write, so none is filled
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        for i in range(steps):
            img, b, c, v, m = (torch.from_numpy(np.asarray(a)).to(dev)
                               for a in scene(rng))
            draws = torch.rand((2, cfg.post_nms_proposals + b.shape[0]),
                               generator=torch.Generator().manual_seed(i))
            loss = model.train_losses(img[None], b, c, v, m,
                                      draws.to(dev))["total"]
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(loss.detach())
            if log_every and (i + 1) % log_every == 0:
                recent = torch.stack(losses[-log_every:]).mean().item()
                print(f"step {i + 1}/{steps} loss {recent:.4f}", flush=True)
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        torch.utils.deterministic.fill_uninitialized_memory = was[2]
    return (maskrcnn_flax_tree(model.state_dict(), cfg),
            torch.stack(losses).cpu().tolist())


def train_shapes(steps: int = 700, image_size: int = 64, seed: int = 0,
                 lr: float = 1e-3, log_every: int = 0, device=None):
    """Train the full loss stack (RPN + box + mask heads) on the shapes
    domain with Adam at ``lr``; returns (params, losses).  The recipe
    behind the repository's shapes checkpoint."""
    return train(micro_config(image_size),
                 lambda rng: make_shapes_scene(rng, image_size), steps,
                 seed, lr, log_every=log_every, device=device)


def eval_shapes_detection(params, image_size: int = 64, n_scenes: int = 12,
                          seed: int = 1, device=None):
    """Held-out detection quality of a shapes-trained network: returns
    dict(det_iou, cls_acc, mask_iou, mean_score) — the quantities the
    quality test asserts (reference operating threshold 0.55,
    config.toml.in:33)."""
    fwd = forward_fn(micro_config(image_size), params, device)
    rng = np.random.default_rng(seed)
    ious, cls_ok, scores_l, mask_ious = [], [], [], []
    for _ in range(n_scenes):
        img, b, c, v, m = make_shapes_scene(rng, image_size, max_objects=1)
        out = fwd(img)
        scores = np.asarray(out["detection_scores"])
        k = int(np.argmax(scores))
        det = np.asarray(out["detections"])[k]
        ious.append(box_iou_np(det, b[0]))
        cls_ok.append(
            int(np.asarray(out["detection_classes"])[k]) == int(c[0]))
        scores_l.append(scores[k])
        ml = np.asarray(out["mask_logits"])[k] > 0
        S = image_size
        y1, x1, y2, x2 = np.clip((det * S).astype(int), 0, S)
        y2, x2 = max(y2, y1 + 1), max(x2, x1 + 1)
        yy, xx = np.mgrid[y1:y2, x1:x2]
        my = np.clip(((yy - y1) / (y2 - y1) * ml.shape[0]).astype(int),
                     0, ml.shape[0] - 1)
        mx = np.clip(((xx - x1) / (x2 - x1) * ml.shape[1]).astype(int),
                     0, ml.shape[1] - 1)
        pred = np.zeros((S, S), bool)
        pred[y1:y2, x1:x2] = ml[my, mx]
        gtm = m[0] > 0.5
        mask_ious.append((pred & gtm).sum() / max((pred | gtm).sum(), 1))
    return {
        "det_iou": float(np.mean(ious)),
        "cls_acc": float(np.mean(cls_ok)),
        "mask_iou": float(np.mean(mask_ious)),
        "mean_score": float(np.mean(scores_l)),
    }


# --------------------------------------------------------------------------
# Rich multi-instance domain (>=256 px): occlusion, clutter, 3 shape classes
# --------------------------------------------------------------------------

NUM_RICH_CLASSES = 4    # bg, rectangle, disk, triangle
RICH_MAX_OBJECTS = 4


def make_rich_scene(
    rng: np.random.Generator,
    size: int,
    max_objects: int = RICH_MAX_OBJECTS,
    min_visible: float = 0.25,
):
    """Multi-instance scene at >=256 px with the failure modes the micro
    domain lacks (VERDICT r3 item 8): overlapping instances (later shapes
    OCCLUDE earlier ones — gt masks are the VISIBLE parts), low-contrast
    clutter distractors, textured background, and per-instance hue jitter.
    Classes: 1 rectangle, 2 disk, 3 triangle (matterport's train_shapes
    domain plus occlusion, MaskRCNN.py.in tutorial lineage).

    Returns (image, boxes, classes, valid, masks) with static
    (max_objects, ...) shapes; occluded-away instances have valid=False."""
    S = size
    yy, xx = np.mgrid[0:S, 0:S].astype(np.float32)
    # textured background: low-frequency gradient + broadband noise
    g = rng.uniform(0, 60, 3).astype(np.float32)
    d = rng.uniform(-1, 1, (2, 3)).astype(np.float32)
    img = (g[None, None] + yy[..., None] / S * 40 * d[0]
           + xx[..., None] / S * 40 * d[1]
           + rng.uniform(0, 25, (S, S, 3))).astype(np.float32)

    def draw_shape(cls, cy, cx, h, w, ang):
        if cls == 1:
            ca, sa = np.cos(ang), np.sin(ang)
            ry = (yy - cy) * ca - (xx - cx) * sa
            rx = (yy - cy) * sa + (xx - cx) * ca
            return (np.abs(ry) <= h / 2) & (np.abs(rx) <= w / 2)
        if cls == 2:
            return ((yy - cy) / (h / 2)) ** 2 + ((xx - cx) / (w / 2)) ** 2 <= 1.0
        # triangle: apex up, base h below, rotated by ang
        ca, sa = np.cos(ang), np.sin(ang)
        ry = (yy - cy) * ca - (xx - cx) * sa
        rx = (yy - cy) * sa + (xx - cx) * ca
        return (ry >= -h / 2) & (ry <= h / 2) & (
            np.abs(rx) <= (ry + h / 2) / h * (w / 2))

    # clutter: 3-6 dim distractors that must be REJECTED (below the object
    # intensity band, wrong saturation)
    for _ in range(int(rng.integers(3, 7))):
        cls = int(rng.integers(1, NUM_RICH_CLASSES))
        h = rng.uniform(0.04, 0.12) * S
        m = draw_shape(cls, rng.uniform(0, S), rng.uniform(0, S), h, h,
                       rng.uniform(0, np.pi))
        img[m] = rng.uniform(40, 90, 3).astype(np.float32)

    n = int(rng.integers(2, max_objects + 1))
    boxes = np.zeros((max_objects, 4), np.float32)
    classes = np.zeros((max_objects,), np.int32)
    valid = np.zeros((max_objects,), bool)
    masks = np.zeros((max_objects, S, S), np.float32)
    full = []
    for i in range(n):
        cls = int(rng.integers(1, NUM_RICH_CLASSES))
        h = rng.uniform(0.15, 0.4) * S
        w = rng.uniform(0.15, 0.4) * S
        if cls == 2:
            w = h
        cy = rng.uniform(h / 2 + 2, S - h / 2 - 2)
        cx = rng.uniform(w / 2 + 2, S - w / 2 - 2)
        m = draw_shape(cls, cy, cx, h, w, rng.uniform(0, np.pi))
        color = np.full(3, 0.0, np.float32)
        color[cls - 1] = rng.uniform(170, 255)
        color[(cls) % 3] = rng.uniform(90, 150)    # hue jitter off the axis
        img[m] = color[None] + rng.uniform(-12, 12, (int(m.sum()), 3))
        # later shapes occlude earlier ones: carve the overlap out
        for j in range(len(full)):
            full[j] = (full[j][0] & ~m, full[j][1])
        full.append((m, float(m.sum())))
        classes[i] = cls
    for i, (m, area0) in enumerate(full):
        if m.sum() < min_visible * max(area0, 1.0):
            classes[i] = 0
            continue
        ys, xs = np.nonzero(m)
        boxes[i] = [ys.min() / S, xs.min() / S,
                    (ys.max() + 1) / S, (xs.max() + 1) / S]
        masks[i][m] = 1.0
        valid[i] = True
    return img, boxes, classes, valid, masks


def rich_config(image_size: int = 256):
    """Training config for the rich domain at >=256 px: deeper backbone and
    wider heads than micro_config, anchors rescaled to the instance sizes."""
    from maskfusion_tpu_torch.maskrcnn.model import MaskRCNNConfig

    return MaskRCNNConfig(
        num_classes=NUM_RICH_CLASSES, image_size=image_size,
        anchor_scales=(16, 32, 64, 128, 256), anchor_ratios=(0.5, 1.0, 2.0),
        pre_nms_limit=512, post_nms_proposals=64,
        max_detections=RICH_MAX_OBJECTS * 2,
        roi_pool_size=7, mask_pool_size=14,
        fpn_channels=64, box_head_dim=256, mask_head_channels=64,
        backbone_blocks=(2, 2, 2, 2),
        train_rois=32, roi_positive_ratio=0.4, score_threshold=0.0,
        rpn_positive_iou=0.6, dtype=torch.float32,
    )


def train_rich(steps: int = 1500, image_size: int = 256, seed: int = 0,
               lr: float = 1e-3, log_every: int = 0, warmup: int = 100,
               device=None):
    """Train the full loss stack on the rich domain: gradients clipped to a
    global norm of 5, Adam over a ``warmup``-step linear warm-up then a
    cosine decay (``optim.warmup_cosine``); returns (params, losses)."""
    from maskfusion_tpu_torch.maskrcnn.optim import warmup_cosine

    return train(rich_config(image_size),
                 lambda rng: make_rich_scene(rng, image_size), steps, seed,
                 warmup_cosine(lr, warmup, steps), clip_norm=5.0,
                 log_every=log_every, device=device)


def eval_rich_detection(params, image_size: int = 256, n_scenes: int = 10,
                        seed: int = 1, score_thresh: float = 0.5,
                        device=None):
    """Held-out MULTI-instance quality: greedy best-IoU matching of
    detections to ground truth per scene.  Returns dict(det_iou, cls_acc,
    mask_iou, recall) over all gt instances (unmatched gt scores 0)."""
    fwd = forward_fn(rich_config(image_size), params, device)
    rng = np.random.default_rng(seed)
    S = image_size
    ious, cls_ok, mask_ious, matched_n, gt_n = [], [], [], 0, 0
    for _ in range(n_scenes):
        img, b, c, v, m = make_rich_scene(rng, image_size)
        out = fwd(img)
        scores = np.asarray(out["detection_scores"])
        dets = np.asarray(out["detections"])
        dcls = np.asarray(out["detection_classes"])
        mlog = np.asarray(out["mask_logits"])
        order = np.argsort(-scores)
        used = set()
        for gi in np.nonzero(v)[0]:
            gt_n += 1
            best, best_iou = -1, 0.0
            for k in order:
                if scores[k] < score_thresh or k in used:
                    continue
                iou = box_iou_np(dets[k], b[gi])
                if iou > best_iou:
                    best, best_iou = k, iou
            if best < 0 or best_iou < 0.3:
                ious.append(0.0)
                continue
            used.add(best)
            matched_n += 1
            ious.append(best_iou)
            cls_ok.append(int(dcls[best]) == int(c[gi]))
            det = dets[best]
            ml = mlog[best] > 0
            y1, x1, y2, x2 = np.clip((det * S).astype(int), 0, S)
            y2, x2 = max(y2, y1 + 1), max(x2, x1 + 1)
            yy, xx = np.mgrid[y1:y2, x1:x2]
            my = np.clip(((yy - y1) / (y2 - y1) * ml.shape[0]).astype(int),
                         0, ml.shape[0] - 1)
            mx = np.clip(((xx - x1) / (x2 - x1) * ml.shape[1]).astype(int),
                         0, ml.shape[1] - 1)
            pred = np.zeros((S, S), bool)
            pred[y1:y2, x1:x2] = ml[my, mx]
            gtm = m[gi] > 0.5
            mask_ious.append((pred & gtm).sum() / max((pred | gtm).sum(), 1))
    return {
        "det_iou": float(np.mean(ious)) if ious else 0.0,
        "cls_acc": float(np.mean(cls_ok)) if cls_ok else 0.0,
        "mask_iou": float(np.mean(mask_ious)) if mask_ious else 0.0,
        "recall": matched_n / max(gt_n, 1),
    }


def paste_mask_np(det: np.ndarray, mask_logits: np.ndarray,
                  size: int) -> np.ndarray:
    """Paste a (mH, mW) mask-logit crop into a full (S, S) bool image over
    the detection's box (the reference's unmold step — matterport
    utils.unmold_mask; nearest-neighbour instead of bilinear, adequate for
    IoU scoring)."""
    S = size
    ml = mask_logits > 0
    y1, x1, y2, x2 = np.clip((det * S).astype(int), 0, S)
    y2, x2 = max(y2, y1 + 1), max(x2, x1 + 1)
    yy, xx = np.mgrid[y1:y2, x1:x2]
    my = np.clip(((yy - y1) / (y2 - y1) * ml.shape[0]).astype(int),
                 0, ml.shape[0] - 1)
    mx = np.clip(((xx - x1) / (x2 - x1) * ml.shape[1]).astype(int),
                 0, ml.shape[1] - 1)
    pred = np.zeros((S, S), bool)
    pred[y1:y2, x1:x2] = ml[my, mx]
    return pred


def _ap_from_matches(records, n_gt: int) -> float:
    """COCO-style AP with 101-point interpolation from (score, is_tp)
    records (greedy per-scene matching already applied)."""
    if n_gt == 0 or not records:
        return 0.0
    records = sorted(records, key=lambda r: -r[0])
    tp = np.cumsum([r[1] for r in records], dtype=np.float64)
    fp = np.cumsum([not r[1] for r in records], dtype=np.float64)
    recall = tp / n_gt
    precision = tp / np.maximum(tp + fp, 1e-10)
    # precision envelope + 101-point sampling (pycocotools semantics)
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    pts = np.linspace(0, 1, 101)
    idx = np.searchsorted(recall, pts, side="left")
    p = np.where(idx < len(precision), precision[np.minimum(idx, len(precision) - 1)], 0.0)
    return float(np.mean(p))


def eval_rich_ap(params, image_size: int = 256, n_scenes: int = 25,
                 seed: int = 2, score_thresh: float = 0.05, device=None):
    """COCO-style held-out AP on the rich domain: box/mask AP@0.5 and
    mAP@[.5:.95] (class-aware greedy matching, 101-point interpolation) —
    the quality analogue of the reference's COCO-pretrained operating point
    (score threshold 0.55, MaskRCNN config.toml.in:33).  Low score_thresh:
    AP integrates over the PR curve, so all confident-ish detections count.
    Returns dict(box_ap50, box_map, mask_ap50, mask_map, n_gt)."""
    fwd = forward_fn(rich_config(image_size), params, device)
    rng = np.random.default_rng(seed)
    thresholds = np.arange(0.5, 1.0, 0.05)
    # records[t_idx][kind] = list of (score, is_tp); kind 0=box, 1=mask
    records = [([], []) for _ in thresholds]
    n_gt = 0
    for _ in range(n_scenes):
        img, b, c, v, m = make_rich_scene(rng, image_size)
        out = fwd(img)
        scores = np.asarray(out["detection_scores"])
        dets = np.asarray(out["detections"])
        dcls = np.asarray(out["detection_classes"])
        mlog = np.asarray(out["mask_logits"])
        gt_idx = np.nonzero(v)[0]
        n_gt += len(gt_idx)
        keep = np.nonzero(scores >= score_thresh)[0]
        keep = keep[np.argsort(-scores[keep])]
        # per-detection IoUs against every gt (box and pasted-mask)
        box_iou = np.zeros((len(keep), len(gt_idx)))
        mask_iou = np.zeros_like(box_iou)
        for a, k in enumerate(keep):
            pred = paste_mask_np(dets[k], mlog[k], image_size)
            for g, gi in enumerate(gt_idx):
                if int(dcls[k]) != int(c[gi]):
                    continue          # class-aware: wrong class never matches
                box_iou[a, g] = box_iou_np(dets[k], b[gi])
                gtm = m[gi] > 0.5
                mask_iou[a, g] = (pred & gtm).sum() / max((pred | gtm).sum(), 1)
        for ti, t in enumerate(thresholds):
            for kind, ious in ((0, box_iou), (1, mask_iou)):
                taken = np.zeros(len(gt_idx), bool)
                for a, k in enumerate(keep):     # score-descending greedy
                    cand = np.where(taken, -1.0, ious[a])
                    g = int(np.argmax(cand)) if len(gt_idx) else -1
                    is_tp = len(gt_idx) > 0 and cand[g] >= t
                    if is_tp:
                        taken[g] = True
                    records[ti][kind].append((float(scores[k]), bool(is_tp)))
    box_aps = [_ap_from_matches(records[ti][0], n_gt)
               for ti in range(len(thresholds))]
    mask_aps = [_ap_from_matches(records[ti][1], n_gt)
                for ti in range(len(thresholds))]
    return {
        "box_ap50": box_aps[0], "box_map": float(np.mean(box_aps)),
        "mask_ap50": mask_aps[0], "mask_map": float(np.mean(mask_aps)),
        "n_gt": n_gt,
    }
