"""Mask R-CNN (ResNet-50/101-FPN) for inference and training, in PyTorch.

Port of ``maskfusion_tpu/maskrcnn/model.py`` (the reference's embedded
matterport network, Core/Segmentation/MaskRCNN): the backbone, the RPN,
ROIAlign, the box and class head and the mask head, with the JAX package's
static shapes (fixed proposal and detection counts padded with validity
masks), its training losses (RPN targets, proposal-target sampling, the box
and mask head losses) and its numerics:

- convs and dense layers hold float32 parameters, as flax's
  ``param_dtype``, and cast weight, bias and input to ``cfg.dtype`` (bf16
  by default) in the call, so an optimiser updates float32 weights;
  ``to_compute_dtype_`` stores them in ``cfg.dtype`` once for serving,
  which gives the same bits (both casts round to nearest even); GroupNorm
  takes its statistics in float32 (E[x^2] - E[x]^2, epsilon 1e-6, flax's)
  and casts back; the RPN, ROIAlign and the heads' outputs are float32;
- SAME padding as XLA pads it: the stem's 3x3/2 max pool pads 0 before and
  1 after with -inf; flax's 2x2/2 transposed conv (``transpose_kernel``
  False) puts kernel tap 1 on even outputs where F.conv_transpose2d puts
  tap 0, so ``maskfusion_tpu_torch.convert.maskrcnn_state_dict`` flips it;
- ties: proposals, and the sampled positive and negative training ROIs,
  are the first of a stable descending sort (``jax.lax.top_k`` puts the
  lower index first), and the NMS, class and IoU argmaxes take the first
  maximum.

Modules are NCHW ``nn.Module``s, run channels-last on CUDA; a feature map's
NHWC view is free there.  The NMS loops and the training losses run on
device tensors with no host synchronise.  The JAX ``train=True`` flag
reaches no layer (GroupNorm keeps no batch statistics), so there is no
train mode here.  There is no hand-written kernel here: the JAX package leaves
the whole network to XLA, and the port leaves it to torch ops.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from maskfusion_tpu_torch.utils.stopwatch import span


@dataclasses.dataclass(frozen=True)
class MaskRCNNConfig:
    num_classes: int = 81                  # COCO (matterport default)
    image_size: int = 512                  # square, padded
    # anchors
    anchor_scales: Tuple[int, ...] = (32, 64, 128, 256, 512)
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    # proposals / detections (static shapes)
    pre_nms_limit: int = 1024
    post_nms_proposals: int = 256
    max_detections: int = 100
    rpn_nms_threshold: float = 0.7
    detection_nms_threshold: float = 0.3
    score_threshold: float = 0.55          # config.toml.in:33
    # heads
    roi_pool_size: int = 7
    mask_pool_size: int = 14
    fpn_channels: int = 256
    box_head_dim: int = 1024               # matterport FPN_CLASSIF_FC_LAYERS
    mask_head_channels: int = 256
    # backbone (resnet50/101 via stage block counts)
    backbone_blocks: Tuple[int, ...] = (3, 4, 6, 3)
    # "gn" (from-scratch training) or "frozen_bn" (converted matterport
    # weights, which bake BatchNorm statistics)
    norm: str = "gn"
    # training (read by rpn_targets and proposal_targets)
    rpn_positive_iou: float = 0.7
    rpn_negative_iou: float = 0.3
    train_rois: int = 64                   # matterport TRAIN_ROIS_PER_IMAGE
    roi_positive_ratio: float = 0.33
    roi_positive_iou: float = 0.5
    # box-delta normalisation (matterport BBOX_STD_DEV / RPN_BBOX_STD_DEV)
    bbox_std: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)
    dtype: Any = torch.bfloat16


def matterport_coco_config(score_threshold: float = 0.55) -> MaskRCNNConfig:
    """MaskFusion's labeller: matterport's COCO Mask R-CNN, as
    ``mask_rcnn_coco.h5`` holds it (``mrcnn/config.py``,
    ``samples/coco/coco.py``; MaskFusion's ``MaskRCNN.py.in`` loads it):
    ResNet-101-FPN (BACKBONE "resnet101", TRAIN_BN False, so frozen
    BatchNorm), IMAGE_MAX_DIM 1024, PRE_NMS_LIMIT 6000,
    POST_NMS_ROIS_INFERENCE 1000, DETECTION_MAX_INSTANCES 100,
    RPN_NMS_THRESHOLD 0.7, DETECTION_NMS_THRESHOLD 0.3, 81 classes, FPN and
    mask head 256 wide, box head 1024, bf16 compute.  ``score_threshold``
    defaults to MaskFusion's 0.55 (``config.toml.in:33``), which its
    command line passes in place of matterport's 0.7."""
    return MaskRCNNConfig(
        num_classes=81, image_size=1024, pre_nms_limit=6000,
        post_nms_proposals=1000, max_detections=100, rpn_nms_threshold=0.7,
        detection_nms_threshold=0.3, score_threshold=score_threshold,
        roi_pool_size=7, mask_pool_size=14, fpn_channels=256,
        box_head_dim=1024, mask_head_channels=256,
        backbone_blocks=(3, 4, 23, 3), norm="frozen_bn",
        dtype=torch.bfloat16)


# --------------------------------------------------------------------------
# Layers with flax's numerics
# --------------------------------------------------------------------------

class Conv(nn.Module):
    """flax nn.Conv: float32 weight and bias (flax's param_dtype), cast with
    the input to ``dtype`` in the call; ``padding`` is the symmetric SAME
    padding of a stride-1 kernel (every strided conv of the network is 1x1
    or explicitly padded)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: Optional[int] = None, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dtype = dtype
        self.stride = stride
        self.padding = (k - 1) // 2 if padding is None else padding

    def forward(self, x):
        dt = self.dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), self.bias.to(dt),
                        self.stride, self.padding)


class Dense(nn.Module):
    """flax nn.Dense computing in ``dtype`` (weight (out, in), torch's
    layout; float32 parameters)."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class ConvTranspose2x2(nn.Module):
    """flax ConvTranspose((2, 2), strides=2, padding="SAME") as
    F.conv_transpose2d computing in ``dtype``: weight (in, out, 2, 2),
    flipped from flax's kernel by the converter."""

    def __init__(self, cin: int, cout: int, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, 2, 2))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt),
                                  self.bias.to(dt), stride=2)


def flax_axes(name: str, ndim: int) -> Tuple[int, ...]:
    """The layout of the ``state_dict`` entry ``name`` against flax's: axis
    i of the torch tensor is axis ``flax_axes(name, ndim)[i]`` of the flax
    leaf.  Conv kernels (kh, kw, in, out) are held (out, in, kh, kw), the
    transposed conv's (in, out, kh, kw) (and flipped in both spatial
    axes), Dense kernels (in, out) as (out, in); every other leaf keeps
    its axes.  ``convert.maskrcnn_state_dict`` and the FSDP placement rule
    (``parallel.mesh``) read this one table."""
    if name.endswith(".weight") and ndim >= 2:
        if name.endswith("deconv.weight"):
            return (2, 3, 0, 1)
        return (3, 2, 0, 1) if ndim == 4 else (1, 0)
    return tuple(range(ndim))


def to_compute_dtype_(model: nn.Module) -> nn.Module:
    """Store every conv, dense and transposed-conv parameter in its compute
    dtype, in place: a serving copy whose calls cast nothing.  Its forward
    equals the float32-held one bit for bit."""
    for mod in model.modules():
        if isinstance(mod, (Conv, Dense, ConvTranspose2x2)):
            mod.to(mod.dtype)
    return model


class GroupNorm(nn.Module):
    """flax nn.GroupNorm: statistics over (channels of the group, spatial)
    in float32 with the fast variance, epsilon 1e-6, float32 scale and
    bias, the result cast to ``dtype``.  Works on (N, C) rows as on
    (N, C, H, W) maps."""

    def __init__(self, channels: int, groups: int, dtype=torch.float32):
        super().__init__()
        self.groups = groups
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        n, c = x.shape[:2]
        xf = x.float()
        grouped = xf.reshape(n, self.groups, -1)
        mu = grouped.mean(-1)
        var = (grouped * grouped).mean(-1).sub_(mu * mu).clamp_min_(0.0)
        shape = (n, c) + (1,) * (x.dim() - 2)

        def per_channel(v):                 # (n, groups) -> (n, c, 1...)
            return v.repeat_interleave(c // self.groups, 1).reshape(shape)

        ch = (1, c) + (1,) * (x.dim() - 2)
        mul = per_channel(torch.rsqrt(var + 1e-6)) * self.scale.reshape(ch)
        y = (xf - per_channel(mu)) * mul + self.bias.reshape(ch)
        return y.to(self.dtype)


class FrozenBatchNorm(nn.Module):
    """BatchNorm as the fixed affine transform of matterport's inference
    graph (model.py:65-81 of the JAX package), computed in ``x``'s dtype."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.mean = nn.Parameter(torch.zeros(channels))
        self.var = nn.Parameter(torch.ones(channels))

    def forward(self, x):
        inv = self.scale / torch.sqrt(self.var + 1e-5)
        shift = self.bias - self.mean * inv
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return (x * inv.to(x.dtype).reshape(shape)
                + shift.to(x.dtype).reshape(shape))


def group_count(channels: int) -> int:
    """At most 32 groups, each at least 8 channels wide (model.py:84-93 of
    the JAX package)."""
    groups = min(32, max(1, channels // 8))
    while channels % groups:
        groups -= 1
    return groups


def make_norm(cfg: MaskRCNNConfig, channels: int) -> nn.Module:
    if cfg.norm == "frozen_bn":
        return FrozenBatchNorm(channels)
    return GroupNorm(channels, group_count(channels), cfg.dtype)


def max_pool_same_3x3s2(x):
    """flax max_pool((3, 3), strides=(2, 2), padding="SAME"): XLA pads
    (k - s) // 2 = 0 before and 1 after an even size, with -inf."""
    return F.max_pool2d(F.pad(x, (0, 1, 0, 1), value=float("-inf")), 3, 2)


# --------------------------------------------------------------------------
# Backbone: ResNet-50/101 + FPN
# --------------------------------------------------------------------------

class Bottleneck(nn.Module):
    """matterport's identity/conv block (stride on the 1x1 branch2a conv)."""

    def __init__(self, cfg: MaskRCNNConfig, cin: int, filters: int,
                 stride: int = 1):
        super().__init__()
        dt = cfg.dtype
        self.conv1 = Conv(cin, filters, 1, stride, dtype=dt)
        self.norm1 = make_norm(cfg, filters)
        self.conv2 = Conv(filters, filters, 3, dtype=dt)
        self.norm2 = make_norm(cfg, filters)
        self.conv3 = Conv(filters, filters * 4, 1, dtype=dt)
        self.norm3 = make_norm(cfg, filters * 4)
        self.down = self.down_norm = None
        if cin != filters * 4 or stride != 1:
            self.down = Conv(cin, filters * 4, 1, stride, dtype=dt)
            self.down_norm = make_norm(cfg, filters * 4)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        y = self.norm3(self.conv3(y))
        res = x if self.down is None else self.down_norm(self.down(x))
        return F.relu(y + res)


class ResNetFPN(nn.Module):
    """ResNet + FPN giving P2..P6 at strides 4..64.  ``blocks`` are the
    flax Bottleneck_k in creation order across the stages; ``lateral`` are
    the 1x1 convs on C5, C4, C3, C2 (flax Conv_1..Conv_4), ``output`` the
    3x3 convs on P2..P5 (Conv_5..Conv_8)."""

    def __init__(self, cfg: MaskRCNNConfig):
        super().__init__()
        dt = cfg.dtype
        self.dtype = dt
        self.stem = Conv(3, 64, 7, 2, padding=0, dtype=dt)
        self.stem_norm = make_norm(cfg, 64)
        blocks, cin = [], 64
        for filters, n, stride in zip((64, 128, 256, 512),
                                      cfg.backbone_blocks, (1, 2, 2, 2)):
            for i in range(n):
                blocks.append(Bottleneck(cfg, cin, filters,
                                         stride if i == 0 else 1))
                cin = filters * 4
        self.blocks = nn.ModuleList(blocks)
        self.stage_ends = list(np.cumsum(cfg.backbone_blocks))
        ch = cfg.fpn_channels
        self.lateral = nn.ModuleList(Conv(c, ch, 1, dtype=dt)
                                     for c in (2048, 1024, 512, 256))
        self.output = nn.ModuleList(Conv(ch, ch, 3, dtype=dt)
                                    for _ in range(4))

    def forward(self, x) -> List[torch.Tensor]:
        # matterport: ZeroPadding2D(3) + 7x7/2 VALID
        x = F.pad(x.to(self.dtype), (3, 3, 3, 3))
        x = F.relu(self.stem_norm(self.stem(x)))
        x = max_pool_same_3x3s2(x)
        cs = []
        for i, block in enumerate(self.blocks):
            x = block(x)
            if i + 1 in self.stage_ends:
                cs.append(x)
        c2, c3, c4, c5 = cs
        l5, l4, l3, l2 = self.lateral
        # jax.image.resize "nearest" samples at half-pixel centres:
        # nearest-exact (a repeat for the exact 2x here)
        p5 = l5(c5)
        p4 = l4(c4) + F.interpolate(p5, size=c4.shape[-2:],
                                    mode="nearest-exact")
        p3 = l3(c3) + F.interpolate(p4, size=c3.shape[-2:],
                                    mode="nearest-exact")
        p2 = l2(c2) + F.interpolate(p3, size=c2.shape[-2:],
                                    mode="nearest-exact")
        p2, p3, p4, p5 = (conv(p) for conv, p in zip(self.output,
                                                      (p2, p3, p4, p5)))
        p6 = p5[:, :, ::2, ::2]          # flax max_pool((1, 1), strides=2)
        return [p2, p3, p4, p5, p6]


# --------------------------------------------------------------------------
# RPN
# --------------------------------------------------------------------------

class RPNHead(nn.Module):
    def __init__(self, cfg: MaskRCNNConfig):
        super().__init__()
        dt, ch = cfg.dtype, cfg.fpn_channels
        n = len(cfg.anchor_ratios)
        self.conv = Conv(ch, ch, 3, dtype=dt)
        self.cls = Conv(ch, n * 2, 1, dtype=dt)
        self.box = Conv(ch, n * 4, 1, dtype=dt)

    def forward(self, feats):
        """Per level, the logits and deltas in flax's NHWC order: anchors
        (h, w, ratio)."""
        logits, deltas = [], []
        for f in feats:
            h = F.relu(self.conv(f))
            b = f.shape[0]
            logits.append(self.cls(h).permute(0, 2, 3, 1).reshape(b, -1, 2))
            deltas.append(self.box(h).permute(0, 2, 3, 1).reshape(b, -1, 4))
        return torch.cat(logits, 1).float(), torch.cat(deltas, 1).float()


def generate_anchors(cfg: MaskRCNNConfig) -> np.ndarray:
    """All anchors over the FPN pyramid, normalised [y1, x1, y2, x2]."""
    S = cfg.image_size
    anchors = []
    for lvl, scale in enumerate(cfg.anchor_scales):
        stride = 4 * (2 ** lvl)
        fs = S // stride
        ys = (np.arange(fs) + 0.5) * stride
        xs = (np.arange(fs) + 0.5) * stride
        cy, cx = np.meshgrid(ys, xs, indexing="ij")
        for ratio in cfg.anchor_ratios:
            h = scale / np.sqrt(ratio)
            w = scale * np.sqrt(ratio)
            a = np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], -1)
            anchors.append(a.reshape(-1, 4))
    # interleave per position to match the head's reshape order:
    # per level, (H*W, n_ratios, 4)
    out = []
    for lvl in range(len(cfg.anchor_scales)):
        per_ratio = anchors[lvl * len(cfg.anchor_ratios):
                            (lvl + 1) * len(cfg.anchor_ratios)]
        out.append(np.stack(per_ratio, axis=1).reshape(-1, 4))
    return (np.concatenate(out, 0) / S).astype(np.float32)


def apply_deltas(boxes, deltas):
    """Standard (dy, dx, log dh, log dw) box refinement."""
    h = boxes[..., 2] - boxes[..., 0]
    w = boxes[..., 3] - boxes[..., 1]
    cy = boxes[..., 0] + h / 2
    cx = boxes[..., 1] + w / 2
    cy = cy + deltas[..., 0] * h
    cx = cx + deltas[..., 1] * w
    h = h * torch.exp(torch.clamp(deltas[..., 2], -4, 4))
    w = w * torch.exp(torch.clamp(deltas[..., 3], -4, 4))
    return torch.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], -1)


def box_iou(a, b):
    """(N, 4) x (M, 4) -> (N, M) IoU."""
    y1 = torch.maximum(a[:, None, 0], b[None, :, 0])
    x1 = torch.maximum(a[:, None, 1], b[None, :, 1])
    y2 = torch.minimum(a[:, None, 2], b[None, :, 2])
    x2 = torch.minimum(a[:, None, 3], b[None, :, 3])
    inter = torch.clamp(y2 - y1, min=0) * torch.clamp(x2 - x1, min=0)
    area_a = (torch.clamp(a[:, 2] - a[:, 0], min=0)
              * torch.clamp(a[:, 3] - a[:, 1], min=0))
    area_b = (torch.clamp(b[:, 2] - b[:, 0], min=0)
              * torch.clamp(b[:, 3] - b[:, 1], min=0))
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / torch.clamp(union, min=1e-10)


def nms_fixed(boxes, scores, k: int, iou_threshold: float):
    """Greedy NMS with a static output size (model.py:245-271 of the JAX
    package): k picks of the highest live score, each suppressing the boxes
    above the IoU threshold and itself.  Returns (indices (k,), valid (k,));
    an invalid pick (no live score left) points at index 0, the first of
    the all -inf maxima, as jnp.argmax.  Three launches a pick on device
    tensors, no host synchronise: a pick's validity is read after the loop
    (its score was live: not -inf to begin with, and not suppressed by an
    earlier pick, the loop's only writes)."""
    n = boxes.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=boxes.device)
    suppress = (box_iou(boxes, boxes) > iou_threshold) | eye
    live = scores.clone()
    picks = []
    for _ in range(k):
        i = torch.argmax(live)              # the first maximum
        picks.append(i)
        live.masked_fill_(suppress.index_select(0, i.view(1))[0],
                          float("-inf"))
    idx = torch.stack(picks)
    earlier = torch.ones(k, k, dtype=torch.bool,
                         device=boxes.device).triu(1)    # [i, j]: i < j
    hit = (suppress[idx][:, idx] & earlier).any(0)
    valid = (scores[idx] > float("-inf")) & ~hit
    return idx, valid


def roi_align(feats, boxes, out_size: int, cfg: MaskRCNNConfig):
    """Multi-level ROIAlign (model.py:274-319 of the JAX package): every box
    bilinearly sampled on an out_size^2 grid on each of P2..P5, then the
    level of matterport's log2 area rule selected.  Returns (N, S, S, C)
    float32 (bf16 features times f32 weights)."""
    N = boxes.shape[0]
    dev = boxes.device
    h = torch.clamp(boxes[:, 2] - boxes[:, 0], min=1e-6)
    w = torch.clamp(boxes[:, 3] - boxes[:, 1], min=1e-6)
    lvl = torch.floor(4 + torch.log2(torch.sqrt(h * w) * cfg.image_size
                                     / 224.0))
    lvl = (torch.clamp(lvl, 2, 5) - 2).long()
    # jnp.linspace(0, 1, S) is iota / (S - 1)
    ts = torch.arange(out_size, dtype=torch.float32, device=dev) / (
        out_size - 1)
    gy = boxes[:, 0:1] + ts[None, :] * h[:, None]          # (N, S)
    gx = boxes[:, 1:2] + ts[None, :] * w[:, None]
    pooled = []
    for f in feats[:4]:
        _, C, H, W = f.shape
        flat = f[0].permute(1, 2, 0).reshape(H * W, C)     # NHWC rows
        fy = gy * H - 0.5
        fx = gx * W - 0.5
        y0f, x0f = torch.floor(fy), torch.floor(fx)
        wy = (fy - y0f)[:, :, None, None]
        wx = (fx - x0f)[:, None, :, None]
        y0, x0 = y0f.long(), x0f.long()

        def g(yi, xi):
            yi = yi.clamp(0, H - 1)
            xi = xi.clamp(0, W - 1)
            idx = yi[:, :, None] * W + xi[:, None, :]      # (N, S, S)
            return flat.index_select(0, idx.reshape(-1)).reshape(
                N, out_size, out_size, C)

        v00, v01 = g(y0, x0), g(y0, x0 + 1)
        v10, v11 = g(y0 + 1, x0), g(y0 + 1, x0 + 1)
        pooled.append(v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
                      + v10 * wy * (1 - wx) + v11 * wy * wx)
    pooled = torch.stack(pooled)
    return pooled[lvl, torch.arange(N, device=dev)]


class BoxHead(nn.Module):
    """fpn_classifier_graph: the 7x7 'conv' as a Dense over the ROI
    flattened in (h, w, c) order, as flax flattens it."""

    def __init__(self, cfg: MaskRCNNConfig):
        super().__init__()
        dt, d = cfg.dtype, cfg.box_head_dim
        self.num_classes = cfg.num_classes
        self.fc1 = Dense(cfg.roi_pool_size ** 2 * cfg.fpn_channels, d, dt)
        self.norm1 = make_norm(cfg, d)
        self.fc2 = Dense(d, d, dt)
        self.norm2 = make_norm(cfg, d)
        self.cls = Dense(d, cfg.num_classes, dt)
        self.box = Dense(d, cfg.num_classes * 4, dt)

    def forward(self, rois):
        x = rois.reshape(rois.shape[0], -1)
        x = F.relu(self.norm1(self.fc1(x)))
        x = F.relu(self.norm2(self.fc2(x)))
        return (self.cls(x).float(),
                self.box(x).reshape(-1, self.num_classes, 4).float())


class MaskHead(nn.Module):
    """build_fpn_mask_graph: 4x (conv + norm + relu), the 2x2 transposed
    conv + relu, the 1x1 class conv (logits)."""

    def __init__(self, cfg: MaskRCNNConfig):
        super().__init__()
        dt, ch = cfg.dtype, cfg.mask_head_channels
        cins = [cfg.fpn_channels] + [ch] * 3
        self.convs = nn.ModuleList(Conv(c, ch, 3, dtype=dt) for c in cins)
        self.norms = nn.ModuleList(make_norm(cfg, ch) for _ in range(4))
        self.deconv = ConvTranspose2x2(ch, ch, dt)
        self.out = Conv(ch, cfg.num_classes, 1, dtype=dt)

    def forward(self, rois):
        """rois (N, C, S, S) -> (N, num_classes, 2S, 2S) float32."""
        x = rois
        for conv, norm in zip(self.convs, self.norms):
            x = F.relu(norm(conv(x)))
        return self.out(F.relu(self.deconv(x))).float()


class MaskRCNN(nn.Module):
    """The inference network: ``forward(image)`` with image (1, S, S, 3)
    float32 in [0, 255], NHWC as the JAX package takes it, returns the JAX
    ``MaskRCNN.__call__``'s dict (model.py:396-444)."""

    def __init__(self, cfg: MaskRCNNConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = ResNetFPN(cfg)
        self.rpn = RPNHead(cfg)
        self.box_head = BoxHead(cfg)
        self.mask_head = MaskHead(cfg)
        self.register_buffer("anchors", torch.from_numpy(
            generate_anchors(cfg)), persistent=False)
        self.register_buffer("bbox_std", torch.tensor(
            cfg.bbox_std, dtype=torch.float32), persistent=False)
        self.register_buffer("pixel_mean", torch.tensor(
            [123.7, 116.8, 103.9], dtype=torch.float32), persistent=False)

    def _normalise(self, image):
        if self.cfg.norm == "frozen_bn":
            # matterport mold_image: RGB mean-pixel subtraction
            return image - self.pixel_mean
        return (image - 127.5) / 127.5

    def _proposals(self, rpn_logits, rpn_deltas):
        """RPN scores + deltas -> post_nms_proposals boxes (one image).
        While a profiler runs, the proposals' NMS is the span `rpn_nms`."""
        cfg = self.cfg
        scores = torch.softmax(rpn_logits, -1)[:, 1]
        k = min(cfg.pre_nms_limit, scores.shape[0])
        # jax.lax.top_k: the lower index first among equal scores
        top_scores, top_idx = torch.sort(scores, descending=True,
                                         stable=True)
        top_scores, top_idx = top_scores[:k], top_idx[:k]
        boxes = apply_deltas(self.anchors[top_idx],
                             rpn_deltas[top_idx] * self.bbox_std)
        boxes = torch.clamp(boxes, 0.0, 1.0)
        with span("rpn_nms"):
            sel, valid = nms_fixed(boxes, top_scores, cfg.post_nms_proposals,
                                   cfg.rpn_nms_threshold)
        props = torch.where(valid[:, None], boxes[sel], 0.0)
        return props, valid

    def features(self, image) -> List[torch.Tensor]:
        """P2..P6 of an (1, S, S, 3) image, (1, C, H, W) each."""
        x = self._normalise(image).permute(0, 3, 1, 2)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        return self.backbone(x)

    def forward(self, image) -> Dict[str, torch.Tensor]:
        """While a profiler runs, the backbone and FPN are the span
        `label_features`, the proposals' NMS `rpn_nms` and the detections'
        `det_nms`.  Besides the JAX package's outputs: ``box_deltas`` at
        every proposal, and ``pick_boxes`` / ``pick_classes``, the
        detection NMS's picks before the score threshold, at which
        ``mask_logits`` are taken."""
        cfg = self.cfg
        with span("label_features"):
            feats = self.features(image)
        rpn_logits, rpn_deltas = self.rpn(feats)
        out = {"rpn_logits": rpn_logits, "rpn_deltas": rpn_deltas}
        props, prop_valid = self._proposals(rpn_logits[0], rpn_deltas[0])
        out["proposals"] = props
        out["proposal_valid"] = prop_valid

        rois = roi_align(feats, props, cfg.roi_pool_size, cfg)
        cls_logits, box_deltas = self.box_head(rois)
        out["class_logits"] = cls_logits
        out["box_deltas"] = box_deltas

        # detection assembly (one image)
        probs = torch.softmax(cls_logits, -1)
        best_cls = torch.argmax(probs[:, 1:], -1) + 1
        best_score = probs.gather(1, best_cls[:, None])[:, 0]
        best_score = torch.where(prop_valid, best_score, 0.0)
        det_deltas = box_deltas[torch.arange(box_deltas.shape[0],
                                             device=box_deltas.device),
                                best_cls]
        det_boxes = torch.clamp(apply_deltas(props, det_deltas
                                             * self.bbox_std), 0.0, 1.0)
        with span("det_nms"):
            sel, valid = nms_fixed(det_boxes, best_score, cfg.max_detections,
                                   cfg.detection_nms_threshold)
        final_boxes = det_boxes[sel]
        final_scores = best_score[sel]
        final_cls = best_cls[sel]
        valid = valid & (final_scores >= cfg.score_threshold)

        out["detections"] = torch.where(valid[:, None], final_boxes, 0.0)
        out["detection_scores"] = torch.where(valid, final_scores, 0.0)
        out["detection_classes"] = torch.where(valid, final_cls, 0)
        out["detection_valid"] = valid
        out["pick_boxes"] = final_boxes
        out["pick_classes"] = final_cls

        mask_rois = roi_align(feats, final_boxes, cfg.mask_pool_size, cfg)
        mask_logits = self.mask_head(mask_rois.permute(0, 3, 1, 2))
        out["mask_logits"] = mask_logits[
            torch.arange(mask_logits.shape[0], device=mask_logits.device),
            final_cls]
        return out

    def train_losses(self, image, gt_boxes, gt_classes, gt_valid, gt_masks,
                     draws) -> Dict[str, torch.Tensor]:
        """End-to-end training losses for one image (model.py:446-482 of
        the JAX package): RPN class and box, then the box head's class and
        box and the mask head on proposal-target samples.  The proposals
        are detached (``stop_gradient``) and joined by the gt boxes, so
        positive ROIs exist from step 0.  ``draws`` (2, post_nms_proposals
        + G) are the uniform draws ``proposal_targets`` samples with
        (``jax.random.uniform(rng, (2, N))`` in the JAX package).

        image (1, S, S, 3) float32 in [0, 255]; gt_boxes (G, 4) normalised;
        gt_classes (G,) int; gt_valid (G,) bool; gt_masks (G, Hm, Wm)
        float binary instance masks over the full image."""
        cfg = self.cfg
        feats = self.features(image)
        rpn_logits, rpn_deltas = self.rpn(feats)
        l_rpn = rpn_loss(rpn_logits[0], rpn_deltas[0], self.anchors,
                         gt_boxes, gt_valid, cfg)
        props, prop_valid = self._proposals(rpn_logits[0].detach(),
                                            rpn_deltas[0].detach())
        props = torch.cat([props, gt_boxes.to(props.dtype)])
        prop_valid = torch.cat([prop_valid, gt_valid])
        tgt = proposal_targets(draws, props, prop_valid, gt_boxes,
                               gt_classes, gt_valid, gt_masks, cfg)
        rois = roi_align(feats, tgt.rois, cfg.roi_pool_size, cfg)
        cls_logits, box_deltas = self.box_head(rois)
        l_cls, l_box = box_head_loss(cls_logits, box_deltas, tgt)
        mask_rois = roi_align(feats, tgt.rois, cfg.mask_pool_size, cfg)
        mask_logits = self.mask_head(mask_rois.permute(0, 3, 1, 2))
        l_mask = mask_head_loss(mask_logits, tgt)
        return {"rpn": l_rpn, "class": l_cls, "box": l_box, "mask": l_mask,
                "total": l_rpn + l_cls + l_box + l_mask}

    def batch_loss(self, images, gt_boxes, gt_classes, gt_valid, gt_masks,
                   draws, full_loss: bool = True) -> torch.Tensor:
        """The mean over a batch of each image's loss (the JAX train step's
        ``loss_fn``, parallel/train.py:46-61, which ``vmap``s where this
        loops): ``train_losses``' total, or the RPN loss alone for the
        warm-up.  Inputs as ``train_losses``' with a leading batch axis;
        draws (B, 2, post_nms_proposals + G).  The sharded train step
        registers this method as an FSDP forward."""
        losses = []
        for b in range(images.shape[0]):
            img = images[b][None]
            if full_loss:
                losses.append(self.train_losses(
                    img, gt_boxes[b], gt_classes[b], gt_valid[b],
                    gt_masks[b], draws[b])["total"])
            else:
                logits, deltas = self.rpn(self.features(img))
                losses.append(rpn_loss(logits[0], deltas[0], self.anchors,
                                       gt_boxes[b], gt_valid[b], self.cfg))
        return torch.stack(losses).mean()


# --------------------------------------------------------------------------
# Training losses (model.py:489-657 of the JAX package)
# --------------------------------------------------------------------------

def rpn_targets(anchors, gt_boxes, gt_valid, cfg: MaskRCNNConfig):
    """Per-anchor class target (1 positive, 0 negative, -1 ignored) and box
    deltas.  Every valid gt's best anchor is positive.  The JAX package
    writes that with a scatter (``labels.at[best_anchor].set``) in which a
    padded gt's all-zero IoU column also names anchor 0, so anchor 0 can be
    written twice with different values in an order XLA leaves open; here
    the rule has no order: an anchor that is some valid gt's best is
    positive."""
    iou = torch.where(gt_valid[None, :], box_iou(anchors, gt_boxes), 0.0)
    best_iou = iou.max(1).values
    best_gt = torch.argmax(iou, 1)
    labels = torch.full((anchors.shape[0],), -1, dtype=torch.long,
                        device=anchors.device)
    labels = torch.where(best_iou < cfg.rpn_negative_iou, 0, labels)
    labels = torch.where(best_iou >= cfg.rpn_positive_iou, 1, labels)
    forced = torch.zeros(anchors.shape[0], dtype=torch.int32,
                         device=anchors.device)
    forced.index_add_(0, torch.argmax(iou, 0), gt_valid.to(torch.int32))
    labels = torch.where(forced > 0, 1, labels)
    return labels, box_deltas_between(anchors, gt_boxes[best_gt], cfg)


def rpn_loss(rpn_logits, rpn_deltas, anchors, gt_boxes, gt_valid,
             cfg: MaskRCNNConfig):
    """Cross-entropy over the labelled anchors plus L1 on the positives'
    deltas, each a mean over its anchors."""
    labels, target_deltas = rpn_targets(anchors, gt_boxes, gt_valid, cfg)
    use = labels >= 0
    ce = -torch.log_softmax(rpn_logits, -1).gather(
        1, labels.clamp(min=0)[:, None])[:, 0]
    cls_loss = torch.where(use, ce, 0.0).sum() / use.sum().clamp(min=1)
    pos = labels == 1
    l1 = torch.abs(rpn_deltas - target_deltas).sum(-1)
    box_loss = torch.where(pos, l1, 0.0).sum() / pos.sum().clamp(min=1)
    return cls_loss + box_loss


def box_deltas_between(src, dst, cfg: MaskRCNNConfig):
    """(dy, dx, log dh, log dw) refinement targets src -> dst, normalised by
    BBOX_STD_DEV."""
    sh = torch.clamp(src[:, 2] - src[:, 0], min=1e-6)
    sw = torch.clamp(src[:, 3] - src[:, 1], min=1e-6)
    dh = torch.clamp(dst[:, 2] - dst[:, 0], min=1e-6)
    dw = torch.clamp(dst[:, 3] - dst[:, 1], min=1e-6)
    # filled on the device: a copy from pageable host memory waits for the
    # card
    std = torch.stack([torch.full((), v, dtype=torch.float32,
                                  device=src.device) for v in cfg.bbox_std])
    return torch.stack([
        ((dst[:, 0] + dh / 2) - (src[:, 0] + sh / 2)) / sh,
        ((dst[:, 1] + dw / 2) - (src[:, 1] + sw / 2)) / sw,
        torch.log(dh / sh), torch.log(dw / sw)], -1) / std


def crop_masks_to_boxes(gt_masks, boxes, out_size: int):
    """Bilinearly resample each instance mask (N, H, W) to its box's
    out_size^2 grid (matterport DetectionTargetLayer's crop_and_resize, as
    the JAX package samples it)."""
    N, H, W = gt_masks.shape
    ts = torch.arange(out_size, dtype=torch.float32,
                      device=boxes.device) / (out_size - 1)
    h = boxes[:, 2] - boxes[:, 0]
    w = boxes[:, 3] - boxes[:, 1]
    gy = (boxes[:, 0:1] + ts[None, :] * h[:, None]) * H - 0.5   # (N, S)
    gx = (boxes[:, 1:2] + ts[None, :] * w[:, None]) * W - 0.5
    y0f, x0f = torch.floor(gy), torch.floor(gx)
    wy = (gy - y0f)[:, :, None]
    wx = (gx - x0f)[:, None, :]
    y0, x0 = y0f.long(), x0f.long()
    flat = gt_masks.reshape(N, H * W)

    def g(yi, xi):
        yi = yi.clamp(0, H - 1)
        xi = xi.clamp(0, W - 1)
        idx = yi[:, :, None] * W + xi[:, None, :]           # (N, S, S)
        return flat.gather(1, idx.reshape(N, -1)).reshape(N, out_size,
                                                          out_size)

    v00, v01 = g(y0, x0), g(y0, x0 + 1)
    v10, v11 = g(y0 + 1, x0), g(y0 + 1, x0 + 1)
    return (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
            + v10 * wy * (1 - wx) + v11 * wy * wx)


class ProposalTargets(NamedTuple):
    rois: torch.Tensor           # (T, 4) sampled training rois
    target_class: torch.Tensor   # (T,) int64, 0 = background
    target_deltas: torch.Tensor  # (T, 4) for the target class
    target_masks: torch.Tensor   # (T, 2*mask_pool, 2*mask_pool) in [0, 1]
    positive: torch.Tensor       # (T,) bool
    valid: torch.Tensor          # (T,) bool (positive or sampled negative)


def _top(scores, k: int):
    """jax.lax.top_k's indices: the k largest, the lower index first among
    equal scores (every non-candidate here is exactly -1)."""
    return torch.sort(scores, descending=True, stable=True)[1][:k]


def proposal_targets(draws, proposals, prop_valid, gt_boxes, gt_classes,
                     gt_valid, gt_masks, cfg: MaskRCNNConfig
                     ) -> ProposalTargets:
    """Sample ``train_rois`` proposals into positives (IoU >= 0.5, share
    ``roi_positive_ratio``) and negatives, with class, box and mask targets
    (a static-shape DetectionTargetLayer).  ``draws`` (2, N) are the
    uniform scores of the positive and the negative draw."""
    T = cfg.train_rois
    n_pos = int(round(T * cfg.roi_positive_ratio))
    iou = torch.where(gt_valid[None, :] & prop_valid[:, None],
                      box_iou(proposals, gt_boxes), 0.0)
    best_iou = iou.max(1).values
    best_gt = torch.argmax(iou, 1)
    is_pos = prop_valid & (best_iou >= cfg.roi_positive_iou)
    is_neg = prop_valid & (best_iou < cfg.roi_positive_iou)
    pos_score = torch.where(is_pos, draws[0], -1.0)
    pos_idx = _top(pos_score, n_pos)
    pos_ok = pos_score[pos_idx] >= 0.0
    neg_score = torch.where(is_neg, draws[1], -1.0)
    neg_idx = _top(neg_score, T - n_pos)
    neg_ok = neg_score[neg_idx] >= 0.0
    sel = torch.cat([pos_idx, neg_idx])
    positive = torch.cat([pos_ok, torch.zeros_like(neg_ok)])
    valid = torch.cat([pos_ok, neg_ok])
    rois = proposals[sel]
    gt_idx = best_gt[sel]
    tgt_cls = torch.where(positive, gt_classes.long()[gt_idx], 0)
    return ProposalTargets(
        rois, tgt_cls, box_deltas_between(rois, gt_boxes[gt_idx], cfg),
        crop_masks_to_boxes(gt_masks[gt_idx], rois, cfg.mask_pool_size * 2),
        positive, valid)


def box_head_loss(cls_logits, box_deltas, tgt: ProposalTargets):
    """Class cross-entropy over the sampled rois plus smooth L1 on the
    positives' target-class deltas (mrcnn_class_loss, mrcnn_bbox_loss)."""
    T = cls_logits.shape[0]
    tc = tgt.target_class
    ce = -torch.log_softmax(cls_logits, -1).gather(1, tc[:, None])[:, 0]
    cls_loss = (torch.where(tgt.valid, ce, 0.0).sum()
                / tgt.valid.sum().clamp(min=1))
    sel = box_deltas[torch.arange(T, device=tc.device), tc]
    diff = torch.abs(sel - tgt.target_deltas)
    sl1 = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5).sum(-1)
    box_loss = (torch.where(tgt.positive, sl1, 0.0).sum()
                / tgt.positive.sum().clamp(min=1))
    return cls_loss, box_loss


def mask_head_loss(mask_logits, tgt: ProposalTargets):
    """Per-pixel binary cross-entropy at the target class's channel
    (mrcnn_mask_loss).  ``mask_logits`` (T, num_classes, H, W), the port's
    mask head's NCHW output."""
    T = mask_logits.shape[0]
    tc = tgt.target_class
    sel = mask_logits[torch.arange(T, device=tc.device), tc]
    y = tgt.target_masks
    bce = (torch.clamp(sel, min=0) - sel * y
           + torch.log1p(torch.exp(-torch.abs(sel))))
    per_roi = bce.mean((1, 2))
    return (torch.where(tgt.positive, per_roi, 0.0).sum()
            / tgt.positive.sum().clamp(min=1))


def init_params_(model: MaskRCNN, seed: int = 0) -> MaskRCNN:
    """Fill ``model`` in place with flax's default initialisers from a
    seeded torch.Generator: lecun_normal kernels (truncated normal, std
    sqrt(1 / fan_in) / 0.8796, cut at 2 std), zero biases, unit scales
    (GroupNorm) and the identity statistics (FrozenBatchNorm).  These match
    a JAX ``model.init`` in distribution only, not value for value."""
    g = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, (Conv, Dense, ConvTranspose2x2)):
            w = mod.weight
            if isinstance(mod, ConvTranspose2x2):
                fan_in = w.shape[0] * w[0, 0].numel()
            else:
                fan_in = w[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            buf = torch.empty(w.shape, dtype=torch.float32)
            nn.init.trunc_normal_(buf, 0.0, std, -2 * std, 2 * std,
                                  generator=g)
            with torch.no_grad():
                w.copy_(buf)
                mod.bias.zero_()
    return model
