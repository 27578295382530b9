"""Matterport Mask_RCNN .h5 -> the JAX package's parameter tree.

Port of ``maskfusion_tpu/maskrcnn/convert.py`` (numpy; h5py is imported
where a file is read).  The reference loads trained Keras weights at
startup (MaskRCNN.py.in:40-68, `model_path` in config.toml.in:28-33; COCO
weights are ResNet-101).  This module maps that .h5 layer-for-layer onto the
flax-named parameter tree that ``maskfusion_tpu_torch.convert.
maskrcnn_state_dict`` carries into the port's model, so real weights drop
in when a file is available; use ``MaskRCNNConfig(norm="frozen_bn",
backbone_blocks=(3, 4, 23, 3))`` for the published mask_rcnn_coco.h5.

Layout notes (verified against matterport model.py's graph):
  - Keras Conv2D kernels are (kh, kw, in, out) == flax Conv ``kernel``.
  - Keras Dense kernels are (in, out) == flax Dense.
  - mrcnn_class_conv1 is a 7x7 VALID conv over the pooled roi == a Dense on
    the flattened (7*7*C) roi; the kernel reshapes row-major (h, w, c).
  - Keras Conv2DTranspose kernels are (kh, kw, out, in) and apply the
    spatially-flipped kernel relative to flax ConvTranspose: transpose the
    channel axes and flip both spatial axes.
  - BatchNorm (gamma, beta, moving_mean, moving_variance) -> FrozenBatchNorm
    (scale, bias, mean, var); matterport runs BN in inference mode
    (train_bn=False), which FrozenBatchNorm reproduces exactly.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from maskfusion_tpu_torch.maskrcnn.model import MaskRCNN, MaskRCNNConfig


def _read_layer_weights(f) -> Dict[str, Dict[str, np.ndarray]]:
    """h5 file -> {layer_name: {weight_basename: array}}.

    Handles both flat save_weights layouts and nested sub-models (matterport
    wraps the RPN in an inner Model named 'rpn_model')."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    root = f["model_weights"] if "model_weights" in f else f

    def visit(name, obj):
        import h5py

        if isinstance(obj, h5py.Dataset):
            parts = name.split("/")
            base = parts[-1].split(":")[0]          # kernel:0 -> kernel
            layer = parts[-2] if len(parts) >= 2 else parts[0]
            out.setdefault(layer, {})[base] = np.asarray(obj)

    root.visititems(visit)
    return out


def _stage_blocks(n: int) -> List[str]:
    return [chr(ord("a") + i) if i < 26 else "z" + str(i) for i in range(n)]


def _bn(lw, name):
    w = lw[name]
    return {
        "scale": w["gamma"].astype(np.float32),
        "bias": w["beta"].astype(np.float32),
        "mean": w["moving_mean"].astype(np.float32),
        "var": w["moving_variance"].astype(np.float32),
    }


def _conv(lw, name):
    w = lw[name]
    p = {"kernel": w["kernel"].astype(np.float32)}
    if "bias" in w:
        p["bias"] = w["bias"].astype(np.float32)
    return p


def _dense_from_conv(lw, name):
    """7x7/1x1 conv kernel -> Dense kernel (flatten h, w, c row-major)."""
    w = lw[name]
    k = w["kernel"].astype(np.float32)
    p = {"kernel": k.reshape(-1, k.shape[-1])}
    if "bias" in w:
        p["bias"] = w["bias"].astype(np.float32)
    return p


def _deconv(lw, name):
    w = lw[name]
    k = w["kernel"].astype(np.float32)          # (kh, kw, out, in)
    k = k[::-1, ::-1].transpose(0, 1, 3, 2)     # -> flax (kh, kw, in, out)
    p = {"kernel": k}
    if "bias" in w:
        p["bias"] = w["bias"].astype(np.float32)
    return p


def convert_matterport_h5(h5_path: str, cfg: MaskRCNNConfig) -> dict:
    """Read a matterport Mask_RCNN .h5 and return the flax-named parameter
    tree (numpy float32) for ``MaskRCNN(cfg)``.  cfg.norm must be
    "frozen_bn"."""
    import h5py

    if cfg.norm != "frozen_bn":
        raise ValueError("matterport weights bake BatchNorm statistics; "
                         "use MaskRCNNConfig(norm='frozen_bn')")
    with h5py.File(h5_path, "r") as f:
        lw = _read_layer_weights(f)

    bb: Dict[str, dict] = {}
    # stem
    bb["Conv_0"] = _conv(lw, "conv1")
    bb["FrozenBatchNorm_0"] = _bn(lw, "bn_conv1")

    # residual stages
    bi = 0
    for stage, blocks in zip((2, 3, 4, 5), cfg.backbone_blocks):
        for k, blk in enumerate(_stage_blocks(blocks)):
            p: Dict[str, dict] = {}
            for j, br in enumerate(("2a", "2b", "2c")):
                p[f"Conv_{j}"] = _conv(lw, f"res{stage}{blk}_branch{br}")
                p[f"FrozenBatchNorm_{j}"] = _bn(lw, f"bn{stage}{blk}_branch{br}")
            if k == 0:  # conv_block: branch1 downsample
                p["Conv_3"] = _conv(lw, f"res{stage}{blk}_branch1")
                p["FrozenBatchNorm_3"] = _bn(lw, f"bn{stage}{blk}_branch1")
            bb[f"Bottleneck_{bi}"] = p
            bi += 1

    # FPN: lateral 1x1s in call order p5, p4, p3, p2 then 3x3s p2..p5
    for i, name in enumerate(
            ("fpn_c5p5", "fpn_c4p4", "fpn_c3p3", "fpn_c2p2",
             "fpn_p2", "fpn_p3", "fpn_p4", "fpn_p5"), start=1):
        bb[f"Conv_{i}"] = _conv(lw, name)

    rpn = {
        "rpn_conv": _conv(lw, "rpn_conv_shared"),
        "rpn_cls": _conv(lw, "rpn_class_raw"),
        "rpn_box": _conv(lw, "rpn_bbox_pred"),
    }

    box_head = {
        "fc1": _dense_from_conv(lw, "mrcnn_class_conv1"),
        "FrozenBatchNorm_0": _bn(lw, "mrcnn_class_bn1"),
        "fc2": _dense_from_conv(lw, "mrcnn_class_conv2"),
        "FrozenBatchNorm_1": _bn(lw, "mrcnn_class_bn2"),
        "cls": _dense_from_conv(lw, "mrcnn_class_logits"),
        "box": _dense_from_conv(lw, "mrcnn_bbox_fc"),
    }

    mask_head: Dict[str, dict] = {}
    for i in range(4):
        mask_head[f"conv{i + 1}"] = _conv(lw, f"mrcnn_mask_conv{i + 1}")
        mask_head[f"FrozenBatchNorm_{i}"] = _bn(lw, f"mrcnn_mask_bn{i + 1}")
    mask_head["deconv"] = _deconv(lw, "mrcnn_mask_deconv")
    mask_head["out"] = _conv(lw, "mrcnn_mask")

    params = {"params": {
        "backbone": bb,
        "rpn": rpn,
        "box_head": box_head,
        "mask_head": mask_head,
    }}
    _check_against_model(params, cfg)
    return _as_float32(params)


def _as_float32(tree):
    if isinstance(tree, dict):
        return {k: _as_float32(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def _check_against_model(params: dict, cfg: MaskRCNNConfig) -> None:
    """Verify the converted tree fits ``MaskRCNN(cfg)``: a strict
    ``load_state_dict`` of its ``maskrcnn_state_dict`` (every parameter
    present, none extra, every shape equal)."""
    from maskfusion_tpu_torch.convert import maskrcnn_state_dict

    try:
        state = maskrcnn_state_dict(params, cfg)
        MaskRCNN(cfg).load_state_dict(state, strict=True)
    except (KeyError, RuntimeError) as e:
        raise ValueError("converted weights do not match the model — "
                         f"{e}") from e
