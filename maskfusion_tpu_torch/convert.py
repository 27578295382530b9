"""Carry engine state across packages.

The system has no weights: its state is the surfel maps, the poses, the
predictions and the engine's host bookkeeping.

- `map_state_from_numpy`: a ``MapState`` flattened to numpy arrays — the
  map's fields (pos, conf, color, init_time, last_seen, normal, radius,
  count) and the state's (pose, last_delta, pred_vmap, pred_nmap, pred_rgb,
  so3_intensity) under those names — becomes the port's ``MapState``.
- `engine_snapshot` / `restore_engine`: a whole engine (every active and
  inactive model's state and record, object window included, the frame
  counter, the id and spawn counters, the last segmentation, the
  recent-spawn claims, the segmenter's carried state, what the pipelined
  schedules read: each model's surfel-count estimate and the last tracking
  verdict, and relocalisation's state: the tracking-loss bookkeeping and
  the fern database, its seeded ferns and its kept frames, in
  ``io.checkpoint``'s layout) as plain numpy and Python values.  The
  snapshot reads any engine with the JAX package's attribute names, arrays
  through ``np.asarray``, so the port can start from the JAX engine's state
  and both can then run in lockstep, in the synchronous or a pipelined
  schedule.  An engine with pipelined frames still pending is refused: its
  state is not that of any one frame until ``drain_pipeline()`` has
  finished them.
- `maskrcnn_state_dict`: the JAX package's Mask R-CNN parameter tree (flax
  names, numpy arrays: a ``model.init`` or ``checkpoint_io.load_params``
  tree) becomes the ``state_dict`` of the port's ``maskrcnn.model.MaskRCNN``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from maskfusion_tpu_torch.engine import MapState, MaskFusion, Model
from maskfusion_tpu_torch.io import checkpoint
from maskfusion_tpu_torch.mapping.surfel_map import SurfelMap
from maskfusion_tpu_torch.maskrcnn.model import flax_axes

MAP_FIELDS = SurfelMap._fields
STATE_FIELDS = tuple(f for f in MapState._fields if f != "map")
# the Model record's fields that cross over (pose_log stays behind)
MODEL_FIELDS = ("model_id", "class_id", "age", "unseen_count", "is_static",
                "initial_c2w_inv", "conf_threshold", "max_depth",
                "prev_pose", "last_bucket", "count_est", "window",
                "fused_once")
ENGINE_FIELDS = ("tick", "next_id", "spawn_offset", "lost",
                 "_last_tracking_ok", "_pipelined_active",
                 "bad_tracking_streak", "last_frame_recovery")
SEGMENTER_FIELDS = ("semantic_ignore", "_ignore_any", "label_to_model")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def map_state_from_numpy(d: Dict[str, np.ndarray], device) -> MapState:
    def t(name):
        a = np.asarray(d[name])
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        # a copy: the engine updates the map in place, and the source
        # arrays may be read-only views of another framework's buffers
        return torch.tensor(a, device=device)

    m = SurfelMap(*(t(f) for f in MAP_FIELDS[:-1]),
                  count=t("count").to(torch.int32).reshape(()))
    return MapState(m, *(t(f) for f in STATE_FIELDS))


def state_to_numpy(state) -> Dict[str, np.ndarray]:
    """A MapState of either package flattened to numpy arrays."""
    flat = {k: _np(getattr(state.map, k)) for k in MAP_FIELDS}
    flat.update({k: _np(getattr(state, k)) for k in STATE_FIELDS})
    return flat


def _model_snapshot(m) -> Dict[str, Any]:
    rec = {k: getattr(m, k) for k in MODEL_FIELDS}
    for k in ("initial_c2w_inv", "prev_pose"):
        if rec[k] is not None:
            rec[k] = _np(rec[k]).astype(np.float32)
    rec["state"] = state_to_numpy(m.state)
    return rec


def engine_snapshot(engine) -> Dict[str, Any]:
    """Everything an engine carries from frame to frame, as numpy arrays
    and Python values.  Raises ValueError while pipelined frames are
    pending."""
    if getattr(engine, "_pending", None):
        raise ValueError(
            f"{len(engine._pending)} pipelined frames are still pending: "
            "call drain_pipeline() first")
    snap = {k: getattr(engine, k) for k in ENGINE_FIELDS}
    seg = engine.last_segmentation
    snap["last_segmentation"] = None if seg is None else np.array(seg)
    snap["models"] = [_model_snapshot(m) for m in engine.models]
    snap["inactive_models"] = [_model_snapshot(m)
                               for m in engine.inactive_models]
    snap["recent_spawns"] = [(int(e), int(r), np.array(mask))
                             for e, r, mask in engine._recent_spawns]
    snap["segmenter"] = {k: getattr(engine.segmenter, k)
                         for k in SEGMENTER_FIELDS
                         if hasattr(engine.segmenter, k)}
    # the fern database in the checkpoint's layout (io/checkpoint.py)
    snap["ferns"] = None if engine.ferns is None else \
        checkpoint.fern_record(engine.ferns)
    return snap


def _model_from_snapshot(rec: Dict[str, Any], device) -> Model:
    fields = {k: rec[k] for k in MODEL_FIELDS}
    if fields["prev_pose"] is not None:
        fields["prev_pose"] = torch.tensor(fields["prev_pose"],
                                           device=device)
    return Model(state=map_state_from_numpy(rec["state"], device), **fields)


def restore_engine(engine: MaskFusion, snap: Dict[str, Any]) -> None:
    """Put `snap` (from `engine_snapshot`) into the port's `engine`, as if
    it had run the frames the snapshot's engine ran."""
    dev = engine.device
    for k in ENGINE_FIELDS:
        setattr(engine, k, snap[k])
    seg = snap["last_segmentation"]
    engine.last_segmentation = None if seg is None else np.array(seg)
    engine.models = [_model_from_snapshot(r, dev) for r in snap["models"]]
    engine.inactive_models = [_model_from_snapshot(r, dev)
                              for r in snap["inactive_models"]]
    engine._recent_spawns = [(e, r, np.array(mask))
                             for e, r, mask in snap["recent_spawns"]]
    engine._pending.clear()
    engine._seg_dev = None
    engine._np_glob_pose = None
    for k, v in snap["segmenter"].items():
        if hasattr(engine.segmenter, k):
            setattr(engine.segmenter, k,
                    v.copy() if hasattr(v, "copy") else v)
    if engine.ferns is not None and snap["ferns"] is not None:
        checkpoint.restore_ferns(engine.ferns, *snap["ferns"])
    if engine.models:
        engine._last_count = engine.models[0].surfel_count
    engine._frames_since_flush = 0


__all__ = ["map_state_from_numpy", "state_to_numpy", "engine_snapshot",
           "restore_engine", "maskrcnn_state_dict", "maskrcnn_flax_tree",
           "maskrcnn_flax_path"]


# ---------------------------------------------------------------- Mask R-CNN
def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def maskrcnn_state_dict(flax_tree, cfg) -> Dict[str, torch.Tensor]:
    """The port model's ``state_dict`` (float32 tensors; loading casts them
    to the model's dtype) from the JAX package's parameter tree.

    - flax's auto-names, in creation order: ``backbone/Conv_0`` the stem,
      ``Conv_1..4`` the lateral 1x1 convs on C5..C2, ``Conv_5..8`` the 3x3
      output convs on P2..P5; ``Bottleneck_k`` numbered across the stages
      (``Conv_0..2`` the branch, ``Conv_3`` the downsample); norms
      ``GroupNorm_i`` / ``FrozenBatchNorm_i`` likewise;
    - conv kernels (kh, kw, in, out) -> (out, in, kh, kw); Dense kernels
      (in, out) -> (out, in); ``fc1``'s rows are the ROI flattened in
      (h, w, c) order, which the port's box head flattens alike;
    - the transposed conv (kh, kw, in, out) -> (in, out, kh, kw), flipped
      in both spatial axes: flax's (transpose_kernel=False) puts tap 1 of
      each axis on the even outputs, F.conv_transpose2d tap 0.
    """
    tree = flax_tree.get("params", flax_tree)
    norm = "FrozenBatchNorm" if cfg.norm == "frozen_bn" else "GroupNorm"
    lateral = {f"Conv_{i + 1}": f"lateral.{i}" for i in range(4)}
    output = {f"Conv_{i + 5}": f"output.{i}" for i in range(4)}
    block_convs = {"Conv_0": "conv1", "Conv_1": "conv2", "Conv_2": "conv3",
                   "Conv_3": "down"}
    block_norms = {f"{norm}_0": "norm1", f"{norm}_1": "norm2",
                   f"{norm}_2": "norm3", f"{norm}_3": "down_norm"}

    def module(path):
        head, rest = path[0], path[1:]
        if head == "backbone":
            if rest[0] == "Conv_0":
                return "backbone.stem"
            if rest[0] == f"{norm}_0":
                return "backbone.stem_norm"
            if rest[0] in lateral:
                return "backbone." + lateral[rest[0]]
            if rest[0] in output:
                return "backbone." + output[rest[0]]
            if rest[0].startswith("Bottleneck_"):
                k = rest[0].split("_")[1]
                sub = block_convs.get(rest[1]) or block_norms[rest[1]]
                return f"backbone.blocks.{k}.{sub}"
        if head == "rpn":
            return "rpn." + rest[0][len("rpn_"):]
        if head == "box_head":
            if rest[0].startswith(norm):
                return f"box_head.norm{int(rest[0].split('_')[1]) + 1}"
            return "box_head." + rest[0]
        if head == "mask_head":
            if rest[0].startswith(norm):
                return f"mask_head.norms.{rest[0].split('_')[1]}"
            if rest[0].startswith("conv"):
                return f"mask_head.convs.{int(rest[0][4:]) - 1}"
            return "mask_head." + rest[0]
        raise KeyError("/".join(path))

    out = {}
    for key, v in _flat(tree).items():
        path = key.split("/")
        name, leaf = module(path[:-1]), path[-1]
        if leaf == "kernel":
            leaf = "weight"
            if path[-2] == "deconv":
                v = v[::-1, ::-1]
            v = v.transpose(flax_axes(f"{name}.weight", v.ndim))
        out[f"{name}.{leaf}"] = torch.from_numpy(np.array(v, order="C"))
    return out


def maskrcnn_flax_path(key: str, cfg) -> list:
    """The JAX package's parameter-tree path (under ``params``) of the
    port model's ``state_dict`` entry ``key``: flax module names, then the
    leaf (``kernel`` for a weight)."""
    norm = "FrozenBatchNorm" if cfg.norm == "frozen_bn" else "GroupNorm"
    block = {"conv1": "Conv_0", "conv2": "Conv_1", "conv3": "Conv_2",
             "down": "Conv_3", "norm1": f"{norm}_0", "norm2": f"{norm}_1",
             "norm3": f"{norm}_2", "down_norm": f"{norm}_3"}
    name, leaf = key.rsplit(".", 1)
    leaf = "kernel" if leaf == "weight" else leaf
    head, *rest = name.split(".")
    if head == "backbone":
        if rest[0] == "stem":
            return [head, "Conv_0", leaf]
        if rest[0] == "stem_norm":
            return [head, f"{norm}_0", leaf]
        if rest[0] == "lateral":
            return [head, f"Conv_{int(rest[1]) + 1}", leaf]
        if rest[0] == "output":
            return [head, f"Conv_{int(rest[1]) + 5}", leaf]
        if rest[0] == "blocks":
            return [head, f"Bottleneck_{rest[1]}", block[rest[2]], leaf]
    if head == "rpn":
        return [head, "rpn_" + rest[0], leaf]
    if head == "box_head" and rest[0].startswith("norm"):
        return [head, f"{norm}_{int(rest[0][4:]) - 1}", leaf]
    if head == "mask_head" and rest[0] == "norms":
        return [head, f"{norm}_{rest[1]}", leaf]
    if head == "mask_head" and rest[0] == "convs":
        return [head, f"conv{int(rest[1]) + 1}", leaf]
    if head in ("box_head", "mask_head"):
        return [head, rest[0], leaf]
    raise KeyError(key)


def maskrcnn_flax_tree(state_dict, cfg) -> dict:
    """The JAX package's parameter tree ``{"params": {...}}`` of numpy
    float32 arrays from the port model's ``state_dict``: the inverse of
    ``maskrcnn_state_dict``, exact both ways (transposes and flips only).
    What ``checkpoint_io.save_params`` writes and the JAX package's
    ``checkpoint_io.load_params`` and ``MaskRCNN.apply`` read.  A sharded
    network's state_dict is gathered first
    (``parallel.train.full_state_dict``)."""
    tree: dict = {}
    for key, t in state_dict.items():
        v = t.detach().to("cpu", torch.float32).numpy()
        *p, leaf = maskrcnn_flax_path(key, cfg)
        if leaf == "kernel":
            v = v.transpose(np.argsort(flax_axes(key, v.ndim)))
            if p[-1] == "deconv":
                v = v[::-1, ::-1]
        node = tree
        for part in p:
            node = node.setdefault(part, {})
        node[leaf] = np.array(v, np.float32, order="C")
    return {"params": tree}
