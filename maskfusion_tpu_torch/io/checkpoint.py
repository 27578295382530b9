"""Mid-run state checkpointing / resume.

Port of ``maskfusion_tpu/io/checkpoint.py``, in the same on-disk layout, so
that a checkpoint written by either package resumes in the other: a
directory holding one ``savez_compressed`` file per model
(``model<i>.npz``, ``inactive<i>.npz``: the map's fields at full capacity
and the state's poses and predictions), ``ferns.npz`` (the fern database's
kept frames), ``last_seg.npy`` and ``meta.json`` (counters, lifecycle
bookkeeping, each model's record and pose log, the segmenter's label map,
the seeded ferns).  The reference has no checkpointing (SURVEY.md §5.4).

`save` does not drain the pipelined schedules first, as the JAX package's
does not: the models' states hold every dispatched frame's device work,
but frames whose host stage is still pending (at most ``pipeline_depth``)
never get their segmentation, lifecycle step or pose-log entry, in the
saved run or in a resumed one (ROADMAP fault 8).
"""

from __future__ import annotations

import json
import os
from typing import TYPE_CHECKING

import numpy as np
import torch

if TYPE_CHECKING:
    from maskfusion_tpu_torch.engine import MaskFusion


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def save(engine: "MaskFusion", path: str) -> None:
    """Write engine state to `path` (a directory)."""
    os.makedirs(path, exist_ok=True)
    meta = {
        "tick": engine.tick,
        "next_id": engine.next_id,
        "spawn_offset": engine.spawn_offset,
        "lost": engine.lost,
        "last_count": engine._last_count,
        "bad_tracking_streak": engine.bad_tracking_streak,
        "last_frame_recovery": engine.last_frame_recovery,
        "models": [],
        "inactive_models": [],
    }
    seg = engine.segmenter
    if seg is not None and hasattr(seg, "label_to_model"):
        meta["label_to_model"] = {
            str(k): v for k, v in seg.label_to_model.items()}

    def dump_model(model, name):
        st = model.state
        np.savez_compressed(
            os.path.join(path, f"{name}.npz"),
            pos=_np(st.map.pos), conf=_np(st.map.conf),
            color=_np(st.map.color), init_time=_np(st.map.init_time),
            last_seen=_np(st.map.last_seen), normal=_np(st.map.normal),
            radius=_np(st.map.radius), count=_np(st.map.count),
            pose=_np(st.pose), last_delta=_np(st.last_delta),
            pred_vmap=_np(st.pred_vmap), pred_nmap=_np(st.pred_nmap),
            pred_rgb=_np(st.pred_rgb), so3_intensity=_np(st.so3_intensity),
        )
        return {
            "name": name,
            "model_id": model.model_id,
            "class_id": model.class_id,
            "age": model.age,
            "unseen_count": model.unseen_count,
            "is_static": model.is_static,
            "conf_threshold": model.conf_threshold,
            "max_depth": model.max_depth,
            "initial_c2w_inv": (np.asarray(model.initial_c2w_inv).tolist()
                                if model.initial_c2w_inv is not None
                                else None),
            "pose_log": [
                {"timestamp": e["timestamp"], "tick": e["tick"],
                 "pose": _np(e["pose"]).tolist()}
                for e in model.pose_log
            ],
        }

    for i, model in enumerate(engine.models):
        meta["models"].append(dump_model(model, f"model{i}"))
    for i, model in enumerate(engine.inactive_models):
        meta["inactive_models"].append(dump_model(model, f"inactive{i}"))

    if engine.ferns is not None:
        meta["ferns"], arrays = fern_record(engine.ferns)
        if arrays is not None:
            np.savez_compressed(os.path.join(path, "ferns.npz"), **arrays)
    if engine.last_segmentation is not None:
        np.save(os.path.join(path, "last_seg.npy"), engine.last_segmentation)

    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def load(engine: "MaskFusion", path: str) -> "MaskFusion":
    """Restore engine state saved by `save` (of either package) into a
    freshly built engine with the same Config and resolution; the arrays go
    to the engine's device."""
    from maskfusion_tpu_torch.engine import MapState, Model
    from maskfusion_tpu_torch.mapping.surfel_map import SurfelMap

    dev = engine.device
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)

    def load_model(md):
        z = np.load(os.path.join(path, f"{md['name']}.npz"))

        def t(name, dtype=None):
            return torch.tensor(z[name] if dtype is None
                                else z[name].astype(dtype), device=dev)

        state = MapState(
            map=SurfelMap(
                pos=t("pos"), conf=t("conf"), color=t("color"),
                init_time=t("init_time"), last_seen=t("last_seen"),
                normal=t("normal"), radius=t("radius"),
                count=t("count", np.int32).reshape(()),
            ),
            pose=t("pose"), last_delta=t("last_delta"),
            pred_vmap=t("pred_vmap"), pred_nmap=t("pred_nmap"),
            pred_rgb=t("pred_rgb"), so3_intensity=t("so3_intensity"),
        )
        model = Model(
            model_id=md["model_id"], state=state, class_id=md["class_id"],
            age=md["age"], unseen_count=md["unseen_count"],
            is_static=md["is_static"],
            conf_threshold=md["conf_threshold"], max_depth=md["max_depth"],
            initial_c2w_inv=(np.array(md["initial_c2w_inv"], np.float32)
                             if md["initial_c2w_inv"] else None),
        )
        # fused_once is not saved, so a resumed object model's next fuse
        # weighs 100 again, as in the JAX package (ROADMAP fault 14)
        model.pose_log = [
            {"timestamp": e["timestamp"], "tick": e["tick"],
             "pose": torch.tensor(np.array(e["pose"], np.float32),
                                  device=dev)}
            for e in md["pose_log"]
        ]
        model.prev_pose = state.pose.clone()
        return model

    engine.models = [load_model(md) for md in meta["models"]]
    engine.inactive_models = [load_model(md) for md in meta["inactive_models"]]
    engine.tick = meta["tick"]
    engine.next_id = meta["next_id"]
    engine.spawn_offset = meta["spawn_offset"]
    engine.lost = meta["lost"]
    engine._last_count = meta["last_count"]
    engine.bad_tracking_streak = meta.get("bad_tracking_streak", 0)
    engine.last_frame_recovery = meta.get("last_frame_recovery", False)
    if (engine.segmenter is not None
            and hasattr(engine.segmenter, "label_to_model")
            and "label_to_model" in meta):
        engine.segmenter.label_to_model = {
            int(k): v for k, v in meta["label_to_model"].items()}

    if engine.ferns is not None and "ferns" in meta:
        fm = meta["ferns"]
        restore_ferns(engine.ferns, fm, np.load(os.path.join(
            path, "ferns.npz")) if fm["n_frames"] else None)
    seg_path = os.path.join(path, "last_seg.npy")
    if os.path.exists(seg_path):
        engine.last_segmentation = np.load(seg_path)
    return engine


def fern_record(ferns):
    """The fern database (of either package) in the checkpoint's layout:
    (`meta`, the seeded ferns and the number of kept frames, for
    meta.json; `arrays`, the kept frames stacked, for ferns.npz, or None
    when no frame is kept).  `last_closest` is not kept: every search
    resets it."""
    frames = ferns.frames
    meta = {
        "n_frames": len(frames),
        "pos_x": np.asarray(ferns.pos_x).tolist(),
        "pos_y": np.asarray(ferns.pos_y).tolist(),
        "thresh_rgb": np.asarray(ferns.thresh_rgb).tolist(),
        "thresh_d": np.asarray(ferns.thresh_d).tolist(),
    }
    arrays = None if not frames else dict(
        poses=np.stack([f.pose for f in frames]),
        src_times=np.array([f.src_time for f in frames]),
        codes=np.stack([f.codes for f in frames]),
        good_codes=np.array([f.good_codes for f in frames]),
        rgbs=np.stack([f.rgb for f in frames]),
        verts=np.stack([f.verts for f in frames]),
        norms=np.stack([f.norms for f in frames]),
    )
    return meta, arrays


def restore_ferns(ferns, meta, arrays) -> None:
    """Put a `fern_record` (`arrays` None when no frame is kept) into the
    port's `ferns`."""
    from maskfusion_tpu_torch.reloc.ferns import FernFrame

    ferns.pos_x = np.array(meta["pos_x"])
    ferns.pos_y = np.array(meta["pos_y"])
    ferns.thresh_rgb = np.array(meta["thresh_rgb"])
    ferns.thresh_d = np.array(meta["thresh_d"])
    ferns.last_closest = -1
    ferns.frames = []
    for i in range(meta["n_frames"]):
        ferns.frames.append(FernFrame(
            frame_id=i, pose=np.array(arrays["poses"][i]),
            src_time=int(arrays["src_times"][i]),
            codes=np.array(arrays["codes"][i]),
            good_codes=int(arrays["good_codes"][i]),
            rgb=np.array(arrays["rgbs"][i]),
            verts=np.array(arrays["verts"][i]),
            norms=np.array(arrays["norms"][i]),
        ))
