"""The SLAM driver: MaskFusion at VGA on the two-object scene.

Set-up builds the engine from the configuration's file, renders the scene's
loop on the card from the seed and copies it to the host (where a sensor's
frames arrive), and warms up.  The window then feeds the loop played forward
and back in a closed loop, each frame's upload staged while the previous one
runs, until ``seconds`` have passed; it ends once the engine has drained and
the card has synchronised.  ``slam_fps`` counts every frame of the window
over all of its time.

What decides ``correct`` (the limits are the workload file's): on frames
drawn from the seed, each stage of the frame against the plain reference,
fed that stage's inputs as the program held them.  The device stage
(``mfbench.reference.slam``): the preprocessed depth and vertex maps
(``prep_gap_mm``) and normals (``prep_normal_gap``) from the raw frame,
pixels whose validity differs (``prep_flips``), the edge strength
(``edge_gap``) and non-edge binary (``edge_flips``) on the program's maps,
the tracks from the models' predictions before the frame (the global
one as the displacement of the image corners at 2 m, ``track_gap_mm``;
the objects' batched, windowed one as the displacement of each object's
own predicted surface, ``obj_surface_gap_mm``, the worst slot), and the
(depth, id) projection of the models' maps at
the new poses (``ids_flips``).  The fuse stage (``reference.fusion``) from
each model's map before the frame: the map after it (``map_count_diff``,
``map_gap_mm``, ``map_attr_gap``) and its predictions, the level-0 scan
kernel's work (``pred_px_off``, ``pred_flips``).
The host segmentation (``reference.segmentation``) from its inputs: the
per-pixel model ids (``seg_px_diff``).
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from mfbench import harness
from mfbench.traffic import scenes

CHECK_DEPTH_M = 2.0


def engine_config(config: Dict):
    """The program's Config with every field the configuration's file
    states."""
    from maskfusion_tpu_torch.config import Config

    names = {f.name for f in dataclasses.fields(Config)}
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in config["engine"].items() if k in names}
    return Config(**kw)


def make_engine(config: Dict, intr, device):
    from maskfusion_tpu_torch.camera import CameraIntrinsics, Resolution
    from maskfusion_tpu_torch.engine import MaskFusion

    W, H = config["resolution"]
    return MaskFusion(Resolution(W, H), CameraIntrinsics(*intr),
                      engine_config(config), device=device)


def state_of(st) -> Dict[str, torch.Tensor]:
    """Clones of what a model's track reads from its state."""
    return {"pose": st.pose.clone(), "pred_vmap": st.pred_vmap.clone(),
            "pred_nmap": st.pred_nmap.clone(),
            "pred_rgb": st.pred_rgb.clone(),
            "so3": st.so3_intensity.clone()}


def map_prefix(m, bucket: int):
    """A clone of a model map's first ``bucket`` slots, as the reference's
    map."""
    from mfbench.reference import surfel_map as rsm

    n = min(int(bucket), m.pos.shape[0])
    return rsm.SurfelMap(*(a[:n].clone() for a in m[:7]),
                         count=m.count.clone())


class Capture:
    """Keeps, for the ticks drawn for the check, what each stage of the
    frame took and what it produced: the device stage (the models' poses,
    predictions and map prefixes before the frame, the staged
    segmentation; the preprocessed frame, the poses, the id projection, the
    edge strength and non-edge binary), the fuse stage that follows it
    (its inputs; each model's map prefix and predictions after it) and the
    frame's host segmentation (its inputs and the model-id image).
    References to fresh tensors, and clones of what the next frames may
    update."""

    def __init__(self, engine, ticks: Dict[int, int]):
        from maskfusion_tpu_torch.engine import DEAD_SLOT_ID as DEAD

        self.ticks: set = set()
        self.frame_of = ticks              # tick -> the traffic's frame k
        self.got: Dict[int, dict] = {}
        stage = engine.pipelined_device_stage
        fuse_stage = engine.fuse_stage
        segmenter = engine.segmenter
        edge_binary = segmenter.edge_binary
        perform = segmenter.perform
        self._current: Optional[dict] = None

        def device_stage(glob_state, obj_states, obj_aux, rgb, depth,
                         prev_seg, time_, glob_bucket, obj_bucket,
                         windowed=False):
            tick = engine.tick
            if tick not in self.ticks:
                return stage(glob_state, obj_states, obj_aux, rgb, depth,
                             prev_seg, time_, glob_bucket, obj_bucket,
                             windowed)
            rec = dict(state_of(glob_state), prev_seg=prev_seg.clone())
            live = [i for i, row in enumerate(obj_aux) if row[0] < DEAD]
            rec["objects"] = [state_of(obj_states[i]) for i in live]
            rec["mask_ids"] = [int(obj_aux[i][0]) for i in live]
            rec["windows"] = [(int(obj_aux[i][1]), int(obj_aux[i][2]))
                              for i in live]
            rec["windowed"] = bool(windowed)
            rec["time"] = float(time_)
            rec["buckets"] = (int(glob_bucket), int(obj_bucket))
            rec["maps"] = ([map_prefix(glob_state.map, glob_bucket)]
                           + [map_prefix(obj_states[i].map, obj_bucket)
                              for i in live])
            self._current = rec
            out = stage(glob_state, obj_states, obj_aux, rgb, depth,
                        prev_seg, time_, glob_bucket, obj_bucket, windowed)
            self._current = None
            rec.update(prep=out[0], gpose=out[1], ids=out[4], nonedge=out[5],
                       oposes=[out[2][i] for i in range(len(live))])
            self.got[tick] = rec
            return out

        def edge(vmap, nmap):
            e, ne = edge_binary(vmap, nmap)
            if self._current is not None:
                self._current["edge"] = e
            return e, ne

        def fuse(glob_state, obj_states, prep, rgb, seg_mask, prev_poses,
                 time_, obj_params, **kw):
            rec = self.got.get(engine.tick)
            if rec is None or "fuse" in rec:
                return fuse_stage(glob_state, obj_states, prep, rgb,
                                  seg_mask, prev_poses, time_, obj_params,
                                  **kw)
            n = len(rec["mask_ids"])
            inputs = [{"pose": st.pose.clone(),
                       "last_delta": st.last_delta.clone(),
                       "pred_vmap": st.pred_vmap.clone(),
                       "pred_nmap": st.pred_nmap.clone()}
                      for st in [glob_state] + list(obj_states[:n])]
            new_glob, new_objs = fuse_stage(
                glob_state, obj_states, prep, rgb, seg_mask, prev_poses,
                time_, obj_params, **kw)
            gb, ob = kw["glob_bucket"], kw["obj_bucket"]
            after = [(map_prefix(st.map, b), st.pred_vmap, st.pred_nmap)
                     for st, b in [(new_glob, gb)]
                     + [(st, ob) for st in new_objs[:n]]]
            rec["fuse"] = dict(
                inputs=inputs, rgb=rgb, seg_mask=seg_mask, time=float(time_),
                rows=[list(map(float, r)) for r in obj_params[:n]],
                gate=kw.get("gate"), ids_guard=kw.get("ids_guard"),
                parity=kw.get("parity"), windowed=bool(kw.get("windowed")),
                buckets=(int(gb), int(ob)), after=after)
            return new_glob, new_objs

        def segment(frame, vmap, nmap, ids, infos, next_id, allow_new,
                    **kw):
            k = int(round(frame.timestamp)) - 1
            tick = next((t for t in self.got if self.frame_of.get(t) == k),
                        None)
            if tick is None or "seg" in self.got[tick]:
                return perform(frame, vmap, nmap, ids, infos, next_id,
                               allow_new, **kw)
            state = {"semantic_ignore": segmenter.semantic_ignore.copy(),
                     "ignore_any": segmenter._ignore_any}
            res = perform(frame, vmap, nmap, ids, infos, next_id, allow_new,
                          **kw)
            nonedge = kw.get("nonedge")
            if isinstance(nonedge, torch.Tensor):
                nonedge = nonedge.cpu().numpy()
            self.got[tick]["seg"] = dict(
                ids=np.array(ids, copy=True),
                models=[(m.model_id, m.class_id) for m in infos],
                next_id=int(next_id), allow_new=bool(allow_new),
                nonedge=np.array(nonedge, copy=True), state=state,
                out=np.array(res.full_segmentation, copy=True))
            return res

        engine.pipelined_device_stage = device_stage
        engine.fuse_stage = fuse
        segmenter.edge_binary = edge
        segmenter.perform = segment


def corners(W: int, H: int, intr, depth: float) -> torch.Tensor:
    fx, fy, cx, cy = intr
    pts = [[(u - cx) / fx * depth, (v - cy) / fy * depth, depth]
           for u, v in ((0, 0), (W - 1, 0), (0, H - 1), (W - 1, H - 1))]
    return torch.tensor(pts, dtype=torch.float64)


def surface(vmap: torch.Tensor) -> torch.Tensor:
    """The finite points of an (H, W, 3) vertex map, (N, 3) float64."""
    v = vmap.reshape(-1, 3)
    return v[torch.isfinite(v).all(-1)].to(torch.float64).cpu()


def point_gap_mm(Ta: torch.Tensor, Tb: torch.Tensor, pts) -> float:
    """The largest distance between the points moved by Ta and by Tb (0
    for no points)."""
    if len(pts) == 0:
        return 0.0
    Ta, Tb = Ta.to(torch.float64).cpu(), Tb.to(torch.float64).cpu()
    pa = pts @ Ta[:3, :3].T + Ta[:3, 3]
    pb = pts @ Tb[:3, :3].T + Tb[:3, 3]
    return float(torch.linalg.vector_norm(pa - pb, dim=-1).max()) * 1e3


class SlamTraffic:
    """The cell's frames: the scene's loop rendered on the card, on the
    host, with the ground truth of each."""

    def __init__(self, workload: Dict, config: Dict, seed: int, device):
        t = workload["traffic"]
        W, H = config["resolution"]
        self.scene = scenes.TwoObjectScene(W, H, t["loop_frames"],
                                           tuple(t["phases"]), device,
                                           t["camera_span"])
        # the seed picks where in the loop played forward and back the
        # stream starts: every seed sees the same frames, in another order
        period = 2 * (t["loop_frames"] - 1)
        self.start = int(np.random.default_rng(seed).integers(0, period))
        self.frames = []
        from maskfusion_tpu_torch.frame import FrameData

        for i in range(t["loop_frames"]):
            rgb, depth, lab = self.scene.render(i)
            depth_mm = torch.round(depth * 1000.0).to(torch.int32)
            self.frames.append(FrameData(
                rgb=rgb.cpu().numpy(),
                depth=depth_mm.cpu().numpy().astype(np.uint16),
                mask=lab.cpu().numpy(),
                class_ids=list(scenes.TwoObjectScene.CLASS_IDS)))
        self.loop = t["loop_frames"]
        self.intr = self.scene.intrinsics()

    def index(self, k: int) -> int:
        return scenes.ping_pong_index(self.start + k, self.loop)

    def frame(self, k: int):
        return dataclasses.replace(self.frames[self.index(k)],
                                   timestamp=float(k + 1))


def engine_counters(engine, spans: harness.Spans):
    """Snapshots the engine's forced waits and its stopwatch's ``odom`` and
    ``segmentation`` scopes; the returned function, called when the window
    closes, records what they counted since as the window's counters."""
    sw = engine.stopwatch
    scopes = ("odom", "segmentation")
    before = {s: (sw.timings_ms.get(s, 0.0), sw.counts.get(s, 0))
              for s in scopes}
    waits0 = engine.forced_waits

    def counted():
        spans.counters["forced_waits"] = engine.forced_waits - waits0
        for s, (ms, c) in before.items():
            spans.counters[f"stopwatch.{s}.ms"] = \
                sw.timings_ms.get(s, 0.0) - ms
            spans.counters[f"stopwatch.{s}.n"] = sw.counts.get(s, 0) - c

    return counted


def window(engine, traffic, k0: int, seconds: float, spans: harness.Spans,
           ticks: Dict[int, int]):
    """The closed loop: frames k0, k0+1, ... until ``seconds`` have passed,
    each upload staged one frame ahead; returns (frames, seconds, next k)."""
    counted = engine_counters(engine, spans)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    k = k0
    staged = engine.upload_frame(traffic.frame(k))
    n = 0
    last = t0
    while True:
        nxt = engine.upload_frame(traffic.frame(k + 1))
        ticks[engine.tick + 1] = k
        engine.process_frame(staged)
        now = time.perf_counter()
        spans.span("frame", last, now)
        last = now
        n += 1
        k += 1
        staged = nxt
        if now >= deadline:
            break
    engine.flush_diagnostics()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    t1 = time.perf_counter()
    counted()
    return n, t1 - t0, k


def print_models(engine, spans: harness.Spans) -> None:
    """One line on standard error: the models at the window's end (their
    number, then each with its class and surfel bucket), the frames fused in windows, and the
    mean frame time of the window's two halves."""
    ms = [(b - a) * 1e3 for a, b in spans.spans.get("frame", [])]
    h = len(ms) // 2
    halves = (sum(ms[:h]) / max(h, 1), sum(ms[h:]) / max(len(ms) - h, 1))
    print(f"models: {len(engine.models)}: " + ", ".join(
        f"{m.model_id}:{m.class_id}:{m.last_bucket}" for m in engine.models)
        + f"; windowed fuses {engine.windowed_fuses}; frame ms by half "
        f"{halves[0]:.1f} {halves[1]:.1f}", file=sys.stderr)


def traced_frames(engine, traffic, k: int, n: int, ticks) -> dict:
    """The traced sub-window: ``pipeline_depth`` untraced frames fill the
    pipeline, then ``n`` frames run under the profiler with no drain (the
    steady state: each call finishes earlier frames' host stages), then the
    engine drains."""
    for _ in range(max(1, engine.cfg.pipeline_depth)):
        ticks[engine.tick + 1] = k
        engine.process_frame(engine.upload_frame(traffic.frame(k)))
        k += 1
    frames = [engine.upload_frame(traffic.frame(k + j)) for j in range(n)]
    for j in range(n):
        ticks[engine.tick + 1 + j] = k + j

    def run():
        for f in frames:
            engine.process_frame(f)

    prof = harness.traced(run, n, engine.device)
    engine.flush_diagnostics()
    return prof


# ------------------------------------------------------------------ checks
STAGE_KEYS = ("prep_gap_mm", "prep_normal_gap", "prep_flips", "edge_gap",
              "edge_flips", "track_gap_mm", "ids_flips", "map_count_diff",
              "map_gap_mm", "map_attr_gap", "pred_px_off", "pred_flips",
              "seg_px_diff")


def stage_checks(cap: Capture, traffic, ticks, config,
                 control: bool = False) -> Dict:
    """Each stage's outputs on the captured ticks against the plain
    reference, fed the stage's inputs.  With ``control`` the reference in
    the next precision below the configuration's float32 with TF32 off
    takes the program's place: its matmuls in TF32, its stages outside
    matmuls (and the maps they read) rounded through bfloat16."""
    from mfbench.reference import slam as ref
    from mfbench.reference.camera import CameraIntrinsics

    cfg = config["engine"]
    intr = CameraIntrinsics(*traffic.intr)
    W, H = config["resolution"]
    pts = corners(W, H, traffic.intr, CHECK_DEPTH_M)
    out = {k: 0.0 for k in STAGE_KEYS}
    slots = []      # (tick, slot, surface gap mm, corner gap mm, condition)
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    for tick, rec in sorted(cap.got.items()):
        f = traffic.frames[traffic.index(ticks[tick])]
        dev = rec["pose"].device
        rgb = torch.from_numpy(f.rgb).to(dev)
        depth_mm = torch.from_numpy(f.depth.astype(np.int32)).to(dev)

        def reference(low: bool):
            torch.backends.cuda.matmul.allow_tf32 = low
            torch.backends.cudnn.allow_tf32 = low
            bf16 = torch.bfloat16 if low else None
            try:
                prep = ref.preprocess(rgb, depth_mm, cfg, intr,
                                      rec["prev_seg"], bf16)
                lv0 = (prep["levels"][0] if low
                       else rec["prep"].levels[0])
                edge, nonedge = ref.edge_map(lv0["vmap"], lv0["nmap"], cfg,
                                             bf16)
                gpose, gate = ref.track(rec["pose"], rec["pred_vmap"],
                                        rec["pred_nmap"], rec["pred_rgb"],
                                        rec["so3"], prep["frame_pyr"], cfg,
                                        intr)
                poses = [gpose]
                systems = None
                if rec["objects"]:
                    op, systems = ref.track_objects(
                        rec["objects"], rec["mask_ids"], rec["windows"],
                        rec["windowed"], prep["frame_pyr"], cfg, intr, H, W)
                    poses += list(op)
                mapping = mapping_reference(rec, f, cfg, intr, H, W, gate,
                                            bf16, nonedge if low else None)
            finally:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = saved
            return dict(mapping, filt=prep["filt"], levels=prep["levels"],
                        edge=edge, nonedge=nonedge, poses=poses,
                        systems=systems)

        want = reference(False)
        if control:
            got = reference(True)
        else:
            p = rec["prep"]
            got = dict(program_mapping(rec), filt=p.filt_depth,
                       levels=p.levels, edge=rec["edge"],
                       nonedge=rec["nonedge"],
                       poses=[rec["gpose"]] + list(rec["oposes"]))
        gaps_ = dict(map_gaps(got, want), **mapping_gaps(got, want))
        for k_, v in gaps_.items():
            out[k_] = max(out[k_], v)
        gaps = [point_gap_mm(a, b, pts)
                for a, b in zip(got["poses"], want["poses"])]
        out["track_gap_mm"] = max(out["track_gap_mm"], gaps[0])
        # an object's pose moves that object alone: its gap is taken on
        # the object's own surface as predicted before the frame; the
        # corners' gap and the solve's condition number are printed beside
        for j, g in enumerate(gaps[1:]):
            sg = point_gap_mm(got["poses"][1 + j], want["poses"][1 + j],
                              surface(rec["objects"][j]["pred_vmap"]))
            slots.append((tick, j, sg, g, condition(want["systems"][j])))
    out["obj_surface_gap_mm"] = max((s for _, _, s, _, _ in slots),
                                    default=0.0)
    print(f"track gaps mm: global {out['track_gap_mm']!r}; objects "
          "(tick, slot, surface gap mm, corner gap mm, condition): "
          + ", ".join(f"({t}, {j}, {s:.6g}, {g:.6g}, {c:.4g})"
                      for t, j, s, g, c in slots), file=sys.stderr)
    return out


def condition(A: torch.Tensor) -> float:
    """The condition number of a 6x6 Gauss-Newton system."""
    ev = torch.linalg.eigvalsh(A.to(torch.float64).cpu())
    return float(ev[-1] / ev[0]) if float(ev[0]) > 0 else float("inf")


def _rounded_map(m, low):
    from mfbench.reference import surfel_map as rsm

    if low is None:
        return m
    return rsm.SurfelMap(*(a.to(low).to(a.dtype) for a in m[:7]),
                         count=m.count)


def mapping_reference(rec: dict, frame, cfg: Dict, intr, H: int, W: int,
                      gate, low=None, nonedge=None) -> Dict:
    """The reference's id projection, fuse stage and host segmentation on
    the captured inputs of the program's stages, the fuse gated by the
    reference's own tracking-ok ``gate`` where the program's was gated;
    with ``low`` (the control) the maps and frame it reads are rounded
    through that dtype, and its segmentation takes the control's own
    ``nonedge``."""
    from mfbench.reference import fusion, segmentation
    from mfbench.reference import slam as ref

    q = (lambda x: x) if low is None else (
        lambda x: x.to(low).to(x.dtype))
    maps = [_rounded_map(m, low) for m in rec["maps"]]
    gb, ob = rec["buckets"]
    OW = ref.window_size(cfg, H, W)
    depths = [fusion.project_depth(cfg, maps[0], rec["gpose"], rec["time"],
                                   gb, intr, H, W)]
    for j, (oy, ox) in enumerate(rec["windows"]):
        depths.append(fusion.project_depth(
            cfg, maps[1 + j], rec["oposes"][j], rec["time"], ob, intr, H, W,
            (oy, ox, OW) if rec["windowed"] else None))
    out = {"ids": fusion.combine_ids(depths, [0] + rec["mask_ids"])}
    F = rec.get("fuse")
    if F is not None:
        p = rec["prep"]
        lv0 = p.levels[0]
        fr = {"vmap_raw": q(p.vmap_raw), "vmap": q(lv0["vmap"]),
              "nmap": q(lv0["nmap"]), "filt": q(p.filt_depth),
              "rgb": F["rgb"], "intr": intr}
        seg = F["seg_mask"]
        if F["ids_guard"] is not None:
            seg = fusion.guarded(seg, F["ids_guard"])
        gb, ob = F["buckets"]
        if F["gate"] is None:
            gate = None
        elif bool(gate) != bool(F["gate"]):
            print(f"fuse gate: the program's {bool(F['gate'])}, the "
                  f"reference's {bool(gate)}", file=sys.stderr)
        after = [fusion.fuse_global(cfg, dict(F["inputs"][0], map=maps[0]),
                                    fr, seg, F["time"], gb, F["parity"],
                                    gate)]
        for j, row in enumerate(F["rows"]):
            after.append(fusion.fuse_object(
                cfg, dict(F["inputs"][1 + j], map=maps[1 + j]), fr, seg,
                F["time"], row, ob, F["parity"], F["windowed"], OW, gate))
        out["after"] = [(a["map"], a["pred_vmap"], a["pred_nmap"])
                        for a in after]
    S = rec.get("seg")
    if S is not None:
        if nonedge is None:
            nonedge = S["nonedge"]
        elif isinstance(nonedge, torch.Tensor):
            nonedge = nonedge.cpu().numpy()
        depth = frame.depth.astype(np.float32) * np.float32(1e-3)
        mask = (frame.mask if frame.mask is not None
                else np.zeros((H, W), np.uint8))
        res = segmentation.perform(
            cfg, mask, frame.class_ids or [], depth, nonedge, S["ids"],
            S["models"], S["next_id"], S["allow_new"],
            {k: (v.copy() if hasattr(v, "copy") else v)
             for k, v in S["state"].items()})
        out["seg"] = res.full_segmentation
    return out


def program_mapping(rec: dict) -> Dict:
    out = {"ids": rec["ids"]}
    if "fuse" in rec:
        out["after"] = rec["fuse"]["after"]
    if "seg" in rec:
        out["seg"] = rec["seg"]["out"]
    return out


def _finite_gap(a: torch.Tensor, b: torch.Tensor):
    """(largest gap where both are finite, elements finite on one side
    only)."""
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    both = fa & fb
    gap = float((a - b).abs()[both].max()) if bool(both.any()) else 0.0
    return gap, int((fa != fb).sum())


MAP_ATTRS = ("conf", "color", "init_time", "last_seen", "normal", "radius")
PRED_OFF_M, PRED_OFF_NORMAL = 1e-3, 1e-2


def pixels_off(va, vb, na, nb) -> int:
    """Pixels predicted on both sides whose vertex lies more than 1 mm or
    whose normal more than 0.01 from the reference's.  A ray that grazes a
    surfel's rim may hit it on one side and miss it on the other under
    rounding, and then sees another surface: a few such pixels are
    rounding, a wrong scan moves them all."""
    both = torch.isfinite(va).all(-1) & torch.isfinite(vb).all(-1)
    off = (((va - vb).abs().amax(-1) > PRED_OFF_M)
           | ((na - nb).abs().amax(-1) > PRED_OFF_NORMAL))
    return int((off & both).sum())


def mapping_gaps(got: Dict, want: Dict) -> Dict[str, float]:
    """The id projection's differing pixels; each model's map after the
    fuse stage (the surfel counts' difference, the positions' largest gap
    in mm, the other fields' largest gap against the field's largest
    magnitude) and its predictions (``pixels_off``, and the pixels
    predicted on one side only), summed over the models; the
    segmentation's differing pixels.
    A stage the program did not run reads infinite."""
    inf = float("inf")
    out = {"ids_flips": float(int((got["ids"].to(want["ids"].device)
                                   != want["ids"]).sum()))}
    if "after" not in got or len(got["after"]) != len(want["after"]):
        out.update(map_count_diff=inf, map_gap_mm=inf, map_attr_gap=inf,
                   pred_px_off=inf, pred_flips=inf)
    else:
        cd = pos = attr = off = flips = 0.0
        for (ma, va, na), (mb, vb, nb) in zip(got["after"], want["after"]):
            ca, cb = int(ma.count), int(mb.count)
            cd = max(cd, abs(ca - cb))
            n = min(ca, cb)
            if n:
                pos = max(pos, float((ma.pos[:n] - mb.pos[:n]).abs().max())
                          * 1e3)
                for f in MAP_ATTRS:
                    a_, b_ = getattr(ma, f)[:n], getattr(mb, f)[:n]
                    attr = max(attr, float((a_ - b_).abs().max()) / max(
                        float(b_.abs().max()), 1e-30))
            flips += _finite_gap(va, vb)[1]
            off += pixels_off(va, vb, na, nb)
        out.update(map_count_diff=float(cd), map_gap_mm=pos,
                   map_attr_gap=attr, pred_px_off=float(off),
                   pred_flips=float(flips))
    out["seg_px_diff"] = (float(int((np.asarray(got["seg"])
                                     != want["seg"]).sum()))
                          if "seg" in got and "seg" in want else inf)
    return out


def map_gaps(got: Dict, want: Dict) -> Dict[str, float]:
    depth_gap = normal_gap = 0.0
    flips = 0
    pairs = [(got["filt"], want["filt"], "d")]
    for a, b in zip(got["levels"], want["levels"]):
        pairs += [(a["depth"], b["depth"], "d"), (a["vmap"], b["vmap"], "d"),
                  (a["nmap"], b["nmap"], "n")]
    for a, b, kind in pairs:
        gap, fl = _finite_gap(a, b)
        flips += fl
        if kind == "d":
            depth_gap = max(depth_gap, gap * 1e3)
        else:
            normal_gap = max(normal_gap, gap)
    edge_gap = float((got["edge"] - want["edge"]).abs().max())
    edge_flips = int((got["nonedge"] != want["nonedge"]).sum())
    return {"prep_gap_mm": depth_gap, "prep_normal_gap": normal_gap,
            "prep_flips": float(flips), "edge_gap": edge_gap,
            "edge_flips": float(edge_flips)}


def edge_valid_inner(cap: Capture) -> float:
    """The valid interior pixels of the checked frames' level-0 vertex
    maps, the mean: what the edge map's arithmetic runs on."""
    counts = []
    for rec in cap.got.values():
        inner = rec["prep"].levels[0]["vmap"][1:-1, 1:-1]
        counts.append(int((inner[..., 0].isfinite()
                           & (inner[..., 2] > 0)).sum()))
    return sum(counts) / len(counts) if counts else None


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        device, t_start: float, control: Optional[str] = None,
        window_seconds: Optional[float] = None) -> harness.DriverResult:
    """One run; ``window_seconds`` (the controls' readings) ends the window
    early, the checked frames drawn as in a run of ``seconds``."""
    wl, config = cell.workload, cell.config
    dev = torch.device(device)
    spans = harness.Spans()
    traffic = SlamTraffic(wl, config, seed, dev)
    engine = make_engine(config, traffic.intr, dev)
    ticks: Dict[int, int] = {}
    cap = Capture(engine, ticks)
    t = wl["traffic"]
    # warm-up: the first frame makes the map; drains settle the spawns
    k = 0
    for i in range(t["warmup_frames"]):
        ticks[engine.tick + 1] = k
        engine.process_frame(traffic.frame(k))
        k += 1
        if (i + 1) % t["drain_every"] == 0:
            engine.drain_pipeline()
    engine.flush_diagnostics()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    # the window's frames checked against the reference, drawn from the seed
    rng = np.random.default_rng(seed + 1)
    lo = engine.tick + 1
    span_ticks = max(2, int(seconds * t["min_fps_sampled"]))
    cap.ticks = {lo + int(j) for j in rng.choice(
        span_ticks, size=min(t["checked_frames"], span_ticks),
        replace=False)}
    setup_s = time.perf_counter() - t_start
    n, window_s, k = window(engine, traffic, k, window_seconds or seconds,
                            spans, ticks)
    harness.print_window(spans, "frame", n, window_s)
    print_models(engine, spans)
    fps = n / window_s
    profile = None
    if trace:
        profile = traced_frames(engine, traffic, k, t["trace_frames"], ticks)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    values = stage_checks(cap, traffic, ticks, config)
    # the control: the reference one precision below, in the program's place
    ctrl = stage_checks(cap, traffic, ticks, config, True) if control \
        else None
    spans.counters["edge_valid_inner"] = edge_valid_inner(cap)
    del engine
    checks, ok = harness.judge(values, wl["limits"])
    return harness.DriverResult(
        e2e={"slam_fps": fps, "setup_s": setup_s}, window_s=window_s,
        units=n, spans=spans, profile=profile, checks=checks, correct=ok,
        attempted=n, failed=0, memory_peak_bytes=peak, control=ctrl, values=values)
