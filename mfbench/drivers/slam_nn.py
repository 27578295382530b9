"""The SLAM-plus-network driver: MaskFusion at VGA with Mask R-CNN labelling
frames in the loop.

Set-up builds the engine from the configuration's file and the full-width
network (its ``network`` group) with weights made from the seed on the card,
renders the static ramp's frames on the card from the seed and copies them
to the host, counts a forward's multiply-accumulates, and warms up.  Each
frame is then pushed through the delay queue, which the network's worker
thread labels newest first on its own stream, and the engine takes what the
queue releases (a labelled head, or the head of a full queue), without
blocking, as the port bench's ``bench_nn_in_loop`` does.  The window ends
once ``seconds`` have passed, the queue is flushed, the engine has drained
and the card has synchronised.  ``slam_fps`` counts the frames the engine
took over all of the window's time.

What decides ``correct`` (the limits are the workload file's): on frames
drawn from the seed, the SLAM device stage against the plain reference as
in ``drivers.slam`` (``prep_gap_mm``, ``prep_normal_gap``, ``prep_flips``,
``edge_gap``, ``edge_flips``, ``track_gap_mm``), and on forwards served in
the window, the network's outputs before the score threshold against the
float32 reference (``reference.network``: ``rpn_gap``, ``cls_gap``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from mfbench import arith, harness
from mfbench.drivers import slam
from mfbench.drivers.train import program_config, seeded_weights
from mfbench.reference import network as ref_net
from mfbench.traffic import scenes


class RampTraffic:
    """The static ramp's frames on the host, played forward and back."""

    def __init__(self, workload: Dict, config: Dict, seed: int, device):
        from maskfusion_tpu_torch.frame import FrameData

        t = workload["traffic"]
        W, H = config["resolution"]
        self.loop = t["loop_frames"]
        # the seed picks where in the loop played forward and back the
        # stream starts: every seed sees the same frames, in another order
        self.start = int(np.random.default_rng(seed).integers(
            0, 2 * (self.loop - 1)))
        self.frames = []
        for f in scenes.static_ramp(W, H, self.loop, t["phase"], device):
            self.frames.append(FrameData(
                rgb=f["rgb"].cpu().numpy(),
                depth=f["depth_mm"].cpu().numpy().astype(np.uint16)))
        self.intr = tuple(t["intrinsics"])

    def index(self, k: int) -> int:
        return scenes.ping_pong_index(self.start + k, self.loop)

    def frame(self, k: int):
        return dataclasses.replace(self.frames[self.index(k)],
                                   timestamp=float(k + 1))


@contextlib.contextmanager
def no_host_init():
    """``MaskRCNNInference`` without its host initialisation of the
    weights."""
    from maskfusion_tpu_torch.maskrcnn import inference as inf

    saved = inf.init_params_
    inf.init_params_ = lambda model, seed=0: model
    try:
        yield
    finally:
        inf.init_params_ = saved


class Lane:
    """The network's lane: the worker over the delay queue, with the
    harness's span around each ``execute`` and, for the forwards drawn for
    the check, the frame and the forward's outputs kept."""

    def __init__(self, inference, queue_size: int, spans: harness.Spans):
        from maskfusion_tpu_torch.maskrcnn.inference import (FrameQueue,
                                                             MaskRCNNWorker)

        self.inference = inference
        self.spans = spans
        self.check_forwards: set = set()
        self.forwards = 0
        self.got = []
        execute = inference.execute
        forward = inference.forward

        def timed_execute(frame):
            t0 = time.perf_counter()
            out = execute(frame)
            spans.span("nn_forward", t0, time.perf_counter())
            return out

        def kept_forward(rgb):
            out = forward(rgb)
            if self.forwards in self.check_forwards:
                self.got.append((rgb, out))
            self.forwards += 1
            return out

        inference.execute = timed_execute
        inference.forward = kept_forward
        self.queue = FrameQueue(queue_size)
        self.worker = MaskRCNNWorker(inference, self.queue)


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        device, t_start: float, control: Optional[str] = None
        ) -> harness.DriverResult:
    from maskfusion_tpu_torch.maskrcnn import model as mm
    from maskfusion_tpu_torch.maskrcnn.inference import MaskRCNNInference

    wl, config = cell.workload, cell.config
    t = wl["traffic"]
    dev = torch.device(device)
    spans = harness.Spans()
    traffic = RampTraffic(wl, config, seed, dev)
    engine = slam.make_engine(config, traffic.intr, dev)
    ticks: Dict[int, int] = {}
    cap = slam.Capture(engine, ticks)
    net = config["network"]
    w0 = seeded_weights(net, seed, dev)
    with no_host_init():
        inference = MaskRCNNInference(program_config(net), device=dev)
    with torch.no_grad():
        for n, p in inference.model.named_parameters():
            p.copy_(w0[n])
    macs = arith.network_macs(
        inference.model, lambda: inference.forward(traffic.frames[0].rgb),
        (mm.Conv, mm.Dense, mm.ConvTranspose2x2))
    spans.counters["nn_forward_macs"] = float(sum(macs.values()))
    lane = Lane(inference, config["frame_queue"], spans)
    state = {"consumed": 0, "labelled": 0}

    def consume(out):
        if out is not None:
            state["labelled"] += out.mask is not None
            state["consumed"] += 1
            ticks[engine.tick + 1] = int(out.timestamp) - 1    # frame k
            engine.process_frame(out)

    def pump(frame):
        lane.worker.check()
        lane.queue.push(frame)
        consume(lane.queue.pop_ready())

    def drain():
        while len(lane.queue):
            consume(lane.queue.pop_ready(flush=True))
        engine.flush_diagnostics()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    try:
        k = 0
        for _ in range(t["warmup_frames"]):
            pump(traffic.frame(k))
            k += 1
        drain()
        rng = np.random.default_rng(seed + 1)
        lo = engine.tick + 1
        span_ticks = max(2, int(seconds * t["min_fps_sampled"]))
        cap.ticks = {lo + int(j) for j in rng.choice(
            span_ticks, size=min(t["checked_frames"], span_ticks),
            replace=False)}
        f0 = lane.forwards
        lane.check_forwards = {f0 + int(j) for j in rng.choice(
            t["checked_forwards_span"], size=t["checked_forwards"],
            replace=False)}
        counted = slam.engine_counters(engine, spans)
        c0, l0 = state["consumed"], state["labelled"]
        nn0 = len(spans.spans.get("nn_forward", []))
        setup_s = time.perf_counter() - t_start
        t0 = time.perf_counter()
        deadline = t0 + seconds
        pushed = 0
        last = t0
        while True:
            n_before = state["consumed"]
            pump(traffic.frame(k))
            k += 1
            pushed += 1
            now = time.perf_counter()
            if state["consumed"] > n_before:
                spans.span("frame", last, now)
                last = now
            if now >= deadline:
                break
        drain()
        window_s = time.perf_counter() - t0
        n = state["consumed"] - c0
        harness.print_window(spans, "frame", n, window_s)
        spans.counters["nn_pushed"] = pushed
        spans.counters["nn_labelled"] = state["labelled"] - l0
        counted()
        # forwards that started inside the window
        spans.spans["nn_forward"] = [
            sp for sp in spans.spans.get("nn_forward", [])[nn0:]
            if sp[0] < t0 + window_s]
        profile = None
        if trace:
            # the queue filled first, so that each traced push releases a
            # frame to the engine, as in the window's steady state
            for _ in range(config["frame_queue"]):
                pump(traffic.frame(k))
                k += 1
            frames = [traffic.frame(k + j) for j in range(t["trace_frames"])]
            before_trace = state["consumed"]

            def run_frames():
                for f in frames:
                    pump(f)

            profile = harness.traced(run_frames, len(frames), dev)
            profile["units"] = state["consumed"] - before_trace
            drain()
    finally:
        lane.worker.stop()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    values = slam.stage_checks(cap, traffic, ticks, config)
    spans.counters["edge_valid_inner"] = slam.edge_valid_inner(cap)
    got = [(torch.from_numpy(np.ascontiguousarray(rgb)).to(dev), out)
           for rgb, out in lane.got]
    del engine, inference, lane
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ctrl = None
    model = ref_net.build(net, w0, device=dev)
    gaps = []
    wants = []
    for rgb, out in got:
        want = ref_net.forward(model, rgb, out["proposals"])
        wants.append(want)
        gaps.append(ref_net.compare(
            {"rpn_logits": out["rpn_logits"][0],
             "rpn_deltas": out["rpn_deltas"][0],
             "class_logits": out["class_logits"]}, want))
    del model
    inf_ = float("inf")          # a drawn forward that never ran fails
    values["rpn_gap"] = max((g["rpn_gap"] for g in gaps), default=inf_)
    values["cls_gap"] = max((g["cls_gap"] for g in gaps), default=inf_)
    if control == "fp8":
        low = ref_net.build(net, w0, fp8=True, device=dev)
        cg = [ref_net.compare(ref_net.forward(low, rgb, out["proposals"]), w)
              for (rgb, out), w in zip(got, wants)]
        ctrl = {"rpn_gap": max((g["rpn_gap"] for g in cg), default=inf_),
                "cls_gap": max((g["cls_gap"] for g in cg), default=inf_)}
        ctrl.update(slam.stage_checks(cap, traffic, ticks, config, True))
    checks, ok = harness.judge(values, wl["limits"])
    return harness.DriverResult(
        e2e={"slam_fps": n / window_s, "setup_s": setup_s},
        window_s=window_s, units=n, spans=spans, profile=profile,
        checks=checks, correct=ok, attempted=pushed, failed=0,
        memory_peak_bytes=peak, control=ctrl, values=values)
