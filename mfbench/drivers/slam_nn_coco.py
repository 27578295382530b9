"""MaskFusion's own mode: SLAM at VGA while matterport's COCO Mask R-CNN
(ResNet-101-FPN at 1024 px) labels frames from the delay queue on its own
thread and CUDA stream.

Set-up builds the engine from the configuration's file and the network
the program's own preset gives (the configuration's ``network_preset``,
what the command line's ``--nn`` builds; the file's ``network`` group must
equal it, and without a preset the group alone says what runs), with
weights made from the seed on the card: ``traffic.weights`` for the
kernels, ``traffic.bn_stats`` for the FrozenBatchNorm statistics, drawn
around what the reference's layers see on the stream's first frame.  It
renders the static ramp's frames (``drivers.slam_nn``), counts a forward's
multiply-accumulates and warms up until the engine has taken
``warmup_frames`` frames and the worker has labelled ``warmup_forwards``.
By then the delay queue is full: each push releases the queue's head to
the engine (labelled or not), as in a user's steady state, and the window
opens.  Each frame is pushed once the engine has taken the last (a closed
loop, as MaskFusion reads a log with no frame skip) until ``seconds`` have
passed; the engine then drains and the card synchronises.  ``slam_fps``
counts the frames the engine took over the window's time; the frames
still queued are as many as when it opened.  With ``--trace 1`` the
profiled frames follow, until the worker has finished ``trace_forwards``
labels after the one it was in (so that many whole ``label`` spans).

What decides ``correct`` (the limits are the workload file's): on frames
drawn from the seed, the SLAM device stage against the plain reference as
in ``drivers.slam``; on ``checked_forwards`` forwards drawn from the
first ``checked_forwards_span`` that started in the window, the network's
outputs that no score threshold hides against the float32 reference
(``reference.labeller``: ``rpn_gap``, ``cls_gap``, ``box_gap`` and
``mask_gap``), and each of the two NMS stages by itself, the reference's
stage run on the program's inputs to it against the program's picks
(``proposal_flips``, ``pick_flips``).  With seeded weights no detection
reaches the score threshold, so the id image stays empty and no mask
spawns a model.  Set-up's phases are printed to the error stream.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from mfbench import arith, harness
from mfbench.drivers import slam
from mfbench.drivers.slam_nn import Lane, RampTraffic, no_host_init
from mfbench.drivers.train import program_config, seeded_weights
from mfbench.reference import labeller
from mfbench.reference import network as ref_net
from mfbench.reference.resize import resize_rgb_u8
from mfbench.traffic import bn_stats

GAPS = ("rpn_gap", "cls_gap", "box_gap", "mask_gap")
FLIPS = ("proposal_flips", "pick_flips")


def program_network(config: Dict):
    """The program's network: its preset (a program without it raises
    here, before any set-up), which must equal the ``network`` group."""
    from maskfusion_tpu_torch.maskrcnn import model as mm

    net = config["network"]
    cfg = program_config(net)
    preset = config.get("network_preset")
    if preset is None:
        return cfg
    built = getattr(mm, preset)(net["score_threshold"])
    if built != cfg:
        raise ValueError(f"the configuration's network group is not "
                         f"{preset}: {built} != {cfg}")
    return built


def labeller_weights(net: Dict, frame_rgb: np.ndarray, seed: int, device):
    """The kernels from the seed, then the FrozenBatchNorm statistics drawn
    on ``frame_rgb`` resized as the program resizes it."""
    w0 = seeded_weights(net, seed, device)
    ref = ref_net.build(net, w0, device=device)
    S = net["image_size"]
    img = resize_rgb_u8(torch.from_numpy(np.ascontiguousarray(frame_rgb))
                        .to(device), (S, S)).float()[None]
    bn_stats.draw_(ref, w0, img, seed + 2)
    return w0


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool,
        device, t_start: float, control: Optional[str] = None
        ) -> harness.DriverResult:
    from maskfusion_tpu_torch.maskrcnn import model as mm
    from maskfusion_tpu_torch.maskrcnn.inference import MaskRCNNInference

    wl, config = cell.workload, cell.config
    t = wl["traffic"]
    cfg = program_network(config)
    net = config["network"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    spans = harness.Spans()
    phases = {"imports": time.perf_counter() - t_start}
    mark = [time.perf_counter()]

    def phase(name):
        now = time.perf_counter()
        phases[name] = now - mark[0]
        mark[0] = now

    traffic = RampTraffic(wl, config, seed, dev)
    phase("frames")
    engine = slam.make_engine(config, traffic.intr, dev)
    ticks: Dict[int, int] = {}
    cap = slam.Capture(engine, ticks)
    phase("engine")
    w0 = labeller_weights(net, traffic.frames[traffic.index(0)].rgb, seed, dev)
    phase("weights")
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)   # the reference's is not
    with no_host_init():
        inference = MaskRCNNInference(cfg, device=dev)
    with torch.no_grad():
        for n, p in inference.model.named_parameters():
            p.copy_(w0[n])
    macs = arith.network_macs(
        inference.model, lambda: inference.forward(traffic.frames[0].rgb),
        (mm.Conv, mm.Dense, mm.ConvTranspose2x2))
    spans.counters["nn_forward_macs"] = float(sum(macs.values()))
    phase("network")
    lane = Lane(inference, config["frame_queue"], spans)
    worker = lane.worker
    state = {"consumed": 0, "labelled": 0, "k": 0}

    def consume(out):
        if out is not None:
            state["labelled"] += out.mask is not None
            state["consumed"] += 1
            ticks[engine.tick + 1] = int(out.timestamp) - 1    # frame k
            engine.process_frame(out)

    def pump():
        worker.check()
        lane.queue.push(traffic.frame(state["k"]))
        state["k"] += 1
        consume(lane.queue.pop_ready())

    try:
        while (state["consumed"] < t["warmup_frames"]
               or worker.labelled < t["warmup_forwards"]
               or len(lane.queue) < config["frame_queue"] - 1):
            pump()
        rng = np.random.default_rng(seed + 1)
        lo = engine.tick + 1
        span_ticks = max(2, int(seconds * t["min_fps_sampled"]))
        cap.ticks = {lo + int(j) for j in rng.choice(
            span_ticks, size=min(t["checked_frames"], span_ticks),
            replace=False)}
        # the forward running now started before the window: the drawn
        # ones start inside it
        f1 = lane.forwards + 1
        lane.check_forwards = {f1 + int(j) for j in rng.choice(
            t["checked_forwards_span"], size=t["checked_forwards"],
            replace=False)}
        counted = slam.engine_counters(engine, spans)
        c0, l0 = state["consumed"], state["labelled"]
        idle0 = worker.stopwatch.timings_ms.get("idle", 0.0)
        setup_s = time.perf_counter() - t_start
        phase("warmup")
        print("setup phases s: " + " ".join(
            f"{k} {v:.3f}" for k, v in phases.items()), file=sys.stderr)
        t0 = time.perf_counter()
        deadline = t0 + seconds
        pushed = 0
        last = t0
        while True:
            n_before = state["consumed"]
            pump()
            pushed += 1
            now = time.perf_counter()
            if state["consumed"] > n_before:
                spans.span("frame", last, now)
                last = now
            if now >= deadline:
                break
        engine.flush_diagnostics()
        if cuda:
            torch.cuda.synchronize(dev)
        window_s = time.perf_counter() - t0
        n = state["consumed"] - c0
        spans.counters["nn_worker_idle_ms"] = \
            worker.stopwatch.timings_ms.get("idle", 0.0) - idle0
        harness.print_window(spans, "frame", n, window_s)
        spans.counters["nn_pushed"] = pushed
        spans.counters["nn_labelled"] = state["labelled"] - l0
        counted()
        profile = None
        if trace:
            closed = {}

            def run_frames():
                goal = worker.labelled + t["trace_forwards"] + 1
                limit = time.perf_counter() + t["trace_limit_s"]
                while worker.labelled < goal:
                    pump()
                    if time.perf_counter() > limit:
                        raise RuntimeError(
                            f"{t['trace_forwards'] + 1} labels took over "
                            f"{t['trace_limit_s']} s")
                closed["end_ns"] = time.time_ns()

            before_trace = state["consumed"]
            profile = harness.traced(run_frames, 0, dev)
            profile["units"] = state["consumed"] - before_trace
            profile["end_ns"] = closed["end_ns"]
            engine.flush_diagnostics()
    finally:
        worker.stop()
    # the forwards that started inside the window
    spans.spans["nn_forward"] = [
        sp for sp in spans.spans.get("nn_forward", [])
        if t0 <= sp[0] < t0 + window_s]
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.synchronize(dev)
    values = slam.stage_checks(cap, traffic, ticks, config)
    spans.counters["edge_valid_inner"] = slam.edge_valid_inner(cap)
    got = [(torch.from_numpy(np.ascontiguousarray(rgb)).to(dev), out)
           for rgb, out in lane.got]
    del engine, inference, lane, worker
    if cuda:
        torch.cuda.empty_cache()

    def forwards(model):
        return [labeller.forward(model, rgb, out["proposals"],
                                 out["pick_boxes"], out["pick_classes"])
                for rgb, out in got]

    def worst(gs, keys=GAPS):    # a drawn forward that never ran fails
        return {k: max((g[k] for g in gs), default=float("inf"))
                for k in keys}

    model = ref_net.build(net, w0, device=dev)
    want = forwards(model)
    values.update(worst([labeller.compare(labeller.program_outputs(out), w)
                         for (_, out), w in zip(got, want)]))
    values.update(worst([labeller.nms_flips(model, out) for _, out in got],
                        FLIPS))
    del model
    ctrl = None
    if control == "fp8":
        # the reference at fp8 operands, in the program's place
        low = ref_net.build(net, w0, fp8=True, device=dev)
        ctrl = worst([labeller.compare(g, w)
                      for g, w in zip(forwards(low), want)])
        del low
        ctrl.update(slam.stage_checks(cap, traffic, ticks, config, True))
    checks, ok = harness.judge(values, wl["limits"])
    return harness.DriverResult(
        e2e={"slam_fps": n / window_s, "setup_s": setup_s},
        window_s=window_s, units=n, spans=spans, profile=profile,
        checks=checks, correct=ok, attempted=pushed, failed=0,
        memory_peak_bytes=peak, control=ctrl, values=values)
