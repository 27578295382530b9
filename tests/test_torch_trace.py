"""The port's span log (utils/stopwatch) on the CPU:

- without a profiler nothing is recorded and the stopwatch's aggregates are
  as before;
- under torch.profiler a span brackets the operation it ran, on the
  profiler's own clock (Kineto's start_ns / end_ns);
- a two-object engine in the prefused pipelined schedule (the Config
  default) gives, over three profiled frames, the tree of spans its
  docstring names, each with its frame's tick;
- the scan's counter `scan_live` counts what the plain path's `live` holds;
- a train step records its phases with its step number;
- a full log drops records and counts them.

tests/test_torch_kernels.py::test_spans_on_the_card_under_cuda_activity
holds the clock under CUDA-only activity, as the benchmark profiles."""

import functools

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from maskfusion_tpu_torch.camera import Resolution
from maskfusion_tpu_torch.config import Config
from maskfusion_tpu_torch.engine import MaskFusion
from maskfusion_tpu_torch.frame import FrameData
from maskfusion_tpu_torch.ops import kernels
from maskfusion_tpu_torch.utils import stopwatch
from maskfusion_tpu_torch.utils.stopwatch import Stopwatch
from tests import synthetic as syn
from tests.torch_helpers import CPU, tintr

CLASS_IDS = [0, 7, 8]


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@functools.lru_cache(maxsize=None)
def two_object_frames(count):
    """A still camera, object 1 moving along +x, object 2 along -y."""
    frames = []
    for i in range(count):
        o1 = np.array([0.006 * i, 0.0, 0.0])
        o2 = np.array([0.0, -0.006 * i, 0.0])
        pts, cols, labels = syn.make_scene_with_two_objects(o1, o2)
        frames.append(syn.render(pts, cols, np.eye(4, dtype=np.float32),
                                 syn.DEFAULT_INTR, labels=labels))
    return frames


def pipelined_engine() -> MaskFusion:
    return MaskFusion(
        Resolution(syn.W, syn.H), tintr(syn.DEFAULT_INTR),
        Config(seg_method="maskfusion", global_surfel_capacity=1 << 16,
               object_surfel_capacity=1 << 13, model_spawn_offset=0,
               object_window=104, object_window_margin=24),
        device=CPU)


def feed(eng, frames, start):
    for i, (rgb, depth, lab) in enumerate(frames, start=start):
        eng.process_frame(FrameData(rgb=rgb, depth=depth, mask=lab,
                                    class_ids=CLASS_IDS,
                                    timestamp=float(i + 1)))


def test_nothing_is_recorded_without_a_profiler():
    stopwatch.clear_log()
    sw = Stopwatch()
    with sw.scope("odom"):
        with stopwatch.span("track_global", 3):
            torch.ones(8).sum()
    stopwatch.count("scan_live", 3, live=torch.tensor(5))
    stopwatch.span_since("frame_to_pose", 3, 0)
    live = torch.rand(12, 16) > 0.5
    kernels.predict_l0_scan(torch.rand(12, 16, 3), torch.rand(12, 16, 3),
                            torch.rand(12, 16), live,
                            torch.tensor([10.0, 10.0, 8.0, 6.0]), 5.0)
    assert stopwatch.read_log() == [] and stopwatch.LOG.dropped == 0
    assert set(sw.summary()) == {"odom"} and sw.counts["odom"] == 1
    assert sw.last_ms["odom"] >= 0.0


def test_a_span_brackets_its_operation_on_the_profilers_clock():
    stopwatch.clear_log()
    a = torch.randn(128, 128)
    with cpu_profile() as prof:
        with stopwatch.span("matmul", 7):
            a @ a
    (rec,) = stopwatch.read_log()
    assert (rec["kind"], rec["name"], rec["id"], rec["parent"]) == \
        ("span", "matmul", 7, -1)
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert mm, "the profiler saw no aten::mm"
    for e in mm:
        assert rec["start_ns"] <= e.start_ns() <= e.end_ns() <= \
            rec["end_ns"], (rec, e.start_ns(), e.end_ns())


def test_pipelined_engine_span_tree():
    """Three profiled frames of the prefused schedule after four plain
    ones (both objects spawned): each frame is a root `process_frame` with
    its tick; `odom` holds `track_global` and `track_objects` (the warm
    start, then the one block's solve), `fuse` holds `fuse_global` and
    `fuse_objects`; each
    `host_stage` sits in a `process_frame` and names an earlier tick, with
    `fetch`, `fetch_ids` and `segmentation` inside it; `frame_to_pose`
    starts in its frame's `process_frame` and ends after it.  The
    stopwatch keeps the keys it had without the profiler."""
    stopwatch.clear_log()
    frames = two_object_frames(7)
    eng = pipelined_engine()
    feed(eng, frames[:4], 0)
    assert stopwatch.read_log() == []
    assert [m.class_id for m in eng.models[1:]] == [7, 8]
    keys = set(eng.stopwatch.summary())
    with cpu_profile():
        feed(eng, frames[4:], 4)
    eng.drain_pipeline()
    assert set(eng.stopwatch.summary()) == keys
    log = stopwatch.read_log()
    spans = [r for r in log if r["kind"] == "span"]
    assert all(r["end_ns"] >= r["start_ns"] for r in spans)
    roots = [i for i, r in enumerate(log) if r["name"] == "process_frame"]
    assert [log[i]["id"] for i in roots] == [5, 6, 7]
    assert all(log[i]["parent"] == -1 for i in roots)

    def kids(i):
        return [r["name"] for r in log if r["parent"] == i
                and r["kind"] == "span"]

    def inside(i, name, n=1):
        ks = [j for j, r in enumerate(log) if r["parent"] == i
              and r["name"] == name]
        assert len(ks) == n, (name, ks)
        for k in ks:
            assert log[k]["id"] == log[i]["id"]
            assert log[i]["start_ns"] <= log[k]["start_ns"] <= \
                log[k]["end_ns"] <= log[i]["end_ns"]
        return ks[0]

    for i in roots:
        assert {"odom", "fuse", "host_stage"} <= set(kids(i))
        odom = inside(i, "odom")
        assert kids(odom) == ["track_global", "track_objects",
                              "track_objects"]
        inside(odom, "track_global")
        inside(odom, "track_objects", 2)
        fuse = inside(i, "fuse")
        assert kids(fuse) == ["fuse_global", "fuse_objects"]
        inside(fuse, "fuse_global")
        inside(fuse, "fuse_objects")
        (h,) = [j for j, r in enumerate(log) if r["parent"] == i
                and r["name"] == "host_stage"]
        assert log[h]["id"] < log[i]["id"]
        assert kids(h) == ["fetch", "fetch_ids", "segmentation"]
        assert all(r["id"] == log[h]["id"] for r in log
                   if r["parent"] == h)
    poses = [r for r in log if r["name"] == "frame_to_pose"]
    assert poses and all(r["parent"] == -1 for r in poses)
    by_tick = {log[i]["id"]: log[i] for i in roots}
    inner = [r for r in poses if r["id"] in by_tick]
    assert inner, [r["id"] for r in poses]
    for r in inner:
        frame = by_tick[r["id"]]
        assert frame["start_ns"] <= r["start_ns"] <= frame["end_ns"] \
            <= r["end_ns"]


def box_sum(live: np.ndarray, w: int) -> int:
    """The +-w box sum of `live` at every pixel (zero outside), summed."""
    H, W = live.shape
    p = np.pad(live.astype(np.int64), w)
    return int(sum(p[w + dy:w + dy + H, w + dx:w + dx + W].sum()
                   for dy in range(-w, w + 1) for dx in range(-w, w + 1)))


def test_scan_live_counts_the_plain_paths_live():
    stopwatch.clear_log()
    g = torch.Generator().manual_seed(3)
    cases = [(24, 32, 2, 0.3), (17, 9, 1, 0.8), (40, 30, 3, 0.05)]
    with cpu_profile():
        for H, W, window, p in cases:
            live = torch.rand(H, W, generator=g) < p
            kernels.predict_l0_scan(
                torch.rand(H, W, 3, generator=g),
                torch.rand(H, W, 3, generator=g),
                torch.rand(H, W, generator=g), live,
                torch.tensor([20.0, 20.0, W / 2, H / 2]), 5.0,
                window=window)
            live_np = live.numpy()
            rec = stopwatch.read_log()[-1]
            assert rec["kind"] == "counter" and rec["name"] == "scan_live"
            assert rec["values"] == {
                "H": H, "W": W, "window": window,
                "live": int(live_np.sum()),
                "live_taps": box_sum(live_np, window)}, (H, W, window)
    assert len(stopwatch.read_log()) == len(cases)


def test_train_step_records_its_phases():
    from maskfusion_tpu_torch.maskrcnn import synthetic_shapes
    from maskfusion_tpu_torch.parallel.train import create_train_step

    stopwatch.clear_log()
    init_fn, step_fn = create_train_step(synthetic_shapes.micro_config(64),
                                         device="cpu")
    state = init_fn(0, 2)
    batch = synthetic_shapes.make_batch(np.random.default_rng(0), 2, 64)
    state, _ = step_fn(state, torch.Generator().manual_seed(0),
                       *map(torch.from_numpy, batch))
    assert stopwatch.read_log() == []
    with cpu_profile():
        state, _ = step_fn(state, torch.Generator().manual_seed(1),
                           *map(torch.from_numpy, batch))
    log = stopwatch.read_log()
    assert [(r["name"], r["id"]) for r in log] == [
        ("forward", 1), ("rpn_nms", 1), ("rpn_nms", 1), ("backward", 1),
        ("optimizer", 1)]
    assert [r["parent"] for r in log] == [-1, 0, 0, -1, -1]
    assert state.step == 2


def test_a_full_log_drops_and_counts():
    log = stopwatch.SpanLog(cap=3)
    outer = log.open("a", 1)
    log.count("c", values={"n": torch.tensor([2, 3])})
    inner = log.open("b")
    log.count("dropped")
    log.close(inner)
    log.close(outer)
    recs = log.read()
    assert [(r["name"], r["id"], r["parent"]) for r in recs] == \
        [("a", 1, -1), ("c", 1, 0), ("b", 1, 0)]
    assert recs[1]["values"] == {"n": [2, 3]}
    assert log.dropped == 1
    assert log.open("more") is None and log.dropped == 2
    log.clear()
    assert log.read() == [] and log.dropped == 0
