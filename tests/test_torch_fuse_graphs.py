"""Each model's fuse, clean and predict as CUDA graphs (engine._fuse,
tracking/graphs).

On the CPU the engine's graphed path runs through a stand-in for the CUDA
graph (`cpu_graphs`: a replay runs the function again on the graph's
static buffers with its host-side records noted, as a replay runs no
Python): the frame values (time, mask id, thresholds, principal point)
enter as 0-d tensors filled on each call and the map prefix is copied in
and back, as on a card.  On the 160x120 two-object scene after both
spawns the tests hold there: the graphed fuse stage equal to the eager one
bit for bit (the global model with fill-in; windowed and full-frame object
slots; the gate open and closed; the id guard; both parities and the
parity derived from the time; a bucket step; compaction off), object
slots sharing one graph across a spawn, the counters
(`fuse_graph_replays`, `fuse_graph_captures`, the ``fuse_graph`` counter,
one ``scan_live`` a replay), the keys, the scan's plain twin reading a
device intrinsics buffer, the graphed windowed pass against the JAX
engine's `_fuse_clean_predict_obj_win` at the bounds of
tests/test_torch_object_passes.py, and the metric `fuse_graph_hit_pct`.

The tests marked `cuda` replay the fuse stage on the card at VGA (the SLAM
cell's engine after its warm-up) against the eager stage, equal bits under
deterministic algorithms (the eager `index_add_` sums of the fuse are not
deterministic otherwise: ROADMAP fault 1), and check that a capture never
synchronises and that each replay records its counters.  JAX is imported
inside the one test that needs it, so the card tests also run where JAX
is absent: `pytest --noconftest -m cuda tests/test_torch_fuse_graphs.py`.
"""

import contextlib
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from maskfusion_tpu_torch.camera import CameraIntrinsics, Resolution
from maskfusion_tpu_torch.config import Config
from maskfusion_tpu_torch.engine import DEAD_SLOT_ID, MapState, MaskFusion
from maskfusion_tpu_torch.frame import FrameData
from maskfusion_tpu_torch.mapping import surfel_map as sm
from maskfusion_tpu_torch.ops import kernels
from maskfusion_tpu_torch.tracking import graphs
from maskfusion_tpu_torch.utils import stopwatch

SLICE = dict(global_surfel_capacity=1 << 17, object_surfel_capacity=1 << 14,
             seg_method="maskfusion", pipelined_multiobject=False,
             model_spawn_offset=0, object_window=104,
             object_window_margin=24, min_object_slots=2)
# prefixes of the maps, so the graphed path engages; one step up each
BUCKETS = dict(glob_bucket=1 << 15, obj_bucket=1 << 12)
STEP = dict(glob_bucket=1 << 16, obj_bucket=1 << 13)


@pytest.fixture
def cuda_device():
    """A CUDA device for the tests marked `cuda`; they skip where there is
    none.  The decision is taken here, never while the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on a machine with one: pytest "
                    "--noconftest -m cuda tests/test_torch_fuse_graphs.py)")
    return torch.device("cuda")


def clone_state(st: MapState) -> MapState:
    return MapState(sm.SurfelMap(*(a.clone() for a in st.map)),
                    *(a.clone() for a in st[1:]))


def assert_same(a: MapState, b: MapState, what=""):
    """Every tensor of two states equal bit for bit (NaN where NaN)."""
    for k, (x, y) in enumerate(zip(tuple(a.map) + tuple(a[1:]),
                                   tuple(b.map) + tuple(b[1:]))):
        assert torch.equal(x.isnan(), y.isnan()), (what, k)
        assert torch.equal(x.nan_to_num(), y.nan_to_num()), (what, k)


def recording_stage(eng):
    """Wraps the engine's fuse stage to keep its last call's arguments,
    the states cloned before it ran."""
    rec = {}
    stage = eng.fuse_stage

    def fuse_stage(glob_state, obj_states, prep, rgb, seg_mask, prev_poses,
                   time, obj_params, **kw):
        rec.update(glob=clone_state(glob_state),
                   objs=tuple(clone_state(s) for s in obj_states), prep=prep,
                   rgb=rgb, seg=seg_mask.clone(), prev=prev_poses.clone(),
                   time=time, params=np.array(obj_params), kw=dict(kw))
        return stage(glob_state, obj_states, prep, rgb, seg_mask, prev_poses,
                     time, obj_params, **kw)

    eng.fuse_stage = fuse_stage
    return rec


def run_stage(eng, rec, **over):
    """The recorded fuse stage again on clones of its states, with some
    arguments replaced."""
    a = dict(rec, **{k: v for k, v in over.items() if k in rec})
    kw = dict(rec["kw"], **{k: v for k, v in over.items() if k not in rec})
    return eng.fuse_stage(clone_state(a["glob"]),
                          tuple(clone_state(s) for s in a["objs"]),
                          a["prep"], a["rgb"], a["seg"], a["prev"],
                          a["time"], a["params"], **kw)


# ------------------------------------------------------------ the CPU
class _CpuGraph:
    """A stand-in for a CUDA graph on the CPU: a replay runs the function
    again on the static buffers, its host-side records noted (a replay
    runs no Python), and writes the flat output."""

    def __init__(self, fn, static, flat):
        self.fn, self.static, self.flat = fn, static, flat

    def replay(self):
        self.flat.copy_(graphs._traced(self.fn, self.static)[0])


def _cpu_capture(self, fn, inputs, keep):
    static = [graphs._static_copy(x, torch.device("cpu")) for x in inputs]
    with stopwatch.warming_up():
        fn(*static)
    flat, layout, marks = graphs._traced(fn, static)
    return graphs._Graph(_CpuGraph(fn, static, flat), static, flat, layout,
                         0, keep(), marks)


@contextlib.contextmanager
def cpu_graphs():
    """The engine's graphed fuse path on the CPU, through `_CpuGraph`."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs.SolveGraphs, "_capture", _cpu_capture)
        mp.setattr(MaskFusion, "_replays",
                   staticmethod(lambda m, bucket: bucket < m.capacity))
        yield


def small_engine() -> MaskFusion:
    fx, fy, cx, cy, w, h = chip_smoke.SMALL
    return MaskFusion(Resolution(w, h), CameraIntrinsics(fx, fy, cx, cy),
                      Config(**SLICE), device="cpu")


@pytest.fixture(scope="module")
def scene():
    """An engine after frames 0-3 of the two-object scene (both objects
    spawned and windowed), and the fuse stage of frame 4 as it was called
    (eagerly), with the engine's buckets replaced by map prefixes."""
    frames = chip_smoke.synthetic_two_objects(5)
    eng = small_engine()
    rec = recording_stage(eng)
    for i, (rgb, depth, lab) in enumerate(frames):
        eng.process_frame(FrameData(rgb=rgb, depth=depth, mask=lab,
                                    class_ids=[0, 7, 8], timestamp=float(i)))
    assert [m.model_id for m in eng.models] == [0, 1, 2]
    assert rec["kw"]["windowed"] and rec["kw"]["parity"] is not None
    assert all(m.window is not None for m in eng.models[1:])
    rec["kw"].update(BUCKETS)
    eng.fuse_stage = MaskFusion.fuse_stage.__get__(eng)
    return SimpleNamespace(eng=eng, rec=rec, frames=frames)


def _guard(rec):
    """An id projection that disagrees with the segmentation in places:
    the segmentation shifted by 3 pixels."""
    return torch.roll(rec["seg"], 3, dims=1)


CASES = {
    "windowed": {},
    "full_frame": dict(windowed=False),
    "gate_open": dict(gate=torch.tensor(True)),
    "gate_closed": dict(gate=torch.tensor(False)),
    "guarded": dict(gate=torch.tensor(True), ids_guard="guard"),
    "other_parity": dict(parity="flip"),
    "parity_from_time": dict(parity=None),
    "bucket_step": STEP,
}


def _case(rec, name):
    over = dict(CASES[name])
    if over.get("ids_guard") == "guard":
        over["ids_guard"] = _guard(rec)
    if over.get("parity") == "flip":
        over["parity"] = 1 - rec["kw"]["parity"]
    return over


@pytest.mark.parametrize("case", list(CASES))
def test_graphed_stage_equals_eager(scene, case):
    """The fuse stage through the graphed path (frame values as device
    scalars, the prefix through the graph's buffers) equals the eager
    stage (host numbers, the maps' own tensors) in every tensor of every
    model's state."""
    eng, rec = scene.eng, scene.rec
    over = _case(rec, case)
    eager = run_stage(eng, rec, **over)
    replays = eng.fuse_graph_replays
    with cpu_graphs():
        got = run_stage(eng, rec, **over)
    assert eng.fuse_graph_replays == replays + 3
    assert_same(got[0], eager[0], "global")
    for k, (a, b) in enumerate(zip(got[1], eager[1])):
        assert_same(a, b, f"object {k}")
    if case == "gate_closed":
        # nothing moves: every map and prediction as it came in
        assert_same(got[0]._replace(last_delta=rec["glob"].last_delta,
                                    so3_intensity=rec["glob"].so3_intensity),
                    rec["glob"], "closed gate")
    else:
        assert int(got[0].map.count) != int(rec["glob"].map.count) or \
            not torch.equal(got[0].map.pos, rec["glob"].map.pos)


def test_compaction_off_equals_eager(scene):
    """The global pass without compaction (culled surfels killed in
    place), graphed and eager."""
    eng, rec = scene.eng, scene.rec
    lv = rec["prep"]

    def call():
        return eng.fuse_clean_predict(
            clone_state(rec["glob"]), lv, rec["rgb"], rec["seg"],
            rec["prev"][0], rec["time"], 0, eng.cfg.conf_threshold_global,
            eng.cfg.depth_cutoff, eng.cfg.weight_multiplier, True,
            BUCKETS["glob_bucket"], rec["kw"]["parity"], compact=False)

    eager = call()
    with cpu_graphs():
        got = call()
    assert_same(got[0], eager[0])
    assert torch.equal(got[1], eager[1]) and torch.equal(got[2], eager[2])


def test_slots_share_a_graph_and_the_counters_count(scene, monkeypatch):
    """One graph a key: the objects' slots of one bucket share one, a third
    live slot (a spawn) replays it, a bucket step captures anew.  Each
    graphed pass records the counter ``fuse_graph`` and, while a profiler
    runs (here: the span log made to record as if one ran), one
    ``scan_live`` (a capture's warm-up adds one: its scan ran)."""
    eng = small_engine()
    rec = scene.rec
    three = dict(objs=rec["objs"] + (rec["objs"][1],),
                 params=np.concatenate([rec["params"], rec["params"][1:]]),
                 prev=torch.cat([rec["prev"], rec["prev"][2:]]))
    monkeypatch.setattr(stopwatch, "recording", lambda: True)
    monkeypatch.setattr(kernels, "recording", lambda: True)
    stopwatch.clear_log()
    with cpu_graphs():
        run_stage(eng, rec)                       # captures 2 graphs
        run_stage(eng, rec)                       # replays them
        run_stage(eng, rec, **three)              # a spawn: replays
        assert (len(eng._fuse_graphs), eng.fuse_graph_captures,
                eng.fuse_graph_replays) == (2, 2, 10)
        run_stage(eng, rec, **STEP)               # a bucket step
    log = stopwatch.read_log()
    assert (len(eng._fuse_graphs), eng.fuse_graph_captures,
            eng.fuse_graph_replays) == (4, 4, 13)
    calls = [r["values"] for r in log
             if r["kind"] == "counter" and r["name"] == "fuse_graph"]
    assert [c["captured"] for c in calls] == [1, 1, 0, 0, 0, 0, 0, 0, 0, 0,
                                              1, 1, 0]
    assert [c["path"] for c in calls[:3]] == ["global", "window", "window"]
    assert all(c["slots"] == 1 for c in calls)
    scans = [r["values"] for r in log
             if r["kind"] == "counter" and r["name"] == "scan_live"]
    # one a replay, one more a capture's warm-up; each with its pass's
    # live counts
    assert len(scans) == len(calls) + sum(c["captured"] for c in calls)
    assert {(s["H"], s["W"]) for s in scans} == {(120, 160), (104, 104)}
    assert all(0 < s["live"] <= s["live_taps"] for s in scans)
    # the CPU's tracks run eagerly: no graph of theirs
    assert len(eng._track_graphs) == 0
    stopwatch.clear_log()


def test_keys(scene):
    """What a fuse graph bakes in and what it takes as an input: two
    windowed slots (another mask id, window, time and thresholds) share a
    key, and so does the next frame; the path, the bucket, the parity, the
    gate, the guard and the window size part keys."""
    eng, rec = scene.eng, scene.rec
    keys = []

    def record(path, static, fn, inputs):
        keys.append(eng._fuse_graph_key(static, inputs))
        return fn(*inputs)

    with cpu_graphs(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(eng, "_fuse_graphed", record)

        def keys_of(**over):
            keys.clear()
            run_stage(eng, rec, **over)
            return list(keys)

        base = keys_of()
        later = keys_of(time=rec["time"] + 1.0)
        assert base == later and base[1] == base[2] and base[0] != base[1]
        rows = rec["params"].copy()
        rows[:, 1:4] += 1.0                   # thresholds, weight
        rows[:, 4:6] = [[16, 24], [0, 40]]    # other windows
        assert keys_of(params=rows) == base
        for over in (STEP, dict(parity=1 - rec["kw"]["parity"]),
                     dict(gate=torch.tensor(True)),
                     dict(ids_guard=_guard(rec)), dict(windowed=False)):
            got = keys_of(**over)
            assert got[1] not in base, over
        # host frame values key by their type alone
        sigs = base[1][-1]
        assert sigs[-7:] == (float, int, float, float, float, float, float)


def test_scan_twin_reads_a_device_intrinsics_buffer():
    """The scan's intrinsics buffer stacked from 0-d tensors (a graphed
    window's principal point) equals the cached upload of the host
    numbers, and the plain twin reading it equals the benchmark's
    independent plain reference, which takes them by value, bit for bit,
    at a window's shifted principal point."""
    from mfbench.reference import kernels as ref_kernels

    pos, normal, radius, live, intr, max_depth = \
        chip_smoke.synthetic_scan_args("cpu")
    fx, fy, cx, cy = (float(v) for v in intr)
    for ox, oy in ((0, 0), (1, 2), (-2, 1)):
        host = kernels.intrinsics(
            CameraIntrinsics(fx, fy, cx - ox, cy - oy), "cpu")
        dev = kernels.intrinsics(
            CameraIntrinsics(fx, fy, torch.tensor(cx - ox),
                             torch.tensor(cy - oy)), "cpu")
        assert dev.dtype == torch.float32 and torch.equal(host, dev)
        z, s = kernels.predict_l0_scan_plain(pos, normal, radius, live, dev,
                                             max_depth)
        zr, sr = ref_kernels.predict_l0_scan_plain(
            pos, normal, radius, live, fx, fy, cx - ox, cy - oy, max_depth)
        assert torch.equal(z, zr) and torch.equal(s, sr)
        assert bool(torch.isfinite(z).any())


def test_graphed_window_matches_jax(scene):
    """The graphed windowed pass of object 2 on frame 4, against the JAX
    engine's `_fuse_clean_predict_obj_win` on the same state and the JAX
    engine's preprocessed frame, at the bounds of
    tests/test_torch_object_passes.py."""
    import jax.numpy as jnp

    from maskfusion_tpu.camera import CameraIntrinsics as JIntrinsics
    from maskfusion_tpu.camera import Resolution as JResolution
    from maskfusion_tpu.config import Config as JConfig
    from maskfusion_tpu.engine import MapState as JMapState
    from maskfusion_tpu.engine import MaskFusion as JMaskFusion
    from maskfusion_tpu.mapping import surfel_map as jsm
    from maskfusion_tpu_torch.engine import Preprocessed
    from maskfusion_tpu_torch.tracking import odometry as todo
    from tests.test_torch_object_passes import (_assert_maps_match,
                                                _assert_predictions_match)
    from tests.torch_helpers import n, t

    eng, rec = scene.eng, scene.rec
    fx, fy, cx, cy, w, h = chip_smoke.SMALL
    jeng = JMaskFusion(JResolution(w, h), JIntrinsics(fx, fy, cx, cy),
                       JConfig(**SLICE))
    rgb, depth, _ = scene.frames[4]
    seg = n(rec["seg"])
    pj = jeng._preprocess(jnp.asarray(rgb), jnp.asarray(depth),
                          jnp.asarray(n(eng._zero_mask)))
    prep = Preprocessed(
        filt_depth=t(pj.filt_depth), intensity=t(pj.intensity),
        levels=tuple({k: t(v) for k, v in lv.items()} for lv in pj.levels),
        frame_pyr=todo.FramePyramids(*(tuple(t(a) for a in f)
                                       for f in pj.frame_pyr)),
        vmap_raw=t(pj.vmap_raw))
    st = rec["objs"][1]
    mid, conf_t, max_d, wm, oy, ox = rec["params"][1].tolist()
    parity, bucket = rec["kw"]["parity"], BUCKETS["obj_bucket"]
    with cpu_graphs():
        got = eng.fuse_clean_predict_obj_win(
            clone_state(st), prep, rec["rgb"], rec["seg"], rec["prev"][2],
            rec["time"], int(mid), conf_t, max_d, wm, int(oy), int(ox),
            bucket, parity)
    jst = JMapState(
        jsm.SurfelMap(*(jnp.asarray(n(a)) for a in st.map[:7]),
                      count=jnp.asarray(n(st.map.count), jnp.int32)),
        *(jnp.asarray(n(a)) for a in st[1:]))
    want = jeng._fuse_clean_predict_obj_win(
        jst, pj, jnp.asarray(rgb), jnp.asarray(seg),
        jnp.asarray(n(rec["prev"][2])), rec["time"], jnp.uint8(int(mid)),
        conf_t, max_d, wm, jnp.int32(int(oy)), jnp.int32(int(ox)),
        bucket=bucket, parity=parity)
    _assert_maps_match(got.map, want.map, "object 2")
    _assert_predictions_match(got, want, "object 2")
    np.testing.assert_allclose(n(got.last_delta), n(want.last_delta),
                               atol=1e-6)
    assert not torch.equal(got.map.pos, st.map.pos)     # it fused


def test_hit_share_reads_the_counter(monkeypatch):
    from mfbench import harness, spans

    def counter(captured):
        return {"kind": "counter", "name": "fuse_graph", "id": 1,
                "start_ns": 0, "end_ns": 0, "parent": -1, "tid": 0,
                "values": {"captured": captured, "path": "window",
                           "slots": 1}}

    read = harness.load_reader("fuse_graph_hit_pct")
    monkeypatch.setattr(spans, "program_log",
                        lambda: [counter(1)] + [counter(0)] * 19)
    assert read(None) == pytest.approx(95.0)
    monkeypatch.setattr(spans, "program_log", lambda: [])
    assert read(None) is None
    monkeypatch.setattr(spans, "program_log", lambda: None)
    assert read(None) is None


# --------------------------------------------------------------- the card
@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms (warnings only where an op has none, as
    index_copy_'s dropped rows, which land on a row cut off), so two runs
    of the same work give the same bits."""
    was, warn = (torch.are_deterministic_algorithms_enabled(),
                 torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


@pytest.fixture(scope="module")
def vga():
    """The SLAM cell's engine on the card after its warm-up, and its last
    warm-up frame's fuse stage (prefused: gate and id guard) as called."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mfbench import harness
    from mfbench.drivers import slam

    dev = torch.device("cuda")
    cell = harness.load_cell("slam_two_objects")
    traffic = slam.SlamTraffic(cell.workload, cell.config, 2718281828, dev)
    eng = slam.make_engine(cell.config, traffic.intr, dev)
    rec = recording_stage(eng)
    n = cell.workload["traffic"]["warmup_frames"]
    for k in range(n):
        eng.process_frame(traffic.frame(k))
        if (k + 1) % 4 == 0:
            eng.drain_pipeline()
    eng.drain_pipeline()
    eng.fuse_stage = MaskFusion.fuse_stage.__get__(eng)
    torch.cuda.synchronize()
    kw = rec["kw"]
    assert kw["windowed"] and kw["gate"] is not None \
        and kw["ids_guard"] is not None
    live = [r for r in rec["params"] if int(r[0]) != DEAD_SLOT_ID]
    assert len(live) >= 1, rec["params"]
    return SimpleNamespace(eng=eng, rec=rec)


def _eager(eng):
    """The engine's fuse run eagerly on the card, on the same inputs."""
    def run(path, static, fn, inputs):
        return fn(*inputs)
    return run


CARD_CASES = {
    "prefused": {},
    "full_frame": dict(windowed=False),
    "gate_closed": dict(gate="closed"),
    "unguarded": dict(ids_guard=None, gate=None),
    "other_parity": dict(parity="flip"),
    "bucket_step": dict(glob_bucket="step", obj_bucket="step"),
}


def _card_case(rec, name):
    over = dict(CARD_CASES[name])
    kw = rec["kw"]
    if over.get("gate") == "closed":
        over["gate"] = torch.zeros_like(kw["gate"])
    if over.get("parity") == "flip":
        over["parity"] = 1 - kw["parity"]
    for b in ("glob_bucket", "obj_bucket"):
        if over.get(b) == "step":
            over[b] = 2 * kw[b]
    return over


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_replay_equals_eager_on_the_card(cuda_device, vga, case,
                                         monkeypatch):
    """The fuse stage replayed (captured where the key is new) against the
    eager stage on the same inputs: equal bits in every model's state
    under deterministic algorithms.  Without them the replay agrees with
    the eager stage within two eager runs' spread: the same counts."""
    eng, rec = vga.eng, vga.rec
    over = _card_case(rec, case)
    with deterministic():
        got = run_stage(eng, rec, **over)
        again = run_stage(eng, rec, **over)           # a replay
        with monkeypatch.context() as mp:
            mp.setattr(eng, "_fuse_graphed", _eager(eng))
            eager = run_stage(eng, rec, **over)
    torch.cuda.synchronize()
    for x, y in ((got, eager), (again, eager)):
        assert_same(x[0], y[0], f"{case} global")
        for k, (a, b) in enumerate(zip(x[1], y[1])):
            assert_same(a, b, f"{case} object {k}")
    fast = run_stage(eng, rec, **over)
    with monkeypatch.context() as mp:
        mp.setattr(eng, "_fuse_graphed", _eager(eng))
        e1, e2 = run_stage(eng, rec, **over), run_stage(eng, rec, **over)
    torch.cuda.synchronize()
    for st, a, b in zip((fast[0],) + fast[1], (e1[0],) + e1[1],
                        (e2[0],) + e2[1]):
        assert int(st.map.count) in (int(a.map.count), int(b.map.count))
        spread = float((a.map.pos - b.map.pos).abs().max())
        gap = min(float((st.map.pos - a.map.pos).abs().max()),
                  float((st.map.pos - b.map.pos).abs().max()))
        print(f"{case}: replay against eager {gap:.3e} m, eager against "
              f"eager {spread:.3e} m")


@pytest.mark.cuda
def test_spawn_replays_and_the_counters_count_on_the_card(cuda_device, vga):
    """Object slots of one bucket share one graph: a third live slot
    replays it.  Each graphed pass counts; the pools' bytes."""
    eng, rec = vga.eng, vga.rec
    run_stage(eng, rec)
    live = [k for k, r in enumerate(rec["params"])
            if int(r[0]) != DEAD_SLOT_ID]
    k = live[0]
    params = np.concatenate([rec["params"], rec["params"][k:k + 1]])
    three = dict(objs=rec["objs"] + (rec["objs"][k],), params=params,
                 prev=torch.cat([rec["prev"], rec["prev"][k + 1:k + 2]]))
    graphs_before = len(eng._fuse_graphs)
    replays, captures = eng.fuse_graph_replays, eng.fuse_graph_captures
    run_stage(eng, rec, **three)
    assert len(eng._fuse_graphs) == graphs_before
    assert eng.fuse_graph_captures == captures
    assert eng.fuse_graph_replays == replays + 1 + len(live) + 1
    assert eng.fuse_graph_captures == len(eng._fuse_graphs)
    pools = eng._track_graphs._pools
    assert eng._fuse_graphs._pools is pools
    assert {g.graph.pool() for g in eng._fuse_graphs._graphs.values()} \
        == {pools[torch.device("cuda", 0)]}
    print(f"fuse graphs {len(eng._fuse_graphs)}, their pool "
          f"{eng._fuse_graphs.pool_bytes} bytes; track graphs "
          f"{len(eng._track_graphs)}, {eng._track_graphs.pool_bytes} bytes")


@pytest.mark.cuda
def test_a_fuse_capture_never_waits_and_is_traced(cuda_device, vga):
    """A new key met inside a frame (a bucket step): its warm-up, capture
    and replay issue no synchronising call, also under the profiler, which
    records the counters of every replay and sees the replayed scans: as
    many ``scan_live`` counters as profiled scan kernels, and a launch
    count of one scan a pass."""
    from torch.profiler import ProfilerActivity, profile

    eng, rec = vga.eng, vga.rec
    step = dict(glob_bucket=4 * rec["kw"]["glob_bucket"],
                obj_bucket=4 * rec["kw"]["obj_bucket"])
    n_live = sum(int(r[0]) != DEAD_SLOT_ID for r in rec["params"])
    captures = eng.fuse_graph_captures
    stopwatch.clear_log()
    torch.cuda.synchronize()
    scans = kernels.predict_l0_scan.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run_stage(eng, rec, **step)           # captures
            run_stage(eng, rec, **step)           # replays
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert eng.fuse_graph_captures == captures + 1 + (n_live > 0)
    calls = [r["values"] for r in stopwatch.read_log()
             if r["kind"] == "counter" and r["name"] == "fuse_graph"]
    assert [c["captured"] for c in calls] == \
        [1] + [int(i == 0) for i in range(n_live)] + [0] * (1 + n_live)
    live = [r for r in stopwatch.read_log()
            if r["kind"] == "counter" and r["name"] == "scan_live"]
    profiled = sum(1 for e in prof.events()
                   if e.device_type != torch.autograd.DeviceType.CPU
                   and "predict_l0_scan" in e.name)
    assert len(live) == profiled == len(calls) + 1 + (n_live > 0)
    assert kernels.predict_l0_scan.launches == scans + len(calls)
    stopwatch.clear_log()
