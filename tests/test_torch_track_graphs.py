"""The tracking solves as CUDA graphs (tracking/graphs, engine._graphed).

On the CPU: the graphs' keys (what a graph bakes in, and what it takes as
an input), the runner's copies and clones through a stand-in graph that
re-runs the function, the metric that reads the ``track_graph`` counter,
and the engine's tracks running eagerly there.  The tests marked `cuda`
hold the replays against the eager solve on the card at VGA (the SLAM
cell's engine after its warm-up): the global track and the windowed
object track at 1, 2 and 3 slots (equal bits: the captured kernels are
the eager ones), new inputs, outputs that outlive the next replay, one
capture a key, and a capture that neither synchronises nor fails under
the profiler.  This file imports nothing of JAX, so it
also runs where JAX is absent: `pytest --noconftest -m cuda
tests/test_torch_track_graphs.py`."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from maskfusion_tpu_torch.camera import CameraIntrinsics, Resolution
from maskfusion_tpu_torch.config import Config
from maskfusion_tpu_torch.engine import MapState, MaskFusion
from maskfusion_tpu_torch.tracking import graphs


@pytest.fixture
def cuda_device():
    """A CUDA device for the tests marked `cuda`; they skip where there is
    none.  The decision is taken here, never while the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (on a machine with one: pytest "
                    "--noconftest -m cuda tests/test_torch_track_graphs.py)")
    return torch.device("cuda")


# ---------------------------------------------------------------- the CPU
def small_engine():
    fx, fy, cx, cy, w, h = chip_smoke.SMALL
    return MaskFusion(Resolution(w, h), CameraIntrinsics(fx, fy, cx, cy),
                      Config(global_surfel_capacity=1 << 12,
                             object_surfel_capacity=1 << 10,
                             seg_method="maskfusion", object_window=104,
                             object_window_margin=24, min_object_slots=2),
                      device="cpu")


def small_inputs(eng):
    """A preprocessed frame and a model state whose predictions are that
    frame's own maps."""
    rgb, depth, _ = chip_smoke.synthetic_depth()
    rgb = torch.from_numpy(np.ascontiguousarray(rgb))
    prep = eng.preprocess(rgb, torch.from_numpy(depth), eng._zero_mask)
    lv = prep.levels[0]
    state = MapState(None, torch.eye(4), torch.eye(4), lv["vmap"],
                     lv["nmap"], rgb.to(torch.float32),
                     prep.frame_pyr.intensities[-1])
    return prep, state


@pytest.fixture(scope="module")
def keyed():
    """The keys of the engine's graphed solves on the CPU, recorded through
    `_graphed` (which runs them eagerly there), by call."""
    eng = small_engine()
    prep, st = small_inputs(eng)
    moved = st._replace(pose=st.pose.clone(), pred_vmap=st.pred_vmap + 0.01)
    keys = {}
    graphed = eng._graphed

    def record(name):
        def rec(path, is_object, fn, inputs, slots):
            keys[name] = eng._graph_key(path, is_object, inputs)
            return graphed(path, is_object, fn, inputs, slots)
        eng._graphed = rec

    ids2 = torch.tensor([1, 2], dtype=torch.int32)
    win2 = [(0, 0), (10, 40)]
    org2 = torch.tensor([[0.0, 0.0], [10.0, 40.0]])
    calls = {
        "global": lambda: eng.track(st, prep, 0),
        "global_moved": lambda: eng.track(moved, prep, 0),
        "one_object_id3": lambda: eng.track(st, prep, 3, is_object=True),
        "one_object_id9": lambda: eng.track(st, prep, 9, is_object=True),
        "one_object_warm": lambda: eng.track(st, prep, 3, is_object=True,
                                             warm=torch.eye(4)),
        "batched2_list": lambda: eng.track_objects([st, st], [1, 2], prep),
        "batched2_tensor": lambda: eng.track_objects([st, moved], ids2,
                                                     prep),
        "batched3": lambda: eng.track_objects([st, st, st], [1, 2, 3], prep),
        "win2": lambda: eng.track_objects_win([st, st], ids2, win2, org2,
                                              prep),
        "win2_moved": lambda: eng.track_objects_win(
            [moved, st], ids2.flip(0), [(8, 16), (0, 56)],
            torch.tensor([[8.0, 16.0], [0.0, 56.0]]), prep),
        "win1": lambda: eng.track_objects_win([st], ids2[:1], win2[:1],
                                              org2[:1], prep),
    }
    out = {}
    for name, call in calls.items():
        record(name)
        out[name] = call()
    eng._graphed = graphed
    return SimpleNamespace(eng=eng, keys=keys, out=out)


def test_equal_shapes_share_a_key(keyed):
    k = keyed.keys
    assert k["global"] == k["global_moved"]
    assert k["batched2_list"] == k["batched2_tensor"]
    assert k["win2"] == k["win2_moved"]


def test_slots_shape_path_and_options_part_keys(keyed):
    k = keyed.keys
    distinct = ["global", "one_object_id3", "one_object_warm",
                "batched2_list", "batched3", "win2", "win1"]
    assert len({k[n] for n in distinct}) == len(distinct)


def test_a_host_mask_id_keys_by_its_type_alone(keyed):
    k = keyed.keys
    assert k["one_object_id3"] == k["one_object_id9"]
    # the host int enters as an input (filled into a device value on a
    # card), never as a value of the key
    sigs = k["one_object_id3"][-1]
    assert int in sigs and 3 not in sigs and 9 not in sigs


def test_cpu_tracks_run_eagerly_and_capture_nothing(keyed):
    eng = keyed.eng
    assert (eng.track_graph_replays, eng.track_graph_captures,
            len(eng._track_graphs)) == (0, 0, 0)
    res = keyed.out["global"]
    assert res.pose.device.type == "cpu"
    assert torch.isfinite(res.pose).all() and res.cov_diag.shape == (6,)
    poses, jumps = keyed.out["win2"]
    assert poses.shape == (2, 4, 4) and jumps.shape == (2,)


class _Replayer:
    """A stand-in for a CUDA graph on the CPU: a replay runs the function
    again on the static buffers and writes the flat output."""

    def __init__(self, fn, static, flat):
        self.fn, self.static, self.flat = fn, static, flat

    def replay(self):
        self.flat.copy_(graphs.flatten(self.fn(*self.static))[0])


def _stand_in_capture(self, fn, inputs, keep):
    static = [graphs._static_copy(x, torch.device("cpu")) for x in inputs]
    flat, layout = graphs.flatten(fn(*static))
    return graphs._Graph(_Replayer(fn, static, flat), static, flat, layout,
                         0, keep())


def test_runner_copies_inputs_and_clones_outputs(monkeypatch):
    monkeypatch.setattr(graphs.SolveGraphs, "_capture", _stand_in_capture)
    g = graphs.SolveGraphs()

    def fn(a, k, none):
        assert none is None
        return a * k, (a * k).sum()

    a = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    kept = []
    key = graphs.graph_key(("f",), (a, 2, None))
    (prod, total), captured = g.run(key, fn, (a, 2, None),
                                    keep=lambda: kept.append(1) or (7,))
    assert captured and kept == [1] and len(g) == 1
    assert torch.equal(prod, a * 2) and float(total) == 30.0
    before = prod.clone()
    b = -a
    key_b = graphs.graph_key(("f",), (b, 5, None))
    assert key_b == key
    (prod_b, total_b), captured = g.run(key_b, fn, (b, 5, None))
    assert not captured and kept == [1] and len(g) == 1
    # the new inputs give the new answer; the earlier output is its own
    assert torch.equal(prod_b, b * 5) and float(total_b) == -75.0
    assert torch.equal(prod, before)
    flat = g._graphs[key].flat
    assert prod_b.untyped_storage().data_ptr() != \
        flat.untyped_storage().data_ptr()
    assert prod_b.untyped_storage().data_ptr() == \
        total_b.untyped_storage().data_ptr()      # one clone for all fields
    (_, _), captured = g.run(graphs.graph_key(("f",), (a[:1], 2, None)), fn,
                             (a[:1], 2, None))
    assert captured and len(g) == 2


def test_key_signatures():
    t = torch.zeros(2, 3)
    assert graphs.signature(t) == ((2, 3), torch.float32, t.device)
    assert graphs.signature(4) is int and graphs.signature(None) is None
    assert graphs.graph_key((1,), (t, 4)) == graphs.graph_key((1,), (t + 1,
                                                                      8))
    assert graphs.graph_key((1,), (t, 4)) != graphs.graph_key(
        (1,), (t.to(torch.float64), 4))
    with pytest.raises(TypeError):
        graphs.signature("7")


def test_hit_share_reads_the_counter(monkeypatch):
    from mfbench import harness, spans

    def counter(captured):
        return {"kind": "counter", "name": "track_graph", "id": 1,
                "start_ns": 0, "end_ns": 0, "parent": -1, "tid": 0,
                "values": {"captured": captured, "slots": 2}}

    read = harness.load_reader("track_graph_hit_pct")
    monkeypatch.setattr(spans, "program_log",
                        lambda: [counter(1), counter(0), counter(0),
                                 counter(0)])
    assert read(None) == pytest.approx(75.0)
    monkeypatch.setattr(spans, "program_log", lambda: [])
    assert read(None) is None
    monkeypatch.setattr(spans, "program_log", lambda: None)
    assert read(None) is None


# --------------------------------------------------------------- the card
def _rotation_rad(Ra, Rb) -> float:
    """The angle between two rotations, in float64."""
    d = (Ra.double().mT @ Rb.double())
    c = ((d.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0).clamp(-1, 1)
    # acos loses precision near 0: the skew part's norm is sin(angle)
    s = torch.linalg.vector_norm(torch.stack(
        [d[..., 2, 1] - d[..., 1, 2], d[..., 0, 2] - d[..., 2, 0],
         d[..., 1, 0] - d[..., 0, 1]], -1), dim=-1) / 2.0
    return float(torch.atan2(s, c).abs().max())


def _pose_gap(Pa, Pb):
    """(translation gap in m, rotation gap in rad, bit-equal?)"""
    return (float((Pa[..., :3, 3].double() - Pb[..., :3, 3].double())
                  .norm(dim=-1).max()),
            _rotation_rad(Pa[..., :3, :3], Pb[..., :3, :3]),
            bool(torch.equal(Pa, Pb)))


@pytest.fixture(scope="module")
def vga(request):
    """The SLAM cell's engine on the card after its warm-up, and the next
    frames preprocessed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mfbench import harness
    from mfbench.drivers import slam

    dev = torch.device("cuda")
    cell = harness.load_cell("slam_two_objects")
    traffic = slam.SlamTraffic(cell.workload, cell.config, 3141592653, dev)
    eng = slam.make_engine(cell.config, traffic.intr, dev)
    for k in range(cell.workload["traffic"]["warmup_frames"]):
        eng.process_frame(traffic.frame(k))
        if (k + 1) % 4 == 0:
            eng.drain_pipeline()
    eng.drain_pipeline()
    torch.cuda.synchronize()
    preps = []
    for k in (20, 21):
        f = eng.upload_frame(traffic.frame(k))
        rgb, depth = eng._device_frame(f)
        preps.append(eng.preprocess(rgb, depth, eng._prev_seg()))
    torch.cuda.synchronize()
    return SimpleNamespace(eng=eng, preps=preps)


def _eager(eng):
    """The engine with its graphed solves run eagerly on the card."""
    def run(path, is_object, fn, inputs, slots):
        return fn(*inputs)
    return run


def _objects(vga, n):
    """n windowed object slots over the engine's live objects (repeated
    where there are fewer), as the pipelined device stage passes them."""
    objs = vga.eng.models[1:]
    assert objs and all(m.window is not None for m in objs), \
        [(m.model_id, m.window) for m in objs]
    pick = [objs[i % len(objs)] for i in range(n)]
    dev = vga.eng.device
    ids = torch.tensor([m.model_id for m in pick], dtype=torch.int32,
                       device=dev)
    windows = [m.window for m in pick]
    origins = torch.tensor(windows, dtype=torch.float32, device=dev)
    return [m.state for m in pick], ids, windows, origins


def _track_win(eng, vga, n, prep, objects=None):
    states, ids, windows, origins = objects or _objects(vga, n)
    return eng.track_objects_win(states, ids, windows, origins, prep)


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["global", "win1", "win2", "win3",
                                  "one_object", "batched2"])
def test_replay_equals_the_eager_solve(cuda_device, vga, what, monkeypatch):
    """The global track, the windowed object track at 1-3 slots, and the
    full-frame object tracks (one object with its host mask id; two in
    one solve)."""
    eng = vga.eng
    prep = vga.preps[0]
    objs = eng.models[1:]

    def call():
        if what == "global":
            return eng.track(eng.models[0].state, prep, 0).pose
        if what == "one_object":
            return eng.track(objs[0].state, prep, objs[0].model_id,
                             is_object=True).pose
        if what == "batched2":
            pick = [objs[0], objs[-1]]
            return eng.track_objects([m.state for m in pick],
                                     [m.model_id for m in pick], prep)[0]
        return _track_win(eng, vga, int(what[-1]), prep)[0]

    graphed = call()         # captures where the key is new, then replays
    again = call()           # a replay
    monkeypatch.setattr(eng, "_graphed", _eager(eng))
    eager = call()
    torch.cuda.synchronize()
    dt, dr, same = _pose_gap(graphed, eager)
    print(f"{what}: replay against eager: {dt:.3e} m, {dr:.3e} rad, "
          f"equal bits {same}")
    assert torch.equal(graphed, again)
    # the captured kernels are the eager ones, on the same inputs
    assert same, (dt, dr)


@pytest.mark.cuda
def test_new_inputs_new_answer_and_outputs_outlive_replays(cuda_device, vga,
                                                           monkeypatch):
    eng = vga.eng
    glob = eng.models[0].state
    a = eng.track(glob, vga.preps[0], 0)
    kept = [t.clone() for t in a]
    b = eng.track(glob, vga.preps[1], 0)              # a replay
    wa = _track_win(eng, vga, 2, vga.preps[0])
    wkept = [t.clone() for t in wa]
    wb = _track_win(eng, vga, 2, vga.preps[1])
    torch.cuda.synchronize()
    # what an earlier call returned is unchanged by later replays
    assert all(torch.equal(x, y) for x, y in zip(a, kept))
    assert all(torch.equal(x, y) for x, y in zip(wa, wkept))
    for out in (a, b, wa, wb):
        for g in eng._track_graphs._graphs.values():
            assert out[0].untyped_storage().data_ptr() != \
                g.flat.untyped_storage().data_ptr()
    monkeypatch.setattr(eng, "_graphed", _eager(eng))
    eb = eng.track(glob, vga.preps[1], 0)
    ewb = _track_win(eng, vga, 2, vga.preps[1])
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(b, eb))
    assert all(torch.equal(x, y) for x, y in zip(wb, ewb))
    assert not torch.equal(a.pose, b.pose)        # another frame, another pose


@pytest.mark.cuda
def test_each_key_captures_once_and_the_counters_count(cuda_device, vga):
    eng = vga.eng
    glob = eng.models[0].state
    for _ in range(2):
        eng.track(glob, vga.preps[0], 0)
        _track_win(eng, vga, 2, vga.preps[0])
    graphs_before = len(eng._track_graphs)
    replays, captures = eng.track_graph_replays, eng.track_graph_captures
    for prep in vga.preps:
        eng.track(glob, prep, 0)
        _track_win(eng, vga, 2, prep)
    assert len(eng._track_graphs) == graphs_before
    assert eng.track_graph_captures == captures
    assert eng.track_graph_replays == replays + 4
    # a new slot count is a new key: one capture, then replays
    _track_win(eng, vga, 4, vga.preps[0])
    _track_win(eng, vga, 4, vga.preps[1])
    assert len(eng._track_graphs) == graphs_before + 1
    assert eng.track_graph_captures == captures + 1
    assert eng.track_graph_replays == replays + 6
    assert eng.track_graph_captures == len(eng._track_graphs)
    # every graph of the card was captured into the one pool of the card
    pools = eng._track_graphs._pools
    assert list(pools) == [torch.device("cuda", 0)]
    assert {g.graph.pool() for g in eng._track_graphs._graphs.values()} \
        == {pools[torch.device("cuda", 0)]}
    print(f"graphs {len(eng._track_graphs)}, their pool "
          f"{eng._track_graphs.pool_bytes} bytes")


@pytest.mark.cuda
def test_a_capture_never_waits_and_is_traced(cuda_device, vga):
    """A new key met inside a frame: its warm-up, capture and replay issue
    no synchronising call (none under torch.cuda.set_sync_debug_mode
    ("error")), also under the harness's profiler, which records the
    counter and sees the replayed kernels."""
    from torch.profiler import ProfilerActivity, profile

    from maskfusion_tpu_torch.utils import stopwatch

    eng = vga.eng
    captures = eng.track_graph_captures
    objects = _objects(vga, 5)
    stopwatch.clear_log()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _track_win(eng, vga, 5, vga.preps[0], objects)    # a capture
            _track_win(eng, vga, 5, vga.preps[1], objects)    # a replay
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert eng.track_graph_captures == captures + 1
    calls = [r["values"] for r in stopwatch.read_log()
             if r["kind"] == "counter" and r["name"] == "track_graph"]
    assert calls == [{"captured": 1, "slots": 5},
                     {"captured": 0, "slots": 5}]
    kernels = [e for e in prof.events()
               if e.device_type != torch.autograd.DeviceType.CPU]
    print(f"traced device events {len(kernels)}")
    assert len(kernels) > 1000
