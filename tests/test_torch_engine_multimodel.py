"""The port's synchronous multi-object frame: the scenarios of
tests/test_engine_multimodel.py at their bounds, the configurations of
later slices (Co-Fusion, redetection, relocalisation), and the slice's
device ops against the JAX engine's on a state carried across after a
spawn.  The lockstep run against the JAX engine (configuration `SLICE`,
defined here) is tests/test_torch_engine_multimodel_lockstep.py's."""

import numpy as np
import pytest

import maskfusion_tpu.cpp as jnative
from maskfusion_tpu.camera import Resolution as JResolution
from maskfusion_tpu.config import Config as JConfig
from maskfusion_tpu.engine import MaskFusion as JMaskFusion
from maskfusion_tpu.frame import FrameData as JFrameData
from maskfusion_tpu_torch.camera import Resolution
from maskfusion_tpu_torch.config import Config
from maskfusion_tpu_torch.convert import engine_snapshot, restore_engine
from maskfusion_tpu_torch.engine import MaskFusion
from maskfusion_tpu_torch.frame import FrameData
from tests import synthetic as syn
from tests.torch_helpers import CPU, tintr

BASE = dict(global_surfel_capacity=1 << 16, object_surfel_capacity=1 << 13,
            seg_method="precomputed", use_so3=False, open_loop=True)


def make_engine(**overrides) -> MaskFusion:
    """tests/test_engine_multimodel.py's make_engine, on the port."""
    return MaskFusion(Resolution(syn.W, syn.H), tintr(syn.DEFAULT_INTR),
                      Config(**{**BASE, **overrides}), device=CPU)


def logged(eng, i: int) -> np.ndarray:
    return eng.pose_log_numpy(i)[-1]


def run_moving_object(n_frames=6, step=0.008, cam_poses=None, **overrides):
    eng = make_engine(**overrides)
    if cam_poses is None:
        cam_poses = [np.eye(4, dtype=np.float32)] * n_frames
    offsets = []
    for i in range(n_frames):
        off = np.array([step * max(0, i - 1), 0.0, 0.0])
        offsets.append(off)
        pts, cols, labels = syn.make_scene_with_object(offset=off)
        rgb, depth, lab = syn.render(pts, cols, cam_poses[i],
                                     syn.DEFAULT_INTR, labels=labels)
        eng.process_frame(FrameData(rgb=rgb, depth=depth, mask=lab,
                                    class_ids=[0, 7], timestamp=float(i)))
    return eng, offsets


# ------------------------------------------------------------ scenarios
def test_object_model_spawns():
    eng, _ = run_moving_object(n_frames=3, step=0.0)
    assert len(eng.models) == 2
    obj = eng.models[1]
    assert obj.model_id == 1
    assert obj.class_id == 7
    assert obj.surfel_count > 50


def test_object_motion_tracked():
    eng, offsets = run_moving_object(n_frames=6, step=0.008)
    assert len(eng.models) >= 2
    est = logged(eng, 1)[:3, 3]
    true = offsets[-1] - offsets[1]
    assert np.linalg.norm(true) > 0.02
    err = np.linalg.norm(est - true)
    assert err < 0.025, f"object translation error {err * 1e3:.1f} mm"
    assert np.linalg.norm(eng.current_pose[:3, 3]) < 5e-3


@pytest.mark.parametrize("static_scene", [False, True],
                         ids=["default", "warm_start"])
def test_static_object_with_moving_camera(static_scene):
    """Default tracker: a catastrophic-drift guard (8 cm); the static-scene
    options (warm start, damping, finest-level photometrics): 6 mm."""
    poses = [syn.pose_from(np.zeros(3), np.array([0.004 * i, 0, 0]))
             for i in range(5)]
    opts = dict(object_warm_start=True, object_gn_damping=0.05,
                object_rgb_finest_only=True) if static_scene else {}
    eng, _ = run_moving_object(n_frames=5, step=0.0, cam_poses=poses, **opts)
    assert len(eng.models) >= 2
    est = logged(eng, 1)[:3, 3]
    assert np.linalg.norm(est) < (6e-3 if static_scene else 0.08), est
    assert np.linalg.norm(eng.current_pose[:3, 3] - poses[-1][:3, 3]) < 4e-3


def test_mask_gates_fusion():
    eng, _ = run_moving_object(n_frames=4, step=0.0)
    m = eng.download_map(1)
    assert np.abs(np.median(m["pos"][:, 2]) - 1.5) < 0.1
    assert m["pos"][:, 0].min() > -0.35 and m["pos"][:, 0].max() < 0.55


def test_spawn_subtraction_carves_global_map():
    counts = {}
    for flag in (False, True):
        eng, _ = run_moving_object(n_frames=3, step=0.0,
                                   spawn_subtraction=flag)
        assert len(eng.models) == 2
        counts[flag] = eng.models[0].surfel_count
    carved = counts[False] - counts[True]
    assert carved > 30, f"spawn subtraction removed only {carved} surfels"


def _two_object_frames(n, cam_step=0.0):
    frames = []
    for i in range(n):
        o1 = np.array([0.006 * max(0, i - 1), 0.0, 0.0])
        o2 = np.array([0.0, -0.006 * max(0, i - 2), 0.0])
        pts, cols, labels = syn.make_scene_with_two_objects(o1, o2)
        cam = syn.pose_from(np.zeros(3), np.array([cam_step * i, 0, 0]))
        frames.append(syn.render(pts, cols, cam, syn.DEFAULT_INTR,
                                 labels=labels) + (cam,))
    return frames


def test_two_objects():
    """Two live objects; batch_object_tracking=True (no object window at
    this size) tracks both in one solve over a slot axis and fuses them
    through the fuse stage, False runs the per-model loop: the two agree at
    the bounds of tests/test_engine_multimodel.py:172-201."""
    results = {}
    frames = _two_object_frames(5)
    for batched in (True, False):
        eng = make_engine(model_spawn_offset=0,
                          batch_object_tracking=batched)
        for i, (rgb, depth, lab, _) in enumerate(frames):
            eng.process_frame(FrameData(rgb=rgb, depth=depth, mask=lab,
                                        class_ids=[0, 7, 8],
                                        timestamp=float(i)))
        assert [m.model_id for m in eng.models] == [0, 1, 2]
        assert [m.class_id for m in eng.models[1:]] == [7, 8]
        results[batched] = [m.state.pose.numpy() for m in eng.models]
    np.testing.assert_allclose(results[True][0], results[False][0],
                               atol=1e-4)
    for pb, ps in zip(results[True][1:], results[False][1:]):
        np.testing.assert_allclose(pb, ps, atol=8e-3)


def test_jump_inactivates_and_ids_skip_reserved():
    eng, _ = run_moving_object(n_frames=3, step=0.0)
    obj = eng.models[1]
    eng._inactivate_model(obj, "test")
    # a young model's conf threshold is below min_conf_keep: not kept
    assert eng.models == [eng.models[0]] and eng.inactive_models == []
    eng.next_id = 252
    assert [eng._get_next_model_id(True) for _ in range(3)] == [252, 253, 1]


# --------------------------------------------- the slice's device ops
@pytest.fixture(scope="module")
def spawned_pair():
    """The JAX engine after a spawn, and the port's engine carried from it:
    a global map and an object map.  The tests below only read them."""
    jeng = JMaskFusion(JResolution(syn.W, syn.H), syn.DEFAULT_INTR,
                       JConfig(**{**BASE, "model_spawn_offset": 0}))
    frames = _two_object_frames(3)
    for i, (rgb, depth, lab, _) in enumerate(frames[:2]):
        jeng.process_frame(JFrameData(rgb=rgb, depth=depth, mask=lab,
                                      class_ids=[0, 7, 8],
                                      timestamp=float(i)))
    teng = make_engine(model_spawn_offset=0)
    restore_engine(teng, engine_snapshot(jeng))
    return jeng, teng, frames


def test_project_and_combine_ids_match_jax(spawned_pair):
    """project_ids (the conf-12 render gate and combined_predict) per model
    and combine_ids' argmin: the same uint8 id image, depths to 1e-5 where
    both show a surface (the scan's tie bound elsewhere)."""
    import jax.numpy as jnp
    import torch

    jeng, teng, _ = spawned_pair
    time = float(jeng.tick + 1)
    depths_j, depths_t = [], []
    for mj, mt in zip(jeng.models, teng.models):
        depths_j.append(jeng._project_ids(mj.state.map, mj.state.pose, time,
                                          5.0, bucket=1 << 16 if
                                          mj.model_id == 0 else 1 << 13))
        depths_t.append(teng.project_ids(mt.state.map, mt.state.pose, time,
                                         5.0, bucket=mt.state.map.capacity))
    for k, (dj, dt) in enumerate(zip(depths_j, depths_t)):
        dj, dt = np.asarray(dj), dt.numpy()
        both = np.isfinite(dj) & np.isfinite(dt)
        gap = np.abs(np.where(both, dj, 0.0) - np.where(both, dt, 0.0))
        differ = (np.isfinite(dj) != np.isfinite(dt)) | (gap > 1e-5)
        # a young global map stays under confidence 12; objects, spawned
        # at weight 100, show
        assert both.any() == (k > 0)
        assert differ.mean() < 3e-3
    ids = [m.model_id for m in jeng.models]
    ij = np.asarray(jeng._combine_ids(depths_j, jnp.asarray(ids, jnp.int32)))
    it = MaskFusion.combine_ids(
        [torch.from_numpy(np.array(d)) for d in depths_j],
        torch.tensor(ids, dtype=torch.int32)).numpy()
    assert it.dtype == np.uint8
    np.testing.assert_array_equal(it, ij)
    assert {1} <= set(np.unique(it))


@pytest.mark.parametrize("max_time", [None, 1.0])
def test_render_gates_match_jax(spawned_pair, max_time):
    """render_index_map's conf_threshold and max_time gates, as the JAX
    package's (maskfusion_tpu/ops/splat.py:63-90), at a threshold that
    splits the global map's confidences."""
    import jax.numpy as jnp
    import torch

    from maskfusion_tpu.ops import splat as jsplat
    from maskfusion_tpu_torch.ops import splat as tsplat

    jeng, teng, _ = spawned_pair
    mj, mt = jeng.models[0].state.map, teng.models[0].state.map
    c = int(mt.count)
    conf, seen = mt.conf.numpy()[:c], mt.last_seen.numpy()[:c]
    assert max_time is None or seen.min() <= max_time < seen.max()
    kw = dict(time=float(jeng.tick), time_delta=200, max_depth=5.0,
              conf_threshold=float(np.median(conf)), max_time=max_time)
    imj = jsplat.render_index_map(mj, jnp.eye(4), syn.DEFAULT_INTR, syn.H,
                                  syn.W, **kw)
    imt = tsplat.render_index_map(mt, torch.eye(4), tintr(syn.DEFAULT_INTR),
                                  syn.H, syn.W, **kw)
    ij, it = np.asarray(imj.index), imt.index.numpy()
    assert (ij == it).mean() > 1 - 1e-3
    plain = tsplat.render_index_map(mt, torch.eye(4),
                                    tintr(syn.DEFAULT_INTR), syn.H, syn.W,
                                    float(jeng.tick), 200, 5.0)
    # the gates take pixels away, never add any
    assert (it >= 0).sum() < (plain.index.numpy() >= 0).sum()


def test_erase_error_geometry_matches_jax(spawned_pair):
    """Spawn subtraction on the global map: the same surfels carved."""
    import jax.numpy as jnp
    import torch

    from maskfusion_tpu.ops import clean as jclean
    from maskfusion_tpu_torch.ops import clean as tclean

    jeng, teng, frames = spawned_pair
    _, depth, lab, _ = frames[2]
    seg = np.where(lab == 1, 1, 0).astype(np.uint8)
    pose_inv = np.eye(4, dtype=np.float32)
    mj, mt = jeng.models[0].state.map, teng.models[0].state.map
    oj, rj = jclean.erase_error_geometry(
        mj, jnp.asarray(seg), jnp.uint8(1), jnp.asarray(depth),
        jnp.asarray(pose_inv), syn.DEFAULT_INTR, 0.05)
    ot, rt = tclean.erase_error_geometry(
        mt, torch.from_numpy(seg), 1, torch.from_numpy(depth),
        torch.from_numpy(pose_inv), tintr(syn.DEFAULT_INTR), 0.05)
    assert int(rt) == int(rj) > 30
    c = int(oj.count)
    assert int(ot.count) == c
    np.testing.assert_allclose(ot.pos.numpy()[:c], np.asarray(oj.pos)[:c],
                               atol=1e-6)


# ------------------------------- the configurations of later slices run
# the pipelined schedules (tests/test_torch_pipelined*.py), Co-Fusion, with
# them or not (in the synchronous frame), redetection and relocalisation
# all run; the VGA case only constructs the engine
@pytest.mark.parametrize("overrides,res,run", [
    (dict(seg_method="cofusion", pipelined_multiobject=True), (160, 120),
     True),
    (dict(seg_method="maskfusion", pipelined_multiobject=True,
          enable_redetection=True), (640, 480), False),
    (dict(seg_method="cofusion"), (160, 120), True),
    (dict(enable_redetection=True), (160, 120), True),
    (dict(relocalisation=True), (160, 120), True),
], ids=["pipelined", "pipelined_vga", "cofusion", "redetection",
        "relocalisation"])
def test_unported_configurations_raise(overrides, res, run):
    """Every configuration is ported: none raises.  One with `run` runs two
    frames of tests/synthetic.py's scene in the synchronous frame (ferns
    force it under relocalisation); redetection keeps a matcher for the
    models it makes inactive, relocalisation a fern database."""
    cfg = Config(**{**BASE, **overrides})
    eng = MaskFusion(Resolution(*res), tintr(syn.DEFAULT_INTR), cfg,
                     device=CPU)
    assert (eng.ferns is not None) == bool(cfg.relocalisation)
    if not run:
        return
    pts, cols = syn.make_scene()
    rgb, depth = syn.render(pts, cols, np.eye(4), syn.DEFAULT_INTR)
    for i in range(2):
        out = eng.process_frame(FrameData(rgb=rgb, depth=depth,
                                          timestamp=float(i)))
    assert out["tracking_ok"] and out["model_ids"] == [0]
    assert not out.get("lost")
    if cfg.relocalisation:
        assert len(eng.ferns.frames) == 1
    assert eng.last_segmentation.shape == (res[1], res[0])


@pytest.mark.parametrize("argv", [
    None,
    ["-method", "maskfusion", "--pipeline", "off"],
    ["-method", "precomputed"],
    ["-method", "maskfusion"],
    [],
], ids=["bench_sync", "cli_maskfusion_sync", "cli_precomputed",
        "cli_maskfusion_prefused", "cli_defaults"])
def test_vga_default_object_passes_construct(argv):
    """At 640x480 the default batch_object_tracking=True with the default
    320-pixel object window constructs: bench.py's two-object configuration
    in the synchronous schedule, and the CLI's multi-object methods that run
    it, the default pipelined schedule among them.  No frame runs (no map
    is allocated before the first frame)."""
    from maskfusion_tpu_torch import main as cli

    if argv is None:
        cfg = Config(seg_method="maskfusion", pipelined_multiobject=False,
                     global_surfel_capacity=1 << 22,
                     object_surfel_capacity=1 << 19, model_spawn_offset=2,
                     min_object_slots=2)
    else:
        cfg = cli.make_config(cli.build_parser().parse_args(argv))
    assert cfg.batch_object_tracking and cfg.object_window == 320
    eng = MaskFusion(Resolution(640, 480), tintr(syn.DEFAULT_INTR), cfg,
                     device=CPU)
    assert eng._obj_window == 320 and eng.models == []


# ------------------------------------------------------------- lockstep
SLICE = dict(BASE, seg_method="maskfusion", pipelined_multiobject=False,
             batch_object_tracking=False, model_spawn_offset=0)
