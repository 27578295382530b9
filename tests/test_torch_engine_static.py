"""The port's -static engine end to end on the synthetic 160x120 trajectory
of tests/test_engine_static.py: the same ATE and map bounds, and frame by
frame against the JAX engine from the same carried-over state."""

import numpy as np

from maskfusion_tpu.camera import Resolution as JResolution
from maskfusion_tpu.config import Config as JConfig
from maskfusion_tpu.engine import MaskFusion as JMaskFusion
from maskfusion_tpu.frame import FrameData as JFrameData
from maskfusion_tpu_torch.camera import Resolution
from maskfusion_tpu_torch.config import Config
from maskfusion_tpu_torch.convert import map_state_from_numpy
from maskfusion_tpu_torch.engine import MaskFusion
from maskfusion_tpu_torch.frame import FrameData
from tests import synthetic as syn
from tests.test_engine_static import make_trajectory
from tests.torch_helpers import CPU, tintr

CFG = dict(global_surfel_capacity=1 << 16, static_mode=True, use_so3=False)


def _frames(n=6):
    pts, cols = syn.make_scene()
    poses = make_trajectory(n)
    return poses, [syn.render(pts, cols, p, syn.DEFAULT_INTR) for p in poses]


def test_static_slam_trajectory():
    """tests/test_engine_static.py::test_static_slam_trajectory, on the
    port (CPU, plain kernel versions): ATE < 5 mm, final rotation < 0.5 deg,
    bounded map growth, map within 1 cm of the scene."""
    engine = MaskFusion(Resolution(syn.W, syn.H), tintr(syn.DEFAULT_INTR),
                        Config(**CFG), device=CPU)
    poses, frames = _frames()
    diags = [engine.process_frame(FrameData(rgb=rgb, depth=depth,
                                            timestamp=float(i)))
             for i, (rgb, depth) in enumerate(frames)]
    diags[-1].update(engine.flush_diagnostics())
    logged = engine.pose_log_numpy()
    errs = [np.linalg.norm(p[:3, 3] - gt[:3, 3])
            for p, gt in zip(logged, poses)]
    ate_rmse = np.sqrt(np.mean(np.square(errs)))
    assert ate_rmse < 5e-3, f"ATE RMSE {ate_rmse*1000:.2f}mm"
    assert syn.rotation_angle_deg(logged[-1][:3, :3], poses[-1][:3, :3]) < 0.5
    assert all(d["tracking_ok"] for d in diags)
    assert diags[-1]["surfels"] < 1.6 * diags[0]["surfels"]
    m = engine.download_map()
    sample = m["pos"][:: max(1, len(m["pos"]) // 500)]
    X, Y = sample[:, 0], sample[:, 1]
    Z = (2.0 + 0.25 * np.sin(2.2 * X) + 0.18 * np.cos(3.1 * Y)
         + 0.05 * np.sin(7 * X * Y))
    in_range = (np.abs(X) < 1.5) & (np.abs(Y) < 1.2)
    zerr = np.abs(sample[:, 2] - Z)[in_range]
    assert np.median(zerr) < 0.01, f"map-to-scene median error {np.median(zerr)}"


def _rot_deg(Ra, Rb):
    return syn.rotation_angle_deg(Ra, Rb)


def test_engine_parity_with_jax():
    """Both engines from the same state: the JAX engine initialises the map
    on frame 1, its state crosses over with map_state_from_numpy, and both
    run frames 2-6.  Per frame the pose agrees to 1 mm and 0.05 deg and the
    surfel count to 1%."""
    poses, frames = _frames()
    jeng = JMaskFusion(JResolution(syn.W, syn.H), syn.DEFAULT_INTR,
                       JConfig(**CFG))
    rgb, depth = frames[0]
    jeng.process_frame(JFrameData(rgb=rgb, depth=depth, timestamp=0.0))
    js = jeng.global_model.state
    flat = {k: np.asarray(v) for k, v in js.map._asdict().items()}
    flat.update({k: np.asarray(getattr(js, k))
                 for k in js._fields if k != "map"})

    teng = MaskFusion(Resolution(syn.W, syn.H), tintr(syn.DEFAULT_INTR),
                      Config(**CFG), device=CPU)
    teng.load_state(map_state_from_numpy(flat, CPU), tick=jeng.tick)
    assert teng.global_model.surfel_count == jeng.global_model.surfel_count

    for i, (rgb, depth) in enumerate(frames[1:], start=1):
        jeng.process_frame(JFrameData(rgb=rgb, depth=depth,
                                      timestamp=float(i)))
        teng.process_frame(FrameData(rgb=rgb, depth=depth,
                                     timestamp=float(i)))
        dj, dt = jeng.flush_diagnostics(), teng.flush_diagnostics()
        pj, pt = jeng.current_pose, teng.current_pose
        dpos = np.linalg.norm(pt[:3, 3] - pj[:3, 3])
        drot = _rot_deg(pt[:3, :3], pj[:3, :3])
        assert dpos <= 1e-3, f"frame {i}: pose differs by {dpos*1e3:.3f} mm"
        assert drot <= 0.05, f"frame {i}: rotation differs by {drot:.4f} deg"
        assert abs(dt["surfels"] - dj["surfels"]) <= 0.01 * dj["surfels"], \
            (i, dt["surfels"], dj["surfels"])
        assert dt["tracking_ok"] == dj["tracking_ok"]
