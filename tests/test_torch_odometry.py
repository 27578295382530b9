"""Port parity of tracking/odometry (and ops/reduce under it): the pose
pairs of tests/test_odometry.py through both packages, each package running
its own preprocessing on the same rendered frames.

Held at the reference schedule (assoc_period=1, no early exit) and at the
shipping one (assoc_period=5, gn_step_eps=1e-6).  The pose must agree to
2e-5 (m and rad): both solve the same Gauss-Newton problem in f32, and only
the order of the large reductions differs."""

import numpy as np
import jax.numpy as jnp
import pytest

from maskfusion_tpu.ops import preprocess as jpp
from maskfusion_tpu.tracking import odometry as jodo
from maskfusion_tpu_torch.ops import preprocess as tpp
from maskfusion_tpu_torch.tracking import odometry as todo
from tests import synthetic as syn
from tests.torch_helpers import n, t, tintr

INTR = syn.DEFAULT_INTR
TINTR = tintr(INTR)
SCENE = syn.make_scene()
EYE = np.eye(4, dtype=np.float32)

SCHEDULES = {"reference": dict(assoc_period=1, gn_step_eps=0.0),
             "shipping": dict(assoc_period=5, gn_step_eps=1e-6)}


def _jax_track(rgb_a, depth_a, rgb_b, depth_b, pose_a, use_so3, **kw):
    def prep(rgb, depth):
        filt = jpp.bilateral_filter_depth(jnp.asarray(depth))
        gray = jpp.rgb_to_intensity(jnp.asarray(rgb))
        return jpp.build_frame_pyramids(
            filt, gray, jnp.zeros(depth.shape, jnp.uint8), INTR, 5.0, 3)

    lb, la = prep(rgb_b, depth_b), prep(rgb_a, depth_a)
    frame = jodo.build_frame_pyramids_for_odometry(lb, jnp.asarray(rgb_b))
    model = jodo.build_model_pyramids(la[0]["vmap"], la[0]["nmap"],
                                      jnp.asarray(rgb_a), jnp.asarray(pose_a))
    so3 = tuple(l["intensity"] for l in la) if use_so3 else None
    return jodo.get_incremental_transformation(
        jnp.asarray(pose_a[:3, 3]), jnp.asarray(pose_a[:3, :3]), frame,
        model, so3, INTR, use_so3=use_so3, mask_id=jnp.uint8(0), **kw)


def _torch_track(rgb_a, depth_a, rgb_b, depth_b, pose_a, use_so3, **kw):
    def prep(rgb, depth):
        filt = tpp.bilateral_filter_depth(t(depth))
        gray = tpp.rgb_to_intensity(t(rgb))
        return tpp.build_frame_pyramids(
            filt, gray, t(np.zeros(depth.shape, np.uint8)), TINTR, 5.0, 3)

    lb, la = prep(rgb_b, depth_b), prep(rgb_a, depth_a)
    frame = todo.build_frame_pyramids_for_odometry(lb, t(rgb_b))
    model = todo.build_model_pyramids(la[0]["vmap"], la[0]["nmap"], t(rgb_a),
                                      t(pose_a))
    so3 = tuple(l["intensity"] for l in la) if use_so3 else None
    return todo.get_incremental_transformation(
        t(pose_a[:3, 3]), t(pose_a[:3, :3]), frame, model, so3, TINTR,
        use_so3=use_so3, mask_id=0, **kw)


CASES = {
    "identity": (np.zeros(3), np.zeros(3), {}),
    "tx": (np.zeros(3), np.array([0.01, 0.0, 0.0]), {}),
    "ry": (np.array([0.0, 0.015, 0.0]), np.zeros(3), {}),
    "mixed": (np.array([0.01, -0.008, 0.005]),
              np.array([0.008, -0.006, 0.012]), {}),
    "so3": (np.array([0.0, 0.03, 0.0]), np.zeros(3), {"use_so3": True}),
    "icp_only": (np.array([0.0, 0.0, 0.008]), np.array([0.005, 0.0, 0.0]),
                 {"icp_weight": 100.0}),
    "rgb_only": (np.array([0.0, 0.0, 0.008]), np.array([0.005, 0.0, 0.0]),
                 {"rgb_only": True}),
}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_pose_parity(case, schedule):
    rvec, tvec, extra = CASES[case]
    extra = dict(extra)
    use_so3 = extra.pop("use_so3", False)
    pose_b = syn.pose_from(rvec, tvec)
    rgb_a, depth_a = syn.render(*SCENE, EYE, INTR)
    rgb_b, depth_b = syn.render(*SCENE, pose_b, INTR)
    kw = dict(SCHEDULES[schedule], **extra)
    rj = _jax_track(rgb_a, depth_a, rgb_b, depth_b, EYE, use_so3, **kw)
    rt = _torch_track(rgb_a, depth_a, rgb_b, depth_b, EYE, use_so3, **kw)
    np.testing.assert_allclose(n(rt.t), n(rj.t), atol=2e-5)
    np.testing.assert_allclose(n(rt.R), n(rj.R), atol=2e-5)
    np.testing.assert_allclose(n(rt.delta), n(rj.delta), atol=2e-5)
    # inlier counts of the last iteration agree to a few pixels of 19200
    for a, b in ((rt.icp_count, rj.icp_count), (rt.rgb_count, rj.rgb_count),
                 (rt.so3_count, rj.so3_count)):
        assert abs(float(a) - float(b)) <= max(3.0, 1e-3 * float(b))
    if case == "mixed":
        # the recovered motion itself (tests/test_odometry.py bounds)
        assert np.linalg.norm(n(rt.t) - pose_b[:3, 3]) < 3e-3
        assert syn.rotation_angle_deg(n(rt.R), pose_b[:3, :3]) < 0.25
        cov_t = n(todo.covariance(rt.A))
        cov_j = n(jodo.covariance(rj.A))
        np.testing.assert_allclose(np.diag(cov_t), np.diag(cov_j),
                                   rtol=1e-3)
