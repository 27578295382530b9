"""The port's headless viewer (maskfusion_tpu_torch/viewer.py) and bbox-label
tool against the JAX package's, on the CPU at 160x120.

The map is tests/test_cli.py::test_viewer_and_viewport_export's scene: the
JAX static engine runs its first frame of tests/synthetic.make_scene (the
second frame's fused step would add its compile to the file's run; the
viewer renders with time=inf and reads no confidence), and
convert.engine_snapshot / restore_engine carries its state into the port's
engine (one JAX run, shared by the module).  Renders are held at
tests/test_pallas.py's rule: depth within 1e-5 on all but 3e-3 of the
pixels (knife-edge ties of the level-0 scan, where the winner flips;
normals tell a flip whose depths agree), colour within one level on the
others."""

import os

import numpy as np
import pytest
import torch

from maskfusion_tpu import viewer as jviewer
from maskfusion_tpu.camera import Resolution as JResolution
from maskfusion_tpu.config import Config as JConfig
from maskfusion_tpu.engine import MaskFusion as JMaskFusion
from maskfusion_tpu.frame import FrameData as JFrameData
from maskfusion_tpu_torch import viewer as tviewer
from maskfusion_tpu_torch.camera import Resolution
from maskfusion_tpu_torch.config import Config
from maskfusion_tpu_torch.convert import engine_snapshot, restore_engine
from maskfusion_tpu_torch.engine import MaskFusion
from maskfusion_tpu_torch.mapping import surfel_map as sm
from maskfusion_tpu_torch.ops import splat as tsplat
from tests import synthetic as syn
from tests.torch_helpers import CPU, tintr

CFG = dict(global_surfel_capacity=1 << 16, static_mode=True, use_so3=False)
# test_cli.py's novel view
ORBIT_POSE = syn.pose_from(np.array([0, 0.05, 0]), np.array([0.05, 0, -0.1]))
TIE_SHARE = 3e-3
N_FRAMES = 1


def carried_pair():
    """The JAX static engine after the first of test_cli.py's frames, and
    the port's engine carried from it."""
    jeng = JMaskFusion(JResolution(syn.W, syn.H), syn.DEFAULT_INTR,
                       JConfig(**CFG))
    pts, cols = syn.make_scene()
    rgb, depth = syn.render(pts, cols, np.eye(4), syn.DEFAULT_INTR)
    for _ in range(N_FRAMES):
        jeng.process_frame(JFrameData(rgb=rgb, depth=depth))
    teng = MaskFusion(Resolution(syn.W, syn.H), tintr(syn.DEFAULT_INTR),
                      Config(**CFG), device=CPU)
    restore_engine(teng, engine_snapshot(jeng))
    return jeng, teng


@pytest.fixture(scope="module")
def pair():
    return carried_pair()


def hold_views(out, ref):
    """A tie pixel is one whose winner differs: depth or normal more than
    1e-5 apart.  Fewer than TIE_SHARE of the pixels tie; colour is within
    one level on the others."""
    mismatch = ((np.abs(out["depth"] - ref["depth"]) > 1e-5)
                | (np.abs(out["normal"] - ref["normal"]).max(-1) > 1e-5))
    assert mismatch.mean() < TIE_SHARE, f"{mismatch.sum()} tie pixels"
    diff = np.abs(out["rgb"].astype(int) - ref["rgb"].astype(int))
    assert diff[~mismatch].max() <= 1


@pytest.mark.parametrize("view", ["live", "orbit"])
@pytest.mark.parametrize("shaded", [True, False])
def test_render_map_view_matches_jax(pair, view, shaded):
    """render_map_view from the live pose and from test_cli.py's novel
    pose, shaded and albedo: the port's (render_index_map and
    combined_predict, the scan's plain version here) against the JAX
    package's on the same map; most of the map is visible."""
    jeng, teng = pair
    pose = (np.asarray(jeng.models[0].state.pose) if view == "live"
            else ORBIT_POSE)
    ref = jviewer.render_map_view(jeng.models[0].state.map, pose,
                                  syn.DEFAULT_INTR, syn.W, syn.H,
                                  shaded=shaded)
    out = tviewer.render_map_view(teng.models[0].state.map, pose,
                                  teng.intr, syn.W, syn.H, shaded=shaded)
    assert out["rgb"].shape == (syn.H, syn.W, 3)
    assert out["rgb"].dtype == np.uint8
    assert (out["depth"] > 0).mean() > 0.5
    hold_views(out, ref)


def test_render_over_the_live_prefix_is_the_full_render(pair):
    """A render over [0, count): the index map, the prediction and
    render_map_view's images equal a render over the whole capacity bit
    for bit (slots past the count never pass the slot mask; ties still go
    to the lowest slot)."""
    _, teng = pair
    m = teng.models[0].state.map
    count = int(m.count)
    assert 0 < count < m.capacity
    pose_inv = torch.as_tensor(np.linalg.inv(ORBIT_POSE).astype(np.float32))
    kw = dict(time=float("inf"), time_delta=float("inf"), max_depth=12.0)
    full = tsplat.render_index_map(m, pose_inv, teng.intr, syn.H, syn.W,
                                   **kw)
    pref = tsplat.render_index_map(sm.prefix_view(m, count), pose_inv,
                                   teng.intr, syn.H, syn.W, **kw)
    for a, b in zip(full, pref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    pf = tsplat.combined_predict(full, teng.intr, 12.0)
    pp = tsplat.combined_predict(pref, teng.intr, 12.0)
    for a, b in zip(pf, pp):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    views = [tviewer.render_map_view(m, ORBIT_POSE, teng.intr, syn.W, syn.H,
                                     extent=e) for e in (None, count)]
    for k in ("rgb", "depth", "normal"):
        np.testing.assert_array_equal(views[0][k], views[1][k])


def test_map_extent_bounds_the_count_below_the_capacity():
    """At a capacity above the engine's smallest bucket (2^18), the bucket
    that map_extent reads bounds the count without a fetch and lies below
    the capacity, and the viewer's render over it equals the render over
    the whole capacity bit for bit."""
    from maskfusion_tpu_torch.frame import FrameData

    eng = MaskFusion(Resolution(syn.W, syn.H), tintr(syn.DEFAULT_INTR),
                     Config(**{**CFG, "global_surfel_capacity": 1 << 19}),
                     device=CPU)
    pts, cols = syn.make_scene()
    for t in (np.zeros(3), np.array([0.02, 0.0, 0.0])):
        rgb, depth = syn.render(pts, cols, syn.pose_from(np.zeros(3), t),
                                syn.DEFAULT_INTR)
        eng.process_frame(FrameData(rgb=rgb, depth=depth))
    glob = eng.models[0]
    extent = tviewer.map_extent(glob)
    assert 0 < int(glob.state.map.count) <= extent < glob.state.map.capacity
    views = [tviewer.render_map_view(glob.state.map, ORBIT_POSE, eng.intr,
                                     syn.W, syn.H, extent=e)
             for e in (None, extent)]
    assert (views[0]["depth"] > 0).mean() > 0.3
    for k in ("rgb", "depth", "normal"):
        np.testing.assert_array_equal(views[0][k], views[1][k])


def test_viewport_matches_jax(pair, tmp_path):
    """viewport's 2x2 panel: the predicted-RGB and label panels equal, the
    map render and depth panels at the render rule; save_viewport writes
    the port's panel as a PNG."""
    import cv2

    jeng, teng = pair
    out, ref = tviewer.viewport(teng), jviewer.viewport(jeng)
    assert out.shape == ref.shape == (2 * syn.H, 2 * syn.W, 3)
    H, W = syn.H, syn.W
    np.testing.assert_array_equal(out[:H, :W], ref[:H, :W])
    np.testing.assert_array_equal(out[H:, W:], ref[H:, W:])
    diff = np.abs(out.astype(int) - ref.astype(int)).max(-1)
    assert (diff > 1).mean() < TIE_SHARE
    p = tviewer.save_viewport(teng, str(tmp_path / "vp.png"))
    assert os.path.getsize(p) > 1000
    back = cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(back, out)
    small = tviewer.viewport(teng, width=2 * W // 2, height=2 * H // 2)
    assert small.shape == (H, W, 3)


def _staircase():
    H = W = 64
    yy, xx = np.mgrid[:H, :W]
    return np.repeat(np.where((xx + yy * 2 > 80)[..., None], 230, 20), 3,
                     axis=-1).astype(np.uint8)


@pytest.mark.parametrize("image", ["staircase", "random", "flat"])
def test_fxaa_bit_exact(image):
    """fxaa equals the JAX package's bit for bit, on test_cli.py's 64x64
    staircase, a random image and a flat one."""
    if image == "staircase":
        img = _staircase()
    elif image == "random":
        img = np.random.default_rng(0).integers(0, 256, (48, 64, 3),
                                                dtype=np.uint8)
    else:
        img = np.full((32, 32, 3), 128, np.uint8)
    np.testing.assert_array_equal(tviewer.fxaa(img), jviewer.fxaa(img))


def test_orbit_camera_matches_jax():
    """OrbitCamera's poses after the same rotations, dollies and pans, and
    from_pose, within 1e-6 of the JAX package's."""
    cams = [mod.OrbitCamera(pivot=(0.2, -0.1, 1.5), distance=2.0, yaw=0.4,
                            pitch=-0.2) for mod in (tviewer, jviewer)]
    steps = [("rotate", (0.7, 0.3)), ("dolly", (0.5,)),
             ("pan", (0.1, -0.05)), ("rotate", (-1.3, 2.0)),
             ("dolly", (300.0,)), ("pan", (-0.2, 0.3))]
    np.testing.assert_allclose(cams[0].pose(), cams[1].pose(), atol=1e-6)
    for name, args in steps:
        for c in cams:
            getattr(c, name)(*args)
        np.testing.assert_allclose(cams[0].pose(), cams[1].pose(), atol=1e-6)
    live = syn.pose_from(np.array([0.1, -0.2, 0.05]),
                         np.array([0.3, 0.1, -0.2])).astype(np.float32)
    a = tviewer.OrbitCamera.from_pose(live, lookahead=1.5)
    b = jviewer.OrbitCamera.from_pose(live, lookahead=1.5)
    np.testing.assert_allclose(a.pose(), b.pose(), atol=1e-6)


def test_normalise_depth_and_colorise_labels_exact():
    rng = np.random.default_rng(3)
    depth = rng.uniform(-0.5, 7.0, (40, 50)).astype(np.float32)
    depth[::7] = 0.0
    for lo, hi in ((0.3, 5.0), (0.3, 0.3), (1.0, 3.0)):
        np.testing.assert_array_equal(tviewer.normalise_depth(depth, lo, hi),
                                      jviewer.normalise_depth(depth, lo, hi))
    seg = rng.integers(0, 256, (40, 50)).astype(np.uint8)
    seg[0, :5] = 255
    np.testing.assert_array_equal(tviewer.colorise_labels(seg),
                                  jviewer.colorise_labels(seg))
    np.testing.assert_array_equal(tviewer.LABEL_COLORS, jviewer.LABEL_COLORS)


@pytest.mark.parametrize("toml", [False, True])
def test_bbox_label_tool_matches_jax(tmp_path, toml):
    """tools/sequence_add_bbox_labels on tests.test_io.write_dataset with
    masks: the port's annotated PNGs are byte-identical to the JAX tool's
    (COCO names, and class names from a --toml config)."""
    from maskfusion_tpu.tools.sequence_add_bbox_labels import main as jmain
    from maskfusion_tpu_torch.tools.sequence_add_bbox_labels import \
        main as tmain
    from tests.test_io import write_dataset

    d = tmp_path / "data"
    d.mkdir()
    write_dataset(str(d), n=2)
    extra = []
    if toml:
        cfg = tmp_path / "c.toml"
        cfg.write_text('[MaskRCNN]\nclass_names = ["bg", "a", "b", "c", '
                       '"d", "e", "f", "seven"]\n')
        extra = ["--toml", str(cfg)]
    for name, run in (("jax", jmain), ("torch", tmain)):
        assert run(["-dir", str(d), "-o", str(tmp_path / name),
                    *extra]) == 0
    names = sorted(os.listdir(tmp_path / "torch"))
    assert names == ["Color0000.png", "Color0001.png"]
    assert names == sorted(os.listdir(tmp_path / "jax"))
    for name in names:
        a = (tmp_path / "torch" / name).read_bytes()
        b = (tmp_path / "jax" / name).read_bytes()
        assert a == b, name
    orig = (d / names[0]).read_bytes()
    assert (tmp_path / "torch" / names[0]).read_bytes() != orig
