"""The port's live viewer (maskfusion_tpu_torch/gui.py) on the CPU at
160x120: tests/test_cli.py's LiveViewer scenarios (offscreen detection, the
'm' / 'x' / 'r' keys, the model strip) on the port, and the port's canvas
against the JAX package's LiveViewer on the map that the JAX engine built
and convert.restore_engine carried in (tests/test_torch_viewer.py's pair).
Canvases are compared below the 24-px HUD bar, whose FPS text differs from
run to run, at the viewer's rule: at most one level apart on all but 3e-3
of the pixels (the level-0 scan's knife-edge ties)."""

import numpy as np
import pytest

from maskfusion_tpu import gui as jgui
from maskfusion_tpu_torch import gui as tgui
from tests import synthetic as syn
from tests.test_torch_viewer import TIE_SHARE, carried_pair

HUD = 24


@pytest.fixture(scope="module")
def pair():
    return carried_pair()


def hold_canvases(out, ref):
    assert out.shape == ref.shape and out.dtype == ref.dtype == np.uint8
    diff = np.abs(out[HUD:].astype(int) - ref[HUD:].astype(int)).max(-1)
    assert (diff > 1).mean() < TIE_SHARE, f"{(diff > 1).sum()} pixels"


@pytest.mark.parametrize("display", [None, "DISPLAY", "WAYLAND_DISPLAY"])
def test_offscreen_follows_the_display(pair, monkeypatch, display):
    """Offscreen exactly when neither DISPLAY nor WAYLAND_DISPLAY is set,
    as the JAX viewer decides; an offscreen update composes the canvas
    without a window."""
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    if display:
        monkeypatch.setenv(display, ":0")
    _, teng = pair
    v = tgui.LiveViewer(teng)
    assert v.offscreen == (display is None)
    assert v.offscreen == jgui.LiveViewer(teng).offscreen
    if v.offscreen:
        assert v.update()
        assert v.last_canvas.shape == (2 * syn.H + HUD, 2 * syn.W, 3)
        assert v.last_canvas[HUD:].std() > 5.0
        assert not v._window_open


def test_canvas_matches_jax_follow_and_orbit(pair):
    """The port's canvas against the JAX LiveViewer's on the same map, in
    follow mode, then after 'm' and the same orbit moves on both."""
    jeng, teng = pair
    tv = tgui.LiveViewer(teng, offscreen=True)
    jv = jgui.LiveViewer(jeng, offscreen=True)
    assert tv.update() and jv.update()
    hold_canvases(tv.last_canvas, jv.last_canvas)
    for v in (tv, jv):
        assert v._handle_key(ord("m"))
        v.orbit.rotate(0.6, 0.25)
        v.orbit.dolly(1.6)
        v.orbit.pan(0.05, -0.02)
        assert v.update()
    np.testing.assert_allclose(tv.orbit.pose(), jv.orbit.pose(), atol=1e-6)
    hold_canvases(tv.last_canvas, jv.last_canvas)


def test_live_viewer_orbit_and_fxaa_keys(pair):
    """tests/test_cli.py::test_live_viewer_orbit_and_fxaa_keys on the
    port: 'm' detaches the map panel onto the orbit camera, 'x' toggles
    FXAA, 'r' re-seeds on the live camera."""
    _, eng = pair
    W, Hh = syn.W, syn.H
    v = tgui.LiveViewer(eng, offscreen=True)
    assert v.update()
    follow = v.last_canvas.copy()

    assert v._handle_key(ord("m"))        # enter orbit mode
    assert v.free_orbit and v.orbit is not None
    v.orbit.rotate(0.6, 0.25)
    v.orbit.dolly(1.6)
    assert v.update()
    orbited = v.last_canvas
    # moving the inspection camera changes the map panel (top-right),
    # not the predicted-RGB panel (top-left)
    assert (orbited[HUD:HUD + Hh, W:] != follow[HUD:HUD + Hh, W:]).mean() > 0.05
    np.testing.assert_array_equal(orbited[HUD:HUD + Hh, :W],
                                  follow[HUD:HUD + Hh, :W])

    assert v._handle_key(ord("x"))        # FXAA on
    assert v.fxaa
    assert v.update()
    assert v.last_canvas.shape == follow.shape

    assert v._handle_key(ord("x"))        # FXAA back off
    assert v._handle_key(ord("r"))        # re-seed orbit on live camera
    assert v._handle_key(ord("m"))        # back to follow mode
    assert not v.free_orbit
    assert v.update()
    np.testing.assert_array_equal(v.last_canvas[HUD:, W:],
                                  follow[HUD:, W:])
    assert not v._handle_key(ord("q"))
    assert not v._handle_key(27)


def test_live_viewer_model_strip(pair, tmp_path):
    """tests/test_cli.py::test_live_viewer_model_strip on the port: a
    second live model appends the per-model row (two thumbnails and two
    blanks), equal to the JAX viewer's strip on the same state; the
    screenshot writes the canvas."""
    import cv2

    jeng, teng = pair
    tv = tgui.LiveViewer(teng, offscreen=True)
    jv = jgui.LiveViewer(jeng, offscreen=True)
    assert tv.update()
    base_h = tv.last_canvas.shape[0]
    assert tv._model_strip(syn.W, syn.H) is None
    teng.models.append(teng.models[0])
    jeng.models.append(jeng.models[0])
    try:
        strip = tv._model_strip(syn.W, syn.H)
        assert strip is not None
        assert strip.shape == (syn.H // 2, 2 * syn.W, 3)
        assert (strip[:, syn.W:] == 0).all()
        assert (strip[:, :syn.W] != 0).any()
        np.testing.assert_array_equal(strip, jv._model_strip(syn.W, syn.H))
        assert tv.update()
        assert tv.last_canvas.shape[0] == base_h + syn.H // 2
    finally:
        teng.models.pop()
        jeng.models.pop()
    path = tv.screenshot(str(tmp_path / "shot.png"))
    back = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
    np.testing.assert_array_equal(back, tv.last_canvas)
    tv.close()
