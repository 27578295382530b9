"""Minimal live viewer (-viewer).

Port of ``maskfusion_tpu/gui.py``.  The interactive stand-in for the
reference's Pangolin window (GUI/Tools/GUI.h:67-762,
MainController::launchViewer/drawScene, MainController.cpp:609-955): one
cv2 window composited from the headless
viewer's panels (predicted RGB | shaded 3D map render | normalised depth |
instance labels, viewer.viewport) plus a HUD line with the live engine
state, and the GUI.h key controls that matter headlessly:

    q / ESC   quit the run            (GUI.h pangolin::RegisterKeyPressCallback)
    space     pause / resume          (GUI.h:200 "pause" toggle)
    n         step one frame while paused (GUI.h:201 "step")
    s         save a screenshot PNG   (GUI.h:214 record/screenshot tools)
    v         toggle shaded map vs raw albedo (draw modes, GUI.h:172-187)
    x         toggle FXAA on the map panel (GUI.h:208,238 drawFxaa)
    m         toggle free-orbit map camera vs follow-live-camera
              (stand-in for pangolin::Handler3D mouse nav, GUI.h:701)
    r         reset the orbit camera onto the live camera

With a display, the map panel also takes mouse input in orbit mode:
left-drag orbits, right-drag pans, wheel dollies (Handler3D semantics).

On a machine without a display (a server, CI) construct with
``offscreen=True`` — the viewer composes exactly the same canvas every
frame and keeps it in ``last_canvas`` (tested via that path), it just never
opens a window.  That keeps one code path for the panel composition whether
or not a display exists.  The map render runs on the engine's device
either way.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np


class LiveViewer:
    """Per-frame window over a running MaskFusion engine."""

    def __init__(self, engine, title: str = "maskfusion-tpu",
                 scale: float = 1.0, offscreen: Optional[bool] = None,
                 screenshot_dir: str = "."):
        self.engine = engine
        self.title = title
        self.scale = scale
        self.screenshot_dir = screenshot_dir
        if offscreen is None:
            # headless boxes have no X/Wayland display; cv2.imshow would
            # abort the run rather than degrade
            offscreen = not (os.environ.get("DISPLAY")
                             or os.environ.get("WAYLAND_DISPLAY"))
        self.offscreen = offscreen
        self.paused = False
        self.shaded = True
        self.fxaa = False
        self.free_orbit = False
        self.orbit = None            # OrbitCamera once first enabled
        self.last_canvas: Optional[np.ndarray] = None
        self._drag = None            # (button, x, y) during a mouse drag
        self._window_open = False
        self._t_last = time.perf_counter()
        self._fps = 0.0

    # ------------------------------------------------------------ internals
    def _compose(self, diag: dict) -> np.ndarray:
        from maskfusion_tpu_torch import viewer as hv

        # the engine's state as it stands after process_frame: under the
        # pipelined schedules, that of the last device stage issued (no
        # drain); each device tensor is fetched once
        glob = self.engine.models[0]
        rgb = hv.host_pred_rgb(glob)
        H, W = rgb.shape[:2]
        view_pose = (self.orbit.pose()
                     if self.free_orbit and self.orbit is not None
                     else self.engine.current_pose)
        view = hv.render_map_view(
            glob.state.map, view_pose, self.engine.intr,
            W, H, max_depth=self.engine.cfg.depth_cutoff, shaded=self.shaded,
            extent=hv.map_extent(glob))
        if self.fxaa:
            view["rgb"] = hv.fxaa(view["rgb"])
        canvas = hv.panels(self.engine, view, rgb)
        strip = self._model_strip(W, H)
        if strip is not None:
            canvas = np.concatenate([canvas, strip], axis=0)
        hud = (f"tick {diag.get('tick', self.engine.tick)}  "
               f"{self._fps:5.1f} FPS  models {diag.get('n_models', 1)}  "
               f"surfels {diag.get('surfels', 0)}  "
               f"{'TRACKING' if diag.get('tracking_ok', True) else 'LOST'}"
               f"{'  [paused]' if self.paused else ''}"
               f"{'  [orbit]' if self.free_orbit else ''}"
               f"{'  [fxaa]' if self.fxaa else ''}")
        canvas = self._draw_hud(canvas, hud)
        if self.scale != 1.0:
            import cv2

            canvas = cv2.resize(
                canvas, (int(canvas.shape[1] * self.scale),
                         int(canvas.shape[0] * self.scale)))
        return canvas

    def _model_strip(self, W: int, H: int) -> Optional[np.ndarray]:
        """Per-model viewport row, shown when object models exist: each
        live model's own predicted-RGB texture (the reference fills the
        P1..P4 / ICP1..ICP4 panels with up to four per-model textures and
        blanks the rest, GUI/MainController.cpp:909-921, GUI.h:138-153)."""
        if len(self.engine.models) < 2:
            return None
        import cv2

        from maskfusion_tpu_torch.viewer import host_pred_rgb

        tw, th = W // 2, H // 2
        thumbs = []
        for m in self.engine.models[:4]:
            t = cv2.resize(host_pred_rgb(m), (tw, th))
            cv2.putText(t, f"model {m.model_id}", (4, 14),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.4, (255, 255, 255), 1,
                        cv2.LINE_AA)
            thumbs.append(t)
        while len(thumbs) < 4:                    # displayEmpty parity
            thumbs.append(np.zeros((th, tw, 3), np.uint8))
        strip = np.concatenate(thumbs, axis=1)
        if strip.shape[1] != 2 * W:               # odd-width rounding
            strip = cv2.resize(strip, (2 * W, th))
        return strip

    @staticmethod
    def _draw_hud(canvas: np.ndarray, text: str) -> np.ndarray:
        import cv2

        bar = np.zeros((24, canvas.shape[1], 3), np.uint8)
        cv2.putText(bar, text, (6, 17), cv2.FONT_HERSHEY_SIMPLEX, 0.45,
                    (255, 255, 255), 1, cv2.LINE_AA)
        return np.concatenate([bar, canvas], axis=0)

    def _handle_key(self, key: int) -> bool:
        """Returns False when the run should stop."""
        if key in (ord("q"), 27):
            return False
        if key == ord(" "):
            self.paused = not self.paused
        elif key == ord("v"):
            self.shaded = not self.shaded
        elif key == ord("x"):
            self.fxaa = not self.fxaa
        elif key == ord("m"):
            self.toggle_orbit()
        elif key == ord("r"):
            self.reset_orbit()
        elif key == ord("s"):
            self.screenshot()
        return True

    def toggle_orbit(self):
        self.free_orbit = not self.free_orbit
        if self.free_orbit and self.orbit is None:
            self.reset_orbit()

    def reset_orbit(self):
        from maskfusion_tpu_torch.viewer import OrbitCamera

        self.orbit = OrbitCamera.from_pose(self.engine.current_pose)

    def _on_mouse(self, event, x, y, flags, _param):
        """Handler3D-style navigation on the composited window: left-drag
        orbits, right-drag pans in the image plane, wheel dollies."""
        import cv2

        if not self.free_orbit or self.orbit is None:
            return
        if event in (cv2.EVENT_LBUTTONDOWN, cv2.EVENT_RBUTTONDOWN):
            self._drag = (event, x, y)
        elif event in (cv2.EVENT_LBUTTONUP, cv2.EVENT_RBUTTONUP):
            self._drag = None
        elif event == cv2.EVENT_MOUSEMOVE and self._drag is not None:
            btn, px, py = self._drag
            dx, dy = x - px, y - py
            self._drag = (btn, x, y)
            if btn == cv2.EVENT_LBUTTONDOWN:
                self.orbit.rotate(dx * 0.008, dy * 0.008)
            else:
                self.orbit.pan(-dx * 0.002, -dy * 0.002)
        elif event == cv2.EVENT_MOUSEWHEEL:
            self.orbit.dolly(0.9 if flags > 0 else 1.0 / 0.9)

    # ------------------------------------------------------------ public
    def update(self, diag: Optional[dict] = None) -> bool:
        """Compose + show the current frame's panels.  Returns False when
        the user quit; while paused, blocks until space (resume), n (single
        step) or quit."""
        now = time.perf_counter()
        dt = now - self._t_last
        self._t_last = now
        if dt > 0:
            self._fps = 0.9 * self._fps + 0.1 / dt if self._fps else 1.0 / dt
        self.last_canvas = self._compose(diag or {})
        if self.offscreen:
            return True
        import cv2

        cv2.imshow(self.title, cv2.cvtColor(self.last_canvas,
                                            cv2.COLOR_RGB2BGR))
        if not self._window_open:
            cv2.setMouseCallback(self.title, self._on_mouse)
        self._window_open = True
        if not self._handle_key(cv2.waitKey(1) & 0xFF):
            return False
        while self.paused:
            key = cv2.waitKey(50) & 0xFF
            if key == ord("n"):
                break                      # step one frame, stay paused
            if not self._handle_key(key):
                return False
            if not self.paused:
                break
        return True

    def screenshot(self, path: Optional[str] = None) -> Optional[str]:
        if self.last_canvas is None:
            return None
        import cv2

        path = path or os.path.join(
            self.screenshot_dir,
            f"viewer-{self.engine.tick:05d}.png")
        cv2.imwrite(path, cv2.cvtColor(self.last_canvas, cv2.COLOR_RGB2BGR))
        return path

    def close(self):
        if self._window_open:
            import cv2

            cv2.destroyWindow(self.title)
            self._window_open = False
