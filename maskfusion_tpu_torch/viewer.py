"""Headless visualisation.

Port of ``maskfusion_tpu/viewer.py``, the equivalent of the reference's
Pangolin GUI rendering (GUI/Tools/GUI.h, MainController::drawScene,
draw_global_surface.vert/frag+phong, FXAA, texture viewports) re-targeted at
offscreen images: the surfel splatting pipeline renders the map from any
viewpoint on the map's device (the level-0 scan is the hand-written kernel
ops/kernels.predict_l0_scan), a Lambert pass on the host replaces the GLSL
lighting, and the texture panels (predicted RGB / normals / normalised
depth / labels) are composited into one viewport image (-ev export).
`LABEL_COLORS`, `fxaa`, `OrbitCamera`, `normalise_depth` and
`colorise_labels` are host numpy and OpenCV, copied as they are."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from maskfusion_tpu_torch.camera import CameraIntrinsics
from maskfusion_tpu_torch.io.export import export_label_image  # noqa: F401 (re-export)
from maskfusion_tpu_torch.mapping import surfel_map as sm
from maskfusion_tpu_torch.ops import splat as splat_ops

LABEL_COLORS = np.array(
    [[0, 0, 0], [0, 0, 255], [255, 0, 0], [0, 255, 0], [255, 26, 184],
     [255, 211, 0], [0, 131, 246], [0, 140, 70], [167, 96, 61],
     [79, 0, 105], [0, 255, 246], [61, 123, 140], [237, 167, 255],
     [211, 255, 149], [184, 79, 255], [228, 26, 87], [131, 131, 0],
     [0, 255, 149], [96, 0, 43], [246, 131, 17], [202, 255, 0],
     [43, 61, 0], [0, 52, 193], [255, 202, 131], [0, 43, 96],
     [158, 114, 140], [79, 184, 17], [158, 193, 255], [149, 158, 123],
     [255, 123, 175], [158, 8, 0]], np.uint8)


def render_map_view(
    surfel_map: sm.SurfelMap,
    view_pose: np.ndarray,
    intr: CameraIntrinsics,
    width: int,
    height: int,
    max_depth: float = 12.0,
    shaded: bool = True,
    light_dir=(0.3, -0.4, -0.85),
    extent: Optional[int] = None,
):
    """Render the surfel map from `view_pose` (cam->world) on the map's
    device.

    Returns dict with 'rgb' (shaded or albedo, uint8), 'depth', 'normal'
    (host arrays).  The Phong term mirrors draw_global_surface.frag's
    headlight shading.  `extent`, a bound on the map's count that the
    host already holds (`map_extent`), renders over the prefix [0, extent)
    instead of the whole capacity: no slot at or past `count` passes the
    render's slot mask, and a prefix keeps every slot's index, so the
    z-buffer's ties still go to the lowest slot and the image is the
    full-capacity render's.  Nothing is fetched before the render."""
    live = (surfel_map if extent is None
            else sm.prefix_view(surfel_map, max(int(extent), 1)))
    pose_inv = torch.as_tensor(
        np.linalg.inv(view_pose).astype(np.float32),
        device=surfel_map.pos.device)
    im = splat_ops.render_index_map(
        live, pose_inv, intr, height, width, time=float("inf"),
        time_delta=float("inf"), max_depth=max_depth)
    pred = splat_ops.combined_predict(im, intr, max_depth)
    # one device->host copy of the three images
    host = torch.cat([pred.rgb, pred.nmap, pred.depth[..., None]],
                     dim=-1).cpu().numpy()
    rgb = np.ascontiguousarray(host[..., 0:3])
    nrm = np.nan_to_num(np.ascontiguousarray(host[..., 3:6]), nan=0.0)
    depth = np.ascontiguousarray(host[..., 6])
    if shaded:
        l = np.asarray(light_dir, np.float64)
        l /= np.linalg.norm(l)
        lambert = np.clip(-(nrm @ l), 0.15, 1.0)
        rgb = rgb * lambert[..., None]
    out_rgb = np.clip(rgb, 0, 255).astype(np.uint8)
    return {"rgb": out_rgb, "depth": depth, "normal": nrm}


def fxaa(rgb: np.ndarray) -> np.ndarray:
    """Fast approximate anti-aliasing over an (H, W, 3) uint8 image.

    Vectorised port of the reference's post-process pass
    (Core/Shaders/fxaa.frag:21-83, toggled by the 'x' key /
    "ui.Draw FXAA" panel var, GUI/Tools/GUI.h:208,238,519-594): luma-based
    edge direction from the 3x3 diagonal taps, span clamped to
    FXAA_SPAN_MAX texels, two-tap inner blur with the four-tap fallback
    when the blurred luma leaves the local [min, max] range.  Fractional
    taps use bilinear sampling (cv2.remap) exactly like the GLSL
    texture2D reads."""
    import cv2

    REDUCE_MIN, REDUCE_MUL, SPAN_MAX = 1.0 / 128.0, 1.0 / 8.0, 8.0
    img = rgb.astype(np.float32) / 255.0
    H, W = img.shape[:2]
    lw = np.array([0.299, 0.587, 0.114], np.float32)
    luma = img @ lw
    lp = np.pad(luma, 1, mode="edge")
    l_nw, l_ne = lp[:-2, :-2], lp[:-2, 2:]
    l_sw, l_se = lp[2:, :-2], lp[2:, 2:]
    l_m = luma
    l_min = np.minimum(l_m, np.minimum(np.minimum(l_nw, l_ne),
                                       np.minimum(l_sw, l_se)))
    l_max = np.maximum(l_m, np.maximum(np.maximum(l_nw, l_ne),
                                       np.maximum(l_sw, l_se)))

    dx = -((l_nw + l_ne) - (l_sw + l_se))
    dy = (l_nw + l_sw) - (l_ne + l_se)
    dir_reduce = np.maximum((l_nw + l_ne + l_sw + l_se)
                            * (0.25 * REDUCE_MUL), REDUCE_MIN)
    rcp = 1.0 / (np.minimum(np.abs(dx), np.abs(dy)) + dir_reduce)
    dx = np.clip(dx * rcp, -SPAN_MAX, SPAN_MAX)
    dy = np.clip(dy * rcp, -SPAN_MAX, SPAN_MAX)

    xx = np.arange(W, dtype=np.float32)[None, :].repeat(H, 0)
    yy = np.arange(H, dtype=np.float32)[:, None].repeat(W, 1)

    def tap(t):
        mx = xx + dx * t
        my = yy + dy * t
        return cv2.remap(img, mx, my, cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_REPLICATE)

    rgb_a = 0.5 * (tap(1.0 / 3.0 - 0.5) + tap(2.0 / 3.0 - 0.5))
    rgb_b = rgb_a * 0.5 + 0.25 * (tap(-0.5) + tap(0.5))
    luma_b = rgb_b @ lw
    use_a = ((luma_b < l_min) | (luma_b > l_max))[..., None]
    out = np.where(use_a, rgb_a, rgb_b)
    return np.clip(out * 255.0, 0, 255).astype(np.uint8)


class OrbitCamera:
    """Interactive 3D inspection camera: yaw/pitch orbit about a pivot,
    wheel dolly, in-plane pan — the headless equivalent of the reference's
    `pangolin::Handler3D(s_cam)` mouse navigation over the map view
    (GUI/Tools/GUI.h:73-75,441,701,748).  Produces a cam->world pose (this
    repo's convention) for `render_map_view`."""

    def __init__(self, pivot=(0.0, 0.0, 1.5), distance: float = 2.5,
                 yaw: float = 0.0, pitch: float = 0.0):
        self.pivot = np.asarray(pivot, np.float64).copy()
        self.distance = float(distance)
        self.yaw = float(yaw)
        self.pitch = float(pitch)

    @classmethod
    def from_pose(cls, cam_pose: np.ndarray, lookahead: float = 2.0):
        """Seed the orbit at the live camera: pivot `lookahead` metres
        along the optical axis, same eye position."""
        p = np.asarray(cam_pose, np.float64)
        eye, fwd = p[:3, 3], p[:3, 2]
        pivot = eye + lookahead * fwd
        yaw = float(np.arctan2(-fwd[0], -fwd[2]))
        pitch = float(np.arcsin(np.clip(fwd[1], -1.0, 1.0)))
        return cls(pivot, lookahead, yaw, pitch)

    def _forward(self) -> np.ndarray:
        cp = np.cos(self.pitch)
        return np.array([-np.sin(self.yaw) * cp, np.sin(self.pitch),
                         -np.cos(self.yaw) * cp])

    def rotate(self, d_yaw: float, d_pitch: float):
        self.yaw += d_yaw
        lim = np.pi / 2 - 1e-3
        self.pitch = float(np.clip(self.pitch + d_pitch, -lim, lim))

    def dolly(self, factor: float):
        self.distance = float(np.clip(self.distance * factor, 0.05, 100.0))

    def pan(self, dx: float, dy: float):
        """Move the pivot in the current image plane (right, down axes),
        scaled by distance so a drag covers the same screen fraction at
        any zoom."""
        pose = self.pose()
        self.pivot += (dx * pose[:3, 0] + dy * pose[:3, 1]) * self.distance

    def pose(self) -> np.ndarray:
        """cam->world 4x4: camera on the orbit sphere looking at the
        pivot, CV axes (x right, y down, z forward)."""
        fwd = self._forward()                      # eye -> pivot
        eye = self.pivot - self.distance * fwd
        up_hint = np.array([0.0, -1.0, 0.0])       # y-down convention
        x = np.cross(fwd, up_hint)                 # right = fwd x up
        n = np.linalg.norm(x)
        if n < 1e-9:                               # looking straight up/down
            x = np.array([1.0, 0.0, 0.0])
        else:
            x /= n
        y = np.cross(fwd, x)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 0], pose[:3, 1], pose[:3, 2] = x, y, fwd
        pose[:3, 3] = eye
        return pose


def normalise_depth(depth: np.ndarray, min_val: float = 0.3,
                    max_val: float = 5.0) -> np.ndarray:
    """Depth -> grayscale (ref depth_norm.frag)."""
    d = np.clip((depth - min_val) / max(max_val - min_val, 1e-6), 0, 1)
    d = np.where(depth > 0, d, 0.0)
    return (d * 255).astype(np.uint8)


def colorise_labels(seg: np.ndarray) -> np.ndarray:
    """(ref int_to_color.frag + color_table.glsl)."""
    vis = LABEL_COLORS[seg % 31]
    vis[seg == 255] = 255
    return vis


def map_extent(model) -> Optional[int]:
    """A bound on the model's surfel count that the host holds without a
    fetch: the bucket the engine last sized the model's passes to.  The
    engine picks it at or above the count plus a frame's appends, and a
    fuse appends inside it (`surfel_map.append` clamps the count to its
    prefix).  None (the whole capacity) before the engine has chosen
    one."""
    return model.last_bucket or None


def host_pred_rgb(model) -> np.ndarray:
    """A model's predicted colour image as uint8 on the host (one copy)."""
    return np.clip(model.state.pred_rgb.cpu().numpy(), 0, 255).astype(
        np.uint8)


def panels(engine, view: dict, rgb: np.ndarray) -> np.ndarray:
    """The 2x2 grid: predicted RGB | map render, normalised depth | labels
    (GUI.h:312-339)."""
    H, W = rgb.shape[:2]
    depth = normalise_depth(view["depth"], 0.3, engine.cfg.depth_cutoff)
    depth_vis = np.repeat(depth[..., None], 3, axis=-1)
    seg = (engine.last_segmentation
           if engine.last_segmentation is not None
           else np.zeros((H, W), np.uint8))
    labels = colorise_labels(seg)
    top = np.concatenate([rgb, view["rgb"]], axis=1)
    bottom = np.concatenate([depth_vis, labels], axis=1)
    return np.concatenate([top, bottom], axis=0)


def viewport(engine, width: Optional[int] = None,
             height: Optional[int] = None) -> np.ndarray:
    """2x2 panel: predicted RGB | shaded map | normalised depth | labels —
    the headless stand-in for the GUI's texture viewport columns
    (GUI.h:312-339).  It reads the engine's state as it stands: under the
    pipelined schedules, the state of the last device stage issued."""
    glob = engine.models[0]
    rgb = host_pred_rgb(glob)
    H, W = rgb.shape[:2]
    view = render_map_view(
        glob.state.map, engine.current_pose, engine.intr, W, H,
        max_depth=engine.cfg.depth_cutoff, extent=map_extent(glob),
    )
    panel = panels(engine, view, rgb)
    if width and height:
        import cv2

        panel = cv2.resize(panel, (width, height))
    return panel


def save_viewport(engine, path: str):
    import cv2

    cv2.imwrite(path, cv2.cvtColor(viewport(engine), cv2.COLOR_RGB2BGR))
    return path
