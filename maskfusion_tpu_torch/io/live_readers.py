"""Live-capture readers.

Port of ``maskfusion_tpu/io/live_readers.py``, a copy of its host code that
returns the port's numpy ``FrameData`` (the engine uploads it as it does
any reader's frames).  Equivalents of the reference's camera sources
(GUI/Tools/OpenNI2LiveReader, FreenectLiveReader, RealsenseLiveReader,
PangolinReader).  The capture machinery mirrors OpenNI2Interface.cpp:1-222:
a vendor stream delivers frames on a background thread into a mutex-guarded
ring buffer (ThreadMutexObject<...> int ring in the reference) from which
the SLAM loop takes the newest frame.  Each vendor adapter raises a clear
DeviceNotAvailable error when its SDK binding is missing or its stream
stops delivering; the generic loop is exercised in tests against a fake
SDK module.  `VideoLogReader` (cv2.VideoCapture over files, streams or
V4L devices) is the working generic source, covering the PangolinReader
video-URI role."""

from __future__ import annotations

import importlib
import threading
import time
from collections import deque
from typing import Callable, Optional, Tuple

import numpy as np

from maskfusion_tpu_torch.frame import FrameData
from maskfusion_tpu_torch.io.log_reader import LogReader


class DeviceNotAvailable(RuntimeError):
    pass


class RingBuffer:
    """Thread-safe latest-N frame buffer (ref ThreadMutexObject ring,
    OpenNI2Interface's 10-slot buffer)."""

    def __init__(self, size: int = 10):
        self._dq = deque(maxlen=size)
        self._lock = threading.Lock()
        self._count = 0

    def push(self, frame: FrameData):
        with self._lock:
            self._count += 1
            frame.index = self._count - 1
            self._dq.append(frame)

    def latest(self) -> Optional[FrameData]:
        with self._lock:
            return self._dq[-1] if self._dq else None


class VideoLogReader(LogReader):
    """RGB video source (no depth) via OpenCV — usable for RGB-only /
    frame-to-frame tracking modes and testing capture plumbing."""

    def __init__(self, uri, flip_colors: bool = False,
                 synthetic_depth: Optional[float] = None):
        super().__init__(str(uri), flip_colors)
        import cv2

        self.cap = cv2.VideoCapture(uri)
        if not self.cap.isOpened():
            raise DeviceNotAvailable(f"cannot open video source {uri!r}")
        self.synthetic_depth = synthetic_depth
        self._frame_idx = 0

    def get_next(self) -> Optional[FrameData]:
        import cv2

        ok, bgr = self.cap.read()
        if not ok:
            return None
        rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        if self.flip_colors:
            rgb = rgb[..., ::-1].copy()
        depth = np.full(rgb.shape[:2],
                        self.synthetic_depth or 0.0, np.float32)
        f = FrameData(rgb=rgb, depth=depth, index=self._frame_idx,
                      timestamp=self._frame_idx * 1000.0 / 30.0)
        self._frame_idx += 1
        self.current_frame = self._frame_idx
        return f

    def has_more(self) -> bool:
        return self.cap.isOpened()


# (rgb uint8 HxWx3, depth float32 metres, timestamp ms) or None (no frame yet)
GrabFn = Callable[[], Optional[Tuple[np.ndarray, np.ndarray, float]]]


class _SdkLiveReader(LogReader):
    """Base for vendor-SDK readers: probes for the python binding and runs
    the generic callback->ring-buffer capture loop
    (OpenNI2Interface.cpp:1-222: the SDK's frame callbacks write into
    ThreadMutexObject-guarded ring slots; get_next takes the newest).

    Subclasses implement `_open_streams() -> GrabFn` against their vendor
    API and optionally `_close_streams()`."""

    SDK_MODULE = ""
    NAME = ""

    def __init__(self, flip_colors: bool = False, start: bool = True,
                 timeout: float = 5.0):
        super().__init__(self.NAME, flip_colors)
        try:
            self.sdk = importlib.import_module(self.SDK_MODULE)
        except ImportError as e:
            raise DeviceNotAvailable(
                f"{self.NAME} requires the {self.SDK_MODULE!r} binding, "
                f"which is not installed in this environment") from e
        self.ring = RingBuffer()
        self.timeout = timeout
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._grab: Optional[GrabFn] = None
        if start:
            self.start()

    # ------------------------------------------------------------- control
    def start(self):
        """Open the vendor streams and launch the capture thread."""
        if self._thread is not None:
            return
        self._grab = self._open_streams()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._capture_loop, name=f"{self.NAME}-capture",
            daemon=True)
        self._thread.start()

    def stop(self):
        """Stop the capture thread and close the vendor streams (the
        reference's destructor path, OpenNI2Interface.cpp:~200)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self._close_streams()

    close = stop

    def _capture_loop(self):
        while not self._stop.is_set():
            try:
                item = self._grab()
            except Exception:
                # transient SDK hiccup: back off, keep capturing
                time.sleep(0.01)
                continue
            if item is None:
                time.sleep(0.001)
                continue
            rgb, depth, ts = item
            if self.flip_colors:
                rgb = rgb[..., ::-1]
            # writable copies: the engine wraps a frame's arrays with
            # torch.from_numpy, which does not support read-only buffers
            self.ring.push(FrameData(
                rgb=np.array(rgb, np.uint8, order="C"),
                depth=np.array(depth, np.float32, order="C"),
                timestamp=float(ts)))

    # ------------------------------------------------------------- LogReader
    def has_more(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def get_next(self) -> Optional[FrameData]:
        """Newest unseen frame; blocks up to `timeout` (live sources drop
        frames rather than queue them — the SLAM loop always gets the most
        recent capture, like the reference's latestDepthIndex ring read)."""
        deadline = time.monotonic() + self.timeout
        while time.monotonic() < deadline:
            f = self.ring.latest()
            if f is not None and f.index >= self.current_frame:
                self.current_frame = f.index + 1
                return f
            time.sleep(0.002)
        raise DeviceNotAvailable(f"{self.NAME}: no frames arriving")

    # ------------------------------------------------------------- vendor
    def _open_streams(self) -> GrabFn:
        raise DeviceNotAvailable(f"{self.NAME}: no stream adapter")

    def _close_streams(self):
        pass


class OpenNI2LiveReader(_SdkLiveReader):
    """Kinect v1 / Asus Xtion via the primesense `openni` binding
    (ref OpenNI2LiveReader + OpenNI2Interface.cpp:20-140: depth+color VGA
    streams at 30 Hz, registration on)."""
    SDK_MODULE = "openni"
    NAME = "OpenNI2"

    def _open_streams(self) -> GrabFn:
        openni2 = self.sdk.openni2
        openni2.initialize()
        dev = openni2.Device.open_any()
        self._dev = dev
        self._depth = dev.create_depth_stream()
        self._color = dev.create_color_stream()
        try:  # depth->color registration (OpenNI2Interface.cpp:66)
            dev.set_image_registration_mode(
                openni2.IMAGE_REGISTRATION_DEPTH_TO_COLOR)
        except Exception:
            pass
        self._depth.start()
        self._color.start()

        def grab():
            df = self._depth.read_frame()
            cf = self._color.read_frame()
            if df is None or cf is None:
                return None
            depth_mm = np.frombuffer(
                df.get_buffer_as_uint16(), np.uint16).reshape(
                    df.height, df.width)
            rgb = np.frombuffer(
                cf.get_buffer_as_uint8(), np.uint8).reshape(
                    cf.height, cf.width, 3)
            return rgb, depth_mm.astype(np.float32) * 1e-3, \
                float(getattr(df, "timestamp", 0)) * 1e-3
        return grab

    def _close_streams(self):
        for name in ("_depth", "_color"):
            s = getattr(self, name, None)
            if s is not None:
                try:
                    s.stop()
                except Exception:
                    pass
        try:
            self.sdk.openni2.unload()
        except Exception:
            pass


class FreenectLiveReader(_SdkLiveReader):
    """Kinect v2 via `freenect2` (ref FreenectLiveReader, optional
    WITH_FREENECT2 build)."""
    SDK_MODULE = "freenect2"
    NAME = "Freenect2"

    def _open_streams(self) -> GrabFn:
        fn2 = self.sdk
        self._device = fn2.Device()
        self._device.start()
        FrameType = fn2.FrameType

        def grab():
            frames = self._device.get_next_frame()
            if not frames:
                return None
            color = frames[FrameType.Color]
            depth = frames[FrameType.Depth]
            rgb = np.asarray(color.to_array())[..., :3][..., ::-1]
            d = np.asarray(depth.to_array(), np.float32) * 1e-3
            return rgb, d, time.monotonic() * 1e3
        return grab

    def _close_streams(self):
        dev = getattr(self, "_device", None)
        if dev is not None:
            try:
                dev.stop()
            except Exception:
                pass


class RealsenseLiveReader(_SdkLiveReader):
    """Intel RealSense via `pyrealsense2` (ref RealsenseLiveReader)."""
    SDK_MODULE = "pyrealsense2"
    NAME = "RealSense"

    def _open_streams(self) -> GrabFn:
        rs = self.sdk
        self._pipeline = rs.pipeline()
        cfg = rs.config()
        cfg.enable_stream(rs.stream.depth, 640, 480, rs.format.z16, 30)
        cfg.enable_stream(rs.stream.color, 640, 480, rs.format.rgb8, 30)
        profile = self._pipeline.start(cfg)
        try:
            scale = profile.get_device().first_depth_sensor() \
                .get_depth_scale()
        except Exception:
            scale = 1e-3
        self._align = rs.align(rs.stream.color)

        def grab():
            frames = self._pipeline.wait_for_frames()
            frames = self._align.process(frames)
            df = frames.get_depth_frame()
            cf = frames.get_color_frame()
            if not df or not cf:
                return None
            depth = np.asanyarray(df.get_data()).astype(np.float32) * scale
            rgb = np.asanyarray(cf.get_data())
            return rgb, depth, float(df.get_timestamp())
        return grab

    def _close_streams(self):
        p = getattr(self, "_pipeline", None)
        if p is not None:
            try:
                p.stop()
            except Exception:
                pass
