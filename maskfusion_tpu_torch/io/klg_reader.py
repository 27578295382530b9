"""ElasticFusion .klg binary log reader (ref: GUI/Tools/KlgLogReader.cpp).

Copy of ``maskfusion_tpu/io/klg_reader.py`` for the PyTorch port.

Format: int32 frame count, then per frame
  int64 timestamp | int32 depthSize | int32 rgbSize |
  depth payload (zlib-compressed uint16 mm, or raw) |
  rgb payload (JPEG, or raw 8UC3)
Depth stays in the u16-mm wire format (the engine uploads it raw and
converts on device; FrameData.host_depth() gives metric float32).  A
per-frame seek stack supports getPrevious/rewind (KlgLogReader.cpp:40-90).

Payload DECODE (inflate + JPEG) is prefetched one frame ahead on a worker
thread (zlib/cv2 release the GIL), like the reference's disk-prefetching
ImageLogReader; file reads stay on the calling thread so the seek stack
keeps exact positions.  OpenCV is imported only for JPEG payloads, so a log
of raw payloads reads without it."""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from maskfusion_tpu_torch.frame import FrameData
from maskfusion_tpu_torch.io.log_reader import LogReader


class KlgLogReader(LogReader):
    def __init__(self, file: str, width: int, height: int,
                 flip_colors: bool = False):
        super().__init__(file, flip_colors)
        self.width = width
        self.height = height
        self.fp = open(file, "rb")
        (self.num_frames,) = struct.unpack("<i", self.fp.read(4))
        self._seek_stack = []
        self._lpos = self.fp.tell()     # offset of the next unread frame
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pre = None                # (offset, end_offset, future)

    # ------------------------------------------------------------- decode
    def _read_raw(self):
        """Read one frame's bytes at the current fp position (no decode)."""
        ts, depth_size, rgb_size = struct.unpack("<qii", self.fp.read(16))
        depth_payload = self.fp.read(depth_size)
        rgb_payload = self.fp.read(rgb_size) if rgb_size > 0 else b""
        return ts, depth_payload, rgb_payload

    def _decode(self, raw) -> FrameData:
        ts, depth_payload, rgb_payload = raw
        n = self.width * self.height
        if len(depth_payload) != n * 2:
            depth_raw = zlib.decompress(depth_payload)
        else:
            depth_raw = depth_payload
        # keep the sensor wire format: the engine uploads u16 mm raw (half
        # the bytes) and converts on device; host consumers go through
        # FrameData.host_depth()
        depth = np.frombuffer(depth_raw, np.uint16).reshape(
            self.height, self.width).copy()

        if rgb_payload:
            if len(rgb_payload) != n * 3:
                import cv2

                rgb = cv2.imdecode(
                    np.frombuffer(rgb_payload, np.uint8), cv2.IMREAD_COLOR
                )
                rgb = cv2.cvtColor(rgb, cv2.COLOR_BGR2RGB)
            else:
                rgb = np.frombuffer(rgb_payload, np.uint8).reshape(
                    self.height, self.width, 3
                ).copy()
        else:
            rgb = np.zeros((self.height, self.width, 3), np.uint8)
        if self.flip_colors:
            rgb = rgb[..., ::-1].copy()
        return FrameData(rgb=rgb, depth=depth, timestamp=float(ts))

    # ------------------------------------------------------------ reading
    def get_next(self) -> Optional[FrameData]:
        if not self.has_more():
            return None
        self._seek_stack.append(self._lpos)
        pre = self._pre
        self._pre = None
        if pre is not None and pre[0] == self._lpos:
            fr = pre[2].result()
            self._lpos = pre[1]
        else:
            self.fp.seek(self._lpos)
            fr = self._decode(self._read_raw())
            self._lpos = self.fp.tell()
        self.current_frame += 1
        fr = FrameData(rgb=fr.rgb, depth=fr.depth, timestamp=fr.timestamp,
                       index=self.current_frame - 1)
        # prefetch: read the next frame's bytes now, decode on the worker
        if self.has_more():
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="klg-decode")
            self.fp.seek(self._lpos)
            raw = self._read_raw()
            self._pre = (self._lpos, self.fp.tell(),
                         self._pool.submit(self._decode, raw))
        return fr

    def get_previous(self) -> FrameData:
        """Re-read the frame just returned; the NEXT get_next continues
        forward (KlgLogReader.cpp getPrevious semantics — current_frame is
        net-unchanged)."""
        assert self._seek_stack
        self._pre = None
        self.fp.seek(self._seek_stack.pop())
        fr = self._decode(self._read_raw())
        self._lpos = self.fp.tell()
        return FrameData(rgb=fr.rgb, depth=fr.depth, timestamp=fr.timestamp,
                         index=self.current_frame - 1)

    def fast_forward(self, frame: int):
        """Skip frames without decoding payloads."""
        self._pre = None
        self.fp.seek(self._lpos)
        while self.current_frame < frame and self.has_more():
            self._seek_stack.append(self.fp.tell())
            _, depth_size, rgb_size = struct.unpack("<qii", self.fp.read(16))
            self.fp.seek(depth_size + max(rgb_size, 0), 1)
            self.current_frame += 1
        self._lpos = self.fp.tell()

    def has_more(self) -> bool:
        return self.current_frame + 1 < self.num_frames

    def get_num_frames(self) -> int:
        return self.num_frames

    def rewind(self) -> bool:
        self._pre = None
        self._lpos = 4
        self.current_frame = 0
        self._seek_stack.clear()
        return True

    def close(self):
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None
        self.fp.close()


def write_klg(path: str, frames, compress: bool = True):
    """Writer (for tests and dataset conversion — the reference points at
    prerecorded .klg logs).  Depth is zlib u16-mm, RGB is JPEG when
    `compress` (matching the payload kinds KlgLogReader.cpp:60-78 expects);
    raw u16 depth and raw RGB otherwise.  OpenCV is imported only for the
    JPEG payloads."""
    with open(path, "wb") as f:
        frames = list(frames)
        f.write(struct.pack("<i", len(frames)))
        for fr in frames:
            if fr.depth.dtype == np.uint16:
                depth_mm = fr.depth
            else:
                depth_mm = np.clip(np.round(fr.depth * 1000.0),
                                   0, 65535).astype(np.uint16)
            dpayload = zlib.compress(depth_mm.tobytes()) if compress \
                else depth_mm.tobytes()
            rpayload = fr.rgb.tobytes()
            if compress:
                import cv2

                ok, jpg = cv2.imencode(
                    ".jpg", cv2.cvtColor(fr.rgb, cv2.COLOR_RGB2BGR),
                    [cv2.IMWRITE_JPEG_QUALITY, 95],
                )
                if ok:
                    rpayload = jpg.tobytes()
            f.write(struct.pack("<qii", int(fr.timestamp), len(dpayload),
                                len(rpayload)))
            f.write(dpayload)
            f.write(rpayload)
