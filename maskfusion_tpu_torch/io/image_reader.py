"""Directory-of-images log reader with background prefetch.

Copy of ``maskfusion_tpu/io/image_reader.py`` for the PyTorch port.
Equivalent of GUI/Tools/ImageLogReader.{h,cpp}: Color####.png +
Depth####.exr/.png [+ Mask####.png + Mask####.png.txt] with a prefetch
thread (minBuffered=30, batches of 15, ImageLogReader.cpp:178-216), depth
conversions 32FC3/16UC1 -> metric float32 (0.001 scale, :249-270), and
synthesised timestamps at rateHz=24 (:283, .h:96).

OpenCV decodes the PNG and JPEG images; it is imported when the first image
is read, not with this module."""

from __future__ import annotations

import os
import queue
import threading
from typing import List, Optional, Tuple

import numpy as np

from maskfusion_tpu_torch.frame import FrameData
from maskfusion_tpu_torch.io.log_reader import LogReader


def _cv2():
    os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
    import cv2

    return cv2


def _load_mask_ids(path: str) -> Tuple[List[int], List[Tuple[int, int, int, int]]]:
    """Mask####.png.txt: first line space-separated class ids for masks 1..n
    (0/background prepended), remaining lines 4-int ROIs
    (ImageLogReader::loadMaskIDs)."""
    class_ids = [0]
    rois: List[Tuple[int, int, int, int]] = []
    with open(path) as f:
        lines = f.read().splitlines()
    if lines:
        class_ids += [int(t) for t in lines[0].split() if t]
        for line in lines[1:]:
            parts = line.split()
            if len(parts) >= 4:
                rois.append(tuple(int(p) for p in parts[:4]))
    return class_ids, rois


class ImageLogReader(LogReader):
    RATE_HZ = 24.0

    def __init__(
        self,
        color_dir: str,
        depth_dir: Optional[str] = None,
        mask_dir: Optional[str] = None,
        color_prefix: str = "Color",
        depth_prefix: str = "Depth",
        mask_prefix: str = "Mask",
        index_width: int = 4,
        flip_colors: bool = False,
        max_masks: Optional[int] = None,
        prefetch: bool = True,
        min_buffered: int = 30,
    ):
        super().__init__(color_dir, flip_colors)
        self.color_dir = color_dir
        self.depth_dir = depth_dir or color_dir
        self.mask_dir = mask_dir or color_dir
        self.color_prefix = color_prefix
        self.depth_prefix = depth_prefix
        self.mask_prefix = mask_prefix
        self.index_width = index_width
        self.max_masks = max_masks if max_masks is not None else (1 << 30)

        self._color_files = self._scan(self.color_dir, color_prefix,
                                       (".png", ".jpg", ".jpeg"))
        self._depth_files = self._scan(self.depth_dir, depth_prefix,
                                       (".exr", ".png"))
        self._mask_files = self._scan(self.mask_dir, mask_prefix, (".png",))
        self.n_frames = min(len(self._color_files), len(self._depth_files))
        if self.n_frames == 0:
            raise FileNotFoundError(
                f"no frames found in {color_dir} (prefix {color_prefix!r})"
            )

        self._queue: "queue.Queue" = queue.Queue(maxsize=max(min_buffered, 4))
        self._prefetch = prefetch
        if prefetch:
            self._thread = threading.Thread(target=self._prefetch_loop,
                                            daemon=True)
            self._stop = threading.Event()
            self._thread.start()

    def _scan(self, directory: str, prefix: str, exts) -> List[str]:
        if not os.path.isdir(directory):
            return []
        out = []
        for name in sorted(os.listdir(directory)):
            base, ext = os.path.splitext(name)
            if ext.lower() in exts and base.startswith(prefix):
                idx = base[len(prefix):]
                if idx.isdigit():
                    out.append(os.path.join(directory, name))
        return out

    # ---------------------------------------------------------------- load
    def _load(self, index: int) -> FrameData:
        cv2 = _cv2()
        rgb = cv2.imread(self._color_files[index])
        if rgb is None:
            raise IOError(f"could not read {self._color_files[index]}")
        rgb = cv2.cvtColor(rgb, cv2.COLOR_BGR2RGB)
        if self.flip_colors:
            rgb = rgb[..., ::-1]

        dpath = self._depth_files[index]
        if dpath.lower().endswith(".exr"):
            # OpenCV builds often lack EXR support: use the repo's codec
            from maskfusion_tpu_torch.io.exr import read_exr_depth

            depth = read_exr_depth(dpath)
        else:
            depth = cv2.imread(dpath, cv2.IMREAD_UNCHANGED)
        if depth is None:
            raise IOError(f"could not read {self._depth_files[index]}")
        if depth.ndim == 3:
            depth = depth[..., 0].astype(np.float32)
        elif depth.dtype == np.uint16:
            pass   # keep u16 mm: engine uploads raw, host_depth() converts
        else:
            depth = depth.astype(np.float32)

        mask = None
        class_ids = None
        rois = None
        if index < len(self._mask_files) and index < self.max_masks:
            mask = cv2.imread(self._mask_files[index], cv2.IMREAD_GRAYSCALE)
            txt = self._mask_files[index] + ".txt"
            if os.path.exists(txt):
                class_ids, rois = _load_mask_ids(txt)

        return FrameData(
            rgb=np.ascontiguousarray(rgb),
            depth=np.ascontiguousarray(depth),
            timestamp=index * 1000.0 / self.RATE_HZ,
            index=index,
            mask=mask,
            class_ids=class_ids,
            rois=rois,
        )

    def _prefetch_loop(self):
        for i in range(self.n_frames):
            if self._stop.is_set():
                return
            self._queue.put(self._load(i))
        self._queue.put(None)

    # ----------------------------------------------------------------- api
    def get_next(self) -> Optional[FrameData]:
        if self.current_frame >= self.n_frames:
            return None
        if self._prefetch:
            frame = self._queue.get()
        else:
            frame = self._load(self.current_frame)
        self.current_frame += 1
        return frame

    def has_more(self) -> bool:
        return self.current_frame < self.n_frames

    def get_num_frames(self) -> int:
        return self.n_frames

    def has_masks(self) -> bool:
        return len(self._mask_files) > 0

    def close(self):
        if self._prefetch:
            self._stop.set()
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
