"""Mask R-CNN inference, the labelling worker and the frame delay queue.

Port of ``maskfusion_tpu/maskrcnn/inference.py``.  Equivalents of:
  - MaskRCNN.py.in `execute(rgb)` + helpers.py `generate_id_image`
    (flatten instance masks to a uint8 id image + class-id/roi lists)
  - the C++ worker thread that labels the newest frame in the engine's
    delay queue (MaskRCNN.cpp:178-208) and the sequential fallback
    (:147-151)
  - config.toml class_names / filter_classes / score_threshold surface
    (config.toml.in:4-36)

On a card the network runs on a CUDA stream of its own and fetches its
results into pinned memory, waiting on its own event only: the SLAM frames
queued on the default stream by the prefused schedule (which issues no
synchronise) are never waited for, and never wait for it.  No OpenCV: the
two resizes are ``maskrcnn.resize``'s.

The command line's ``--nn`` serves ``model.matterport_coco_config``
(MaskFusion's labeller, ResNet-101-FPN at 1024 px) with the Config's score
threshold and class filter; ``MaskRCNNConfig()`` stays this class's
default.  While a profiler runs, each ``execute`` is the span ``label``
(the root on the worker's thread), and the worker's stopwatch keeps the
time it waits with no frame to label (``idle``) at all times.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from maskfusion_tpu_torch import resolve_device
from maskfusion_tpu_torch.frame import FrameData
from maskfusion_tpu_torch.maskrcnn.model import (MaskRCNN, MaskRCNNConfig,
                                                 init_params_,
                                                 to_compute_dtype_)
from maskfusion_tpu_torch.maskrcnn.resize import (resize_mask_f32,
                                                  resize_rgb_u8)
from maskfusion_tpu_torch.utils.stopwatch import Stopwatch, span

# COCO class list (matterport ordering; config.toml.in class_names)
COCO_CLASS_NAMES = [
    "BG", "person", "bicycle", "car", "motorcycle", "airplane", "bus",
    "train", "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella", "handbag",
    "tie", "suitcase", "frisbee", "skis", "snowboard", "sports ball", "kite",
    "baseball bat", "baseball glove", "skateboard", "surfboard",
    "tennis racket", "bottle", "wine glass", "cup", "fork", "knife", "spoon",
    "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "couch", "potted plant",
    "bed", "dining table", "toilet", "tv", "laptop", "mouse", "remote",
    "keyboard", "cell phone", "microwave", "oven", "toaster", "sink",
    "refrigerator", "book", "clock", "vase", "scissors", "teddy bear",
    "hair drier", "toothbrush",
]


def generate_id_image(
    boxes: np.ndarray,          # (D, 4) normalised y1x1y2x2
    masks: np.ndarray,          # (D, S, S) logits
    classes: np.ndarray,        # (D,)
    scores: np.ndarray,
    valid: np.ndarray,
    height: int,
    width: int,
    score_threshold: float = 0.55,
    filter_classes: Optional[Sequence[int]] = None,
) -> Tuple[np.ndarray, List[int], List[Tuple[int, int, int, int]]]:
    """Paste per-detection masks into a uint8 instance-id image (1..n) with
    class ids and ROIs — helpers.py:70-98 equivalent.  Later (higher-score)
    instances do not overwrite earlier ones, matching the reference's paste
    order."""
    id_image = np.zeros((height, width), np.uint8)
    class_ids: List[int] = [0]
    rois: List[Tuple[int, int, int, int]] = []
    next_id = 1
    order = np.argsort(-scores)
    for i in order:
        if not valid[i] or scores[i] < score_threshold:
            continue
        if filter_classes and int(classes[i]) not in filter_classes:
            continue
        if next_id >= 255:
            break
        y1 = int(np.clip(boxes[i, 0] * height, 0, height - 1))
        x1 = int(np.clip(boxes[i, 1] * width, 0, width - 1))
        y2 = int(np.clip(boxes[i, 2] * height, y1 + 1, height))
        x2 = int(np.clip(boxes[i, 3] * width, x1 + 1, width))
        m = resize_mask_f32(masks[i].astype(np.float32), (x2 - x1, y2 - y1))
        region = id_image[y1:y2, x1:x2]
        paint = (m > 0) & (region == 0)
        region[paint] = next_id
        class_ids.append(int(classes[i]))
        rois.append((y1, x1, y2, x2))
        next_id += 1
    return id_image, class_ids, rois


class MaskRCNNInference:
    """Single-image inference with the reference's config surface.

    ``params`` is the JAX package's parameter tree (flax names, as
    ``checkpoint_io.load_params`` reads a checkpoint), carried over by
    ``convert.maskrcnn_state_dict``.  Without it the network is initialised
    from a torch.Generator seeded with ``seed`` with flax's default
    distributions (``model.init_params_``): the weights match a JAX
    ``model.init`` in distribution only, not value for value.  Runs on the
    first CUDA card unless ``device="cpu"``; raises when no card is found."""

    def __init__(self, cfg: Optional[MaskRCNNConfig] = None,
                 params=None, seed: int = 0,
                 filter_classes: Optional[Sequence[int]] = None,
                 device=None):
        self.cfg = cfg or MaskRCNNConfig()
        self.device = resolve_device(device, "MaskRCNNInference")
        self.filter_classes = list(filter_classes) if filter_classes else None
        model = MaskRCNN(self.cfg)
        if params is None:
            init_params_(model, seed)
        else:
            from maskfusion_tpu_torch.convert import maskrcnn_state_dict

            model.load_state_dict(maskrcnn_state_dict(params, self.cfg))
        # the serving copy holds its weights in the compute dtype
        model = to_compute_dtype_(model).to(self.device).eval()
        self.stream = None
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
            self.stream = torch.cuda.Stream(self.device)
            # the layout copies are queued on the caller's stream: every
            # forward on this stream comes after them
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        self.model = model
        self._staged = None          # pinned (rgb in, results out) buffers

    def _pinned(self, rgb: np.ndarray, n: int):
        """The pinned input and output buffers (made once, reused: each
        execute waits for its own copies before returning)."""
        if self._staged is None or self._staged[0].shape != rgb.shape:
            self._staged = (torch.empty(rgb.shape, dtype=torch.uint8,
                                        pin_memory=True),
                            torch.empty(n, dtype=torch.float32,
                                        pin_memory=True))
        return self._staged

    def forward(self, rgb: np.ndarray):
        """(H, W, 3) uint8 RGB -> the network's output dict for the frame
        resized to S x S (a float32 batch of one)."""
        S = self.cfg.image_size
        if self.stream is None:
            img = resize_rgb_u8(torch.from_numpy(np.ascontiguousarray(rgb)),
                                (S, S))
            with torch.no_grad():
                return self.model(img.float()[None])
        pinned_in, _ = self._pinned(rgb, self._packed_size())
        pinned_in.numpy()[...] = rgb
        with torch.cuda.stream(self.stream), torch.no_grad():
            img = pinned_in.to(self.device, non_blocking=True)
            return self.model(resize_rgb_u8(img, (S, S)).float()[None])

    def _packed_size(self) -> int:
        D, M = self.cfg.max_detections, 4 * self.cfg.mask_pool_size ** 2
        return D * (4 + M + 3)

    def detect(self, rgb: np.ndarray):
        """(boxes, mask logits, classes, scores, valid) as numpy arrays."""
        out = self.forward(rgb)
        cfg = self.cfg
        D, M = cfg.max_detections, 2 * cfg.mask_pool_size
        keys = ("detections", "mask_logits", "detection_classes",
                "detection_scores", "detection_valid")
        if self.stream is None:
            return tuple(out[k].numpy() for k in keys)
        _, pinned_out = self._pinned(rgb, self._packed_size())
        with torch.cuda.stream(self.stream):
            packed = torch.cat([out[k].float().reshape(-1) for k in keys])
            pinned_out.copy_(packed, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        done.synchronize()               # this stream's work only
        flat = pinned_out.numpy()
        cuts = np.cumsum([D * 4, D * M * M, D, D])
        boxes, masks, classes, scores, valid = np.split(flat, cuts)
        return (boxes.reshape(D, 4).copy(), masks.reshape(D, M, M).copy(),
                classes.astype(np.int64), scores.copy(), valid > 0.5)

    def execute(self, frame: FrameData) -> FrameData:
        """Label a frame in place (MaskRCNN::executeSequential)."""
        with span("label"):
            boxes, masks, classes, scores, valid = self.detect(
                frame.host_rgb())
            id_img, class_ids, rois = generate_id_image(
                boxes, masks, classes, scores, valid,
                frame.height, frame.width,
                self.cfg.score_threshold, self.filter_classes)
        frame.class_ids = class_ids
        frame.rois = rois
        frame.mask = id_img              # last: the queue reads it as done
        return frame


class MaskRCNNWorker:
    """Async labelling thread over the engine's frame delay-queue.

    Mirrors MaskRCNN::startThreadLoop/loop (MaskRCNN.cpp:178-208):
    repeatedly labels the newest unlabelled frame in the queue; the engine
    only consumes frames once their masks arrived (or the queue overflows).
    An exception in the thread stops it and is raised again by ``stop()``
    (and ``check()``).  ``stopwatch``'s ``idle`` aggregate is the time the
    thread waited because every queued frame was labelled."""

    def __init__(self, inference: MaskRCNNInference, frame_queue):
        self.inference = inference
        self.queue = frame_queue
        self.error: Optional[BaseException] = None
        self.labelled = 0
        self.stopwatch = Stopwatch()
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def _loop(self):
        try:
            while not self._stop.is_set():
                frame = self.queue.newest_unlabelled()
                if frame is None:
                    t0 = time.perf_counter()
                    self._stop.wait(0.002)
                    self.stopwatch.record(
                        "idle", (time.perf_counter() - t0) * 1000.0)
                    continue
                self.inference.execute(frame)
                self.labelled += 1
        except Exception as e:          # reported by check() / stop()
            self.error = e

    def check(self):
        if self.error is not None:
            raise RuntimeError("the Mask R-CNN worker failed") from self.error

    def stop(self):
        self._stop.set()
        self.thread.join(timeout=60)
        if self.thread.is_alive():
            raise RuntimeError("the Mask R-CNN worker did not stop")
        self.check()


class FrameQueue:
    """Delay queue between reader and engine (MaskFusion.h:362-363,
    MaskFusion.cpp:206-209): frames wait up to `size` slots for the async
    labeller before the engine consumes them."""

    def __init__(self, size: int = 30):
        self.size = size
        self._lock = threading.Lock()
        self._frames: List[FrameData] = []

    def push(self, frame: FrameData):
        with self._lock:
            self._frames.append(frame)

    def pop_ready(self, flush: bool = False) -> Optional[FrameData]:
        """Oldest frame, but only once labelled or the queue is full.

        ``flush=True`` (end of stream) pops the head regardless: with no
        more pushes arriving the queue can never reach `size`, and the
        worker labels newest-first, so an unlabelled head would otherwise
        wait forever — it exits unlabelled exactly as an overflowing queue
        would have dropped it (MaskFusion.cpp:206-209 lag semantics)."""
        with self._lock:
            if not self._frames:
                return None
            head = self._frames[0]
            if (head.mask is not None or len(self._frames) >= self.size
                    or flush):
                return self._frames.pop(0)
            return None

    def newest_unlabelled(self) -> Optional[FrameData]:
        with self._lock:
            for f in reversed(self._frames):
                if f.mask is None:
                    return f
        return None

    def __len__(self):
        with self._lock:
            return len(self._frames)


def load_toml_config(path: str):
    """config.toml surface: class_names, filter_classes, score_threshold,
    trackable_classes (config.toml.in + MainController.cpp:269-287)."""
    import tomllib

    with open(path, "rb") as f:
        data = tomllib.load(f)
    mr = data.get("MaskRCNN", data)
    return {
        "class_names": mr.get("class_names", COCO_CLASS_NAMES),
        "filter_classes": mr.get("filter_classes", []),
        "score_threshold": mr.get("score_threshold", 0.55),
        "trackable_classes": data.get("ModelSpawning", {}).get(
            "trackable_classes", []),
    }
