"""Fern-based keyframe database for relocalisation / global loop closure.

Port of ``maskfusion_tpu/reloc/ferns.py`` (ref Core/Ferns.{h,cpp}, the
randomised-fern place recognition of ElasticFusion): 1/8-scale keyframes
encoded by `num` random 4-bit RGBD ferns; `add_frame` keeps a frame when its
minimum dissimilarity to the database exceeds fernThresh
(Ferns.cpp:72-142); `find_frame` retrieves the most similar old-enough
keyframe, verifies it with ICP odometry against the stored fern maps and a
photometric check, and emits surface constraints (Ferns.cpp:144-259).

The reference release stubs the fern-odometry initialisation with
assert(false) (Ferns.cpp:212-216); here, as in the JAX package, the
verification solve runs.

The encoding, the dissimilarities and the photometric check are numpy on
the small maps, as in the JAX package, with the same seeded fern positions
and thresholds (``np.random.default_rng(seed)``).  Only the verification
solve (`_verify_odometry`) runs on the engine's device, through the port's
tracking core; its four numbers come back in one fetch.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from maskfusion_tpu_torch import resolve_device
from maskfusion_tpu_torch.camera import CameraIntrinsics, Resolution

BAD_CODE = 255


class SurfaceConstraint(NamedTuple):
    source_point: np.ndarray   # (3,) world point under the current pose
    target_point: np.ndarray   # (3,) world point under the estimated pose


@dataclasses.dataclass
class FernFrame:
    frame_id: int
    pose: np.ndarray           # (4,4) camera pose at capture
    src_time: int
    codes: np.ndarray          # (num,) uint8
    good_codes: int
    rgb: np.ndarray            # (h, w, 3) uint8
    verts: np.ndarray          # (h, w, 3) camera-frame
    norms: np.ndarray          # (h, w, 3)


class FindResult(NamedTuple):
    pose: Optional[np.ndarray]
    constraints: List[SurfaceConstraint]
    closest_id: int


class Ferns:
    def __init__(self, num: int, resolution: Resolution,
                 intr: CameraIntrinsics, max_depth: float = 4.0,
                 photo_thresh: float = 115.0, factor: int = 8, seed: int = 0,
                 device=None):
        self.device = resolve_device(device, "Ferns")
        self.num = num
        self.factor = factor
        self.width = resolution.width // factor
        self.height = resolution.height // factor
        self.intr_small = CameraIntrinsics(
            intr.fx / factor, intr.fy / factor,
            intr.cx / factor, intr.cy / factor,
        )
        self.max_depth = max_depth
        self.photo_thresh = photo_thresh
        rng = np.random.default_rng(seed)
        self.pos_x = rng.integers(0, self.width, num)
        self.pos_y = rng.integers(0, self.height, num)
        self.thresh_rgb = rng.integers(0, 256, (num, 3))
        self.thresh_d = rng.integers(400, int(max_depth * 1000), num)
        self.frames: List[FernFrame] = []
        self.last_closest = -1

    # ------------------------------------------------------------- encoding
    def _encode(self, rgb: np.ndarray, verts: np.ndarray
                ) -> Tuple[np.ndarray, int]:
        """4-bit code per fern (Ferns.cpp:90-105): 3 RGB threshold bits +
        1 depth threshold bit; BAD_CODE where depth invalid."""
        px = rgb[self.pos_y, self.pos_x]                  # (num, 3)
        z = verts[self.pos_y, self.pos_x, 2]
        z_mm = (z * 1000.0).astype(np.int64)
        code = (
            ((px[:, 0] > self.thresh_rgb[:, 0]).astype(np.uint8) << 3)
            | ((px[:, 1] > self.thresh_rgb[:, 1]).astype(np.uint8) << 2)
            | ((px[:, 2] > self.thresh_rgb[:, 2]).astype(np.uint8) << 1)
            | (z_mm > self.thresh_d).astype(np.uint8)
        )
        valid = z > 0
        codes = np.where(valid, code, BAD_CODE).astype(np.uint8)
        return codes, int(valid.sum())

    def _dissimilarities(self, codes: np.ndarray, good: int) -> np.ndarray:
        """1 - co-occurrence ratio against every stored frame."""
        if not self.frames:
            return np.zeros(0)
        mat = np.stack([f.codes for f in self.frames])   # (F, num)
        goods = np.array([f.good_codes for f in self.frames])
        co = np.sum((mat == codes[None]) & (codes[None] != BAD_CODE), axis=1)
        max_co = np.minimum(good, goods).astype(np.float64)
        return (max_co - co) / np.maximum(max_co, 1.0)

    # ------------------------------------------------------------------ add
    def add_frame(self, rgb_small: np.ndarray, verts_small: np.ndarray,
                  norms_small: np.ndarray, pose: np.ndarray, src_time: int,
                  threshold: float) -> bool:
        codes, good = self._encode(rgb_small, verts_small)
        if good == 0:
            return False
        dissim = self._dissimilarities(codes, good)
        if len(dissim) and dissim.min() <= threshold:
            return False
        self.frames.append(FernFrame(
            frame_id=len(self.frames), pose=pose.copy(),
            src_time=src_time, codes=codes, good_codes=good,
            rgb=rgb_small.copy(), verts=verts_small.copy(),
            norms=norms_small.copy(),
        ))
        return True

    # ----------------------------------------------------------------- find
    def _block_hd_aware(self, c1: np.ndarray, c2: np.ndarray) -> float:
        both = (c1 != BAD_CODE) & (c2 != BAD_CODE)
        if both.sum() == 0:
            return 0.0
        return float(((c1 == c2) & both).sum() / both.sum())

    def find_frame(self, curr_pose: np.ndarray, rgb_small: np.ndarray,
                   verts_small: np.ndarray, norms_small: np.ndarray,
                   time: int, lost: bool, time_gap: int = 300) -> FindResult:
        """Retrieve + verify (Ferns.cpp:144-259)."""
        self.last_closest = -1
        codes, good = self._encode(rgb_small, verts_small)
        if good == 0 or not self.frames:
            return FindResult(None, [], -1)
        dissim = self._dissimilarities(codes, good)
        ages = np.array([time - f.src_time for f in self.frames])
        dissim = np.where(ages > time_gap, dissim, np.inf)
        min_id = int(np.argmin(dissim))
        if not np.isfinite(dissim[min_id]):
            return FindResult(None, [], -1)
        fern = self.frames[min_id]
        if self._block_hd_aware(codes, fern.codes) <= 0.3:
            return FindResult(None, [], -1)

        est_pose, icp_error, icp_count = self._verify_odometry(
            fern, verts_small, norms_small, rgb_small
        )
        photo_error = self._photometric_check(
            verts_small, rgb_small, est_pose, fern
        )
        icp_count_thresh = 1400 if lost else 2400
        # scale the count threshold to our actual small-frame pixel count
        # (the reference's constants assume 80x60=4800 px)
        scale = (self.width * self.height) / 4800.0
        if (icp_error < 3e-4 and icp_count > icp_count_thresh * scale
                and photo_error < self.photo_thresh):
            self.last_closest = min_id
            constraints = []
            step = max(1, self.num // 50)
            for i in range(0, self.num, step):
                v = verts_small[self.pos_y[i], self.pos_x[i]]
                if v[2] > 0 and v[2] < self.max_depth:
                    vh = np.array([v[0], v[1], v[2], 1.0])
                    constraints.append(SurfaceConstraint(
                        source_point=(curr_pose @ vh)[:3],
                        target_point=(est_pose @ vh)[:3],
                    ))
            return FindResult(est_pose, constraints, min_id)
        return FindResult(None, [], -1)

    def _verify_odometry(self, fern: FernFrame, verts, norms, rgb):
        """ICP-only odometry of the current small maps against the fern's
        (the part stubbed in the reference, Ferns.cpp:212-224), on the
        device; R, t, the ICP error and count come back in one fetch."""
        from maskfusion_tpu_torch.ops import preprocess as pp
        from maskfusion_tpu_torch.tracking import odometry as odo

        dev = self.device

        def up(a, dtype=np.float32):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

        def nanify(a):
            return up(np.where(a[..., 2:3] > 0, a, np.nan))

        frame_pyr = odo.FramePyramids(
            vmaps=(nanify(verts),),
            nmaps=(nanify(norms),),
            depths=(up(np.where(verts[..., 2] > 0, verts[..., 2], np.nan)),),
            intensities=(pp.rgb_to_intensity(up(rgb, np.uint8)),),
            masks=(torch.zeros((self.height, self.width), dtype=torch.uint8,
                               device=dev),),
        )
        model = odo.build_model_pyramids(
            nanify(fern.verts), nanify(fern.norms), up(fern.rgb, np.uint8),
            up(fern.pose), num_levels=1,
        )
        pose = up(fern.pose)
        res = odo.get_incremental_transformation(
            pose[:3, 3], pose[:3, :3], frame_pyr, model, None,
            self.intr_small, icp_weight=100.0, pyramid=False,
            use_so3=False, num_levels=1, mask_id=0,
        )
        out = torch.cat([res.R.reshape(9), res.t.reshape(3),
                         res.icp_error.reshape(1).to(torch.float32),
                         res.icp_count.reshape(1).to(torch.float32)]
                        ).cpu().numpy()
        est = np.eye(4, dtype=np.float32)
        est[:3, :3] = out[:9].reshape(3, 3)
        est[:3, 3] = out[9:12]
        return est, float(out[12]), float(out[13])

    def _photometric_check(self, verts, rgb, est_pose, fern: FernFrame
                           ) -> float:
        """Mean absolute RGB difference at reprojected fern positions
        (Ferns.cpp:261-307)."""
        ii = self.intr_small
        v = verts[self.pos_y, self.pos_x]                # (num, 3)
        ok = (v[:, 2] > 0) & (v[:, 2] < self.max_depth)
        diff = np.linalg.inv(fern.pose) @ est_pose
        vh = np.concatenate([v, np.ones((self.num, 1))], 1)
        w = (diff @ vh.T).T
        with np.errstate(divide="ignore", invalid="ignore"):
            u = (w[:, 0] * ii.fx / w[:, 2] + ii.cx).astype(np.int64)
            vv = (w[:, 1] * ii.fy / w[:, 2] + ii.cy).astype(np.int64)
        inb = ok & (u >= 0) & (vv >= 0) & (u < self.width) & (vv < self.height)
        uc = np.clip(u, 0, self.width - 1)
        vc = np.clip(vv, 0, self.height - 1)
        fern_px = fern.rgb[vc, uc].astype(np.int64)
        cur_px = rgb[self.pos_y, self.pos_x].astype(np.int64)
        nonzero = fern_px.sum(1) > 0
        use = inb & nonzero
        if use.sum() == 0:
            return np.inf
        return float(np.abs(fern_px[use] - cur_px[use]).sum() / use.sum())
