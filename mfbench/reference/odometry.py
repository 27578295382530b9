"""Frozen copy of ``maskfusion_tpu_torch/tracking/odometry.py``,
the plain PyTorch version the benchmark judges the program against
(imports rewritten to this folder; nothing of the program is imported).

Joint projective-ICP + photometric RGB-D odometry.

Port of ``maskfusion_tpu/tracking/odometry.py`` (ref
Core/Utils/RGBDOdometry.{h,cpp}): SO(3) photometric pre-alignment, then the
{10,5,4} ICP+RGB Gauss-Newton schedule over a 3-level pyramid with the 6x6
solve on the device.

The JAX package ends converged levels early with ``lax.while_loop``.  Here
every iteration of the schedule is issued and a converged (``done``)
iteration keeps the old state through ``torch.where`` — the same numbers,
with no host sync on the device's verdict.

The model side may carry a leading slot axis: N object models tracked
against the same frame in one solve (the JAX engine's ``jax.vmap`` over
objects, maskfusion_tpu/engine.py:318-356).  Each slot has its own pose,
model pyramids, SO(3) intensity, mask id and ``done`` flags, so a slot that
has converged keeps its state while the others iterate, as the vmapped
``while_loop`` does; the frame pyramids are shared, broadcast across the
slots.  A call without the slot axis is the one-slot case.  The windowed
object tracker gives each slot its own frame crop instead (N, h, w, ...)
and its own principal point: intrinsics whose ``cx``, ``cy`` are (N, 1)
tensors, with K and its closed-form inverse built per slot on the device
(the JAX package's traced-intrinsics branch of ``_k_matrices``).

The frozen-association schedule (``assoc_period``) and its gates are those
of the JAX package: gates freeze with the association, at level 0 only.

Pose convention: (R, t) is camera-to-world; the returned `delta` is the
prev->curr increment in the previous camera frame (the reference's
`resultRt`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from mfbench.reference import se3
from mfbench.reference.camera import CameraIntrinsics
from mfbench.reference import preprocess as pp
from mfbench.reference import reduce as red

_F32_MAX = float(np.finfo(np.float32).max)


class FramePyramids(NamedTuple):
    """The 'next' (current frame) side of tracking."""
    vmaps: Tuple[torch.Tensor, ...]
    nmaps: Tuple[torch.Tensor, ...]
    depths: Tuple[torch.Tensor, ...]       # float32 depth, NaN invalid
    intensities: Tuple[torch.Tensor, ...]  # uint8
    masks: Tuple[torch.Tensor, ...]        # uint8 instance labels


class ModelPyramids(NamedTuple):
    """The 'last/prev' (model prediction) side of tracking."""
    vmaps_g: Tuple[torch.Tensor, ...]      # world-frame predicted vertices
    nmaps_g: Tuple[torch.Tensor, ...]
    depths: Tuple[torch.Tensor, ...]       # NaN-invalid predicted depth
    intensities: Tuple[torch.Tensor, ...]
    # the model-side 4x4 validity erosion of each level, precomputed where
    # the pyramid is built on a halo-padded crop (the windowed object
    # tracker); None: eroded from `intensities` in the solve
    last_valids: Optional[Tuple[torch.Tensor, ...]] = None


class OdometryResult(NamedTuple):
    t: torch.Tensor            # (3,) new camera translation (cam->world)
    R: torch.Tensor            # (3,3) new camera rotation
    delta: torch.Tensor        # (4,4) prev->curr increment (prev camera frame)
    A: torch.Tensor            # (6,6) final blended GN system
    b: torch.Tensor            # (6,)
    icp_error: torch.Tensor
    icp_count: torch.Tensor
    rgb_error: torch.Tensor
    rgb_count: torch.Tensor
    so3_error: torch.Tensor
    so3_count: torch.Tensor


def _pyr_down_nan_depth(d: torch.Tensor) -> torch.Tensor:
    d = pp.pyr_down_gauss_depth(torch.where(torch.isfinite(d), d, 0.0))
    return torch.where(d > 0, d, float("nan"))


def build_frame_pyramids_for_odometry(levels, raw_rgb: torch.Tensor,
                                      max_depth_rgb: float = 6.0
                                      ) -> FramePyramids:
    """The 'next' side from preprocess.build_frame_pyramids: photometric
    depth is the vertex maps' z with the 6 m cutoff and NaN holes, the
    intensity is recomputed from the raw frame (RGBDOdometry.cpp:187-204)."""
    depths = [pp.vertices_to_depth(levels[0]["vmap"], max_depth_rgb)]
    intens = [pp.rgb_to_intensity(raw_rgb)]
    for i in range(1, len(levels)):
        depths.append(_pyr_down_nan_depth(depths[-1]))
        intens.append(pp.pyr_down_uchar_gauss(intens[-1]))
    return FramePyramids(
        vmaps=tuple(l["vmap"] for l in levels),
        nmaps=tuple(l["nmap"] for l in levels),
        depths=tuple(depths), intensities=tuple(intens),
        masks=tuple(l["mask"] for l in levels))


def build_model_pyramids(pred_vmap, pred_nmap, pred_rgb, model_pose,
                         num_levels: int = 3,
                         max_depth_rgb: float = 6.0) -> ModelPyramids:
    """The 'prev' side from a model's predicted view: pyramid, then every
    level into the world frame (initICPModel/initRGBModel,
    RGBDOdometry.cpp:153-209).  With a slot axis: (N, H, W, 3) predictions
    and (N, 4, 4) poses."""
    R = model_pose[..., :3, :3]
    t = model_pose[..., :3, 3]
    v, n = pred_vmap, pred_nmap
    d = pp.vertices_to_depth(pred_vmap, max_depth_rgb)
    g = pp.rgb_to_intensity(pred_rgb)
    vmaps, nmaps, depths, intens = [], [], [], []
    for i in range(num_levels):
        if i > 0:
            v = pp.resize_vmap(v)
            n = pp.resize_nmap(n)
            d = _pyr_down_nan_depth(d)
            g = pp.pyr_down_uchar_gauss(g)
        vg, ng = pp.transform_maps(v, n, R, t)
        vmaps.append(vg)
        nmaps.append(ng)
        depths.append(d)
        intens.append(g)
    return ModelPyramids(vmaps_g=tuple(vmaps), nmaps_g=tuple(nmaps),
                         depths=tuple(depths), intensities=tuple(intens))


@functools.lru_cache(maxsize=64)
def _k_matrices(intr: CameraIntrinsics, level: int, device: torch.device):
    """K and K^-1 of a pyramid level, made once per device: a copy from
    pageable host memory waits for the device's stream, so per-frame
    constants are not uploaded again each frame."""
    il = intr.level(level)
    K = np.array([[il.fx, 0, il.cx], [0, il.fy, il.cy], [0, 0, 1]],
                 dtype=np.float32)
    K_inv = np.linalg.inv(K).astype(np.float32)
    return (torch.as_tensor(K, device=device),
            torch.as_tensor(K_inv, device=device))


def _k_of(intr: CameraIntrinsics, level: int, device: torch.device):
    """K and K^-1 of a pyramid level: cached host constants for float
    intrinsics; for a principal point given as (N, 1) tensors (one window a
    slot), (N, 3, 3) stacks built on the device with the pinhole inverse in
    closed form, as the JAX package builds them for traced intrinsics
    (maskfusion_tpu/tracking/odometry.py:148-170)."""
    if not isinstance(intr.cx, torch.Tensor):
        return _k_matrices(intr, level, device)
    il = intr.level(level)
    f32 = torch.float32
    cx, cy = il.cx.reshape(-1), il.cy.reshape(-1)
    # fills on the device: a tensor made from a host scalar would be a
    # copy that waits for the device
    fx = torch.full_like(cx, il.fx, dtype=f32)
    fy = torch.full_like(cx, il.fy, dtype=f32)
    z = torch.zeros_like(cx)
    o = torch.ones_like(cx)
    K = torch.stack([torch.stack([fx, z, cx], -1),
                     torch.stack([z, fy, cy], -1),
                     torch.stack([z, z, o], -1)], -2)
    K_inv = torch.stack([torch.stack([1.0 / fx, z, -cx / fx], -1),
                         torch.stack([z, 1.0 / fy, -cy / fy], -1),
                         torch.stack([z, z, o], -1)], -2)
    return K, K_inv


def _w(cond, a, b):
    """torch.where with a per-slot `cond` ((), or (N,)) widened to the
    trailing dims of a and b."""
    extra = max(a.dim(), b.dim()) - cond.dim()
    return torch.where(cond.reshape(cond.shape + (1,) * max(extra, 0)), a, b)


def _sel(done, old, new):
    """Per-field select of a tuple of tensors: old where done (per slot)."""
    return tuple(_w(done, o, n) for o, n in zip(old, new))


def get_incremental_transformation(
    t_prev: torch.Tensor,
    R_prev: torch.Tensor,
    frame: FramePyramids,
    model: ModelPyramids,
    so3_last_intensities,
    intr: CameraIntrinsics,
    *,
    rgb_only: bool = False,
    icp_weight: float = 10.0,
    pyramid: bool = True,
    fast_odom: bool = False,
    use_so3: bool = True,
    mask_id=None,
    use_mask_rgb: bool = True,
    use_mask_icp: bool = False,
    dist_thresh: float = 0.10,
    angle_thresh_sine: float = 0.34202,
    max_depth_delta_rgb: float = 0.07,
    sobel_scale: float = 1.0 / (2.0 * (2.0 * 0.52201 + 0.79451)),
    min_grad_magnitudes: Tuple[float, ...] = (5.0, 3.0, 1.0),
    so3_iterations: int = 10,
    translation_jump_limit: float = 0.3,
    num_levels: int = 3,
    assoc_period: int = 1,
    gn_step_eps: float = 0.0,
    gn_damping: float = 0.0,
    rgb_finest_only: bool = False,
) -> OdometryResult:
    """One tracking solve (RGBDOdometry.cpp:227-497); the arguments and
    schedule are those of maskfusion_tpu.tracking.odometry, with its
    object-model options gn_damping and rgb_finest_only, and the model
    pyramids' precomputed last_valids (the windowed object tracker's).

    With a slot axis: `t_prev` (N, 3), `R_prev` (N, 3, 3), the model
    pyramids and SO(3) intensities (N, ...) and `mask_id` an (N,) tensor;
    every field of the result then has a leading (N,) axis."""
    use_icp = (not rgb_only) and icp_weight > 0
    use_rgb_any = rgb_only or icp_weight < 100
    dev = t_prev.device
    f32 = torch.float32
    t_prev = t_prev.to(f32)
    R_prev = R_prev.to(f32)
    R_prev_inv = R_prev.mT
    slots = t_prev.shape[:-1]           # () or (N,)
    # the mask id against the frame's (H, W) masks and its P pixels
    mid_img = mid_pix = mask_id
    if slots and mask_id is not None:
        mid_img = mask_id.reshape(slots + (1, 1))
        mid_pix = mask_id.reshape(slots + (1,))

    def scalar(v):
        # a fill on the device, not a host->device copy
        return torch.full(slots, v, dtype=f32, device=dev)

    false = torch.zeros(slots, dtype=torch.bool, device=dev)

    didx, didy = [], []
    for i in range(num_levels):
        if not (use_rgb_any and (i == 0 or not rgb_finest_only)):
            didx.append(None)
            didy.append(None)
            continue
        dx, dy = pp.compute_derivative_images(frame.intensities[i])
        didx.append(dx)
        didy.append(dy)

    so3_error = scalar(0.0)
    so3_count = scalar(0.0)
    result_R = torch.eye(3, dtype=f32, device=dev).expand(slots + (3, 3))

    # --- SO(3) pre-alignment on the coarsest level (.cpp:254-325) ---
    if use_so3 and so3_last_intensities is not None:
        lvl = num_levels - 1
        K, K_inv = _k_of(intr, lvl, dev)
        last_img = so3_last_intensities[lvl]
        next_img = frame.intensities[lvl]
        big = scalar(_F32_MAX / 2)
        resultR, lastErr, lastCnt = result_R, big, big
        lastResultR = result_R
        err, cnt, done = so3_error, so3_count, false
        for _ in range(so3_iterations):
            term = red.so3_step(last_img, next_img, K @ resultR @ K_inv,
                                K_inv, K @ resultR)
            cur_err = torch.sqrt(term.residual_sq) / torch.clamp(
                term.count, min=1.0)
            cur_cnt = term.count
            # divergence check (.cpp:300-307): error grew -> revert + stop
            diverged = cur_err > lastErr + 0.001
            converged = (cur_err < lastErr) & (
                (lastErr - cur_cnt).abs() < 0.001)
            new_resultR = se3.rodrigues(se3.solve_6x6_ldlt(term.A, term.b)) \
                @ resultR
            keep = diverged | converged
            step = (
                _w(diverged, lastResultR,
                   _w(converged, resultR, new_resultR)),
                torch.where(keep, lastErr, cur_err),
                torch.where(keep, lastCnt, cur_cnt),
                _w(keep, lastResultR, resultR),
                torch.where(diverged, lastErr, cur_err),
                torch.where(diverged, lastCnt, cur_cnt),
                keep,
            )
            # a finished loop (done) leaves its state untouched
            (resultR, lastErr, lastCnt, lastResultR, err, cnt, done) = _sel(
                done, (resultR, lastErr, lastCnt, lastResultR, err, cnt,
                       done), step)
        result_R, so3_error, so3_count = resultR, err, cnt

    # --- iteration schedule (.cpp:327-329) ---
    if fast_odom:
        iters = [3] + [0] * (num_levels - 1)
    elif pyramid:
        iters = [10, 5, 4][:num_levels]
    else:
        iters = [10] + [0] * (num_levels - 1)

    result_rt = se3.make_pose(
        result_R, torch.zeros(slots + (3,), dtype=f32, device=dev))
    t_curr, R_curr = t_prev, R_prev
    lastA = torch.zeros(slots + (6, 6), dtype=f32, device=dev)
    lastb = torch.zeros(slots + (6,), dtype=f32, device=dev)
    icp_error, icp_count = scalar(0.0), scalar(0.0)
    rgb_error, rgb_count = scalar(0.0), scalar(0.0)
    prevT = se3.make_pose(R_prev, t_prev)

    for lvl in range(num_levels - 1, -1, -1):
        if iters[lvl] == 0:
            continue
        Kj, K_invj = _k_of(intr, lvl, dev)
        il = intr.level(lvl)
        min_scale = (min_grad_magnitudes[lvl] ** 2) / (sobel_scale ** 2)
        # rgb_finest_only: a small object's coarse-level photometrics are
        # boundary-dominated, so its coarse levels stay ICP only
        use_rgb = use_rgb_any and (lvl == 0 or not rgb_finest_only)
        vn_packed = red.pack_model_maps(
            model.vmaps_g[lvl], model.nmaps_g[lvl]) if use_icp else None
        static_valid = red.rgb_static_valid(
            frame.intensities[lvl], frame.depths[lvl], didx[lvl], didy[lvl],
            min_scale,
            next_mask=frame.masks[lvl] if use_mask_rgb else None,
            mask_id=mid_img if use_mask_rgb else None,
        ) if use_rgb else None
        last_valid = (model.last_valids[lvl]
                      if model.last_valids is not None
                      else red.rgb_last_valid(model.intensities[lvl])
                      ) if use_rgb else None

        def rgb_corres(result_rt_c, lvl=lvl, Kj=Kj, K_invj=K_invj,
                       min_scale=min_scale, static_valid=static_valid,
                       last_valid=last_valid):
            Rt = se3.pose_inverse(result_rt_c)
            # one model keeps its matrix-vector product (and its rounding)
            kt = (Kj @ Rt[:3, 3] if Rt.dim() == 2
                  else (Kj @ Rt[..., :3, 3:4])[..., 0])
            return red.compute_rgb_residual(
                didx[lvl], didy[lvl], model.depths[lvl], frame.depths[lvl],
                model.intensities[lvl], frame.intensities[lvl],
                Kj @ Rt[..., :3, :3] @ K_invj, kt, min_scale,
                max_depth_delta_rgb, static_valid=static_valid,
                last_valid=last_valid)

        def body(carry, frozen=None, lvl=lvl, il=il, vn_packed=vn_packed,
                 rgb_corres=rgb_corres, use_rgb=use_rgb):
            (result_rt, t_curr, R_curr, last_rgb_error, lastA, lastb,
             icp_error, icp_count, rgb_error, rgb_count, done) = carry
            if use_rgb and frozen is None:
                corres = rgb_corres(result_rt)
                tmp_error = torch.sqrt(corres.sigma_sum) / torch.clamp(
                    corres.count, min=1.0)
                sigma_val = torch.where(tmp_error == 0, 1.0, corres.count)
                if rgb_only:
                    sigma_val = scalar(-1.0)
                    done = done | (tmp_error > last_rgb_error)
                new_rgb_error, new_rgb_count = tmp_error, corres.count
            else:
                new_rgb_error, new_rgb_count = rgb_error, rgb_count

            if use_icp:
                if frozen is None:
                    icp_term = red.icp_step(
                        R_curr, t_curr, frame.vmaps[lvl], frame.nmaps[lvl],
                        R_prev_inv, t_prev, il, model.vmaps_g[lvl],
                        model.nmaps_g[lvl], dist_thresh, angle_thresh_sine,
                        mask=frame.masks[lvl] if use_mask_icp else None,
                        mask_id=mid_pix if use_mask_icp else None,
                        vn_packed=vn_packed)
                else:
                    icp_term = red.icp_term_from_assoc(
                        R_curr, t_curr, frame.vmaps[lvl], frame.nmaps[lvl],
                        R_prev_inv, t_prev, frozen[0])
                new_icp_error = torch.sqrt(icp_term.residual_sq) / \
                    torch.clamp(icp_term.count, min=1.0)
                new_icp_count = icp_term.count
            else:
                new_icp_error, new_icp_count = icp_error, icp_count

            if use_rgb:
                rgb_term = (red.rgb_step(corres, sigma_val, il, didx[lvl],
                                         didy[lvl], sobel_scale)
                            if frozen is None else frozen[1])
            if use_icp and use_rgb:
                A = rgb_term.A + icp_weight * icp_weight * icp_term.A
                b = rgb_term.b + icp_weight * icp_term.b
            elif use_icp:
                A, b = icp_term.A, icp_term.b
            else:
                A, b = rgb_term.A, rgb_term.b
            if gn_damping > 0:
                # Levenberg-style zero-step prior for small objects' few-pixel
                # systems (Config.object_gn_damping)
                lam = gn_damping * (se3.trace(A) / 6.0)
                A = A + lam[..., None, None] * torch.eye(6, dtype=A.dtype,
                                                         device=dev)
            x = se3.solve_6x6_ldlt(A, b)
            new_result_rt = se3.se3_exp_update(result_rt, x)
            currentT = prevT @ se3.pose_inverse(new_result_rt)
            out_done = done
            if gn_step_eps > 0:
                # this iteration's update still applies; later ones are
                # masked (the JAX package's while_loop skips them)
                out_done = done | (x.abs().amax(-1) < gn_step_eps)
            kept = _sel(done, carry[:10], (
                new_result_rt, currentT[..., :3, 3], currentT[..., :3, :3],
                new_rgb_error, A, b, new_icp_error, new_icp_count,
                new_rgb_error, new_rgb_count))
            return kept + (out_done,)

        def fresh_assoc(c, lvl=lvl, il=il, vn_packed=vn_packed,
                        rgb_corres=rgb_corres, use_rgb=use_rgb):
            assoc = red.icp_associate(
                c[2], c[1], frame.vmaps[lvl], frame.nmaps[lvl], R_prev_inv,
                t_prev, il, vn_packed, dist_thresh, angle_thresh_sine,
                mask=frame.masks[lvl] if use_mask_icp else None,
                mask_id=mid_pix if use_mask_icp else None)
            rgb_term = None
            if use_rgb:
                corres = rgb_corres(c[0])
                tmp_error = torch.sqrt(corres.sigma_sum) / torch.clamp(
                    corres.count, min=1.0)
                sigma_val = torch.where(tmp_error == 0, 1.0, corres.count)
                rgb_term = red.rgb_step(corres, sigma_val, il, didx[lvl],
                                        didy[lvl], sobel_scale)
                c = c[:3] + (tmp_error,) + c[4:8] + (
                    tmp_error, corres.count, c[10])
            return (assoc, rgb_term), c

        carry = (result_rt, t_curr, R_curr, scalar(_F32_MAX), lastA, lastb,
                 icp_error, icp_count, rgb_error, rgb_count, false)
        # frozen association only at level 0 (see the JAX package)
        period = (1 if (rgb_only or not use_icp or lvl > 0)
                  else max(1, assoc_period))
        if period == 1:
            for _ in range(iters[lvl]):
                carry = body(carry)
        else:
            left = iters[lvl]
            frozen = None
            while left > 0:
                chunk = min(period, left)
                left -= chunk
                if frozen is None or gn_step_eps <= 0:
                    frozen, carry = fresh_assoc(carry)
                else:
                    # a converged level skips the search in the JAX
                    # package; here it runs and is discarded
                    new_frozen, new_carry = fresh_assoc(carry)
                    done = carry[10]
                    frozen = (
                        red.ICPAssociation(*_sel(done, frozen[0],
                                                 new_frozen[0])),
                        None if frozen[1] is None else red.GNTerm(
                            *_sel(done, frozen[1], new_frozen[1])))
                    carry = _sel(done, carry, new_carry)
                for _ in range(chunk):
                    carry = body(carry, frozen)
        (result_rt, t_curr, R_curr, _, lastA, lastb,
         icp_error, icp_count, rgb_error, rgb_count, _) = carry

    # translation jump rejection (.cpp:478-482); the JAX package reads the
    # finest level's photometric switch here
    if use_rgb_any:
        jumped = torch.linalg.vector_norm(t_curr - t_prev, dim=-1) > \
            translation_jump_limit
        t_curr = _w(jumped, t_prev, t_curr)
        R_curr = _w(jumped, R_prev, R_curr)
        result_rt = _w(jumped, torch.eye(4, dtype=f32, device=dev),
                       result_rt)

    return OdometryResult(
        t=t_curr, R=R_curr, delta=result_rt, A=lastA, b=lastb,
        icp_error=icp_error, icp_count=icp_count,
        rgb_error=rgb_error, rgb_count=rgb_count,
        so3_error=so3_error, so3_count=so3_count)


def covariance(A: torch.Tensor) -> torch.Tensor:
    """inv(lastA), the tracking-failure detector's input
    (RGBDOdometry.cpp:499, MaskFusion.cpp:377-414)."""
    return se3.spd_inverse_small(
        A + 1e-12 * torch.eye(6, dtype=A.dtype, device=A.device))
