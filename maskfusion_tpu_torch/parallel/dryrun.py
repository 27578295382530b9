"""The driver entry points: a Mask R-CNN forward, and a dry run of both
multi-device paths on the CPU.

Port of ``__graft_entry__.py``:

- `entry()` returns ``(forward, (model, image))``: the forward of the
  entry's Mask R-CNN (256 px, 81 classes, seeded random weights) on a
  zero image, on the card unless ``device="cpu"``.
- `dryrun_multichip(n)` checks both paths on the CPU at tiny sizes, as
  the JAX one forces the CPU platform with n virtual devices: one
  full-loss train step sharded over ``make_mesh(n)`` (batch on dp,
  parameters FSDP on mp) on n gloo ranks, and meanwhile, in the calling
  process as the JAX engine's single controller, the engine's pipelined
  device and fuse stages with n object slots split over a ``ModelMesh``
  of n CPU entries (`_dryrun_slam_model_axis`).  Every output must be
  finite; a rank that fails or hangs fails the call.
"""

from __future__ import annotations

import numpy as np
import torch

from maskfusion_tpu_torch import resolve_device
from maskfusion_tpu_torch.maskrcnn.model import (MaskRCNN, MaskRCNNConfig,
                                                 init_params_)


def entry(device=None):
    """The entry's forward and its arguments (``__graft_entry__.entry``):
    ``forward(model, image)`` returns the detections, their classes and
    scores and the mask logits of the (1, 256, 256, 3) image."""
    dev = resolve_device(device, "entry")
    cfg = MaskRCNNConfig(
        image_size=256,
        anchor_scales=(16, 32, 64, 128, 256),
        pre_nms_limit=512,
        post_nms_proposals=128,
        max_detections=32,
    )
    model = init_params_(MaskRCNN(cfg), 0).to(dev)
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    image = torch.zeros((1, cfg.image_size, cfg.image_size, 3),
                        device=dev)

    @torch.no_grad()
    def forward(model, image):
        out = model(image)
        return (out["detections"], out["detection_classes"],
                out["detection_scores"], out["mask_logits"])

    return forward, (model, image)


def tiny_config() -> MaskRCNNConfig:
    """The dry run's network (``__graft_entry__.py:76-85``): the full-width
    ResNet-50-FPN at 64 px, 5 classes, float32."""
    return MaskRCNNConfig(
        num_classes=5,
        image_size=64,
        anchor_scales=(8, 16, 32, 64, 128),
        pre_nms_limit=64,
        post_nms_proposals=16,
        max_detections=4,
        train_rois=8,
        dtype=torch.float32,
    )


def dryrun_multichip(n_devices: int, timeout_s: float = 300.0) -> None:
    """Both multi-device paths, the train step on ``n_devices`` CPU ranks;
    raises when a rank fails, produces a non-finite value or has not
    finished within ``timeout_s`` seconds, or when the split engine
    does."""
    from concurrent.futures import ThreadPoolExecutor

    from maskfusion_tpu_torch.parallel.launch import run_ranks

    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, _dryrun_rank, n_devices, "gloo", (),
                            timeout_s)
        _dryrun_slam_model_axis([torch.device("cpu")] * n_devices)
        ranks.result()


def _dryrun_rank(rank: int, world: int) -> None:
    from maskfusion_tpu_torch.parallel.mesh import make_mesh
    from maskfusion_tpu_torch.parallel.train import create_train_step

    mesh = make_mesh(world, device_type="cpu")
    cfg = tiny_config()
    # the full objective: RPN + box head + mask head through
    # proposal-target sampling, the batch on dp, parameters FSDP on mp
    init_fn, step_fn = create_train_step(cfg, full_loss=True, mesh=mesh)
    batch = mesh.size(mesh.mesh_dim_names.index("dp"))
    state = init_fn(0, batch)
    images = torch.zeros((batch, cfg.image_size, cfg.image_size, 3))
    gt_boxes = torch.tensor([[[0.2, 0.2, 0.7, 0.7]]]).repeat(batch, 1, 1)
    gt_classes = torch.ones((batch, 1), dtype=torch.int32)
    gt_valid = torch.ones((batch, 1), dtype=torch.bool)
    gt_masks = torch.ones((batch, 1, 16, 16))
    state, loss = step_fn(state, torch.Generator().manual_seed(1), images,
                          gt_boxes, gt_classes, gt_valid, gt_masks)
    if not torch.isfinite(loss):
        raise AssertionError("multichip train step produced NaN")


def _dryrun_slam_model_axis(devices) -> None:
    """The engine's pipelined device stage (preprocess, every model's
    track, the id projection) and fuse stage (fuse, clean, predict of every
    object slot) with len(devices) object slots split over a ``ModelMesh``
    of those devices (``__graft_entry__.py:115-186``)."""
    from maskfusion_tpu_torch.camera import CameraIntrinsics, Resolution
    from maskfusion_tpu_torch.config import Config
    from maskfusion_tpu_torch.engine import MapState, MaskFusion
    from maskfusion_tpu_torch.frame import FrameData
    from maskfusion_tpu_torch.mapping import surfel_map as sm
    from maskfusion_tpu_torch.parallel.multimodel import ModelMesh

    n = len(devices)
    mesh = ModelMesh(devices)
    W, H = 64, 48
    cfg = Config(global_surfel_capacity=1 << 12,
                 object_surfel_capacity=1 << 10,
                 gn_iterations=(2, 2, 2),
                 use_so3=False, seg_method="maskfusion",
                 pipelined_multiobject=True)
    eng = MaskFusion(Resolution(W, H),
                     CameraIntrinsics(52.0, 52.0, 32.0, 24.0), cfg,
                     device=devices[0], mesh=mesh)
    # the split must actually be live on this mesh
    plan = eng._shard_model_axis(n)
    if plan is None or [b.device for b in plan] != mesh.devices:
        raise AssertionError(f"model-axis split not applied: {plan}")

    u, v = np.meshgrid(np.arange(W), np.arange(H))
    depth = (1.2 + 0.002 * u + 0.001 * v).astype(np.float32)
    rgb = np.stack([(u * 5) % 256, (v * 3) % 256, (u + v) % 256],
                   -1).astype(np.uint8)
    eng.process_frame(FrameData(rgb=rgb, depth=depth))
    eng.process_frame(FrameData(rgb=rgb, depth=depth))
    eng.drain_pipeline()
    glob = eng.models[0]

    OB = 1 << 8
    obj_state = glob.state._replace(map=sm.prefix_view(glob.state.map, OB))
    # distinct buffers per object: the fuse updates each map in place
    obj_states = tuple(
        MapState(sm.SurfelMap(*(a.clone() for a in obj_state.map)),
                 *(a.clone() for a in obj_state[1:])) for _ in range(n))
    obj_aux = np.asarray([[float(i + 1), 0.0, 0.0] for i in range(n)],
                         np.float32)
    dev = eng.device
    rj = torch.from_numpy(rgb).to(dev)
    dj = torch.from_numpy(depth).to(dev)
    seg = torch.zeros((H, W), dtype=torch.uint8, device=dev)
    GB = 1 << 11
    (prep, gpose, oposes, hostvec, _ids, _nonedge, prev_poses,
     okf) = eng.pipelined_device_stage(
        glob.state, obj_states, obj_aux, rj, dj, seg, 2.0,
        glob_bucket=GB, obj_bucket=OB, windowed=False)
    if len(oposes) != n:
        raise AssertionError(f"{len(oposes)} object poses for {n} slots")
    if not torch.isfinite(hostvec).all():
        raise AssertionError("sharded device stage produced NaN")
    obj_params = np.asarray(
        [[float(i + 1), 3.0, 3.0, 1.0, 0.0, 0.0] for i in range(n)],
        np.float32)
    new_glob, new_objs = eng.fuse_stage(
        glob.state, obj_states, prep, rj, seg, prev_poses, 2.0,
        obj_params, glob_bucket=GB, obj_bucket=OB, parity=None,
        windowed=False, gate=okf)
    if len(new_objs) != n:
        raise AssertionError(f"{len(new_objs)} object states for {n} slots")
    for pose in [new_glob.pose] + [o.pose for o in new_objs]:
        if not torch.isfinite(pose).all():
            raise AssertionError("sharded fuse stage produced NaN")
