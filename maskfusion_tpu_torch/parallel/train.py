"""The Mask R-CNN training step, on one card or sharded over a mesh.

Port of ``maskfusion_tpu/parallel/train.py``: ``create_train_step``
returns ``(init_fn, step_fn)`` with the JAX signatures.  The step takes a
batch of images with their ground truth, computes the mean over the batch
of each image's loss (``MaskRCNN.batch_loss``: ``train_losses``, or the
RPN loss alone for the warm-up, looped where JAX ``vmap``s), and applies
one Adam update as ``optax.adam`` computes it (``maskrcnn.optim``) to
float32 parameters.  The loss stays a device tensor: a step on
device-resident inputs issues no host synchronise.

The JAX step is SPMD over a (dp, mp) mesh: the batch on dp, parameters
FSDP-sharded on mp, one controller, GSPMD inserting the collectives.  With
``mesh=`` (``parallel.mesh.make_mesh``) the port runs the same layout as
one process a rank (``parallel.launch.run_ranks``) with FSDP2: every rank
takes the global batch, as the JAX step takes global arrays, and computes
the rows of its dp coordinate (the ranks of one dp group compute the same
rows, as GSPMD does); the parameters are HSDP-sharded, replicated over dp
and split over mp by the JAX rule (``parallel.mesh.shard_pytree_fsdp``);
FSDP's reduction averages the gradients over every rank, which is the
gradient of the global mean.  The sharded step therefore equals the
one-card step on the same batch and draws, up to the order of the float
sums.  A mesh of CUDA devices runs on NCCL, one card a rank.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.fsdp import register_fsdp_forward_method
from torch.distributed.tensor import DTensor

from maskfusion_tpu_torch import resolve_device
from maskfusion_tpu_torch.maskrcnn.model import (MaskRCNN, MaskRCNNConfig,
                                                 init_params_)
from maskfusion_tpu_torch.maskrcnn.optim import Optimizer
from maskfusion_tpu_torch.parallel import mesh as mesh_lib
from maskfusion_tpu_torch.utils.stopwatch import span


class TrainState(NamedTuple):
    params: MaskRCNN         # the network, float32 parameters
    opt_state: Optimizer
    step: int


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def create_train_step(cfg: MaskRCNNConfig, learning_rate: float = 1e-4,
                      full_loss: bool = True, device=None,
                      mesh: Optional[DeviceMesh] = None):
    """Returns (init_fn, step_fn).

    ``init_fn(rng, batch_size)`` initialises the network from the integer
    seed ``rng`` with flax's default distributions (``init_params_``), and
    with a mesh then shards it (`parallel.mesh.shard_pytree_fsdp`: a unit
    each backbone block, the rest of the backbone, the RPN, each head, and
    the network as the root).
    ``step_fn(state, rng, images, gt_boxes, gt_classes, gt_valid,
    gt_masks)`` takes tensors on the step's device: images (B, S, S, 3)
    float32 in [0, 255], gt_boxes (B, G, 4), gt_classes (B, G), gt_valid
    (B, G) bool, gt_masks (B, G, S, S); ``rng`` is a torch.Generator on
    that device, from which the step draws the proposal sampling's uniform
    scores, or those draws themselves, (B, 2, post_nms_proposals + G).  It
    updates the state's network in place and returns the next state and
    the batch's mean loss (a device scalar).  With a mesh every rank passes
    the global batch and the same generator state (or draws); B must be a
    multiple of the dp axis; the loss is the global mean on every rank.
    While a profiler runs, a step records the spans ``forward`` (the batch
    loss, with the RPN's ``rpn_nms`` inside), ``backward`` and
    ``optimizer`` (the gradient averaging over the mesh and the Adam
    update), each with the state's step number.

    full_loss=True optimises the complete objective (RPN class and box,
    box head class and box, mask head through proposal-target sampling);
    False the RPN loss alone (the warm-up), which leaves the heads as they
    are.  Runs on the first CUDA card unless ``device="cpu"``; raises when
    no card is found.  With a mesh the device is the rank's (its current
    card, or the CPU for a ``cpu`` mesh)."""
    dev = (_mesh_device(mesh) if mesh is not None
           else resolve_device(device, "create_train_step"))

    def init_fn(rng: int, batch_size: int) -> TrainState:
        del batch_size               # the JAX init runs on one image too
        model = init_params_(MaskRCNN(cfg), int(rng)).to(dev)
        if mesh is None and dev.type == "cuda":
            # (FSDP shards contiguous parameters only: a sharded network's
            # convs take channels-last inputs with contiguous weights)
            model = model.to(memory_format=torch.channels_last)
        if mesh is not None:
            mesh_lib.shard_pytree_fsdp(
                model, mesh, [*model.backbone.blocks, model.backbone,
                              model.rpn, model.box_head, model.mask_head])
            register_fsdp_forward_method(model, "batch_loss")
        return TrainState(model, Optimizer(model.parameters(),
                                           learning_rate), 0)

    def step_fn(state: TrainState, rng: Union[torch.Generator,
                                              torch.Tensor],
                images, gt_boxes, gt_classes, gt_valid, gt_masks):
        model, opt = state.params, state.opt_state
        B, G = gt_boxes.shape[:2]
        draws = rng if isinstance(rng, torch.Tensor) else torch.rand(
            (B, 2, cfg.post_nms_proposals + G), generator=rng, device=dev)
        rows = slice(None)
        if mesh is not None:
            D = mesh.size(mesh.mesh_dim_names.index("dp"))
            if B % D:
                raise ValueError(f"batch {B} does not split over dp={D}")
            c = mesh.get_local_rank("dp")
            rows = slice(c * B // D, (c + 1) * B // D)
        with span("forward", state.step):
            loss = model.batch_loss(images[rows], gt_boxes[rows],
                                    gt_classes[rows], gt_valid[rows],
                                    gt_masks[rows], draws[rows], full_loss)
        with span("backward", state.step):
            opt.zero_grad()
            loss.backward()
        loss = loss.detach()
        with span("optimizer", state.step):
            if mesh is not None:
                mesh_lib.average_held_out_grads(
                    mesh_lib.held_out_params(model))
                # the global mean, replicated (out_shardings=(None, repl))
                loss = loss.clone()
                dist.all_reduce(loss)
                loss /= dist.get_world_size()
            opt.step()
        return TrainState(model, opt, state.step + 1), loss

    return init_fn, step_fn


def full_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The network's ``state_dict`` with every sharded tensor gathered
    whole (a collective: every rank calls it), for
    ``convert.maskrcnn_flax_tree`` and checkpoints; a one-card network's as
    it is."""
    return {k: v.full_tensor() if isinstance(v, DTensor) else v
            for k, v in model.state_dict().items()}


def full_grads(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """Each parameter's gradient with every sharded one gathered whole (a
    collective: every rank calls it), by parameter name; a parameter
    without a gradient (the RPN-only step's heads) is left out."""
    return {n: p.grad.full_tensor() if isinstance(p.grad, DTensor)
            else p.grad for n, p in model.named_parameters()
            if p.grad is not None}


def _numpy(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    # copies: a gathered tensor may be the parameter itself
    return {k: v.detach().cpu().numpy().copy() for k, v in tensors.items()}


def sharded_run(rank: int, world: int, cfg: MaskRCNNConfig, batch,
                draws, full_loss: bool = True, learning_rate: float = 1e-4,
                clip_norm: Optional[float] = None, device_type: str = "cpu"):
    """A rank function for ``parallel.launch.run_ranks``: the sharded step
    on ``make_mesh(world)`` from seed 0, one step on the global ``batch``
    (numpy arrays) for each entry of ``draws``, its gradients clipped to
    ``clip_norm`` where one is given.  Rank 0 returns each parameter's
    placements after sharding (None for one FSDP holds out) and, a step
    each, the loss, the gradients' global norm (None without a clip), the
    gathered parameters and the gathered gradients the step applied
    (numpy); the other ranks return None."""
    mesh = mesh_lib.make_mesh(world, device_type=device_type)
    init_fn, step_fn = create_train_step(cfg, learning_rate, full_loss,
                                         mesh=mesh)
    state = init_fn(0, len(batch[0]))
    state.opt_state.clip_norm = clip_norm
    dev = _mesh_device(mesh)
    placements = {n: getattr(p, "placements", None)
                  for n, p in state.params.named_parameters()}
    tensors = [torch.as_tensor(a).to(dev) for a in batch]
    steps = []
    for d in draws:
        state, loss = step_fn(state, torch.as_tensor(d).to(dev), *tensors)
        norm = state.opt_state.grad_norm
        full = _numpy(full_state_dict(state.params))
        # the step leaves its (clipped) gradients in place
        steps.append((float(loss), None if norm is None else float(norm),
                      full, _numpy(full_grads(state.params))))
    return (placements, steps) if rank == 0 else None


def sharded_runs(rank: int, world: int, runs) -> list:
    """A rank function: `sharded_run` for each keyword dict of ``runs`` in
    one process group (one start-up for several runs)."""
    return [sharded_run(rank, world, **kw) for kw in runs]
