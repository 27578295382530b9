"""The Mask R-CNN training step, on one card.

Port of ``maskfusion_tpu/parallel/train.py``: ``create_train_step``
returns ``(init_fn, step_fn)`` with the JAX signatures.  The step takes a
batch of images with their ground truth, computes the mean over the batch
of each image's loss (``MaskRCNN.train_losses``, or the RPN loss alone for
the warm-up) where JAX ``vmap``s, and applies one Adam update as
``optax.adam`` computes it (``maskrcnn.optim``) to float32 parameters.  The
loss stays a device tensor: a step on device-resident inputs issues no
host synchronise.

The JAX step is SPMD over a (dp, mp) mesh, batch on dp, parameters
FSDP-sharded on mp.  That mesh, the sharded step and
``__graft_entry__.dryrun_multichip`` wait for multi-device support
(ROADMAP queue 1 item 14); this step runs on one card.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

from maskfusion_tpu_torch import resolve_device
from maskfusion_tpu_torch.maskrcnn.model import (MaskRCNN, MaskRCNNConfig,
                                                 init_params_, rpn_loss)
from maskfusion_tpu_torch.maskrcnn.optim import Optimizer


class TrainState(NamedTuple):
    params: MaskRCNN         # the network, float32 parameters
    opt_state: Optimizer
    step: int


def create_train_step(cfg: MaskRCNNConfig, learning_rate: float = 1e-4,
                      full_loss: bool = True, device=None):
    """Returns (init_fn, step_fn).

    ``init_fn(rng, batch_size)`` initialises the network from the integer
    seed ``rng`` with flax's default distributions (``init_params_``).
    ``step_fn(state, rng, images, gt_boxes, gt_classes, gt_valid,
    gt_masks)`` takes tensors on the step's device: images (B, S, S, 3)
    float32 in [0, 255], gt_boxes (B, G, 4), gt_classes (B, G), gt_valid
    (B, G) bool, gt_masks (B, G, S, S); ``rng`` is a torch.Generator on
    that device, from which the step draws the proposal sampling's uniform
    scores, or those draws themselves, (B, 2, post_nms_proposals + G).  It
    updates the state's network in place and returns the next state and
    the batch's mean loss (a device scalar).

    full_loss=True optimises the complete objective (RPN class and box,
    box head class and box, mask head through proposal-target sampling);
    False the RPN loss alone (the warm-up).  Runs on the first CUDA card
    unless ``device="cpu"``; raises when no card is found."""
    dev = resolve_device(device, "create_train_step")

    def init_fn(rng: int, batch_size: int) -> TrainState:
        del batch_size               # the JAX init runs on one image too
        model = init_params_(MaskRCNN(cfg), int(rng)).to(dev)
        if dev.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        return TrainState(model, Optimizer(model.parameters(),
                                           learning_rate), 0)

    def image_loss(model, img, boxes, classes, valid, masks, draws):
        if full_loss:
            return model.train_losses(img[None], boxes, classes, valid,
                                      masks, draws)["total"]
        logits, deltas = model.rpn(model.features(img[None]))
        return rpn_loss(logits[0], deltas[0], model.anchors, boxes, valid,
                        cfg)

    def step_fn(state: TrainState, rng: Union[torch.Generator,
                                              torch.Tensor],
                images, gt_boxes, gt_classes, gt_valid, gt_masks):
        model, opt = state.params, state.opt_state
        B, G = gt_boxes.shape[:2]
        draws = rng if isinstance(rng, torch.Tensor) else torch.rand(
            (B, 2, cfg.post_nms_proposals + G), generator=rng, device=dev)
        loss = torch.stack([
            image_loss(model, images[b], gt_boxes[b], gt_classes[b],
                       gt_valid[b], gt_masks[b], draws[b])
            for b in range(B)]).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        return TrainState(model, opt, state.step + 1), loss.detach()

    return init_fn, step_fn
