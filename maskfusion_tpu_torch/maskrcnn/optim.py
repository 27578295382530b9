"""The optimiser of the Mask R-CNN training recipes, as optax computes it.

The JAX package trains with ``optax.adam`` (``parallel/train.py``,
``synthetic_shapes.train_shapes``) and with ``optax.chain(
clip_by_global_norm(5.0), adam(schedule))`` over a warm-up and cosine
schedule (``synthetic_shapes.train_rich``).  ``torch.optim.Adam`` computes
optax's Adam update (the same moments, bias corrections and epsilon outside
the square root); the global-norm clip is written here because
``torch.nn.utils.clip_grad_norm_`` scales by ``max_norm / (norm + 1e-6)``
where optax scales by ``max_norm / norm``; the schedules are optax's
formulas on the host, read at the update's count (0 for the first update,
as optax's ``scale_by_schedule``).  Nothing here waits for the card.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional, Sequence, Union

import torch
from torch.distributed.tensor import DTensor

Schedule = Callable[[int], float]


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    """optax.linear_schedule: init_value to end_value over
    transition_steps, then end_value."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count: int) -> float:
        frac = 1 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule: init_value times a half cosine from 1
    down to alpha over decay_steps, then alpha."""
    if not decay_steps > 0:
        raise ValueError(f"decay_steps must be positive, got {decay_steps}")

    def schedule(count: int) -> float:
        t = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * t / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def join_schedules(schedules: Sequence[Schedule],
                   boundaries: Sequence[int]) -> Schedule:
    """optax.join_schedules: each schedule from its boundary on, counted
    from that boundary."""
    def schedule(count: int) -> float:
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sched(count - boundary)
        return out

    return schedule


def warmup_cosine(lr: float, warmup: int, steps: int) -> Schedule:
    """train_rich's schedule (synthetic_shapes.py:312-316 of the JAX
    package): linear from 0.05 lr to lr over ``warmup`` updates, then a
    cosine decay to 0.05 lr over the rest."""
    return join_schedules(
        [linear_schedule(lr * 0.05, lr, warmup),
         cosine_decay_schedule(lr, max(steps - warmup, 1), 0.05)],
        [warmup])


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: every gradient scaled by
    max_norm / norm when the global norm is not below max_norm (``(g /
    norm) * max_norm``, optax's order).  Returns the global norm, a device
    scalar (no host synchronise).  The gradients of a sharded network
    (DTensors, ``parallel.train``) count whole: their squares are summed
    over the shards (one all-reduce), and each rank scales its shard."""
    sharded = [g for g in grads if isinstance(g, DTensor)]
    plain = [g for g in grads if not isinstance(g, DTensor)]
    sq = sum(g.float().pow(2).sum() for g in plain)
    if sharded:
        sq = sq + sum(g.float().pow(2).sum()
                      for g in sharded).full_tensor()
    norm = torch.sqrt(sq)
    clip = norm >= max_norm
    for g in grads:
        local = g.to_local() if isinstance(g, DTensor) else g
        local.copy_(torch.where(clip, (local / norm) * max_norm, local))
    return norm


class Optimizer:
    """Adam (optax's update, b1 0.9, b2 0.999, eps 1e-8) over ``params``,
    with a constant learning rate or a schedule of the update count, after
    an optional global-norm clip of the gradients."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 lr: Union[float, Schedule],
                 clip_norm: Optional[float] = None):
        self.params = list(params)
        self.schedule = lr if callable(lr) else (lambda count: lr)
        self.clip_norm = clip_norm
        self.grad_norm: Optional[torch.Tensor] = None   # the last clip's
        self.count = 0
        # a sharded network's DTensors and the full tensors FSDP holds out
        # (parallel.mesh) update in groups of their own: a group's foreach
        # kernels take one kind
        groups = [[p for p in self.params if isinstance(p, DTensor) == d]
                  for d in (False, True)]
        self.adam = torch.optim.Adam([{"params": g} for g in groups if g],
                                     lr=self.schedule(0),
                                     betas=(0.9, 0.999), eps=1e-8)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        """One update from the gradients in ``.grad``.  A parameter without
        one is left as it is, as optax leaves a parameter whose gradients
        have all been zero (the RPN-only step's heads)."""
        if self.clip_norm is not None:
            self.grad_norm = clip_by_global_norm_(
                [p.grad for p in self.params if p.grad is not None],
                self.clip_norm)
        for group in self.adam.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adam.step()
        self.count += 1
