"""The object models split over a "models" axis of devices.

Port of ``maskfusion_tpu/parallel/multimodel.py``.  The JAX engine stacks
the per-object tracking and fuse problems on a leading slot axis, vmaps the
solve, and puts a GSPMD sharding constraint ``PartitionSpec(axis)`` on that
axis, so that each device of the mesh tracks and fuses a contiguous block
of the object slots in one SPMD dispatch (replacing the reference's
sequential per-model loop, MaskFusion.cpp:246-278).

PyTorch has no GSPMD.  The port keeps the JAX engine's single-controller
contract (one process, one host loop, the same lifecycle, results equal to
the unsharded run's) and places the work explicitly: `shard_model_axis`
returns the same contiguous block plan, and the engine
(``MaskFusion(..., mesh=ModelMesh(...))``, engine._shard_model_axis) runs
each block's solve and fuse on its device.  This module is the one
implementation of the plan; the engine and ``parallel.dryrun`` use it.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch


class ModelMesh:
    """A one-process mesh: an ordered list of devices along one named axis
    (``.shape == {axis: len(devices)}``, as a ``jax.sharding.Mesh``'s).
    A device may repeat.  That is how the split runs on a machine with
    fewer cards than blocks: ``ModelMesh(["cpu", "cpu"])`` in the CPU
    tests, ``ModelMesh(["cuda:0", "cuda:0"])`` on one card.  Each block
    then still runs on its own, on the shared device."""

    def __init__(self, devices: Sequence, axis: str = "models"):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("ModelMesh: no devices")
        self.axis = axis

    @property
    def shape(self) -> dict:
        return {self.axis: len(self.devices)}

    def __repr__(self) -> str:
        return (f"ModelMesh({[str(d) for d in self.devices]}, "
                f"axis={self.axis!r})")


class Block(NamedTuple):
    """Slots [start, stop) of the stacked object axis, on `device`."""
    device: torch.device
    start: int
    stop: int


def shard_model_axis(mesh: Optional[ModelMesh], axis: str,
                     n: int) -> Optional[List[Block]]:
    """The block plan ``PartitionSpec(axis)`` gives a leading axis of n
    slots: device k of the axis owns slots [k n / size, (k + 1) n / size).
    None -- every slot stays on the engine's device -- where the JAX
    constraint is a no-op: no mesh, an axis of one device (or none by that
    name), no slot, or n not a multiple of the axis size (GSPMD needs
    divisibility; the unsplit stack is always correct)."""
    if mesh is None:
        return None
    size = mesh.shape.get(axis, 1)
    if n == 0 or size <= 1 or n % size:
        return None
    k = n // size
    return [Block(dev, i * k, (i + 1) * k)
            for i, dev in enumerate(mesh.devices)]
