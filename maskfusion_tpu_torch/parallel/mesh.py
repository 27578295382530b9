"""The (dp, mp) device mesh and the FSDP placement rule.

Port of ``maskfusion_tpu/parallel/mesh.py``.  The JAX package has one
controller: a ``jax.sharding.Mesh`` of devices and GSPMD sharding
annotations.  PyTorch's collectives run between processes, so here the
mesh is a ``torch.distributed`` ``DeviceMesh`` over the ranks of an
initialised process group (one rank a card; ``parallel.launch`` starts
them), and a placement is a DTensor placement tuple, one entry a mesh
axis: ``Replicate()`` is ``P()``'s, ``Shard(d)`` on the named axis is
``P(..., axis at d, ...)``'s.

`fsdp_param_sharding` keeps the JAX rule (shard the largest dimension
that the axis size divides, the lowest index on ties, else replicate) and
applies it to the parameter's flax-layout shape: torch holds conv kernels
(out, in, kh, kw) where flax holds (kh, kw, in, out), so the same rule on
the torch shape would pick another logical axis where dimensions tie (a
64 -> 64 conv).  `shard_pytree_fsdp` turns the rule into FSDP2
``fully_shard`` units.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.fsdp import fully_shard
from torch.distributed.tensor import DTensor, Replicate, Shard

from maskfusion_tpu_torch.maskrcnn.model import flax_axes


def mesh_shape(n: int, axes: Sequence[str] = ("dp", "mp")
               ) -> Tuple[int, ...]:
    """The JAX factorisation of n devices: mp = 2 when n is even and > 2,
    else 1; one axis takes all n."""
    if len(axes) == 1:
        return (n,)
    mp = 2 if n % 2 == 0 and n > 2 else 1
    return (n // mp, mp)


def make_mesh(n_devices: Optional[int] = None,
              axes: Tuple[str, ...] = ("dp", "mp"),
              device_type: Optional[str] = None) -> DeviceMesh:
    """A DeviceMesh of ``mesh_shape(n_devices)`` over the initialised
    process group, axes named ``axes``; ``cuda`` unless ``device_type`` is
    given.  Raises unless a process group of exactly n_devices ranks
    (default: its size) is initialised; it never starts one."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; start the ranks "
                           "with parallel.launch.run_ranks")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise RuntimeError(f"make_mesh: {n} devices asked for, the process "
                           f"group has {world} ranks")
    shape = mesh_shape(n, axes)
    return init_device_mesh(device_type or "cuda", shape,
                            mesh_dim_names=tuple(axes[:len(shape)]))


def _axis_dim(mesh: DeviceMesh, axis: str) -> int:
    return mesh.mesh_dim_names.index(axis)


def replicated(mesh: DeviceMesh) -> tuple:
    """``NamedSharding(mesh, P())``: a full copy on every rank."""
    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def _sharded(mesh: DeviceMesh, axis: str, dim: int) -> tuple:
    out = list(replicated(mesh))
    out[_axis_dim(mesh, axis)] = Shard(dim)
    return tuple(out)


def batch_sharding(mesh: DeviceMesh, axis: str = "dp") -> tuple:
    """``NamedSharding(mesh, P(axis))``: the leading (batch) dimension split
    over ``axis``, replicated over the others."""
    return _sharded(mesh, axis, 0)


def fsdp_dim(shape: Sequence[int], size: int) -> Optional[int]:
    """The JAX rule (mesh.py:52-66 of the JAX package) on a shape: the
    largest dimension divisible by ``size`` and at least ``size``, the
    lowest index among equal ones; None (replicate) where none is, or
    where size is 1."""
    if size == 1:
        return None
    for d in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if shape[d] % size == 0 and shape[d] >= size:
            return d
    return None


def fsdp_param_dim(shape: Sequence[int], size: int,
                   name: Optional[str] = None) -> Optional[int]:
    """`fsdp_dim` applied to the parameter's flax layout and mapped back to
    the torch tensor's dimension (``name``: its ``state_dict`` key in a
    ``MaskRCNN``; without one the shape is taken as it is)."""
    axes = flax_axes(name, len(shape)) if name else tuple(range(len(shape)))
    flax_shape = [0] * len(shape)
    for i, a in enumerate(axes):
        flax_shape[a] = shape[i]
    d = fsdp_dim(flax_shape, size)
    return None if d is None else axes.index(d)


def fsdp_param_sharding(mesh: DeviceMesh, param, axis: str = "mp",
                        name: Optional[str] = None) -> tuple:
    """The JAX package's placement of a parameter (a tensor or a shape):
    ``Shard(d)`` on ``axis`` for the dimension `fsdp_param_dim` picks,
    replicated otherwise."""
    shape = tuple(param.shape) if hasattr(param, "shape") else tuple(param)
    d = fsdp_param_dim(shape, mesh.size(_axis_dim(mesh, axis)), name)
    return replicated(mesh) if d is None else _sharded(mesh, axis, d)


def shard_pytree_fsdp(model: nn.Module, mesh: DeviceMesh,
                      units: Sequence[nn.Module], axis: str = "mp"
                      ) -> nn.Module:
    """Shard ``model``'s parameters by the JAX rule with FSDP2, in place.

    Each of ``units`` (nested ones innermost first) and then ``model``
    becomes a ``fully_shard`` unit on the mesh: on a 2-D (dp, mp) mesh
    that is HSDP, replicated over dp and sharded over mp, the JAX
    package's layout (batch on dp, parameters FSDP on mp).  A parameter is
    held as ``Shard(d)`` on ``axis`` with d from `fsdp_param_dim`.  Where
    the rule replicates it and the axis has more than one rank, FSDP
    leaves it out (``ignored_params``): it stays a full tensor on every
    rank, and its gradient is averaged by `average_held_out_grads`.  Where
    the axis has one rank, a shard is the whole tensor, so FSDP keeps it
    (its reduction averages over dp)."""
    size = mesh.size(_axis_dim(mesh, axis))
    names = {p: n for n, p in model.named_parameters()}
    held_out = {p for p, n in names.items()
                if size > 1 and fsdp_param_dim(p.shape, size, n) is None}

    def placement(p: nn.Parameter) -> Shard:
        d = fsdp_param_dim(p.shape, size, names[p])
        return Shard(0 if d is None else d)

    for unit in units:
        fully_shard(unit, mesh=mesh, shard_placement_fn=placement,
                    ignored_params=held_out)
    fully_shard(model, mesh=mesh, shard_placement_fn=placement,
                ignored_params=held_out)
    return model


def held_out_params(model: nn.Module) -> list:
    """The parameters FSDP does not manage (full tensors, not DTensors)."""
    return [p for p in model.parameters() if not isinstance(p, DTensor)]


def average_held_out_grads(params: Sequence[torch.Tensor]) -> None:
    """Average the gradients of FSDP's held-out parameters over every rank
    (an all-reduce; gloo has no average, so a sum then a division).  A
    parameter without a gradient (the RPN-only step's heads) has none on
    any rank and is skipped."""
    world = dist.get_world_size()
    for p in params:
        if p.grad is not None:
            dist.all_reduce(p.grad)
            p.grad.div_(world)
