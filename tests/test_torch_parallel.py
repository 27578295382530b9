"""The port's (dp, mp) mesh, FSDP placement rule and sharded Mask R-CNN
train step, on the CPU.

- ``parallel.mesh.mesh_shape`` against the JAX ``make_mesh(n).shape``;
- ``fsdp_param_sharding`` against the JAX package's spec on
  ``make_mesh(4)`` and ``make_mesh(8)`` (conftest's 8 virtual CPU devices)
  for every parameter of ``micro_config(64)`` and of the full-width config
  (JAX shapes from ``jax.eval_shape``), mapped through the flax layout;
  the port's meshes here come from a single-process "fake" process group,
  which gives a DeviceMesh its shape without ranks;
- ``parallel.dryrun.entry()``'s forward on the CPU: finite outputs;
- the sharded step (``create_train_step(..., mesh=)``) on 2 ranks ((2, 1)
  mesh) against the one-card port step on the same batch, parameters and
  draws, over two steps (tests/test_torch_parallel_hsdp.py: 4 ranks).
  Ranks run through ``parallel.launch.run_ranks`` (gloo, one thread a
  rank) with a timeout, in a background thread while the one-card step
  runs here.

Measured (lr 1e-4, this batch and these draws; the 2-rank full loss, the
4-rank clipped full loss and RPN-only runs): the sharded losses within
1.6e-7 relative of the one-card step's on the first step and 3.4e-6 on
the second; after one step every parameter within 1.8e-4 of the one-card
step's and all but 9e-6 of them within 1e-6, after two steps within
1.8e-4 and all but 2.5e-5 of them within 1e-6; the clipped step's global
norm within 2e-7 relative.  The parameters apart are single elements
whose gradient is of the order of Adam's epsilon (1e-8), where the first
update, lr * g / (|g| + eps), turns on the last bits of g: the sharded
gradient is the same sum taken in another order (a per-rank mean, then
FSDP's average).  Held after each step: losses 1e-5 relative, every
parameter within 2 lr a step taken (Adam's update is at most about lr),
and at most 1e-4 of the elements beyond 1e-6; the clipped global norm
1e-5 relative.
"""

import contextlib
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from maskfusion_tpu.maskrcnn import model as jm
from maskfusion_tpu.maskrcnn import synthetic_shapes as jss
from maskfusion_tpu.parallel import mesh as jmesh
from maskfusion_tpu_torch.convert import maskrcnn_flax_path
from maskfusion_tpu_torch.maskrcnn import model as tm
from maskfusion_tpu_torch.maskrcnn import synthetic_shapes as tss
from maskfusion_tpu_torch.maskrcnn.model import flax_axes
from maskfusion_tpu_torch.parallel import mesh as tmesh
from maskfusion_tpu_torch.parallel.dryrun import entry
from maskfusion_tpu_torch.parallel.launch import run_ranks
from maskfusion_tpu_torch.parallel.train import (create_train_step,
                                                 sharded_runs)

TC = tss.micro_config(64)
LR = 1e-4
RANK_TIMEOUT_S = 120.0


# ------------------------------------------------------------------ mesh
@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_matches_jax(n):
    want = jmesh.make_mesh(n, devices=jax.devices("cpu"))
    assert tmesh.mesh_shape(n) == tuple(want.shape[a] for a in ("dp", "mp"))
    assert tmesh.mesh_shape(n, ("models",)) == (n,)


@contextlib.contextmanager
def fake_mesh(n):
    """make_mesh(n) over a single-process fake process group of n ranks
    (no collective runs: placements only)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield tmesh.make_mesh(n, device_type="cpu")
    finally:
        dist.destroy_process_group()


def _mp_dim(placements):
    """The tensor dimension sharded over mp (mesh axis 1), or None."""
    p = placements[1]
    return p.dim if isinstance(p, Shard) else None


def _jax_mp_dim(spec):
    return next((i for i, a in enumerate(spec) if a == "mp"), None)


@functools.lru_cache(maxsize=None)
def _both_shapes(which):
    """The JAX parameter tree's shapes (jax.eval_shape) and the port
    network's parameters on the meta device, of one config."""
    jcfg = jss.micro_config(64) if which == "micro" else jm.MaskRCNNConfig()
    tcfg = TC if which == "micro" else tm.MaskRCNNConfig()
    shapes = jax.eval_shape(jm.MaskRCNN(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))["params"]
    with torch.device("meta"):
        net = tm.MaskRCNN(tcfg)
    return shapes, dict(net.named_parameters())


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("which", ["micro", "full_width"])
def test_fsdp_placements_match_jax(n, which):
    """Every parameter's placement on make_mesh(n) is the JAX package's
    spec for the same flax leaf, the sharded flax axis mapped to the torch
    tensor's by flax_axes; the rule on the torch shape alone would differ
    (a 64 -> 64 conv shards its input channels in flax, its output channels
    first in torch)."""
    tcfg = TC if which == "micro" else tm.MaskRCNNConfig()
    shapes, params = _both_shapes(which)
    jax_mesh = jmesh.make_mesh(n, devices=jax.devices("cpu"))
    assert len(params) == len(jax.tree.leaves(shapes))
    differs_on_torch_shape = 0
    with fake_mesh(n) as mesh:
        assert mesh.shape == tuple(jax_mesh.shape.values())
        for name, p in params.items():
            leaf = shapes
            for part in maskrcnn_flax_path(name, tcfg):
                leaf = leaf[part]
            jdim = _jax_mp_dim(jmesh.fsdp_param_sharding(jax_mesh,
                                                         leaf).spec)
            placements = tmesh.fsdp_param_sharding(mesh, p, name=name)
            assert placements[0] == Replicate(), name
            want = (None if jdim is None
                    else flax_axes(name, p.dim()).index(jdim))
            assert _mp_dim(placements) == want, (name, leaf.shape, jdim)
            differs_on_torch_shape += (
                _mp_dim(tmesh.fsdp_param_sharding(mesh, p)) != want)
    assert differs_on_torch_shape > 0


def test_fsdp_sharding_picks_divisible_axis():
    """tests/test_parallel.py's two cases on make_mesh(8): a (3, 3, 64,
    128) kernel shards its largest axis over mp (as a torch conv weight,
    (128, 64, 3, 3), the same logical axis: dim 0), a (7,) vector
    replicates."""
    with fake_mesh(8) as mesh:
        assert tmesh.fsdp_param_sharding(mesh, (3, 3, 64, 128)) == (
            Replicate(), Shard(3))
        assert tmesh.fsdp_param_sharding(
            mesh, (128, 64, 3, 3), name="backbone.blocks.0.conv2.weight"
        ) == (Replicate(), Shard(0))
        assert tmesh.fsdp_param_sharding(mesh, (7,)) == tmesh.replicated(
            mesh) == (Replicate(), Replicate())
        assert tmesh.batch_sharding(mesh) == (Shard(0), Replicate())


def test_make_mesh_needs_its_process_group():
    with pytest.raises(RuntimeError, match="no process group"):
        tmesh.make_mesh(2, device_type="cpu")
    with fake_mesh(4):
        with pytest.raises(RuntimeError, match="has 4 ranks"):
            tmesh.make_mesh(8, device_type="cpu")


def test_entry_forward_is_finite():
    forward, (model, image) = entry(device="cpu")
    boxes, classes, scores, masks = forward(model, image)
    assert boxes.shape == (32, 4) and classes.shape == scores.shape == (32,)
    assert masks.shape[0] == 32
    for t in (boxes, scores, masks):
        assert torch.isfinite(t).all()


# ------------------------------------------------------- the sharded step
def inputs():
    batch = tss.make_batch(np.random.default_rng(0), 2, 64)
    n = TC.post_nms_proposals + batch[1].shape[1]
    draws = [torch.rand((2, 2, n), generator=torch.Generator().manual_seed(
        s)).numpy() for s in range(2)]
    return batch, draws


def one_card(batch, draws, full_loss, clip_norm=None):
    """The one-card port step from seed 0: (loss, grad norm, parameters)
    after each step."""
    init_fn, step_fn = create_train_step(TC, LR, full_loss, device="cpu")
    state = init_fn(0, 2)
    state.opt_state.clip_norm = clip_norm
    init = {k: v.numpy().copy() for k, v in state.params.state_dict().items()}
    out = []
    for d in draws:
        state, loss = step_fn(state, torch.from_numpy(d),
                              *map(torch.from_numpy, batch))
        norm = state.opt_state.grad_norm
        out.append((float(loss), None if norm is None else float(norm),
                    {k: v.numpy().copy()
                     for k, v in state.params.state_dict().items()}))
    return init, out


@pytest.fixture(scope="module")
def runs():
    """The 2-rank run, started first in a background thread; the one-card
    reference computed meanwhile."""
    batch, draws = inputs()
    with ThreadPoolExecutor(1) as pool:
        future = pool.submit(run_ranks, sharded_runs, 2, "gloo", ([dict(
            cfg=TC, batch=batch, learning_rate=LR, draws=draws)],),
            RANK_TIMEOUT_S)
        _init, ref = one_card(batch, draws, True)
        (sharded,), _ = future.result(timeout=2 * RANK_TIMEOUT_S)
    return {"ref": ref, "sharded": sharded}


def assert_params_close(got, want, lr, n_steps=1):
    """Every parameter after `n_steps` steps within 2 lr a step (Adam's
    update is at most about lr either way), at most 1e-4 of them beyond
    1e-6."""
    diff = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    assert got.keys() == want.keys()
    assert diff.max() <= 2 * lr * n_steps, diff.max()
    assert (diff > 1e-6).mean() <= 1e-4, (diff > 1e-6).mean()


def assert_step_matches(steps, ref):
    """The bounds of the module docstring: each step's loss and the
    parameters after it (a sharded step's record also holds its
    gradients)."""
    assert len(steps) == len(ref)
    for i, (got, want) in enumerate(zip(steps, ref)):
        assert abs(got[0] - want[0]) <= 1e-5 * abs(want[0]), (i, got, want)
        assert_params_close(got[2], want[2], LR, i + 1)


def assert_placements_follow_the_rule(placements, world):
    """After sharding, every parameter FSDP manages has the placements
    fsdp_param_sharding gives it on make_mesh(world) (on a (2, 1) mesh a
    shard of the whole tensor, which is a replica); the parameters the rule
    replicates over mp > 1 are held out (None)."""
    with torch.device("meta"):
        shapes = {k: p.shape for k, p in tm.MaskRCNN(TC).named_parameters()}
    assert placements.keys() == shapes.keys()
    with fake_mesh(world) as mesh:
        size = mesh.size(1)
        for name, got in placements.items():
            want = tmesh.fsdp_param_sharding(mesh, shapes[name], name=name)
            if size > 1 and want == tmesh.replicated(mesh):
                assert got is None, name
            elif size > 1:
                assert tuple(got) == want, name
            else:
                assert tuple(got) == (Replicate(), Shard(_mp_dim(
                    want) or 0)), name
    held = [k for k, v in placements.items() if v is None]
    assert bool(held) == (size > 1)


def test_sharded_step_matches_one_card(runs):
    """The 2-rank step ((2, 1) mesh: the batch split over dp, every
    parameter a whole shard) against the one-card step: each step's loss
    and the parameters after it (bounds in the module docstring)."""
    assert_step_matches(runs["sharded"][1], runs["ref"])


def test_sharded_placements_follow_the_rule(runs):
    assert_placements_follow_the_rule(runs["sharded"][0], 2)
