"""The port's whole training loss and its gradients against the JAX
package's, on the CPU, at micro_config(64) in float32.

The same JAX-initialised parameters (carried by convert.maskrcnn_state_dict)
and the same scene go through ``MaskRCNN.train_losses`` in both packages,
with JAX's draws for the proposal sampling; every parameter's gradient
comes back into the JAX tree through convert.maskrcnn_flax_tree.  The
proposals, their NMS and the sampled ROIs are the same in both (the
forward agrees to ~1e-5), so the losses agree to float32 rounding and the
gradients to its propagation through the backward.  Measured over the two
scenes: each loss within 2.5e-6 relative, every leaf's gradient within
3.0e-6 relative L2 (the largest: fc1, the stem conv, GroupNorm scales),
the whole gradient within 2.5e-6.  Held: 1e-5 relative per loss, 1e-4
relative L2 per leaf and 2e-5 over the whole gradient.  One jit of the JAX
value-and-grad takes ~50 s on one CPU core from a cold compile cache.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskfusion_tpu.maskrcnn import model as jm
from maskfusion_tpu.maskrcnn import synthetic_shapes as jss
from maskfusion_tpu_torch.convert import (maskrcnn_flax_tree,
                                          maskrcnn_state_dict)
from maskfusion_tpu_torch.maskrcnn import checkpoint_io as tio
from maskfusion_tpu_torch.maskrcnn import model as tm
from maskfusion_tpu_torch.maskrcnn import synthetic_shapes as tss

JC, TC = jss.micro_config(64), tss.micro_config(64)
SCENES = 2


@pytest.fixture(scope="module")
def both():
    """Per scene: (JAX losses, JAX gradient tree, port losses, port
    gradient tree)."""
    jmodel = jm.MaskRCNN(JC)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))

    def loss_fn(p, img, b, c, v, m, key):
        out = jmodel.apply(p, img[None], b, c, v, m, key,
                           method=jm.MaskRCNN.train_losses)
        return out["total"], out

    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    tmodel = tm.MaskRCNN(TC)
    tmodel.load_state_dict(maskrcnn_state_dict(params, TC))
    rng = np.random.default_rng(0)
    out = []
    for i in range(SCENES):
        scene = tss.make_shapes_scene(rng, 64)
        key = jax.random.PRNGKey(i)
        (_, jl), jg = vg(params, *map(jnp.asarray, scene), key)
        draws = np.asarray(jax.random.uniform(
            key, (2, TC.post_nms_proposals + scene[1].shape[0])))
        tmodel.zero_grad()
        tl = tmodel.train_losses(
            *(torch.from_numpy(a) for a in (scene[0][None],) + scene[1:]),
            torch.from_numpy(draws))
        tl["total"].backward()
        tg = maskrcnn_flax_tree({n: p.grad for n, p in
                                 tmodel.named_parameters()}, TC)
        out.append(({k: float(v) for k, v in jl.items()},
                    tio._flatten(jax.tree.map(np.asarray, jg)),
                    {k: float(v.detach()) for k, v in tl.items()},
                    tio._flatten(tg)))
    return out


@pytest.mark.parametrize("scene", range(SCENES))
def test_train_losses_match_jax(both, scene):
    jl, _, tl, _ = both[scene]
    assert jl.keys() == tl.keys()
    for k in jl:
        assert abs(tl[k] - jl[k]) <= 1e-5 * abs(jl[k]), (k, tl[k], jl[k])
    assert jl["mask"] > 0 and jl["box"] > 0      # positives were sampled


@pytest.mark.parametrize("scene", range(SCENES))
def test_every_parameter_gradient_matches_jax(both, scene):
    _, jg, _, tg = both[scene]
    assert jg.keys() == tg.keys()
    worst, num, den = {}, 0.0, 0.0
    for k in jg:
        a, b = jg[k].astype(np.float64), tg[k].astype(np.float64)
        assert a.shape == b.shape, k
        d, n = np.linalg.norm(b - a), np.linalg.norm(a)
        num, den = num + d * d, den + n * n
        worst[k] = d / max(n, 1e-30)
        assert n > 0, f"{k}: no gradient"
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:3]
    assert top[0][1] <= 1e-4, top
    assert np.sqrt(num / den) <= 2e-5, np.sqrt(num / den)
