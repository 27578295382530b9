"""Parity of the port's Mask R-CNN training (maskfusion_tpu_torch.maskrcnn
model losses, optim, convert, checkpoint_io; parallel.train) with the JAX
package's on the CPU.

Each loss helper gets the same seeded numpy inputs in both packages and is
held, value and gradient (autograd against ``jax.grad``), to 1e-5 relative;
``proposal_targets`` takes JAX's own draws (``jax.random.uniform(rng, (2,
N))``) and gives the same samples.  The optimiser (Adam, the global-norm
clip, train_rich's schedule) is fed JAX's gradients and held to optax's
parameters within 1e-6.  The parameter-tree converters are exact both
ways.  The whole network's loss and gradients at micro_config(64) are in
tests/test_torch_maskrcnn_grads.py (its JAX compile alone takes ~50 s).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from maskfusion_tpu.maskrcnn import checkpoint_io as jio
from maskfusion_tpu.maskrcnn import model as jm
from maskfusion_tpu.maskrcnn import synthetic_shapes as jss
from maskfusion_tpu_torch.convert import (maskrcnn_flax_tree,
                                          maskrcnn_state_dict)
from maskfusion_tpu_torch.maskrcnn import checkpoint_io as tio
from maskfusion_tpu_torch.maskrcnn import model as tm
from maskfusion_tpu_torch.maskrcnn import optim
from maskfusion_tpu_torch.maskrcnn import synthetic_shapes as tss
from maskfusion_tpu_torch.parallel.train import TrainState, create_train_step

JC, TC = jss.micro_config(64), tss.micro_config(64)


def T(a, grad=False) -> torch.Tensor:
    return torch.tensor(np.array(a), requires_grad=grad)


def close(port, ref, rtol=1e-5):
    """Within rtol of the reference's largest magnitude."""
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    np.testing.assert_allclose(port, ref,
                               atol=rtol * max(np.abs(ref).max(), 1e-12))


def _boxes(rng, n, lo=0.0, hi=0.7, size=(0.05, 0.4)):
    y1, x1 = rng.uniform(lo, hi, (2, n))
    h, w = rng.uniform(*size, (2, n))
    return np.stack([y1, x1, np.minimum(y1 + h, 1), np.minimum(x1 + w, 1)],
                    -1).astype(np.float32)


def test_config_training_fields():
    """The five training fields with the JAX defaults, and the domains'
    settings (train_rois, positive ratio, RPN positive IoU)."""
    names = ("rpn_positive_iou", "rpn_negative_iou", "train_rois",
             "roi_positive_ratio", "roi_positive_iou")
    for jc, tc in ((jm.MaskRCNNConfig(), tm.MaskRCNNConfig()), (JC, TC),
                   (jss.rich_config(), tss.rich_config())):
        assert [getattr(tc, k) for k in names] == \
            [getattr(jc, k) for k in names]


# ------------------------------------------------------------ RPN loss
def _rpn_inputs(seed=0):
    rng = np.random.default_rng(seed)
    anchors = jm.generate_anchors(JC)
    A = anchors.shape[0]
    gt = np.concatenate([_boxes(rng, 2), np.zeros((1, 4), np.float32)])
    valid = np.array([True, True, False])
    logits = rng.normal(0, 1, (A, 2)).astype(np.float32)
    deltas = rng.normal(0, 1, (A, 4)).astype(np.float32)
    return anchors, gt, valid, logits, deltas


def test_rpn_targets_and_loss_match_jax():
    """Labels equal, target deltas and the loss within 1e-5, the gradients
    of logits and deltas within 1e-5 (relative to their largest)."""
    anchors, gt, valid, logits, deltas = _rpn_inputs()
    lj, dj = jm.rpn_targets(jnp.asarray(anchors), gt, valid, JC)
    lt, dt = tm.rpn_targets(T(anchors), T(gt), T(valid), TC)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    assert (lt.numpy() == 1).sum() >= 2
    close(dt, dj)
    val, grads = jax.value_and_grad(jm.rpn_loss, argnums=(0, 1))(
        logits, deltas, jnp.asarray(anchors), gt, valid, JC)
    tl, td = T(logits, True), T(deltas, True)
    loss = tm.rpn_loss(tl, td, T(anchors), T(gt), T(valid), TC)
    loss.backward()
    close(loss, val)
    close(tl.grad, grads[0])
    close(td.grad, grads[1])


def test_rpn_targets_duplicate_best_anchor():
    """A valid gt whose best anchor is anchor 0 (IoU 0.06: below both
    thresholds, so only the best-anchor rule makes it positive) beside a
    padded gt, whose all-zero IoU column also names anchor 0.  The port
    makes anchor 0 positive.  The JAX package's scatter writes anchor 0
    twice, the valid gt's 1 and then the padded gt's unchanged 0, and on
    XLA:CPU the last write stays: its anchor 0 is 0 (ROADMAP §3, a finding
    on the reference).  Without the padded gt the JAX package gives the
    port's labels, loss and gradients."""
    anchors, _, _, logits, deltas = _rpn_inputs(1)
    gt = np.array([[0.0, 0.0, 0.03, 0.03], [0, 0, 0, 0]], np.float32)
    valid = np.array([True, False])
    lt, dt = tm.rpn_targets(T(anchors), T(gt), T(valid), TC)
    lj, _ = jm.rpn_targets(jnp.asarray(anchors), gt, valid, JC)
    lj1, dj1 = jm.rpn_targets(jnp.asarray(anchors), gt[:1], valid[:1], JC)
    assert lt[0] == 1 and int(lj1[0]) == 1
    assert int(lj[0]) == 0                    # the reference's scatter order
    np.testing.assert_array_equal(lt.numpy()[1:], np.asarray(lj)[1:])
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj1))
    close(dt, dj1)
    val, grads = jax.value_and_grad(jm.rpn_loss, argnums=(0, 1))(
        logits, deltas, jnp.asarray(anchors), gt[:1], valid[:1], JC)
    tl, td = T(logits, True), T(deltas, True)
    loss = tm.rpn_loss(tl, td, T(anchors), T(gt), T(valid), TC)
    loss.backward()
    close(loss, val)
    close(tl.grad, grads[0])
    close(td.grad, grads[1])


# --------------------------------------------------- head-side helpers
def test_box_deltas_between_matches_jax():
    rng = np.random.default_rng(2)
    src, dst = _boxes(rng, 20), _boxes(rng, 20)
    src[3, 2:] = src[3, :2]                    # a zero-size box (clipped)

    def f(a, b):
        return jnp.sum(jm.box_deltas_between(a, b, JC) ** 2)

    gj = jax.grad(f, argnums=(0, 1))(src, dst)
    ts, td = T(src, True), T(dst, True)
    out = tm.box_deltas_between(ts, td, TC)
    close(out, jm.box_deltas_between(src, dst, JC))
    (out ** 2).sum().backward()
    close(ts.grad, gj[0])
    close(td.grad, gj[1])


def test_crop_masks_to_boxes_matches_jax():
    """Values, and the gradients of masks and boxes, within 1e-5; and the
    JAX package's own checks (tests/test_maskrcnn_train.py:65-76)."""
    rng = np.random.default_rng(3)
    masks = (rng.random((5, 32, 32)) < 0.5).astype(np.float32)
    boxes = _boxes(rng, 5)

    def f(m, b):
        return jnp.sum(jm.crop_masks_to_boxes(m, b, 14) ** 2)

    gj = jax.grad(f, argnums=(0, 1))(masks, boxes)
    tmk, tb = T(masks, True), T(boxes, True)
    out = tm.crop_masks_to_boxes(tmk, tb, 14)
    close(out, jm.crop_masks_to_boxes(masks, boxes, 14))
    (out ** 2).sum().backward()
    close(tmk.grad, gj[0])
    close(tb.grad, gj[1])

    m = np.zeros((1, 32, 32), np.float32)
    m[0, 8:16, 8:24] = 1.0
    crop = tm.crop_masks_to_boxes(
        T(m), torch.tensor([[8 / 32, 8 / 32, 16 / 32, 24 / 32]]), 8).numpy()
    assert crop.shape == (1, 8, 8)
    assert crop[0, 1:-1, 1:-1].min() > 0.9
    crop0 = tm.crop_masks_to_boxes(
        T(m), torch.tensor([[0.7, 0.7, 0.95, 0.95]]), 8).numpy()
    assert crop0.max() < 1e-6


def _targets_inputs(seed=4, n=34, live=None):
    """Proposals around two valid gts (some positive) and elsewhere, a
    padded gt, the proposals past ``live`` invalid; the JAX draws of
    PRNGKey(seed)."""
    rng = np.random.default_rng(seed)
    gt = np.concatenate([_boxes(rng, 2, size=(0.2, 0.4)),
                         np.zeros((1, 4), np.float32)])
    props = np.concatenate([
        gt[rng.integers(0, 2, n // 2)] + rng.normal(
            0, 0.03, (n // 2, 4)).astype(np.float32),
        _boxes(rng, n - n // 2)])
    props = np.clip(props, 0, 1).astype(np.float32)
    if live is not None:
        props = props[np.r_[0:live // 2, n // 2:n // 2 + live - live // 2,
                            live // 2:n // 2, n // 2 + live - live // 2:n]]
    prop_valid = (rng.random(n) < 0.85) if live is None \
        else np.arange(n) < live
    classes = np.array([1, 2, 0], np.int32)
    gt_valid = np.array([True, True, False])
    masks = (rng.random((3, 64, 64)) < 0.5).astype(np.float32)
    draws = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (2, n)))
    return draws, props, prop_valid, gt, classes, gt_valid, masks


def _port_targets(inputs):
    draws, props, pv, gt, cls, gv, masks = inputs
    return tm.proposal_targets(T(draws), T(props), T(pv), T(gt), T(cls),
                               T(gv), T(masks), TC)


@pytest.mark.parametrize("live", [None, 8], ids=["full", "few"])
def test_proposal_targets_with_jax_draws(live):
    """The same draws give the same sampled rois, classes, positives and
    validity, the deltas and mask crops within 1e-5.  'few': 8 live
    proposals for 16 samples, so both draws run out of candidates and the
    padded samples come from the non-candidates, all exactly -1: the
    lower index first, as jax.lax.top_k."""
    inputs = _targets_inputs(live=live)
    draws = inputs[0]
    tj = jm.proposal_targets(jax.random.PRNGKey(4), *map(jnp.asarray,
                                                         inputs[1:]), JC)
    tt = _port_targets(inputs)
    for k in ("rois", "target_class", "positive", "valid"):
        np.testing.assert_array_equal(getattr(tt, k).numpy(),
                                      np.asarray(getattr(tj, k)), err_msg=k)
    close(tt.target_deltas, tj.target_deltas)
    close(tt.target_masks, tj.target_masks)
    pos = tt.positive.numpy()
    assert 0 < pos.sum() <= TC.train_rois * TC.roi_positive_ratio
    assert (~tt.valid.numpy()).any() == (live is not None)
    assert draws.shape == (2, inputs[1].shape[0])


def test_proposal_targets_sampling():
    """tests/test_maskrcnn_train.py::test_proposal_targets_sampling on the
    port (its draws from jax.random.PRNGKey(0))."""
    props = np.array([
        [0.10, 0.10, 0.50, 0.50],    # IoU 1.0 with gt0  -> positive
        [0.12, 0.12, 0.52, 0.52],    # high IoU          -> positive
        [0.60, 0.60, 0.90, 0.90],    # no overlap        -> negative
        [0.00, 0.00, 0.05, 0.05],    # no overlap        -> negative
    ] + [[0.0, 0.0, 0.0, 0.0]] * 4, np.float32)
    prop_valid = np.array([True] * 4 + [False] * 4)
    draws = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (2, 8)))
    tgt = tm.proposal_targets(
        T(draws), T(props), T(prop_valid),
        torch.tensor([[0.10, 0.10, 0.50, 0.50]]), torch.tensor([2]),
        torch.tensor([True]), torch.ones(1, 16, 16), TC)
    pos, valid = tgt.positive.numpy(), tgt.valid.numpy()
    cls = tgt.target_class.numpy()
    assert pos.sum() == 2
    assert (cls[pos] == 2).all()
    assert (cls[valid & ~pos] == 0).all()
    rois = tgt.rois.numpy()[pos]
    exact = rois[np.argmin(np.abs(rois[:, 0] - 0.10))]
    np.testing.assert_allclose(exact, [0.10, 0.10, 0.50, 0.50], atol=1e-6)
    assert float(tgt.target_masks.numpy()[pos].mean()) > 0.99


def test_head_losses_match_jax():
    """box_head_loss and mask_head_loss on the sampled targets: values and
    the gradients of the logits and deltas within 1e-5 (the port's mask
    logits are NCHW, the JAX package's NHWC)."""
    inputs = _targets_inputs(5)
    tj = jm.proposal_targets(jax.random.PRNGKey(5), *map(jnp.asarray,
                                                         inputs[1:]), JC)
    tt = _port_targets(inputs)
    rng = np.random.default_rng(6)
    Tn, C = JC.train_rois, JC.num_classes
    cls_logits = rng.normal(0, 2, (Tn, C)).astype(np.float32)
    box_deltas = rng.normal(0, 1.5, (Tn, C, 4)).astype(np.float32)
    mask_logits = rng.normal(0, 3, (Tn, 14, 14, C)).astype(np.float32)

    def heads(a, b, m):
        c, bx = jm.box_head_loss(a, b, tj)
        return c + bx + jm.mask_head_loss(m, tj), (c, bx)

    (_, (cj, bj)), gj = jax.value_and_grad(heads, argnums=(0, 1, 2),
                                           has_aux=True)(
        cls_logits, box_deltas, mask_logits)
    mj = jm.mask_head_loss(mask_logits, tj)
    ta, tb = T(cls_logits, True), T(box_deltas, True)
    tmk = T(mask_logits.transpose(0, 3, 1, 2), True)
    ct, bt = tm.box_head_loss(ta, tb, tt)
    mt = tm.mask_head_loss(tmk, tt)
    for a, b in ((ct, cj), (bt, bj), (mt, mj)):
        close(a, b)
    (ct + bt + mt).backward()
    close(ta.grad, gj[0])
    close(tb.grad, gj[1])
    close(tmk.grad.permute(0, 2, 3, 1), gj[2])


# ------------------------------------------------------------ optimiser
def _param_tree(seed=7):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(0, 1, (6, 5)).astype(np.float32),
            "b": {"k": rng.normal(0, 1, (3, 3, 2)).astype(np.float32),
                  "z": np.zeros(4, np.float32)}}


@pytest.mark.parametrize("recipe", ["adam", "rich"])
def test_optimizer_matches_optax(recipe):
    """JAX's gradients fed into the port's optimiser give optax's
    parameters within 1e-6 after each of 12 updates.  'adam':
    optax.adam(1e-3) (train_shapes, create_train_step); 'rich':
    train_rich's chain, clip_by_global_norm(5.0) and Adam over its
    warm-up and cosine schedule (4 warm-up updates of 12), with gradients
    whose global norm crosses 5 both ways.  A leaf whose gradient is
    always zero stays put."""
    lr, steps, warmup = 1e-3, 12, 4
    if recipe == "adam":
        tx, opt_args = optax.adam(lr), (lr, None)
    else:
        sched = optax.join_schedules(
            [optax.linear_schedule(lr * 0.05, lr, warmup),
             optax.cosine_decay_schedule(lr, steps - warmup, 0.05)],
            [warmup])
        tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adam(sched))
        opt_args = (optim.warmup_cosine(lr, warmup, steps), 5.0)
    params = _param_tree()
    state = tx.init(params)
    leaves, treedef = jax.tree.flatten(params)
    tparams = [torch.nn.Parameter(torch.tensor(a)) for a in leaves]
    opt = optim.Optimizer(tparams, *opt_args)
    rng = np.random.default_rng(8)
    norms = []
    for i in range(steps):
        scale = 4.0 if i % 3 else 0.05          # global norm above / below 5
        grads = [rng.normal(0, scale, a.shape).astype(np.float32)
                 for a in leaves]
        grads[-1][:] = 0.0                      # b/z: always zero
        norms.append(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                 for g in grads)))
        upd, state = tx.update(jax.tree.unflatten(treedef, grads), state,
                               params)
        params = optax.apply_updates(params, upd)
        opt.zero_grad()
        for p, g in zip(tparams, grads):
            p.grad = torch.tensor(g)
        opt.step()
        for p, a in zip(tparams, jax.tree.leaves(params)):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(a),
                                       atol=1e-6, err_msg=f"update {i}")
    assert min(norms) < 5.0 < max(norms)
    assert not tparams[-1].detach().any()


def test_schedules_match_optax():
    """linear, cosine (alpha 0.05) and their join at every count 0..60,
    within 1e-6 of the learning rate (optax evaluates them in float32)."""
    lr = 1e-3
    ref = optax.join_schedules(
        [optax.linear_schedule(lr * 0.05, lr, 10),
         optax.cosine_decay_schedule(lr, 40, 0.05)], [10])
    port = optim.warmup_cosine(lr, 10, 50)
    for c in range(61):
        assert abs(port(c) - float(ref(c))) <= 1e-6 * lr, c
    assert port(0) == pytest.approx(lr * 0.05)
    assert port(60) == pytest.approx(lr * 0.05)


def test_clip_uses_optax_scaling():
    """clip_by_global_norm_ scales by max/norm (optax), not by max/(norm +
    1e-6) (torch.nn.utils.clip_grad_norm_)."""
    g = [torch.full((4,), 5.0), torch.zeros(3)]
    norm = optim.clip_by_global_norm_(g, 1.0)
    assert float(norm) == 10.0
    assert torch.equal(g[0], torch.full((4,), 0.5))


# ------------------------------------------------- parameters and files
def test_float32_held_forward_equals_serving_copy():
    """The training layout (float32 parameters, bf16 compute) and the
    serving copy (to_compute_dtype_, weights held in bf16) give the same
    outputs bit for bit, as before the split; state dicts load into both."""
    cfg = tm.MaskRCNNConfig(**{**vars(TC), "dtype": torch.bfloat16})
    train = tm.init_params_(tm.MaskRCNN(cfg), 3)
    serve = tm.to_compute_dtype_(copy.deepcopy(train))
    assert train.backbone.stem.weight.dtype == torch.float32
    assert serve.backbone.stem.weight.dtype == torch.bfloat16
    assert serve.backbone.stem_norm.scale.dtype == torch.float32
    img = torch.from_numpy(np.random.default_rng(9).uniform(
        0, 255, (1, 64, 64, 3)).astype(np.float32))
    with torch.no_grad():
        a, b = train(img), serve(img)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    loaded = tm.to_compute_dtype_(tm.MaskRCNN(cfg))
    loaded.load_state_dict(maskrcnn_state_dict(
        maskrcnn_flax_tree(train.state_dict(), cfg), cfg))
    with torch.no_grad():
        c = loaded(img)
    for k in a:
        assert torch.equal(a[k], c[k]), k


@pytest.mark.parametrize("norm", ["gn", "frozen_bn"])
def test_flax_tree_round_trip(norm):
    """maskrcnn_flax_tree inverts maskrcnn_state_dict exactly, from the
    JAX package's parameter tree (every leaf name, shape and value) and
    from the port's model."""
    jc = jm.MaskRCNNConfig(**{**vars(JC), "norm": norm})
    tc = tm.MaskRCNNConfig(**{**vars(TC), "norm": norm})
    # the JAX package's own names and shapes (traced, not compiled),
    # filled with seeded values
    rng = np.random.default_rng(5)
    tree = jax.tree.map(
        lambda a: rng.normal(0, 1, a.shape).astype(np.float32),
        jax.eval_shape(jm.MaskRCNN(jc).init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 64, 64, 3))))
    back = maskrcnn_flax_tree(maskrcnn_state_dict(tree, tc), tc)
    flat_a, flat_b = tio._flatten(tree), tio._flatten(back)
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        assert flat_b[k].dtype == np.float32
        np.testing.assert_array_equal(flat_b[k], flat_a[k], err_msg=k)
    model = tm.init_params_(tm.MaskRCNN(tc), 1)
    sd = maskrcnn_state_dict(maskrcnn_flax_tree(model.state_dict(), tc), tc)
    assert sd.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k


def test_port_checkpoint_runs_in_the_jax_package(tmp_path):
    """Two steps of the port's shapes recipe, saved by the port's
    checkpoint_io: the JAX package's load_params reads the same tree, and
    its model's forward matches the port's on the loaded weights (f32
    micro config; 1e-4 relative, every integer output equal)."""
    params, losses = tss.train_shapes(steps=2, device="cpu")
    assert len(losses) == 2 and np.isfinite(losses).all()
    path = str(tmp_path / "port.npz")
    tio.save_params(path, params, meta={"steps": 2})
    jparams, jmeta = jio.load_params(path)
    tparams, tmeta = tio.load_params(path)
    assert jmeta == tmeta == {"steps": 2}
    img = tss.make_shapes_scene(np.random.default_rng(11), 64)[0]
    jout = jax.jit(jm.MaskRCNN(JC).apply)(jparams, jnp.asarray(img)[None])
    tout = tss.forward_fn(TC, tparams, "cpu")(img)
    for k, a in jout.items():
        a, b = np.asarray(a), tout[k]
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            close(b, a, 1e-4)


def test_flax_msgpack_read_by_the_port(tmp_path):
    """A flax msgpack_serialize of a JAX init (with a scalar, a complex and
    a list beside the tree) read by the port's reader without msgpack; the
    offline runner's --params takes it."""
    from flax import serialization

    from maskfusion_tpu_torch.maskrcnn.offline_runner import load_params

    tree = jax.jit(jm.MaskRCNN(JC).init)(jax.random.PRNGKey(2),
                                         jnp.zeros((1, 64, 64, 3)))
    path = tmp_path / "weights.msgpack"
    extra = {"step": np.int32(7), "c": complex(1, -2), "l": [1, 2.5, "x"]}
    path.write_bytes(serialization.msgpack_serialize({**tree, **extra}))
    ref = serialization.msgpack_restore(path.read_bytes())
    got = tio.load_msgpack(str(path))
    assert got["step"] == 7 and got["c"] == complex(1, -2)
    assert list(ref["l"]) == got["l"] == [1, 2.5, "x"]
    flat_r, flat_g = tio._flatten(ref["params"]), tio._flatten(got["params"])
    assert flat_r.keys() == flat_g.keys()
    for k in flat_r:
        np.testing.assert_array_equal(flat_g[k], flat_r[k], err_msg=k)
    net = tm.MaskRCNN(TC)
    net.load_state_dict(maskrcnn_state_dict(load_params(str(path)), TC))


def test_matterport_h5_round_trip(tmp_path):
    """tests/test_maskrcnn_train.py::test_matterport_weight_conversion_
    roundtrip on the port: a Keras-layout .h5 written from a seeded tree
    (frozen BatchNorm, a stage with an identity block) converts back to
    the same tree exactly, passes the strict check against the model, and
    runs inference; a layer with the wrong shape is refused."""
    h5py = pytest.importorskip("h5py")
    from maskfusion_tpu_torch.maskrcnn.convert import convert_matterport_h5

    cfg = tm.MaskRCNNConfig(
        num_classes=4, image_size=64,
        anchor_scales=(8, 16, 32, 64, 128), anchor_ratios=(1.0,),
        pre_nms_limit=64, post_nms_proposals=16, max_detections=4,
        roi_pool_size=7, mask_pool_size=7,
        fpn_channels=32, box_head_dim=64, mask_head_channels=32,
        backbone_blocks=(1, 2, 1, 1), norm="frozen_bn", dtype=torch.float32)
    rng = np.random.default_rng(12)
    ref = maskrcnn_flax_tree(tm.init_params_(tm.MaskRCNN(cfg), 12)
                             .state_dict(), cfg)

    def jitter(path, a):
        # every leaf distinct: biases and BatchNorm statistics near their
        # init, so a swapped leaf fails and the forward stays finite
        if path[-1].key == "kernel":
            return a
        return (a + rng.uniform(-0.1, 0.1, a.shape)).astype(np.float32)

    ref = jax.tree_util.tree_map_with_path(jitter, ref)

    def w(f, layer, arrays):
        grp = f.create_group(layer)
        for n, a in arrays.items():
            grp.create_dataset(f"{layer}/{n}:0", data=a)

    def conv_of(p):
        return {"kernel": p["kernel"], "bias": p["bias"]}

    def bn_of(p):
        return {"gamma": p["scale"], "beta": p["bias"],
                "moving_mean": p["mean"], "moving_variance": p["var"]}

    def write(path, bad=False):
        P = ref["params"]
        bb = P["backbone"]
        with h5py.File(path, "w") as f:
            k1 = bb["Conv_0"]["kernel"]
            w(f, "conv1", {"kernel": k1[:, :, :2] if bad else k1,
                           "bias": bb["Conv_0"]["bias"]})
            w(f, "bn_conv1", bn_of(bb["FrozenBatchNorm_0"]))
            bi = 0
            for stage, blocks in zip((2, 3, 4, 5), cfg.backbone_blocks):
                for k in range(blocks):
                    blk = chr(ord("a") + k)
                    p = bb[f"Bottleneck_{bi}"]
                    for j, br in enumerate(("2a", "2b", "2c")):
                        w(f, f"res{stage}{blk}_branch{br}",
                          conv_of(p[f"Conv_{j}"]))
                        w(f, f"bn{stage}{blk}_branch{br}",
                          bn_of(p[f"FrozenBatchNorm_{j}"]))
                    if k == 0:
                        w(f, f"res{stage}{blk}_branch1", conv_of(p["Conv_3"]))
                        w(f, f"bn{stage}{blk}_branch1",
                          bn_of(p["FrozenBatchNorm_3"]))
                    bi += 1
            for i, name in enumerate(
                    ("fpn_c5p5", "fpn_c4p4", "fpn_c3p3", "fpn_c2p2",
                     "fpn_p2", "fpn_p3", "fpn_p4", "fpn_p5"), start=1):
                w(f, name, conv_of(bb[f"Conv_{i}"]))
            rpn = P["rpn"]
            w(f, "rpn_conv_shared", conv_of(rpn["rpn_conv"]))
            w(f, "rpn_class_raw", conv_of(rpn["rpn_cls"]))
            w(f, "rpn_bbox_pred", conv_of(rpn["rpn_box"]))
            bh = P["box_head"]
            S, C = cfg.roi_pool_size, cfg.fpn_channels
            w(f, "mrcnn_class_conv1",
              {"kernel": bh["fc1"]["kernel"].reshape(S, S, C, -1),
               "bias": bh["fc1"]["bias"]})
            w(f, "mrcnn_class_bn1", bn_of(bh["FrozenBatchNorm_0"]))
            w(f, "mrcnn_class_conv2",
              {"kernel": bh["fc2"]["kernel"][None, None],
               "bias": bh["fc2"]["bias"]})
            w(f, "mrcnn_class_bn2", bn_of(bh["FrozenBatchNorm_1"]))
            w(f, "mrcnn_class_logits", conv_of(bh["cls"]))
            w(f, "mrcnn_bbox_fc", conv_of(bh["box"]))
            mh = P["mask_head"]
            for i in range(4):
                w(f, f"mrcnn_mask_conv{i + 1}", conv_of(mh[f"conv{i + 1}"]))
                w(f, f"mrcnn_mask_bn{i + 1}",
                  bn_of(mh[f"FrozenBatchNorm_{i}"]))
            kd = mh["deconv"]["kernel"][::-1, ::-1].transpose(0, 1, 3, 2)
            w(f, "mrcnn_mask_deconv", {"kernel": kd,
                                       "bias": mh["deconv"]["bias"]})
            w(f, "mrcnn_mask", conv_of(mh["out"]))

    path = str(tmp_path / "fake_matterport.h5")
    write(path)
    params = convert_matterport_h5(path, cfg)
    flat_a, flat_b = tio._flatten(ref), tio._flatten(params)
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        np.testing.assert_array_equal(flat_b[k], flat_a[k], err_msg=k)
    net = tm.MaskRCNN(cfg)
    net.load_state_dict(maskrcnn_state_dict(params, cfg))
    with torch.no_grad():
        out = net(torch.zeros(1, 64, 64, 3))
    assert torch.isfinite(out["class_logits"]).all()
    bad = str(tmp_path / "bad.h5")
    write(bad, bad=True)
    with pytest.raises(ValueError, match="do not match the model"):
        convert_matterport_h5(bad, cfg)


# ----------------------------------------------------------- train step
@pytest.mark.parametrize("full_loss", [True, False], ids=["full", "rpn"])
def test_create_train_step_on_the_cpu(full_loss):
    """Three steps of create_train_step(micro_config(64)) on a batch of two
    make_batch scenes: finite losses, the step counted, the parameters
    moved (the heads only with the full loss); the draws given explicitly
    equal those taken from the generator."""
    init_fn, step_fn = create_train_step(TC, learning_rate=1e-3,
                                         full_loss=full_loss, device="cpu")
    state = init_fn(0, 2)
    assert isinstance(state, TrainState) and state.step == 0
    before = {k: v.clone() for k, v in state.params.state_dict().items()}
    batch = [torch.from_numpy(a) for a in
             tss.make_batch(np.random.default_rng(0), 2, 64)]
    n = TC.post_nms_proposals + batch[1].shape[1]
    gen = torch.Generator().manual_seed(0)
    draws = torch.rand((2, 2, n), generator=torch.Generator().manual_seed(0))
    twin_init, twin_step = create_train_step(TC, 1e-3, full_loss, "cpu")
    twin = twin_init(0, 2)
    losses = []
    for i in range(3):
        state, loss = step_fn(state, gen, *batch)
        losses.append(float(loss))
        if i == 0:
            twin, twin_loss = twin_step(twin, draws, *batch)
            assert float(twin_loss) == losses[0]
    assert state.step == 3 and np.isfinite(losses).all()
    after = state.params.state_dict()
    assert not torch.equal(after["backbone.stem.weight"],
                           before["backbone.stem.weight"])
    assert torch.equal(after["mask_head.out.weight"],
                       before["mask_head.out.weight"]) != full_loss


def test_make_batch_matches_jax():
    a = jss.make_batch(np.random.default_rng(3), 3, 64)
    b = tss.make_batch(np.random.default_rng(3), 3, 64)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y, x)


def test_rpn_loss_decreases_with_gradient_step():
    """tests/test_maskrcnn.py::test_rpn_loss_decreases_with_gradient_step
    on the port: the RPN loss of a seeded network has a finite value and a
    non-zero gradient, and a normalised step of 1e-3 along -grad lowers
    it."""
    model = tm.init_params_(tm.MaskRCNN(TC), 0)
    img = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 255, (1, 64, 64, 3)).astype(np.float32))
    gt, valid = torch.tensor([[0.2, 0.2, 0.6, 0.6]]), torch.tensor([True])

    def loss_fn():
        logits, deltas = model.rpn(model.features(img))
        return tm.rpn_loss(logits[0], deltas[0], model.anchors, gt, valid,
                           TC)

    l0 = loss_fn()
    l0.backward()
    gnorm = torch.sqrt(sum((p.grad ** 2).sum() for p in model.parameters()
                           if p.grad is not None))
    assert torch.isfinite(l0) and gnorm > 0
    with torch.no_grad():
        for p in model.parameters():
            if p.grad is not None:
                p -= (1e-3 / gnorm) * p.grad
        assert loss_fn() < l0


def test_train_checkpoint_entry_point(tmp_path, monkeypatch, capsys):
    """`python -m maskfusion_tpu_torch.maskrcnn.train_checkpoint shapes`
    with --cpu: the file lands under build/checkpoints/ of the checkout by
    default (never in maskfusion_tpu/maskrcnn/checkpoints/), or at --out;
    the JAX package's load_params reads it, with the recipe and the
    held-out quality in its meta."""
    from maskfusion_tpu_torch.maskrcnn import train_checkpoint as tc

    monkeypatch.setattr(tc, "ROOT", str(tmp_path))
    assert tc.main(["shapes", "--steps", "2", "--cpu"]) == 0
    default = tmp_path / "build" / "checkpoints" / "shapes_micro_64.npz"
    out = tmp_path / "elsewhere.npz"
    assert tc.main(["shapes", "--steps", "2", "--cpu", "--seed", "1",
                    "--out", str(out)]) == 0
    assert "quality:" in capsys.readouterr().out
    for path, seed in ((default, 0), (out, 1)):
        params, meta = jio.load_params(str(path))
        assert meta["steps"] == 2 and meta["seed"] == seed
        assert meta["domain"] == "synthetic_shapes"
        assert {"det_iou", "cls_acc", "mask_iou", "mean_score"} <= set(meta)
        assert tio._flatten(params).keys() == tio._flatten(
            maskrcnn_flax_tree(tm.MaskRCNN(TC).state_dict(), TC)).keys()
