"""Parity of the port's Mask R-CNN (maskfusion_tpu_torch.maskrcnn.model)
with the JAX package's on the CPU.

Each piece gets the same seeded numpy inputs in both packages: the box
utilities and the fixed-k NMS (exact indices, ties included), ROIAlign, the
layers whose flax semantics differ from torch's defaults (SAME max pool,
the transposed conv, GroupNorm's epsilon and fast variance), then whole
forwards from JAX-initialised weights carried by
``convert.maskrcnn_state_dict`` at the TINY config of tests/test_maskrcnn.py
(f32, frozen_bn, bf16) and from the repository's two trained checkpoints.
Largest differences measured on the CPU: TINY f32 outputs 4.1e-5 (RPN
deltas), checkpoints' mask logits 7.3e-5, scores 4.8e-7.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maskfusion_tpu.maskrcnn import checkpoint_io as jio
from maskfusion_tpu.maskrcnn import inference as jinf
from maskfusion_tpu.maskrcnn import model as jm
from maskfusion_tpu.maskrcnn import synthetic_shapes as jss
from maskfusion_tpu_torch.convert import maskrcnn_state_dict
from maskfusion_tpu_torch.maskrcnn import checkpoint_io as tio
from maskfusion_tpu_torch.maskrcnn import inference as tinf
from maskfusion_tpu_torch.maskrcnn import model as tm
from maskfusion_tpu_torch.maskrcnn import synthetic_shapes as tss

TINY = dict(num_classes=5, image_size=128,
            anchor_scales=(16, 32, 64, 128, 256),
            pre_nms_limit=128, post_nms_proposals=32, max_detections=8)


def configs(**kw):
    """(JAX config, port config) with the same fields; f32 unless `dtype`
    ('bf16') is given."""
    bf16 = kw.pop("dtype", None) == "bf16"
    fields = {**TINY, **kw}
    return (jm.MaskRCNNConfig(**fields, dtype=jnp.bfloat16 if bf16
                              else jnp.float32),
            tm.MaskRCNNConfig(**fields, dtype=torch.bfloat16 if bf16
                              else torch.float32))


def T(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def N(x) -> np.ndarray:
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


# ------------------------------------------------------- box utilities
def test_anchors_equal():
    for cfg in (TINY, {}, dict(image_size=256, anchor_ratios=(1.0,))):
        jc, tc = (jm.MaskRCNNConfig(**cfg), tm.MaskRCNNConfig(**cfg))
        np.testing.assert_array_equal(tm.generate_anchors(tc),
                                      jm.generate_anchors(jc))
    # 512 px: 3 ratios over 128^2 + 64^2 + 32^2 + 16^2 + 8^2 positions
    assert tm.generate_anchors(tm.MaskRCNNConfig()).shape == (65472, 4)


def _boxes(rng, n):
    y1, x1 = rng.uniform(0, 0.8, (2, n))
    h, w = rng.uniform(0.0, 0.4, (2, n))
    return np.stack([y1, x1, y1 + h, x1 + w], -1).astype(np.float32)


def test_apply_deltas_and_box_iou():
    """1e-6 against the JAX functions (max measured 6e-8)."""
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 40), _boxes(rng, 30)
    a[3] = a[3, [0, 1, 0, 1]]                    # a zero-area box
    d = rng.normal(0, 2, (40, 4)).astype(np.float32)     # clipped at +-4
    np.testing.assert_allclose(N(tm.apply_deltas(T(a), T(d))),
                               N(jm.apply_deltas(a, d)), atol=1e-6)
    np.testing.assert_allclose(N(tm.box_iou(T(a), T(b))),
                               N(jm.box_iou(a, b)), atol=1e-6)


@pytest.mark.parametrize("case", ["ties", "steps", "degenerate", "few"])
def test_nms_fixed_indices_equal(case):
    """The same picks and validity as the JAX fori_loop NMS, exactly.
    'ties': every score equal (the first maximum wins each pick); 'steps':
    scores on a coarse grid, as bf16 logits give; 'degenerate': zero-area
    boxes (IoU 0 with everything, itself included: only the explicit
    self-suppression removes them); 'few': k above the boxes left, so the
    last picks are invalid and point at index 0."""
    rng = np.random.default_rng(1)
    n, k = 60, 25
    boxes = _boxes(rng, n)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    if case == "ties":
        scores[:] = 0.5
    elif case == "steps":
        scores = np.round(scores * 8) / 8
    elif case == "degenerate":
        boxes[::3, 2:] = boxes[::3, :2]
    elif case == "few":
        boxes = np.tile(boxes[:4], (15, 1)) + rng.uniform(
            0, 1e-3, (n, 4)).astype(np.float32)
    for thr in (0.3, 0.7):
        ti, tv = tm.nms_fixed(T(boxes), T(scores), k, thr)
        ji, jv = jm.nms_fixed(jnp.asarray(boxes), jnp.asarray(scores), k,
                              thr)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if case == "few":
        assert not tv.numpy().all() and (ti.numpy()[~tv.numpy()] == 0).all()


def test_proposals_take_the_lower_index_among_ties():
    """_proposals on RPN scores with many exact ties (logits on a coarse
    grid): the pre-NMS selection is jax.lax.top_k's (lower index first), so
    the proposals equal the JAX ones exactly."""
    jc, tc = configs()
    rng = np.random.default_rng(2)
    A = tm.generate_anchors(tc).shape[0]
    logits = (np.round(rng.normal(0, 1, (A, 2)) * 2) / 2).astype(np.float32)
    deltas = rng.normal(0, 0.5, (A, 4)).astype(np.float32)
    tmod = tm.MaskRCNN(tc)
    tp, tv = tmod._proposals(T(logits), T(deltas))
    jmod = jm.MaskRCNN(jc)
    jp, jv = jmod.apply({}, jnp.asarray(logits), jnp.asarray(deltas),
                        method=lambda m, a, b: m._proposals(a, b))
    assert len(np.unique(logits[:, 1] - logits[:, 0])) < 40   # ties
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)


# ---------------------------------------------------------- ROIAlign
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_roi_align(dtype):
    """Both the 7x7 and the 14x14 grids over P2..P5 at every level the area
    rule picks: 1e-5 (bf16 features times f32 weights give f32 in both)."""
    jc, tc = configs()
    rng = np.random.default_rng(3)
    C = 16
    feats = [rng.normal(0, 1, (1, 128 // s, 128 // s, C)).astype(np.float32)
             for s in (4, 8, 16, 32)]
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
                else (jnp.float32, torch.float32))
    jf = [jnp.asarray(f, jdt) for f in feats]
    tf = [T(f).permute(0, 3, 1, 2).to(tdt) for f in feats]
    boxes = _boxes(rng, 24)
    boxes[:6] *= 0.1                                 # small: level P2
    boxes[6:12, 2:] = boxes[6:12, :2] + 0.9          # large: level P5
    for size in (7, 14):
        ref = np.asarray(jm.roi_align(jf, jnp.asarray(boxes), size, jc))
        got = tm.roi_align(tf, T(boxes), size, tc)
        assert got.dtype == torch.float32 and ref.dtype == np.float32
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


# -------------------------------------------- layers against flax modules
def test_max_pool_same_pads_after():
    """flax max_pool 3x3/2 SAME on an even size pads 0 before and 1 after;
    a symmetric padding of 1 shifts every window by a pixel."""
    x = np.random.default_rng(4).normal(0, 1, (1, 16, 12, 5)).astype(
        np.float32)
    ref = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                                  padding="SAME"))
    got = tm.max_pool_same_3x3s2(T(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)
    sym = torch.nn.functional.max_pool2d(T(x).permute(0, 3, 1, 2), 3, 2, 1)
    assert not np.array_equal(sym.permute(0, 2, 3, 1).numpy(), ref)


def test_transposed_conv_matches_flax():
    """flax ConvTranspose((2, 2), strides=2, SAME) carried by the converter's
    flip into F.conv_transpose2d: 1e-5; without the flip it differs."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (3, 6, 6, 8)).astype(np.float32)
    mod = fnn.ConvTranspose(4, (2, 2), strides=(2, 2), dtype=jnp.float32)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(lambda p: p + 0.1, params)     # a non-zero bias
    ref = np.asarray(mod.apply(params, jnp.asarray(x)))
    kern = np.asarray(params["params"]["kernel"])
    layer = tm.ConvTranspose2x2(8, 4)
    sd = maskrcnn_state_dict({"mask_head": {"deconv": {
        "kernel": kern, "bias": np.asarray(params["params"]["bias"])}}},
        tm.MaskRCNNConfig())
    layer.load_state_dict({k.split(".", 2)[2]: v for k, v in sd.items()})
    got = layer(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-5)
    with torch.no_grad():
        layer.weight.copy_(T(kern.transpose(2, 3, 0, 1)))      # unflipped
    bad = layer(T(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert np.abs(bad.detach().numpy() - ref).max() > 1e-2


@pytest.mark.parametrize("shape", [(2, 6, 5, 64), (5, 256)])
def test_group_norm_matches_flax(shape):
    """flax GroupNorm (epsilon 1e-6, fast variance, float32 statistics) on
    maps and on the box head's (N, C) rows, with groups of the port's rule,
    on zero-mean inputs of small variance (1e-6, where torch's epsilon 1e-5
    would show): 1e-5 relative; torch's F.group_norm differs."""
    rng = np.random.default_rng(6)
    x = (1e-3 * rng.normal(0, 1, shape)).astype(np.float32)
    c = shape[-1]
    g = tm.group_count(c)
    mod = fnn.GroupNorm(num_groups=g, dtype=jnp.float32)
    params = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    scale = rng.uniform(0.5, 2, c).astype(np.float32)
    bias = rng.normal(0, 1, c).astype(np.float32)
    params = {"params": {"scale": jnp.asarray(scale),
                         "bias": jnp.asarray(bias)}}
    ref = np.asarray(mod.apply(params, jnp.asarray(x)))
    layer = tm.GroupNorm(c, g)
    layer.load_state_dict({"scale": T(scale), "bias": T(bias)})
    xt = T(x) if len(shape) == 2 else T(x).permute(0, 3, 1, 2)
    got = layer(xt)
    got = got if len(shape) == 2 else got.permute(0, 2, 3, 1)
    scale_ref = np.abs(ref).max()
    np.testing.assert_allclose(got.detach().numpy(), ref,
                               atol=1e-5 * scale_ref)
    torch_gn = torch.nn.functional.group_norm(
        xt.reshape(shape[0], c, -1), g, T(scale), T(bias)).reshape(xt.shape)
    torch_gn = torch_gn if len(shape) == 2 else torch_gn.permute(0, 2, 3, 1)
    assert np.abs(torch_gn.numpy() - ref).max() > 1e-2 * scale_ref


# ------------------------------------------------------------ forwards
_JAX_FORWARDS = {}


def _jax_init(jc, image):
    """A JAX init of the network (seed 0), as numpy arrays."""
    init = jax.jit(jm.MaskRCNN(jc).init)
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0),
                                         jnp.asarray(image)))


def _jax_forward(jc, params, image):
    """The JAX forward and its P2..P6, one jit per config."""
    if jc not in _JAX_FORWARDS:
        jmod = jm.MaskRCNN(jc)

        def both(p, im):
            feats = jmod.apply(
                p, im, method=lambda m, x: m.backbone(m._normalise(x)))
            return jmod.apply(p, im), feats

        _JAX_FORWARDS[jc] = jax.jit(both)
    return _JAX_FORWARDS[jc](params, jnp.asarray(image))


def _port_forward(tc, params, image):
    """The port's forward and its P2..P6, from the JAX parameter tree
    carried by maskrcnn_state_dict."""
    tmod = tm.MaskRCNN(tc)
    tmod.load_state_dict(maskrcnn_state_dict(params, tc))
    with torch.no_grad():
        return tmod(T(image)), tmod.features(T(image))


def _jax_and_port(jc, tc, image, params=None, mutate=None):
    """JAX forward with `params` (or a JAX init, then `mutate`), the port's
    forward with the same parameters."""
    if params is None:
        params = _jax_init(jc, image)
        if mutate:
            params = mutate(params)
    jout, jfeats = _jax_forward(jc, params, image)
    tout, tfeats = _port_forward(tc, params, image)
    return jout, tout, jfeats, tfeats


def _image(size, seed=7):
    return np.random.default_rng(seed).uniform(
        0, 255, (1, size, size, 3)).astype(np.float32)


def _assert_outputs_close(jout, tout, atol, relative=False):
    """Every output key: integer and bool outputs equal, floats within
    `atol` (times the key's largest magnitude when `relative`)."""
    for k in jout:
        a, b = np.asarray(jout[k]), tout[k].numpy()
        assert a.shape == b.shape, k
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            tol = atol * max(np.abs(a).max(), 1.0) if relative else atol
            np.testing.assert_allclose(b, a, atol=tol, err_msg=k)


def test_tiny_f32_forward_from_jax_init():
    """TINY at f32 from a JAX init: P2..P6, the RPN outputs, proposals,
    class logits, detections and mask logits within 1e-4 (score threshold
    0, so every slot is live)."""
    jc, tc = configs(score_threshold=0.0)
    jout, tout, jf, tf = _jax_and_port(jc, tc, _image(128))
    for a, b in zip(jf, tf):
        np.testing.assert_allclose(b.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(a), atol=1e-4)
    _assert_outputs_close(jout, tout, 1e-4)
    assert tout["detection_valid"].all()


def test_tiny_frozen_bn_forward():
    """norm='frozen_bn' (converted matterport weights) with non-trivial
    statistics and the mean-pixel input (no scaling: features in the
    hundreds): P2..P6 within 1e-5 of their largest magnitude, every output
    within 1e-4 of its own (measured: class logits 3.1e-5, the box head's
    12,544-term f32 sums in another order)."""
    jc, tc = configs(norm="frozen_bn", score_threshold=0.0)
    rng = np.random.default_rng(8)

    def stats(tree):
        def walk(node):
            for k, v in node.items():
                if k.startswith("FrozenBatchNorm"):
                    c = v["scale"].shape[0]
                    v["scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
                    v["bias"] = rng.normal(0, 0.1, c).astype(np.float32)
                    v["mean"] = rng.normal(0, 0.1, c).astype(np.float32)
                    v["var"] = rng.uniform(0.5, 2.0, c).astype(np.float32)
                elif isinstance(v, dict):
                    walk(v)
        tree = jax.tree.map(np.array, tree)
        walk(tree["params"])
        return tree

    jout, tout, jf, tf = _jax_and_port(jc, tc, _image(128), mutate=stats)
    for a, b in zip(jf, tf):
        a = np.asarray(a)
        np.testing.assert_allclose(b.permute(0, 2, 3, 1).numpy(), a,
                                   atol=1e-5 * np.abs(a).max())
    _assert_outputs_close(jout, tout, 1e-4, relative=True)


def test_tiny_bf16_features():
    """TINY in bfloat16 (the serving dtype).  Each package's bf16 P2..P6
    lie 1.4-2.2% (relative L2) from an f32 forward of the same
    bf16-rounded weights: rounding noise, which grows with depth and does
    not correlate between the two.  Held: the port's bf16 error against
    the f32 forward within 1.2x the JAX package's own (measured up to
    1.11x), and the two bf16 forwards within 3e-2 relative L2 of each other
    (measured 1.5% at P2 to 2.2% at P6); the outputs that leave in float32
    are float32 and finite."""
    jc, tc = configs(dtype="bf16", score_threshold=0.0)
    tc32 = configs(score_threshold=0.0)[1]
    image = _image(128)
    params = _jax_init(jc, image)
    rounded = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16),
                                                np.float32), params)
    _, tout, jf, tf = _jax_and_port(jc, tc, image, params=params)
    _, ref = _port_forward(tc32, rounded, image)
    for a, b, r in zip(jf, tf, ref):
        assert b.dtype == torch.bfloat16
        a = np.asarray(a, np.float32)
        b = b.permute(0, 2, 3, 1).float().numpy()
        r = r.permute(0, 2, 3, 1).numpy()
        norm = np.linalg.norm(r)
        port_err = np.linalg.norm(b - r) / norm
        jax_err = np.linalg.norm(a - r) / norm
        assert port_err <= 1.2 * jax_err, (port_err, jax_err)
        assert np.linalg.norm(b - a) / norm <= 3e-2
    for k in ("rpn_logits", "class_logits", "mask_logits"):
        assert tout[k].dtype == torch.float32
        assert np.isfinite(tout[k].numpy()).all()


CHECKPOINTS = {
    "micro": ("shapes_micro_64", 64, "make_shapes_scene", "micro_config"),
    "rich": ("shapes_rich_256", 256, "make_rich_scene", "rich_config"),
}


@pytest.mark.parametrize("name", list(CHECKPOINTS))
def test_checkpoint_end_to_end(name):
    """The trained checkpoints (loaded by both packages' checkpoint_io) on
    two held-out scenes each: the same detection set (valid slots, classes,
    boxes to 1e-5), scores to 1e-5, masks to 1e-3, and generate_id_image
    equal on at least 99.9% of the pixels (measured 100%)."""
    pytest.importorskip("cv2")          # the JAX generate_id_image's resize
    ckpt, S, scene, config = CHECKPOINTS[name]
    path = f"maskfusion_tpu/maskrcnn/checkpoints/{ckpt}.npz"
    jp, jmeta = jio.load_params(path)
    tp, tmeta = tio.load_params(path)
    assert tmeta == jmeta
    assert jax.tree.structure(jp) == jax.tree.structure(tp)
    jc = getattr(jss, config)(S)
    tc = getattr(tss, config)(S)
    jfwd = jax.jit(jm.MaskRCNN(jc).apply)
    tfwd = tss.forward_fn(tc, tp, device="cpu")
    rng = np.random.default_rng(11)
    for _ in range(2):
        img = getattr(tss, scene)(rng, S)[0]
        jo = {k: np.asarray(v) for k, v in jfwd(jp, jnp.asarray(img)[None])
              .items()}
        to = tfwd(img)
        valid = jo["detection_valid"]
        np.testing.assert_array_equal(to["detection_valid"], valid)
        np.testing.assert_array_equal(to["detection_classes"],
                                      jo["detection_classes"])
        np.testing.assert_allclose(to["detections"], jo["detections"],
                                   atol=1e-5)
        np.testing.assert_allclose(to["detection_scores"],
                                   jo["detection_scores"], atol=1e-5)
        np.testing.assert_allclose(to["mask_logits"][valid],
                                   jo["mask_logits"][valid], atol=1e-3)
        keys = ("detections", "mask_logits", "detection_classes",
                "detection_scores", "detection_valid")
        ji = jinf.generate_id_image(*(jo[k] for k in keys), 120, 160, 0.5)
        ti = tinf.generate_id_image(*(to[k] for k in keys), 120, 160, 0.5)
        assert ti[1:] == ji[1:]
        assert (ti[0] == ji[0]).mean() >= 0.999
        assert len(ti[1]) > 1                  # something was detected


def test_inference_initialises_from_a_seed():
    """Without params: flax's default distributions from a seeded
    generator: lecun_normal kernels (std sqrt(1/fan_in) within 5%, cut at 2
    std), zero biases, unit GroupNorm scales; the same seed gives the same
    weights."""
    cfg = dataclasses.replace(tm.MaskRCNNConfig(**TINY), dtype=torch.float32)
    a = tinf.MaskRCNNInference(cfg, seed=3, device="cpu").model
    b = tinf.MaskRCNNInference(cfg, seed=3, device="cpu").model
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0, msg=k)
    w = a.backbone.blocks[3].conv2.weight
    fan_in = w[0].numel()
    assert abs(w.std().item() * np.sqrt(fan_in) - 1.0) < 0.05
    assert w.abs().max().item() <= 2 / np.sqrt(fan_in) / 0.8796 + 1e-6
    assert (a.backbone.blocks[3].conv2.bias == 0).all()
    assert (a.backbone.blocks[3].norm2.scale == 1).all()
