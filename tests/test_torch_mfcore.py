"""The port's native host library (maskfusion_tpu_torch.cpp, mfcore) against
the JAX package's (maskfusion_tpu.cpp) and against its own numpy / scipy
versions.

Every mf_* function the JAX package calls runs on the same seeded inputs in
both libraries, and the results must be equal bit for bit (the two are
built from the same source); the port's segmenter and engine windows then
take their native paths against the JAX package's native paths.  The
numpy path is the plain version: connected components, reassignment,
histograms and boxes equal it exactly on every input here (largest
difference measured: 0 pixels, 0 counts).
"""

import numpy as np
import jax.numpy as jnp
import pytest

import maskfusion_tpu.cpp as jnative
from maskfusion_tpu.camera import Resolution as JResolution
from maskfusion_tpu.config import Config as JConfig
from maskfusion_tpu.frame import FrameData as JFrameData
from maskfusion_tpu.ops import preprocess as jpp
from maskfusion_tpu.segmentation import components as jcc
from maskfusion_tpu.segmentation.mf_segmentation import (
    MfSegmentation as JMfSegmentation, ModelInfo as JModelInfo)
from maskfusion_tpu_torch import cpp as tnative
from maskfusion_tpu_torch.camera import Resolution
from maskfusion_tpu_torch.config import Config
from maskfusion_tpu_torch.frame import FrameData
from maskfusion_tpu_torch.segmentation import components as tcc
from maskfusion_tpu_torch.segmentation.mf_segmentation import (
    MfSegmentation, ModelInfo)
from tests import synthetic as syn
from tests.test_torch_segmentation import SCENARIOS, _frame, _projected_ids
from tests.torch_helpers import t, tintr

ROOT = tnative._SRC.parents[2]


@pytest.fixture(scope="module")
def libs():
    """(JAX library, port library); the JAX one must be loaded (it is
    committed built), the port's is built at first use."""
    jlib = jnative.load()
    assert jlib is not None, "the JAX package's libmfcore does not load"
    return jlib, tnative.load()


# inputs: (shape, foreground share, seed); the last is VGA
BINARIES = [((60, 80), 0.55, 0), ((120, 160), 0.45, 1), ((121, 163), 0.7, 2),
            ((240, 320), 0.6, 3), ((480, 640), 0.6, 4)]


def _binary(shape, share, seed):
    return np.random.default_rng(seed).random(shape) < share


def _components(lib, binary, max_comp):
    h, w = binary.shape
    b = np.ascontiguousarray(binary.astype(np.uint8))
    labels = np.empty((h, w), np.int32)
    sizes = np.empty(max_comp, np.int32)
    bboxes = np.empty((max_comp, 4), np.int32)
    n = lib.mf_connected_components(b, h, w, labels.reshape(-1), sizes,
                                    bboxes.reshape(-1), max_comp)
    return n, labels, sizes[:max(n, 0)], bboxes[:max(n, 0)]


@pytest.mark.parametrize("shape,share,seed", BINARIES)
def test_connected_components_native_against_jax_native(libs, shape, share,
                                                        seed):
    """mf_connected_components in both libraries, then both packages'
    connected_components: labels, sizes, bboxes and count equal."""
    jlib, tlib = libs
    binary = _binary(shape, share, seed)
    a = _components(jlib, binary, 1 << 16)
    b = _components(tlib, binary, 1 << 16)
    assert a[0] == b[0] > 1
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(x, y)
    jc = jcc.connected_components(binary)
    tc = tcc.connected_components(binary)
    assert tc.count == jc.count == a[0]
    for x, y in zip(tc[:3], jc[:3]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("shape,share,seed", BINARIES)
def test_connected_components_native_against_numpy(shape, share, seed):
    """The port's native components against its scipy version: the same
    labels (both number components in raster order of their first pixel),
    sizes and components' bboxes.  Row 0 (the background) is the whole
    frame in the native result and zeros in the scipy one, in both
    packages alike; no caller reads it."""
    binary = _binary(shape, share, seed)
    native = tcc.connected_components(binary)
    with tnative.disabled():
        plain = tcc.connected_components(binary)
    assert native.count == plain.count
    np.testing.assert_array_equal(native.labels, plain.labels)
    np.testing.assert_array_equal(native.sizes, plain.sizes)
    np.testing.assert_array_equal(native.bboxes[1:], plain.bboxes[1:])
    h, w = shape
    np.testing.assert_array_equal(native.bboxes[0], [0, 0, h - 1, w - 1])


def test_connected_components_retry_ladder(libs):
    """A checkerboard of 4-connected single pixels has more than 16,384
    components: the first rung (16384) refuses, the second (h*w//4 + 2)
    takes it, in both packages alike, and equal to scipy's."""
    jlib, tlib = libs
    h, w = 200, 240
    yy, xx = np.mgrid[:h, :w]
    binary = (yy + xx) % 2 == 0
    assert _components(tlib, binary, 16384)[0] == -1
    assert _components(jlib, binary, 16384)[0] == -1
    tc = tcc.connected_components(binary)
    jc = jcc.connected_components(binary)
    assert tc.count == jc.count == h * w // 2 + 1 > 16384
    for x, y in zip(tc[:3], jc[:3]):
        np.testing.assert_array_equal(x, y)
    with tnative.disabled():
        plain = tcc.connected_components(binary)
    assert plain.count == tc.count
    np.testing.assert_array_equal(tc.labels, plain.labels)
    np.testing.assert_array_equal(tc.sizes, plain.sizes)
    np.testing.assert_array_equal(tc.bboxes[1:], plain.bboxes[1:])


def _depth(shape, seed):
    """Piecewise-smooth depth: planes at a few levels with sub-delta noise,
    so some neighbours pass the 8 mm continuity test and some do not."""
    rng = np.random.default_rng(seed)
    h, w = shape
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    d = 1.5 + 0.3 * (xx > w / 2) + 0.002 * yy / h
    d += rng.normal(0, 0.003, shape)
    d[rng.random(shape) < 0.02] = 0.0
    return d.astype(np.float32)


@pytest.mark.parametrize("shape,share,seed", BINARIES)
@pytest.mark.parametrize("iters", [1, 5])
def test_reassign_native_against_jax_native_and_numpy(libs, shape, share,
                                                      seed, iters):
    """mf_reassign_edges through both packages' reassign_edge_pixels on
    the same components and depth: equal labels; and the port's numpy
    version equal to its native one (the JAX test's 2% bound is a bound,
    the measured difference is 0)."""
    binary = _binary(shape, share, seed)
    depth = _depth(shape, seed)
    comp = tcc.connected_components(binary)
    kw = dict(iterations=iters, depth_delta=0.008, small_threshold=50)
    tout = tcc.reassign_edge_pixels(comp, depth, **kw)
    jout = jcc.reassign_edge_pixels(jcc.Components(*comp), depth, **kw)
    np.testing.assert_array_equal(tout, jout)
    assert (tout != comp.labels).any()          # the pass moved pixels
    with tnative.disabled():
        plain = tcc.reassign_edge_pixels(comp, depth, **kw)
    np.testing.assert_array_equal(tout, plain)


def _stats_inputs(seed, n=120 * 160, n_comp=300, nm=4, n_masks=5):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_comp, n).astype(np.int32)
    proj = rng.choice(np.array([0, 3, 9, 200], np.uint8), n)
    id_to_index = np.zeros(256, np.int32)
    id_to_index[[0, 3, 9, 200]] = np.arange(4)
    mask = rng.integers(0, n_masks + 2, n).astype(np.uint8)   # some > max
    seg = rng.choice(np.array([0, 1, 3, 9, 255], np.uint8), n)
    depth = rng.uniform(0.3, 4.0, n).astype(np.float32)
    depth[rng.random(n) < 0.1] = 0.0
    return labels, proj, id_to_index, mask, seg, depth, n_comp, nm, n_masks


@pytest.mark.parametrize("seed", [0, 1])
def test_histograms_native_against_jax_native_and_numpy(libs, seed):
    """mf_label_stats (with and without the mask histogram),
    mf_model_seg_overlap and mf_depth_moments in both libraries: equal bit
    for bit; and equal to the numpy bincounts they replace (the moments'
    sums to 1e-12 relative: float64 sums in another order)."""
    (labels, proj, id_to_index, mask, seg, depth, n_comp, nm,
     n_masks) = _stats_inputs(seed)
    n = labels.size
    outs = []
    for lib in libs:
        cm = np.zeros((n_comp, nm), np.int32)
        ov = np.zeros((n_comp, n_masks), np.int32)
        lib.mf_label_stats(labels, proj, id_to_index, mask, n, nm, n_masks,
                           cm.reshape(-1), ov.reshape(-1))
        cm1 = np.zeros((n_comp, nm), np.int32)
        lib.mf_label_stats(labels, proj, id_to_index, mask, n, nm, 1,
                           cm1.reshape(-1), np.zeros(1, np.int32))
        mmo = np.zeros((nm, 256), np.int32)
        lib.mf_model_seg_overlap(seg, proj, id_to_index, n, mmo.reshape(-1))
        cnt = np.zeros(256, np.int64)
        s1, s2 = np.zeros(256), np.zeros(256)
        lib.mf_depth_moments(seg, depth, n, cnt, s1, s2)
        outs.append((cm, ov, cm1, mmo, cnt, s1, s2))
    for x, y in zip(*outs):
        np.testing.assert_array_equal(x, y)
    cm, ov, cm1, mmo, cnt, s1, s2 = outs[1]
    np.testing.assert_array_equal(cm, np.bincount(
        labels * nm + id_to_index[proj],
        minlength=n_comp * nm).reshape(n_comp, nm))
    np.testing.assert_array_equal(cm1, cm)
    np.testing.assert_array_equal(ov, np.bincount(
        labels * n_masks + mask.clip(0, n_masks - 1).astype(np.int32),
        minlength=n_comp * n_masks).reshape(n_comp, n_masks))
    np.testing.assert_array_equal(mmo, np.bincount(
        id_to_index[proj] * 256 + seg, minlength=nm * 256).reshape(nm, 256))
    v = depth > 0
    d = depth[v].astype(np.float64)
    np.testing.assert_array_equal(cnt, np.bincount(seg[v], minlength=256))
    np.testing.assert_allclose(s1, np.bincount(seg[v], d, minlength=256),
                               rtol=1e-12)
    np.testing.assert_allclose(s2, np.bincount(seg[v], d * d, minlength=256),
                               rtol=1e-12)


@pytest.mark.parametrize("shape,seed", [((120, 160), 0), ((480, 640), 1)])
def test_u8_bboxes_native_against_jax_native_and_numpy(libs, shape, seed):
    """mf_u8_bboxes in both libraries, and against a per-label numpy scan:
    (top, left, bottom, right) inclusive, (h, w, -1, -1) for an absent
    label."""
    rng = np.random.default_rng(seed)
    h, w = shape
    img = np.zeros(shape, np.uint8)
    for lab in rng.choice(np.arange(1, 256), 12, replace=False):
        y0, x0 = rng.integers(0, h - 10), rng.integers(0, w - 10)
        img[y0:y0 + rng.integers(1, 60), x0:x0 + rng.integers(1, 60)] = lab
    outs = []
    for lib in libs:
        bb = np.empty((256, 4), np.int32)
        lib.mf_u8_bboxes(img.reshape(-1), h, w, bb.reshape(-1))
        outs.append(bb)
    np.testing.assert_array_equal(*outs)
    for lab in range(256):
        ys, xs = np.nonzero(img == lab)
        want = ([ys.min(), xs.min(), ys.max(), xs.max()] if len(ys)
                else [h, w, -1, -1])
        np.testing.assert_array_equal(outs[1][lab], want)


def _perform(name, native: bool):
    """test_torch_segmentation's perform scenario on both packages, each on
    its native library (`native`) or its numpy path."""
    overrides, models, source, next_id, allow_new = SCENARIOS[name]
    rgb, depth, lab = _frame(1)
    vmap = jpp.create_vmap(jnp.asarray(depth), syn.DEFAULT_INTR, 5.0)
    nmap = np.asarray(jpp.create_nmap(vmap))
    vmap = np.asarray(vmap)
    ids = _projected_ids(lab, source)
    jseg = JMfSegmentation(JConfig(seg_method="maskfusion", **overrides),
                           JResolution(syn.W, syn.H), syn.DEFAULT_INTR)
    tseg = MfSegmentation(Config(seg_method="maskfusion", **overrides),
                          Resolution(syn.W, syn.H), tintr(syn.DEFAULT_INTR))
    saved = jnative._lib, jnative._tried
    if not native:
        jnative._lib, jnative._tried = None, True
    try:
        jr = jseg.perform(
            JFrameData(rgb=rgb, depth=depth, mask=lab, class_ids=[0, 7, 8]),
            jnp.asarray(vmap), jnp.asarray(nmap), ids,
            [JModelInfo(m, c) for m, c in models], next_id, allow_new)
    finally:
        jnative._lib, jnative._tried = saved
    with tnative.disabled(not native):
        tr = tseg.perform(
            FrameData(rgb=rgb, depth=depth, mask=lab, class_ids=[0, 7, 8]),
            t(vmap), t(nmap), ids, [ModelInfo(m, c) for m, c in models],
            next_id, allow_new)
    return tr, jr


def _same_result(a, b, depth_atol):
    np.testing.assert_array_equal(a.full_segmentation, b.full_segmentation)
    assert (a.has_new_label, a.new_model_class_id) == \
        (b.has_new_label, b.new_model_class_id)
    assert len(a.model_data) == len(b.model_data)
    for x, y in zip(a.model_data, b.model_data):
        assert (x.model_id, x.is_empty, x.pixel_count, x.class_id) == \
            (y.model_id, y.is_empty, y.pixel_count, y.class_id)
        assert x.depth_mean == pytest.approx(y.depth_mean, abs=depth_atol)
        assert x.depth_std == pytest.approx(y.depth_std, abs=depth_atol)


@pytest.mark.parametrize("name", ["spawn_first", "both_tracked",
                                  "morphology", "person_mask"])
def test_perform_native_against_jax_native(libs, name):
    """MfSegmentation.perform with both packages on their native library
    (components, reassignment, label stats, overlaps, depth moments): the
    same segmentation and model data, depth moments bit for bit; and the
    port's native result equal to its numpy one (moments to 1e-9: float64
    sums in another order)."""
    tr, jr = _perform(name, native=True)
    _same_result(tr, jr, 0.0)
    plain, _ = _perform(name, native=False)
    _same_result(tr, plain, 1e-9)


def test_native_is_the_default_and_disabled_switches_it():
    """active() is the library unless disabled(); disabled(False) turns it
    back on inside; the switch restores on exit."""
    assert tnative.active() is tnative.load()
    with tnative.disabled():
        assert tnative.active() is None
        with tnative.disabled(False):
            assert tnative.active() is not None
        assert tnative.active() is None
    assert tnative.active() is not None


def test_build_lands_in_build_dir_and_no_binary_is_committed():
    """The library is built into build/mfcore/ at the repository root, named
    by its hash; the package holds the source and no .so."""
    path = tnative.build()
    assert path.parent == ROOT / "build" / "mfcore"
    assert path.exists() and path.name.startswith("libmfcore_")
    pkg = ROOT / "maskfusion_tpu_torch" / "cpp"
    assert not list(pkg.glob("*.so"))
    # the source is the JAX package's, below its header comment
    src = (pkg / "mfcore.cpp").read_text()
    ref = (ROOT / "maskfusion_tpu" / "cpp" / "mfcore.cpp").read_text()
    body = "#include <cstdint>"
    assert src[src.index(body):] == ref[ref.index(body):]


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """No silent fallback: a source that does not compile raises with the
    compiler's message, and nothing lands in the build directory."""
    bad = tmp_path / "mfcore.cpp"
    bad.write_text("extern \"C\" int f( { return 0; }\n")
    monkeypatch.setattr(tnative, "_SRC", bad)
    monkeypatch.setattr(tnative, "_BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="mfcore.cpp failed") as err:
        tnative.build()
    assert "error" in str(err.value)
    assert not list((tmp_path / "build").glob("*.so"))
