"""The port's Mask R-CNN held to the JAX package.

Both packages run on the same weights (``_shared_weights``, once per
module and arch): the port's seeded initialisation, BatchNorm's statistics
drawn from the seed too, and the output layers of the RPN and the box head
scaled down, so that scores and deltas spread as a trained model's do
instead of saturating (the seeded trunk's activations reach a few hundred:
its RPN logits would put most sigmoids at exactly 0 or 1, and its box
deltas would push every refined box to the canvas edge). They reach the JAX
package as the flax tree of the port's ``to_flax``. The same inputs, made from a seed with
numpy (or the conftest video), go through jitted JAX and the port. On the
CPU ``nms`` and the crops are their plain versions (their kernels are held
to those on the card by test_torch_kernels_cuda.py).

Tolerances, and why. Each stage is held to JAX on the same inputs, where
the discrete decisions must come out equal: the anchors bit for bit, the
FPN levels equal; the proposals' keep sets, with boxes within
PROPOSAL_ATOL px (decoded with ``exp``, which rounds differently from
XLA's, by an ulp or two of boxes up to 224 px; measured 3.1e-5; a
different keep set would move a box by pixels); ``select_detections``'
boxes, scores and labels bit for bit (it gathers what it is given), but
for the JAX package's row K where K < max_det (its discard slot, ROADMAP
queue 3). The level crop equals the JAX one-hot sum exactly on constant
maps, and within CROP_ATOL of values up to about 4 on random maps (jitted
JAX contracts the sample position into an FMA, which moves it by an ulp,
times the step between neighbouring values; measured 1.1e-5). The trunk
and the heads within NET_RTOL of their largest value (convolutions and
dense layers add in other orders, over activations up to about 800;
measured 3.0e-6). The pipeline's stored rows: the same detections in the
same order with equal labels; normalized boxes within PIPE_BOX_ATOL
(measured 8e-7), scores within PIPE_SCORE_ATOL (the box head's softmax
over float32 sums of 12,544 products; measured 3.8e-6) and the pasted
masks within PIPE_MASK_ATOL (sigmoids of logits up to about 40 from five
convolutions; measured 5.5e-5 before pasting).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scannertools_tpu as jst
import scannertools_tpu_torch as st
from scannertools_tpu.models import common as JC
from scannertools_tpu.models import maskrcnn as JM
from scannertools_tpu.ops import faces as JFO
from scannertools_tpu_torch.models import common as MC
from scannertools_tpu_torch.models import maskrcnn as PM
from scannertools_tpu_torch.models import porting_maps
from scannertools_tpu_torch.models import weights as PW
from scannertools_tpu_torch.ops import faces as PFO

CAPS = (192, 96, 16)  # pre_nms, post_nms, max_det: tests/test_maskrcnn.py's
PROPOSAL_ATOL = 1e-4
CROP_ATOL = 1e-4
NET_RTOL = 1e-5
PIPE_BOX_ATOL = 1e-5
PIPE_SCORE_ATOL = 2e-5
PIPE_MASK_ATOL = 2e-4
# the weights_path under which both packages' model caches hold the shared
# weights (no npz is written: R-50-FPN's is 178 MB)
KEY = "seeded-maskrcnn"
X_TINY = ((1, 1, 1, 1), 32, 8)


def _t(a):
    return torch.from_numpy(np.array(a))


def _shared_weights(arch: str, seed: int):
    """(flax variables as numpy, the port's state_dict) of the same
    weights: the port's seeded init with BatchNorm's statistics, scales
    and shifts drawn from ``seed`` too, and the output layers of the RPN
    and the box head scaled down (see the module docstring)."""
    state = PM.init_params(seed, arch)
    rng = np.random.default_rng(seed)
    for key, x in state.items():
        leaf = key.rsplit(".", 1)[-1]
        if "bn" in key and leaf != "num_batches_tracked":
            lo, hi = {"running_var": (0.5, 2.0), "weight": (0.5, 1.5)}.get(
                leaf, (-0.2, 0.2))
            state[key] = _t(rng.uniform(lo, hi, x.shape).astype(np.float32))
    for key, scale in (("rpn.cls_logits", 0.02), ("rpn.bbox_pred", 0.002),
                       ("box.cls_score", 0.05), ("box.bbox_pred", 0.002)):
        state[key + ".weight"] = state[key + ".weight"] * scale
    return PM.to_flax(state, arch), state


def _jax_model(arch: str, caps=CAPS):
    """The JAX package's MaskRCNNModel for ``arch`` at ``caps``, its
    modules without their own init (the weights come from
    ``_shared_weights``; the eager init takes 15-30 s here)."""
    blocks, groups, wpg = JM.ARCHS[arch]
    model = JM.MaskRCNNModel.__new__(JM.MaskRCNNModel)
    model.arch = arch
    model.pre_nms, model.post_nms, model.max_det = caps
    model.trunk = JM.MaskRCNN(blocks, groups, wpg)
    model.box_head, model.mask_head = JM.BoxHead(), JM.MaskHead()
    model._strides = [4, 8, 16, 32, 64]
    return model


@pytest.fixture(scope="module")
def r50():
    """(JAX model at CAPS, flax variables, port state) of R-50-FPN."""
    return (_jax_model("R-50-FPN"), *_shared_weights("R-50-FPN", 0))


@pytest.fixture(scope="module")
def x_tiny():
    """The same of the ResNeXt variant (32 groups of width 8) at one block
    a stage, added to both packages' arch tables for this module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(JM.ARCHS, "X-tiny", X_TINY)
        mp.setitem(PM.ARCHS, "X-tiny", X_TINY)
        yield (_jax_model("X-tiny"), *_shared_weights("X-tiny", 3))


# ------------------------------------------------------------ geometry


@pytest.mark.parametrize("h,w,lo,hi", [(480, 640, 800, 1333),
                                       (1080, 1920, 800, 1333),
                                       (30, 40, 60, 100), (64, 96, 64, 128)])
def test_letterbox_geometry_equals_jax(h, w, lo, hi):
    assert PM.letterbox_geometry(h, w, lo, hi) == \
        JM.letterbox_geometry(h, w, lo, hi)
    s, (th, tw), (ch, cw) = PM.letterbox_geometry(480, 640)
    assert (th, tw, ch, cw) == (800, 1067, 800, 1088)


def test_preprocess_matches_jax():
    """tests/test_maskrcnn.py's case: the content region within one float32
    ulp of 255 (XLA adds the resize's taps in another order), the padding
    exactly 0, the scale equal."""
    frames = np.random.default_rng(0).integers(
        0, 255, (2, 30, 40, 3)).astype(np.float32)
    want, ws = jax.jit(lambda f: JM.preprocess(f, 60, 100))(frames)
    got, gs = PM.preprocess(_t(frames), 60, 100)
    want, got = np.asarray(want), got.numpy()
    assert gs == pytest.approx(float(ws)) and got.shape == want.shape \
        == (2, 64, 96, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    assert (got[:, 60:] == 0).all() and (got[:, :, 80:] == 0).all()


@pytest.mark.parametrize("canvas", [(64, 96), (512, 672)])
def test_anchors_bit_equal(canvas):
    h, w = canvas
    for s in PM.STRIDES:
        hw = (-(-h // s), -(-w // s))
        np.testing.assert_array_equal(PM.anchors_for(hw, s),
                                      JM._anchors_for(hw, s))


def _level_fixture():
    """tests/test_maskrcnn.py's 256 boxes spanning the four levels."""
    rng = np.random.default_rng(1)
    x1 = rng.uniform(0, 500, 256).astype(np.float32)
    y1 = rng.uniform(0, 500, 256).astype(np.float32)
    ww = np.exp(rng.uniform(np.log(4), np.log(900), 256)).astype(np.float32)
    hh = np.exp(rng.uniform(np.log(4), np.log(900), 256)).astype(np.float32)
    return np.stack([x1, y1, x1 + ww, y1 + hh], axis=1), ww, hh


def test_fpn_level_for_equals_jax():
    boxes, ww, hh = _level_fixture()
    got = PM.fpn_level_for(_t(boxes)).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jax.jit(JM.fpn_level_for)(boxes)))
    want = np.clip(np.floor(4 + np.log2(np.sqrt(ww * hh) / 224.0 + 1e-6)),
                   2, 5).astype(np.int64) - 2
    np.testing.assert_array_equal(got, want)
    assert set(got.tolist()) == {0, 1, 2, 3}


# ------------------------------------------------------------ level crop


def _one_hot_sum(maps, boxes, level, fi, out_hw):
    """The JAX package's formulation with the port's plain crop: every box
    from every level, kept by a one-hot sum."""
    out = None
    for li, (m, s) in enumerate(zip(maps, MC.FPN_STRIDES)):
        crop = MC.crop_and_resize_plain(m, boxes / s, out_hw, fi)
        sel = (level == li).to(crop.dtype)[:, None, None, None]
        out = sel * crop if out is None else out + sel * crop
    return out


def test_level_crop_constant_maps_equal_jax():
    """tests/test_maskrcnn.py's constant maps (value l + 1 on level l):
    each box's crop comes from its level, equal to the JAX one-hot sum."""
    H = W = 256
    maps = [np.full((H // s, W // s, 8), float(v), np.float32)
            for s, v in zip(MC.FPN_STRIDES, (1.0, 2.0, 3.0, 4.0))]
    boxes = np.asarray([[10, 10, 10 + s, 10 + s] for s in
                        (32.0, 120.0, 250.0, 500.0)], np.float32)
    want = np.asarray(JM.roi_align_multilevel(
        [jnp.asarray(m) for m in maps], jnp.asarray(boxes), (7, 7)))
    level = PM.fpn_level_for(_t(boxes))
    np.testing.assert_array_equal(level.numpy(), [0, 1, 2, 3])
    args = ([_t(m[None]) for m in maps], _t(boxes), level,
            torch.zeros(4, dtype=torch.int64), (7, 7))
    for fn in (MC.crop_and_resize_levels, MC.crop_and_resize_levels_plain):
        got = fn(*args).numpy()
        assert (got == want).all()
        assert (got == np.arange(1.0, 5.0)[:, None, None, None]).all()


def test_level_crop_random_maps():
    """Two frames of four random 16-channel levels of a 128x160 canvas,
    boxes on every level, at and past the edges, and zero boxes: ``==`` the
    one-hot sum of the plain crop, and within CROP_ATOL of the JAX
    package's roi_align_multilevel, frame by frame."""
    rng = np.random.default_rng(2)
    H, W, t = 128, 160, 2
    maps = [rng.standard_normal((t, H // s, W // s, 16)).astype(np.float32)
            for s in MC.FPN_STRIDES]
    n = 60
    xy = rng.uniform(-20, 150, (n, 2))
    wh = np.exp(rng.uniform(np.log(2), np.log(700), (n, 2)))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    boxes[1:4] = [[-30, -20, 500, 600], [5, 5, 700, 300], [0, 0, 160, 128]]
    boxes[::11] = 0.0
    fi = rng.integers(0, t, n)
    level = PM.fpn_level_for(_t(boxes))
    assert set(level.tolist()) == {0, 1, 2, 3}
    tm = [_t(m) for m in maps]
    got = MC.crop_and_resize_levels(tm, _t(boxes), level, _t(fi), (7, 7))
    assert (got == _one_hot_sum(tm, _t(boxes), level, _t(fi),
                                (7, 7))).all()
    roi = jax.jit(lambda ms, b: JM.roi_align_multilevel(ms, b, (7, 7)))
    for f in range(t):
        sel = fi == f
        want = np.asarray(roi([m[f] for m in maps], boxes[sel]))
        np.testing.assert_allclose(got.numpy()[sel], want, rtol=0,
                                   atol=CROP_ATOL)


def test_level_crop_checks_its_inputs():
    maps = [torch.zeros((2, 8 // s * 4, 8 // s * 4, 3)) for s in (1, 2)]
    boxes = torch.zeros((3, 4))
    fi = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(IndexError):
        MC.crop_and_resize_levels(maps, boxes, torch.tensor([0, 2, 1]), fi,
                                  (4, 4))
    with pytest.raises(ValueError):
        MC.crop_and_resize_levels(maps, boxes, torch.tensor([0, 1]), fi,
                                  (4, 4))
    with pytest.raises(ValueError):
        MC.crop_and_resize_levels(maps * 3, boxes, fi, fi, (4, 4))
    with pytest.raises(ValueError):
        MC.crop_and_resize_levels([maps[0], maps[1][:1]], boxes, fi, fi,
                                  (4, 4))
    assert MC.crop_and_resize_levels(maps, boxes[:0], fi[:0], fi[:0],
                                     (4, 4)).shape == (0, 4, 4, 3)


# ------------------------------------------------------------ proposals


def _jax_propose(scores, deltas, anchors, H, W, pre, post):
    """maskrcnn.py:329-344 per image (vmapped), the sigmoid's scores
    given."""
    clip_hi = jnp.asarray([W, H, W, H], jnp.float32)

    def per_image(ss, dd):
        lb, ls = [], []
        for s, d, a in zip(ss, dd, anchors):
            k = min(pre, s.shape[0])
            top, idx = jax.lax.top_k(s, k)
            bx = jnp.clip(JM._apply_deltas(a[idx], d[idx]), 0, clip_hi)
            pb, ps, _ = JC.nms(bx, top, 0.7, min(post, k))
            lb.append(pb)
            ls.append(ps)
        sc, bo = jnp.concatenate(ls), jnp.concatenate(lb)
        _, idx = jax.lax.top_k(sc, min(post, sc.shape[0]))
        return bo[idx]

    return jax.vmap(per_image)(scores, deltas)


@pytest.mark.parametrize("canvas,caps", [((64, 96), (192, 96)),
                                         ((64, 96), (40, 30)),
                                         ((160, 224), (1000, 1000))])
def test_propose_matches_jax_loop(canvas, caps):
    """The batched proposal step (one nms call for every level of every
    frame) against the JAX package's per-level loop on the same scores,
    deltas and anchors: ragged levels (P5 and P6 below the cap), tied
    scores. The same boxes in the same order, within PROPOSAL_ATOL."""
    H, W = canvas
    rng = np.random.default_rng(H + caps[0])
    anchors, scores, deltas = [], [], []
    for s in PM.STRIDES:
        a = PM.anchors_for((-(-H // s), -(-W // s)), s)
        sc = rng.uniform(0, 1, (2, len(a))).astype(np.float32)
        sc[:, ::13] = 0.5
        anchors.append(a)
        scores.append(sc)
        deltas.append(rng.normal(0, 0.2, (2, len(a), 4)).astype(np.float32))
    want = np.asarray(jax.jit(lambda s, d: _jax_propose(
        s, d, [jnp.asarray(a) for a in anchors], H, W, *caps))(
            scores, deltas))
    got = PM.propose([_t(s) for s in scores], [_t(d) for d in deltas],
                     [_t(a) for a in anchors], H, W, *caps).numpy()
    assert got.shape == want.shape == (2, min(caps[1], want.shape[1]), 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=PROPOSAL_ATOL)
    assert (got[..., 2] > got[..., 0]).sum() > got.shape[1]


@pytest.mark.parametrize("k,max_det", [(1000, 100), (12, 16)])
def test_select_detections_matches_jax_scan(k, max_det):
    """The class-shifted nms with the kept index against the JAX package's
    K-step scan: boxes, scores and labels bit for bit (the kept rows, their
    order and their source rows), rows below SCORE_THRESH, tied scores, a
    frame with no row above the threshold; at K < max_det, zeros in row K,
    where the JAX package leaves a row it did not keep."""
    rng = np.random.default_rng(k)
    t = 3
    c = rng.uniform(0, 300, (t, k, 2))
    wh = rng.uniform(10, 120, (t, k, 2))
    refined = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    scores = rng.uniform(0, 0.6, (t, k)).astype(np.float32)
    scores[:, ::7] = 0.25
    scores[:, 1::5] = 0.01
    scores[-1] = 0.04
    labels = rng.integers(1, 5, (t, k)).astype(np.int32)
    diag = 2.0 * 800
    want = [np.asarray(a) for a in jax.jit(jax.vmap(
        lambda r, s, l: JM.select_detections(r, s, l, diag, max_det)))(
            refined, scores, labels)]
    got = [a.numpy() for a in PM.select_detections(
        _t(refined), _t(scores), _t(labels), diag, max_det)]
    assert got[2].dtype == np.int32
    # where K < max_det the JAX package's row K is its scatter's discard
    # slot, holding one of the rows not kept (ROADMAP queue 3); the port
    # gives zeros there
    rows = [r for r in range(max_det) if r != k]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g[:, rows], w[:, rows])
    _, _, _, idx = MC.nms(
        _t(refined + labels[..., None].astype(np.float32) * np.float32(diag)),
        _t(scores), 0.5, max_det, 0.05, index=True)
    idx = idx.numpy()
    kept = idx >= 0
    assert kept[:2].sum(axis=1).min() >= min(k // 2, max_det // 2)
    assert not kept[-1].any()
    np.testing.assert_array_equal(want[1][:, rows] > 0, kept[:, rows])
    if k < max_det:
        assert not got[1][:, k].any() and not got[0][:, k].any()
        assert (want[1][:, k] > 0).all()  # a row not kept, in every frame
    # each kept row is a row of the input, by its source index
    np.testing.assert_array_equal(
        np.take_along_axis(refined, np.maximum(idx, 0)[..., None], 1)[kept],
        got[0][kept])
    np.testing.assert_array_equal(
        np.take_along_axis(labels, np.maximum(idx, 0), 1)[kept],
        got[2][kept])


# ------------------------------------------------------------ nets


def _assert_net_close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=NET_RTOL * np.abs(want).max())


@pytest.mark.parametrize("which", ["r50", "x_tiny"])
def test_trunk_and_heads_match_flax(request, which):
    """R-50-FPN at full depth and the ResNeXt variant at a 64x96 canvas:
    P2..P6, the RPN's logits and deltas at every level, the box head on
    seeded 7x7 crops and the mask head (its upsampling the mirrored
    ConvTranspose) on seeded 14x14 crops, each within NET_RTOL of its
    largest value."""
    model, v, state = request.getfixturevalue(which)
    arch = "R-50-FPN" if which == "r50" else "X-tiny"
    rng = np.random.default_rng(4)
    images = rng.uniform(-120, 150, (2, 64, 96, 3)).astype(np.float32)
    roi7 = rng.normal(0, 100, (5, 7, 7, 256)).astype(np.float32)
    roi14 = rng.normal(0, 100, (5, 14, 14, 256)).astype(np.float32)
    fpn, rpn = jax.jit(model.trunk.apply)(v["trunk"], images)
    cls, deltas = jax.jit(model.box_head.apply)(v["box"], roi7)
    masks = jax.jit(model.mask_head.apply)(v["mask"], roi14)
    net = PM.MaskRCNN(arch)
    net.load_state_dict(state)
    with torch.no_grad():
        pfpn = net.backbone(_t(images).permute(0, 3, 1, 2))
        for p, f in zip(pfpn, fpn):
            _assert_net_close(p.permute(0, 2, 3, 1).numpy(), np.asarray(f))
        for p, (logits, d) in zip(pfpn, rpn):
            pl, pd = net.rpn(p)
            _assert_net_close(pl.numpy(), np.asarray(logits).reshape(2, -1))
            _assert_net_close(pd.numpy(),
                              np.asarray(d).reshape(2, -1, 4))
        for g, w in zip(net.box(_t(roi7)), (cls, deltas)):
            _assert_net_close(g.numpy(), np.asarray(w))
        _assert_net_close(net.mask(_t(roi14)).permute(0, 2, 3, 1).numpy(),
                          np.asarray(masks))


def test_conv_transpose_repair_both_ways():
    """flax's ConvTranspose (transpose_kernel=False) equals torch's
    ConvTranspose2d only with the kernel mirrored: the converters mirror it
    from torch to flax and back."""
    import flax.linen as nn

    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, 5, 7, 4)).astype(np.float32)
    layer = nn.ConvTranspose(6, (2, 2), (2, 2))
    v = layer.init(jax.random.PRNGKey(0), x)
    want = np.asarray(layer.apply(v, x))
    kernel = np.asarray(v["params"]["kernel"])
    bias = np.asarray(v["params"]["bias"])
    w = PW._to_torch("conv_transpose", kernel)
    got = torch.nn.functional.conv_transpose2d(
        _t(x).permute(0, 3, 1, 2), _t(w), _t(bias), stride=2)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-6)
    unflipped = torch.nn.functional.conv_transpose2d(
        _t(x).permute(0, 3, 1, 2), _t(kernel.transpose(2, 3, 0, 1)),
        _t(bias), stride=2)
    assert np.abs(unflipped.permute(0, 2, 3, 1).numpy() - want).max() > 0.1
    # torch -> flax: a torch layer's weight through the converter
    tw = rng.normal(0, 1, (4, 6, 2, 2)).astype(np.float32)
    flax_kernel = PW.from_torch_conv_transpose(tw)
    np.testing.assert_array_equal(PW._to_flax("conv_transpose", tw),
                                  flax_kernel)
    np.testing.assert_array_equal(PW._to_torch("conv_transpose",
                                               flax_kernel), tw)
    got = layer.apply({"params": {"kernel": flax_kernel, "bias": bias}}, x)
    want = torch.nn.functional.conv_transpose2d(
        _t(x).permute(0, 3, 1, 2), _t(tw), _t(bias), stride=2)
    np.testing.assert_allclose(np.asarray(got),
                               want.permute(0, 2, 3, 1).numpy(), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("which", ["r50", "x_tiny"])
def test_weights_round_trip(request, which):
    """The mapping covers the module's state exactly, and from_flax and
    to_flax invert each other bit for bit."""
    _, v, state = request.getfixturevalue(which)
    arch = "R-50-FPN" if which == "r50" else "X-tiny"
    mapping = PM.torch_mapping(arch)
    assert set(mapping) == set(porting_maps.maskrcnn_mapping(arch))
    assert {k for k, _ in mapping.values()} == {
        k for k in MC._skeleton(PM.MaskRCNN, arch).state_dict()
        if not k.endswith("num_batches_tracked")}
    back = PM.from_flax(v, arch)
    assert set(back) == set(state)
    assert all(torch.equal(back[k], state[k]) for k in state)
    flat_back = PW._flatten(PM.to_flax(back, arch))
    flat_v = PW._flatten(v)
    assert set(flat_back) == set(flat_v)
    for key, a in flat_v.items():
        np.testing.assert_array_equal(flat_back[key], a)


def test_init_params_shapes_and_ops_cache():
    """The port's own seeded weights load into its module strictly, and the
    op's weight cache keys Mask R-CNN's weights on the arch."""
    state = PM.init_params(0)
    PM.MaskRCNN().load_state_dict(state)
    a = PFO._get_params("maskrcnn", None, "R-50-FPN")
    assert a is PFO._get_params("maskrcnn", None, "R-50-FPN")
    assert ("maskrcnn", None, "R-50-FPN") in PFO._MODEL_CACHE
    assert all(torch.equal(a[k], state[k]) for k in state)


# ------------------------------------------------------------ pipeline


def test_maskrcnn_pipeline_matches_jax(tmp_path, test_video, r50,
                                       monkeypatch):
    """MaskRCNNDetectObjects through Client.run in both packages, on the
    96x64 video's frames 0 and 70 at min_size 64, max_size 128 and the caps
    192/96/16, on the shared weights: the same detections (score above
    0.1) in the same order, labels equal, boxes, scores and mask canvases
    within the PIPE tolerances."""
    model, v, state = r50
    monkeypatch.setitem(JFO._MODEL_CACHE, ("maskrcnn_vars", KEY, "R-50-FPN"),
                        v)
    monkeypatch.setitem(JFO._MODEL_CACHE,
                        ("maskrcnn_model", "R-50-FPN", CAPS), model)
    monkeypatch.setitem(PFO._MODEL_CACHE, ("maskrcnn", KEY, "R-50-FPN"),
                        state)
    rows = {}
    for pkg, tag in ((st, "t"), (jst, "j")):
        sc = pkg.Client(db_path=str(tmp_path / tag),
                        **(dict(device="cpu") if pkg is st else {}))
        frame = sc.io.Input([pkg.NamedVideoStream(sc, "v",
                                                  path=test_video["path"])])
        dets = sc.ops.MaskRCNNDetectObjects(
            frame=sc.streams.Gather(frame, [[0, 70]]), weights_path=KEY,
            confidence_threshold=0.1, min_size=64, max_size=128,
            pre_nms=CAPS[0], post_nms=CAPS[1], max_det=CAPS[2])
        out = pkg.NamedStream(sc, "mrcnn")
        sc.run(sc.io.Output(dets, [out]),
               pkg.PerfParams.manual(work_packet_size=2, ingest="rgb"),
               cache_mode=pkg.CacheMode.Overwrite)
        rows[tag] = list(out.load())
    got, want = rows["t"], rows["j"]
    assert [len(f) for f in got] == [len(f) for f in want]
    assert all(len(f) > 0 for f in got)
    for fg, fw in zip(got, want):
        for a, b in zip(fg, fw):
            assert a["bbox"].label == b["bbox"].label
            np.testing.assert_allclose(
                [a["bbox"].x1, a["bbox"].y1, a["bbox"].x2, a["bbox"].y2],
                [b["bbox"].x1, b["bbox"].y1, b["bbox"].x2, b["bbox"].y2],
                rtol=0, atol=PIPE_BOX_ATOL)
            assert abs(a["bbox"].score - b["bbox"].score) <= PIPE_SCORE_ATOL
            assert a["mask"].shape == b["mask"].shape == (16, 24)
            np.testing.assert_allclose(a["mask"], b["mask"], rtol=0,
                                       atol=PIPE_MASK_ATOL)
