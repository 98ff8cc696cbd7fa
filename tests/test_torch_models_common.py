"""The port's detection primitives, weight carry-across and nets held to the
JAX package.

The same inputs, made from a seed with numpy, go through the jitted JAX
function and its port (``nms`` and ``crop_and_resize`` on CPU tensors are
their plain versions; their CUDA kernels are held to those on the card by
test_torch_kernels_cuda.py). Tolerances, and why:

* ``nms``: exact. The port sorts stably and evaluates the overlap in the
  written order; the keep sets, boxes, scores and valid flags are equal.
  Where ``max_out`` > K the JAX package returns max_out + 1 rows, its
  discard slot (a suppressed row, valid False) at row K (ROADMAP queue 3);
  the port returns max_out, and the rest is compared without that row.
* ``crop_and_resize``: atol 4e-3 on pixel values in [0, 255] at frames of
  at most 64 px. Jitted XLA computes a sample position
  ``(y2 - y1) * (i + 0.5) / oh - 0.5`` with a fused multiply-add and its
  einsum may fuse a tap's product into the sum, where the port rounds each
  operation (what its kernel does bit for bit). A position off by one
  float32 ulp (at most 3.8e-6 below 64) moves a value by at most that
  times the largest step between neighbouring pixels (255): 1e-3, and the
  tap sums by a few ulps of 255. Power-of-two sizes, where the division is
  exact, agree bit for bit.
* The nets on the same npz: relative 1e-5 of the largest output
  (P/R/O-Net, gender logits) and 1e-5 absolute on FaceNet's unit-norm
  embeddings. oneDNN's and XLA's convolutions add in other orders;
  measured about 1e-7 relative.
* The weight converter: exact, both ways.
* FaceNet folded (``facenet.fold``) against its flax order of operations
  on the CPU, with BatchNorm statistics spread (variances 1e-8 to 2, so
  rsqrt(var + eps) reaches 31.6): 1e-5 of the largest output of a unit, a
  block or the tail, and 1e-5 absolute on the embeddings. Folding moves
  the rounding of the scale and the shift into the weights and bias, and
  the sum of up to 2304 products adds in another order: measured 1.8e-7
  to 7.4e-7 relative (blocks the most), 4.9e-7 on the embeddings.
"""

import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from scannertools_tpu.models import common as JC
from scannertools_tpu.models import facenet as JF
from scannertools_tpu.models import gender as JG
from scannertools_tpu.models import mtcnn as JM
from scannertools_tpu.models import weights as JW
from scannertools_tpu_torch.models import common as PC
from scannertools_tpu_torch.models import facenet as PF
from scannertools_tpu_torch.models import gender as PG
from scannertools_tpu_torch.models import mtcnn as PM
from scannertools_tpu_torch.models import weights as PW

CROP_ATOL = 4e-3
FOLD_REL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cloud(rng, k, span=60.0, lo=4.0, hi=18.0):
    c = rng.uniform(0, span, (k, 2))
    wh = rng.uniform(lo, hi, (k, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], axis=1).astype(
        np.float32)


def _jax_nms(boxes, scores, iou, max_out, score_thresh=0.0, mode="union"):
    fn = jax.jit(lambda b, s: JC.nms(b, s, iou, max_out, score_thresh,
                                     mode))
    return [np.asarray(a) for a in fn(jnp.asarray(boxes),
                                      jnp.asarray(scores))]


def _port_nms(boxes, scores, iou, max_out, score_thresh=0.0, mode="union"):
    return [a.numpy() for a in PC.nms(_t(boxes), _t(scores), iou, max_out,
                                      score_thresh, mode)]


def _assert_nms_equal(got, want, k, max_out):
    if max_out > k:  # drop the JAX package's discard slot (row k)
        assert want[0].shape[0] == max_out + 1
        want = [np.delete(w, k, axis=0) for w in want]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------------ iou/nms


def test_iou_matrix_matches_jax():
    rng = np.random.default_rng(0)
    a, b = _cloud(rng, 40), _cloud(rng, 33)
    a[3] = [5, 5, 5, 9]  # zero area: union may be 0
    b[4] = a[3]
    want = np.asarray(jax.jit(JC.iou_matrix)(a, b))
    np.testing.assert_array_equal(PC.iou_matrix(_t(a), _t(b)).numpy(), want)


def test_nms_matches_reference_semantics():
    """tests/test_models.py's case on the port."""
    boxes = np.array([
        [0, 0, 10, 10],
        [1, 1, 11, 11],    # IoU with 0 ~ 0.68 -> suppressed
        [20, 20, 30, 30],
        [21, 21, 29, 29],  # inside box 2, higher score -> suppresses box 2
        [50, 50, 60, 60],
    ], np.float32)
    scores = np.array([0.9, 0.8, 0.7, 0.95, 0.6], np.float32)
    ob, os_, ov = _port_nms(boxes, scores, 0.5, 4)
    assert ov.sum() == 3
    np.testing.assert_array_equal(os_[:3], scores[[3, 0, 4]])
    np.testing.assert_array_equal(ob[0], boxes[3])
    _, os2, ov2 = _port_nms(boxes, scores, 0.9, 4, mode="min")
    assert ov2.sum() == 4
    assert np.float32(0.7) not in os2.tolist()


@pytest.mark.parametrize("mode", ["union", "min"])
@pytest.mark.parametrize("k,max_out", [(1, 1), (5, 5), (5, 2), (5, 9),
                                       (96, 96), (96, 32), (130, 130),
                                       (130, 200)])
def test_nms_matches_jax(mode, k, max_out):
    """Random clouds (K not a multiple of 64 too), every tenth score tied,
    some at or below score_thresh."""
    rng = np.random.default_rng(k * 7 + max_out)
    boxes = _cloud(rng, k)
    scores = rng.uniform(0.0, 1.0, k).astype(np.float32)
    scores[::10] = 0.5
    scores[1::9] = 0.1  # == score_thresh: invalid
    thresh = 0.3 if mode == "min" else 0.5
    got = _port_nms(boxes, scores, thresh, max_out, 0.1, mode)
    want = _jax_nms(boxes, scores, thresh, max_out, 0.1, mode)
    _assert_nms_equal(got, want, k, max_out)


def _greedy_np(boxes, scores, thr):
    order = np.argsort(-scores, kind="stable")
    b = boxes[order]
    kept = []
    for i in range(len(b)):
        x1 = np.maximum(b[i, 0], b[:, 0])
        y1 = np.maximum(b[i, 1], b[:, 1])
        x2 = np.minimum(b[i, 2], b[:, 2])
        y2 = np.minimum(b[i, 3], b[:, 3])
        inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
        a = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(b[:, 3] - b[:, 1], 0)
        union = a[i] + a - inter
        iou = np.where(union > 0, inter / union, 0)
        if not any(iou[j] > thr for j in kept):
            kept.append(i)
    return [tuple(b[i]) for i in kept]


@pytest.mark.parametrize("trial", range(3))
def test_nms_is_sequential_greedy(trial):
    """tests/test_models.py's random clouds against a numpy greedy loop."""
    rng = np.random.default_rng(trial)
    boxes = _cloud(rng, 96)
    scores = rng.uniform(0.1, 1.0, 96).astype(np.float32)
    ob, _, ov = _port_nms(boxes, scores, 0.5, 96)
    assert [tuple(x) for x in ob[ov]] == _greedy_np(boxes, scores, 0.5)


@pytest.mark.parametrize("n", [64, 65])
def test_nms_alternating_chain(n):
    """Box i overlaps only box i+1 (IoU 0.25 > 0.2): greedy keeps the even
    ones, the deepest chain for the fixed point (and across a 64-bit word
    of the kernel's mask at n = 65)."""
    boxes = np.stack([np.arange(n) * 6.0, np.zeros(n),
                      np.arange(n) * 6.0 + 10, np.full(n, 10.0)],
                     axis=1).astype(np.float32)
    scores = np.linspace(1.0, 0.5, n).astype(np.float32)
    got = _port_nms(boxes, scores, 0.2, n)
    assert got[2].sum() == (n + 1) // 2
    np.testing.assert_array_equal(got[0][got[2]][:, 0],
                                  np.arange(0, n, 2) * 6.0)
    _assert_nms_equal(got, _jax_nms(boxes, scores, 0.2, n), n, n)


def test_nms_all_invalid_and_all_tied():
    rng = np.random.default_rng(3)
    boxes = _cloud(rng, 20)
    zero = np.zeros(20, np.float32)
    ob, os_, ov = _port_nms(boxes, zero, 0.5, 24)
    assert not ov.any() and not ob.any() and not os_.any()
    # all scores equal: the input order is the score order
    tied = np.full(20, 0.5, np.float32)
    _assert_nms_equal(_port_nms(boxes, tied, 0.5, 20),
                      _jax_nms(boxes, tied, 0.5, 20), 20, 20)


@pytest.mark.parametrize("mode", ["union", "min"])
def test_nms_batched_is_per_frame(mode):
    """[T, K] frames in one call equal T calls, and the JAX package vmapped;
    frame 2 has no valid row."""
    rng = np.random.default_rng(9)
    t, k = 4, 70
    boxes = np.stack([_cloud(rng, k) for _ in range(t)])
    scores = rng.uniform(0, 1, (t, k)).astype(np.float32)
    scores[2] = 0.0
    scores[1, ::3] = scores[1, 0]  # ties
    got = [a.numpy() for a in PC.nms(_t(boxes), _t(scores), 0.4, 40, 0.0,
                                     mode)]
    want = [np.asarray(a) for a in jax.jit(jax.vmap(
        lambda b, s: JC.nms(b, s, 0.4, 40, 0.0, mode)))(boxes, scores)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for f in range(t):
        one = _port_nms(boxes[f], scores[f], 0.4, 40, 0.0, mode)
        for g, o in zip(got, one):
            np.testing.assert_array_equal(g[f], o)
    assert not got[2][2].any()


def test_nms_rejects_bad_input():
    b = torch.zeros((3, 4))
    with pytest.raises(TypeError):
        PC.nms(b.double(), torch.zeros(3, dtype=torch.float64), 0.5, 3)
    with pytest.raises(ValueError):
        PC.nms(b, torch.zeros(4), 0.5, 3)
    with pytest.raises(ValueError):
        PC.nms(torch.zeros((4, 3)).t(), torch.zeros(3), 0.5, 3)
    with pytest.raises(ValueError):
        PC.nms(b, torch.zeros(3), 0.5, 3, mode="max")


# ------------------------------------------------------------------ crops


def _jax_crop(img, boxes, out_hw):
    fn = jax.jit(lambda im, b: JC.crop_and_resize(im, b, out_hw))
    return np.asarray(fn(jnp.asarray(img), jnp.asarray(boxes)))


CROP_BOXES = np.array([
    [5, 8, 25, 32],          # downsampled to 16, upsampled to 48
    [20, 10, 25, 16],        # a small interior box: upsampled
    [-3, -2, 60, 45],        # past every edge of the frame
    [0, 0, 50, 40],          # the whole frame
    [44, 30, 50, 40],        # on the bottom-right edge
    [30.5, 3.2, 49.9, 39.7],  # fractional corners
    [10, 10, 10, 20],        # degenerate: x2 == x1
    [12, 10, 5, 5],          # degenerate: x2 < x1, y2 < y1
], np.float32)


@pytest.mark.parametrize("out_hw", [(16, 16), (24, 24), (48, 48), (7, 9)])
def test_crop_and_resize_matches_jax(out_hw):
    img = np.random.default_rng(0).uniform(0, 255, (40, 50, 3)).astype(
        np.float32)
    got = PC.crop_and_resize(_t(img), _t(CROP_BOXES), out_hw).numpy()
    want = _jax_crop(img, CROP_BOXES, out_hw)
    assert got.shape == want.shape == (len(CROP_BOXES), *out_hw, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=CROP_ATOL)
    if out_hw == (16, 16):  # exact division: bit-equal
        np.testing.assert_array_equal(got, want)


def test_crop_and_resize_matches_cv2():
    """tests/test_models.py: a downsampled crop near cv2's, and an
    upsampled one whose taps stay inside the crop window."""
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (40, 50, 3)).astype(np.float32)
    got = PC.crop_and_resize(_t(img), _t(np.array([[5, 8, 25, 32]],
                                                  np.float32)),
                             (16, 16)).numpy()[0]
    want = cv2.resize(img[8:32, 5:25], (16, 16),
                      interpolation=cv2.INTER_LINEAR)
    assert np.abs(got - want).mean() < 3.0
    x1, y1, x2, y2 = 20, 10, 25, 16
    got = PC.crop_and_resize(_t(img), _t(np.array([[x1, y1, x2, y2]],
                                                  np.float32)),
                             (16, 16)).numpy()[0]
    want = cv2.resize(img[y1:y2, x1:x2], (16, 16),
                      interpolation=cv2.INTER_LINEAR)
    assert np.abs(got - want).max() < 1.5


def test_crop_and_resize_frame_index():
    """Boxes of several frames in one call equal the JAX package's
    per-frame crops."""
    rng = np.random.default_rng(4)
    frames = rng.uniform(-1, 1, (3, 30, 41, 3)).astype(np.float32)
    fi = np.array([2, 0, 0, 1, 2, 1, 0], np.int64)
    boxes = _cloud(rng, len(fi), span=40.0, lo=2.0, hi=30.0)
    got = PC.crop_and_resize(_t(frames), _t(boxes), (24, 24),
                             _t(fi)).numpy()
    for j, f in enumerate(fi):
        want = _jax_crop(frames[f], boxes[j:j + 1], (24, 24))[0]
        np.testing.assert_allclose(got[j], want, rtol=0, atol=CROP_ATOL)
        one = PC.crop_and_resize(_t(frames[f]), _t(boxes[j:j + 1]),
                                 (24, 24)).numpy()[0]
        np.testing.assert_array_equal(got[j], one)


def test_crop_and_resize_rejects_bad_input():
    img = torch.zeros((2, 8, 8, 3))
    boxes = torch.zeros((3, 4))
    with pytest.raises(ValueError):
        PC.crop_and_resize(img, boxes, (4, 4))  # frames need frame_idx
    with pytest.raises(TypeError):
        PC.crop_and_resize(img, boxes, (4, 4),
                           torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        PC.crop_and_resize(img, torch.zeros((4, 3)).t(), (4, 4),
                           torch.zeros(3, dtype=torch.int64))


def test_topk_boxes_matches_jax():
    """Ties keep the index order (lax.top_k); fewer boxes than k pad with
    zeros and -inf."""
    rng = np.random.default_rng(5)
    boxes = _cloud(rng, 12)
    scores = rng.uniform(0, 1, 12).astype(np.float32)
    scores[[2, 5, 7, 9]] = 0.5
    for k in (6, 12, 20):
        gb, gs = PC.topk_boxes(_t(boxes), _t(scores), k)
        wb, ws = jax.jit(lambda b, s: JC.topk_boxes(b, s, k))(boxes, scores)
        np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


# ------------------------------------------------------ weights and nets


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    """The JAX package's deterministic weights of each model, written by its
    save_params (FaceNet's init takes about 15 s: once per module)."""
    d = tmp_path_factory.mktemp("weights")
    key = jax.random.PRNGKey(0)
    trees = {"mtcnn": JM.init_params(key), "facenet": JF.init_params(key),
             "gender": JG.init_params(key)}
    paths = {}
    for name, tree in trees.items():
        paths[name] = str(d / f"{name}.npz")
        JW.save_params(paths[name], tree)
    return trees, paths


MODELS = {"mtcnn": PM, "facenet": PF, "gender": PG}


@pytest.mark.parametrize("model", ["mtcnn", "facenet", "gender"])
def test_npz_loads_strict_and_round_trips(npz, model):
    trees, paths = npz
    state = MODELS[model].from_flax(PW.load_params(paths[model]))
    if model == "mtcnn":
        for net, cls in PM.NETS.items():
            cls().load_state_dict(state[net], strict=True)
    else:
        cls = PF.InceptionResnetV1 if model == "facenet" else PG.LeviHassner
        cls().load_state_dict(state, strict=True)
    back = JW._flatten(MODELS[model].to_flax(state))
    want = JW._flatten(trees[model])
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], np.asarray(want[k]), k)
    # and a file the port writes loads in the JAX package unchanged
    path = paths[model] + ".port.npz"
    PW.save_params(path, MODELS[model].to_flax(state))
    again = JW._flatten(JW.load_params(path))
    assert all(np.array_equal(again[k], np.asarray(want[k])) for k in want)


def test_dense_after_conv_flatten_order():
    """flax flattens NHWC before a dense layer, torch NCHW: the converter
    permutes the kernel (kind linear_conv), so the products agree."""
    rng = np.random.default_rng(6)
    c, h, w, o = 5, 3, 4, 7
    act = rng.standard_normal((2, h, w, c)).astype(np.float32)  # NHWC
    kernel = rng.standard_normal((h * w * c, o)).astype(np.float32)
    want = act.reshape(2, -1) @ kernel
    tw = PW.flax_to_torch({"fc": {"kernel": kernel}},
                          {"fc/kernel": ("w", f"linear_conv:{c},{h},{w}")})
    got = _t(act).permute(0, 3, 1, 2).reshape(2, -1) @ tw["w"].t()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    back = PW.torch_to_flax(tw, {"fc/kernel": ("w",
                                               f"linear_conv:{c},{h},{w}")})
    np.testing.assert_array_equal(back["fc"]["kernel"], kernel)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("net,shape", [("pnet", (3, 31, 42)),
                                       ("pnet", (1, 12, 12)),
                                       ("rnet", (5, 24, 24)),
                                       ("onet", (4, 48, 48))])
def test_mtcnn_nets_match_flax(npz, net, shape):
    """Odd sizes take the asymmetric SAME pooling of flax."""
    trees, paths = npz
    state = PM.from_flax(PW.load_params(paths["mtcnn"]))[net]
    x = np.random.default_rng(7).uniform(-1, 1, (*shape, 3)).astype(
        np.float32)
    cls = {"pnet": JM.PNet, "rnet": JM.RNet, "onet": JM.ONet}[net]
    want = jax.jit(lambda p, x: cls().apply({"params": p}, x))(
        trees["mtcnn"][net], x)
    got = PC.apply_net(PM.NETS[net], state, _t(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) < 1e-5


def test_gender_net_matches_flax(npz):
    trees, paths = npz
    state = PG.from_flax(PW.load_params(paths["gender"]))
    x = np.random.default_rng(8).uniform(0, 255, (2, 227, 227, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda v, x: JG.LeviHassner().apply(v, x))(
        trees["gender"], x))
    got = PG.logits(state, _t(x)).numpy()
    assert _rel(got, want) < 1e-5
    np.testing.assert_array_equal(PG.classify(state, _t(x)).numpy(),
                                  np.argmax(want, axis=-1))


def test_facenet_matches_flax(npz):
    trees, paths = npz
    state = PF.from_flax(PW.load_params(paths["facenet"]))
    x = np.random.default_rng(9).uniform(0, 255, (2, 160, 160, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(JF.embed)(trees["facenet"], x))
    got = PF.embed(state, _t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(
        PF.prewhiten(_t(x)).numpy(), np.asarray(jax.jit(JF.prewhiten)(x)),
        rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def spread_facenet():
    """The port's seeded FaceNet with every BatchNorm's statistics, scale
    and shift drawn, each with one channel of variance 1e-8 (where
    rsqrt(var + eps) is largest), and the residual blocks' biases drawn."""
    state = PF.init_params(0)
    g = torch.Generator().manual_seed(3)
    for k, v in state.items():
        if k.endswith("running_var"):
            state[k] = torch.rand(v.shape, generator=g) * 2 + 1e-3
            state[k][0] = 1e-8
        elif k.endswith("running_mean") or k.endswith("conv2d.bias"):
            state[k] = torch.randn(v.shape, generator=g) * 0.3
        elif k.endswith("bn.weight"):
            state[k] = torch.rand(v.shape, generator=g) + 0.5
        elif k.endswith("bn.bias"):
            state[k] = torch.randn(v.shape, generator=g) * 0.1
    return state


def _sub(state, prefix):
    return {k[len(prefix) + 1:]: v for k, v in state.items()
            if k.startswith(prefix + ".")}


def _bn(state, prefix):
    """The BatchNorm at ``prefix`` as ``common.batch_norm`` reads it."""
    return types.SimpleNamespace(eps=PF.BN_EPS, **{
        k: v for k, v in _sub(state, prefix).items()
        if k != "num_batches_tracked"})


@pytest.mark.parametrize("unit,hw", [
    ("conv2d_3b", 9),                   # 1x1, 64 -> 80
    ("conv2d_1a", 15),                  # 3x3 stride 2, 3 -> 32
    ("mixed_6a.branch0", 9),            # 3x3 stride 2, 256 -> 384
    ("repeat_2.0.branch1.1", 7),        # 1x7, padding (0, 3)
    ("repeat_2.0.branch1.2", 7)])       # 7x1, padding (3, 0)
def test_facenet_folded_unit_matches_flax_order(spread_facenet, unit, hw):
    """A folded conv unit (one convolution with a bias, ReLU in place)
    against conv -> ``batch_norm`` -> ReLU on the raw weights."""
    raw = _sub(spread_facenet, unit)
    conv = PC._skeleton(PF.InceptionResnetV1).get_submodule(unit).conv
    x = torch.from_numpy(np.random.default_rng(10).uniform(
        -1, 1, (2, conv.in_channels, hw, hw)).astype(np.float32))
    want = torch.relu(PC.batch_norm(_bn(raw, "bn"), F.conv2d(
        x, raw["conv.weight"], None, conv.stride, conv.padding)))
    folded = _sub(PF.fold(spread_facenet), unit)
    assert set(folded) == {"conv.weight", "conv.bias"}
    got = torch.func.functional_call(PF.BasicConv2d(
        conv.in_channels, conv.out_channels, conv.kernel_size, conv.stride,
        conv.padding, folded=True), folded, (x,))
    assert _rel(got, want) < FOLD_REL
    assert bool((want > 0).any()) and bool((want == 0).any())


@pytest.mark.parametrize("block,cls,init,c,hw", [
    ("repeat_1.0", PF.Block35, {}, 256, 7),
    ("repeat_2.0", PF.Block17, {}, 896, 5),
    ("repeat_3.0", PF.Block8, {}, 1792, 3),
    ("block8", PF.Block8, {"activate": False}, 1792, 3)])
def test_facenet_folded_block_matches_flax_order(spread_facenet, block, cls,
                                                 init, c, hw):
    """A folded residual block (the scale in ``conv2d``, the sum and the
    ReLU in place) against ``relu(x + scale * conv2d(branches))`` on the
    raw weights (the final Block8 without the ReLU)."""
    x = torch.from_numpy(np.random.default_rng(11).uniform(
        0, 1, (2, c, hw, hw)).astype(np.float32))
    want = torch.func.functional_call(
        cls(**init).eval(), _sub(spread_facenet, block), (x,))
    got = torch.func.functional_call(
        cls(**init, folded=True), _sub(PF.fold(spread_facenet), block),
        (x,))
    assert _rel(got, want) < FOLD_REL
    assert bool((want < 0).any()) != init.get("activate", True)


def test_facenet_folded_tail_matches_flax_order(spread_facenet):
    """``last_linear`` with a bias against ``last_linear`` -> ``last_bn``."""
    x = torch.from_numpy(np.random.default_rng(12).uniform(
        0, 1, (4, 1792)).astype(np.float32))
    want = PC.batch_norm(_bn(spread_facenet, "last_bn"), F.linear(
        x, spread_facenet["last_linear.weight"]))
    folded = PF.fold(spread_facenet)
    got = F.linear(x, folded["last_linear.weight"],
                   folded["last_linear.bias"])
    assert _rel(got, want) < FOLD_REL


def test_facenet_folded_net_matches_flax_order(spread_facenet):
    """``embed`` (the folded net) against the raw net, in flax's order, on
    the same crops; both module trees load their weights strictly."""
    x = torch.from_numpy(np.random.default_rng(13).uniform(
        0, 255, (2, 160, 160, 3)).astype(np.float32))
    want = PC.apply_net(PF.InceptionResnetV1, spread_facenet,
                        PF.prewhiten(x))
    got = PF.embed(spread_facenet, x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    PF.InceptionResnetV1().load_state_dict(spread_facenet, strict=True)
    PF.InceptionResnetV1(folded=True).load_state_dict(
        PF.fold(spread_facenet), strict=True)


def test_facenet_fold_is_built_once_per_weight_set():
    """``folded`` builds a state's fold once (``fold.builds``), hands a
    folded state back as it is, and builds again when a tensor of the
    state is replaced or changed in place."""
    state = PF.init_params(1)
    builds = PF.fold.builds
    first = PF.folded(state)
    assert PF.folded(state) is first
    assert PF.folded(dict(state)) is first  # the same tensors
    assert PF.folded(first) is first
    assert PF.fold.builds == builds + 1
    state["last_bn.running_var"] = state["last_bn.running_var"] * 2
    second = PF.folded(state)
    assert second is not first and PF.fold.builds == builds + 2
    state["conv2d_1a.bn.running_mean"].add_(0.5)
    third = PF.folded(state)
    assert PF.fold.builds == builds + 3
    assert not torch.equal(third["conv2d_1a.conv.bias"],
                           second["conv2d_1a.conv.bias"])
    assert PF.folded(state) is third


@pytest.mark.parametrize("model", ["mtcnn", "facenet", "gender"])
def test_port_init_is_seeded(model):
    """The port's own weights come from a torch.Generator seeded with 0:
    the same every time, with the module's keys and shapes."""
    lib = MODELS[model]
    a, b = lib.init_params(0), lib.init_params(0)
    if model == "mtcnn":
        a, b = a["onet"], b["onet"]
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
