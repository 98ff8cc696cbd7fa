"""The port's object detection (SSD-MobileNetV1, Faster R-CNN, the decode
ops) held to the JAX package.

Both packages run on the same weights: the JAX package's deterministic
initialisation (jitted, once per module), carried to the port by its
``from_flax``: for SSD through an npz the JAX package's ``save_params``
wrote (the ``weights_path`` route), for Faster R-CNN as numpy arrays, with
no npz (fc6 alone is 411 MB). The same inputs, made from a seed with numpy
(or the conftest video), go through the jitted JAX function and the port.
On the CPU ``nms`` and ``crop_and_resize`` are their plain versions (their
kernels are held to those on the card by test_torch_kernels_cuda.py).

Tolerances, and why. Keep sets (which rows survive, their order, labels,
the kept indices) are compared exactly: top-k and NMS turn a one-ulp
difference into another set, and none of these seeded cases lands on a
near-tie. SSD: boxes within 1e-6 and scores within 1e-6 (normalized
coordinates and probabilities near 0.5; ``exp`` and ``sigmoid`` may round
differently from XLA's; measured 1.5e-8 and 0), the net's outputs within
1e-5 of their largest value (convolutions add in other orders, and the
seeded weights shrink the activations layer by layer, so the heads' values
are about 3e-4 and cancel; measured 3e-6). Faster R-CNN: ``cls_prob``
within 1e-5 (measured 8e-7), ``fc7`` within 1e-3 of values up to about 3
(measured 1.1e-4), rois within 5e-3 px (measured 1.8e-3: the RPN deltas,
about 1e-6 relative apart, are multiplied by anchor sides up to 700 px).
``NNInput`` within 2e-5, one float32 ulp of values up to 255 (XLA adds
the resize's taps in another order: 30 of 13,440 values differ, by one
ulp). The decode ops are numpy in both packages: their outputs are
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scannertools_tpu as jst
import scannertools_tpu_torch as st
from scannertools_tpu import protobufs as jprotobufs
from scannertools_tpu.models import faster_rcnn as JR
from scannertools_tpu.models import ssd as JS
from scannertools_tpu.models import weights as JW
from scannertools_tpu.ops import detection_decode as JD
from scannertools_tpu.ops import faces as JFO
from scannertools_tpu.ops import nn_generic as JN
from scannertools_tpu_torch import protobufs
from scannertools_tpu_torch.models import common as MC
from scannertools_tpu_torch.models import faster_rcnn as PR
from scannertools_tpu_torch.models import ssd as PS
from scannertools_tpu_torch.models import weights as PW
from scannertools_tpu_torch.models.common import apply_net
from scannertools_tpu_torch.ops import detection_decode as PD
from scannertools_tpu_torch.ops import faces as PFO
from scannertools_tpu_torch.ops import nn_generic as PN

SSD_ATOL = 1e-6
CLS_ATOL = 1e-5
FC7_ATOL = 1e-3
ROI_PX_ATOL = 5e-3
ROWS = [0, 1, 70, 130]  # two shots' first frames, the bar in other places
MEAN = (102.9801, 115.9465, 122.7717)
# the weights_path under which both packages' model caches hold the seeded
# Faster R-CNN weights (no npz is written)
FRCNN_KEY = "seeded-faster-rcnn"


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


@pytest.fixture(scope="module")
def ssd_weights(tmp_path_factory):
    """(JAX variables, npz path, port state) of the JAX package's
    init_params(PRNGKey(0))."""
    v = jax.jit(JS.init_params)(jax.random.PRNGKey(0))
    path = str(tmp_path_factory.mktemp("weights") / "ssd.npz")
    JW.save_params(path, v)
    return v, path, PS.from_flax(PW.load_params(path))


@pytest.fixture(scope="module")
def frcnn_weights():
    """(JAX variables, port state) of tests/test_faster_rcnn.py's small
    model's init (full widths; num_rois and pre_nms hold no weights)."""
    m = JR.FasterRCNN(num_rois=8, pre_nms=64)
    v = jax.jit(m.init)(jax.random.PRNGKey(1),
                        jnp.zeros((1, 96, 96, 3), jnp.float32))
    return v, PR.from_flax(_numpy_tree(v))


# ------------------------------------------------------------ nms index


def _ssd_rows(rng, t, k):
    """Seeded prefiltered rows: unique normalized boxes in a few classes
    (so that same-class boxes overlap), scores with ties, the last frame
    all invalid."""
    c = rng.uniform(0.1, 0.9, (t, k, 2))
    wh = rng.uniform(0.05, 0.3, (t, k, 2))
    b = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    s = rng.uniform(0.0, 1.0, (t, k)).astype(np.float32)
    s[:, ::7] = 0.5          # ties
    s[:, 3::11] = 0.0        # invalid rows
    s[-1] = 0.0              # an all-invalid frame
    lab = rng.integers(1, 4, (t, k)).astype(np.int32)
    return b, s, lab


@pytest.mark.parametrize("k", [512, 1000])
def test_nms_index_matches_ssd_scan(monkeypatch, k):
    """The kept source rows of ``nms(..., index=True)`` on class-shifted
    boxes are the kept set and order of SSD's own lax.scan NMS (run jitted,
    every kept row out: NUM_OUT set to K), in both nms versions; the
    boxes, scores and valid flags equal the call without the index."""
    rng = np.random.default_rng(k)
    b, s, lab = _ssd_rows(rng, 3, k)
    monkeypatch.setattr(JS, "NUM_OUT", k)
    jb, js_, jl = (np.asarray(a) for a in jax.jit(jax.vmap(
        lambda b, s, l: JS._postprocess_explicit(b, s, l, 0.6)))(b, s, lab))
    want = np.full((3, k), -1, np.int64)
    for f in range(3):
        where = {row.tobytes(): i for i, row in enumerate(b[f])}
        kept = js_[f] > 0
        want[f, :kept.sum()] = [where[row.tobytes()] for row in jb[f][kept]]
        assert not kept[kept.sum():].any()
    assert (want[:2] >= 0).sum(axis=1).min() > 100  # many kept, some not
    assert (want[:2] < 0).any() and (want[2] < 0).all()
    shifted = _t(b + lab[..., None].astype(np.float32) * 4.0)
    for fn in (MC.nms, MC.nms_plain):
        got = fn(shifted, _t(s), 0.6, k, score_thresh=0.0, index=True)
        np.testing.assert_array_equal(got[3].numpy(), want)
        plain = fn(shifted, _t(s), 0.6, k, score_thresh=0.0)
        for g, p in zip(got[:3], plain):
            assert torch.equal(g, p)
        kept = want >= 0
        np.testing.assert_array_equal(
            np.where(kept, np.take_along_axis(lab, np.maximum(want, 0), 1),
                     0), jl)


def test_nms_index_one_frame_and_max_out():
    """The JAX signature (one frame) and max_out below and above the kept
    count: the index rows follow the kept rows."""
    rng = np.random.default_rng(9)
    b, s, lab = _ssd_rows(rng, 2, 64)
    full = MC.nms(_t(b), _t(s), 0.3, 64, index=True)[3]
    for max_out in (5, 64, 80):
        one = MC.nms(_t(b[0]), _t(s[0]), 0.3, max_out, index=True)
        assert one[3].shape == (max_out,)
        n = min(max_out, 64)
        np.testing.assert_array_equal(one[3][:n].numpy(), full[0, :n])
        assert (one[3][n:] == -1).all()
        np.testing.assert_array_equal(one[3].numpy() >= 0, one[2].numpy())


# ------------------------------------------------------------ SSD


def test_ssd_anchors_and_mapping():
    np.testing.assert_array_equal(PS.anchor_boxes(), JS.anchor_boxes())
    assert PS.anchor_boxes().shape == (1917, 4)
    skeleton = MC._skeleton(PS.SSDMobileNetV1).state_dict()
    mapped = {key for key, _ in PS.torch_mapping().values()}
    assert mapped == {k for k in skeleton
                      if not k.endswith("num_batches_tracked")}


def test_ssd_postprocess_matches_jax():
    """The same loc and logits through _prefilter + _postprocess_explicit:
    keep sets, order and labels equal; boxes and scores within SSD_ATOL."""
    rng = np.random.default_rng(4)
    loc = rng.normal(0, 1, (2, 1917, 4)).astype(np.float32)
    logits = rng.normal(-2, 3, (2, 1917, 91)).astype(np.float32)
    want = [np.asarray(a) for a in jax.jit(jax.vmap(
        lambda lo, cl: JS._postprocess_explicit(*JS._prefilter(lo, cl))))(
            loc, logits)]
    got = [a.numpy() for a in PS._postprocess_explicit(
        *PS._prefilter(_t(loc), _t(logits)))]
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[1] > 0, want[1] > 0)
    assert (want[1] > 0).all(axis=1).all()  # 100 kept in each frame
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=SSD_ATOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=SSD_ATOL)


def test_ssd_net_matches_flax(ssd_weights):
    v, _, state = ssd_weights
    x = np.random.default_rng(2).uniform(-1, 1, (2, 300, 300, 3)).astype(
        np.float32)
    want = [np.asarray(a) for a in jax.jit(JS.SSDMobileNetV1().apply)(v, x)]
    got = [a.numpy() for a in apply_net(PS.SSDMobileNetV1, state, _t(x))]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def test_ssd_detect_matches_jax(ssd_weights):
    v, _, state = ssd_weights
    frames = np.random.default_rng(1).integers(0, 256, (2, 64, 96, 3)) \
        .astype(np.float32)
    want = [np.asarray(a) for a in jax.jit(JS.detect)(v, frames)]
    got = [a.numpy() for a in PS.detect(state, _t(frames))]
    assert got[2].dtype == np.int32 and got[0].shape == (2, 100, 4)
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[1] > 0, want[1] > 0)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=SSD_ATOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=SSD_ATOL)


def test_ssd_weights_round_trip(ssd_weights):
    v, _, state = ssd_weights
    back = PS.to_flax(state)
    flat_back, flat_v = PW._flatten(back), PW._flatten(_numpy_tree(v))
    assert set(flat_back) == set(flat_v)
    for key, a in flat_v.items():
        np.testing.assert_array_equal(flat_back[key], a)


# ------------------------------------------------------------ Faster R-CNN


def test_faster_rcnn_anchors_and_mapping():
    for h, w in ((2, 2), (4, 6), (37, 50)):
        np.testing.assert_array_equal(PR.anchors_for(h, w),
                                      JR.anchors_for(h, w))
    skeleton = MC._skeleton(PR.FasterRCNN).state_dict()
    assert {key for key, _ in PR.torch_mapping().values()} == set(skeleton)


def test_propose_boxes_matches_jax():
    """The proposal layer alone on seeded scores and deltas over a 6x6
    map's anchors: the valid rows equal, boxes within ROI_PX_ATOL."""
    rng = np.random.default_rng(5)
    anchors = JR.anchors_for(6, 6).astype(np.float32)
    fg = rng.uniform(0, 1, (2, len(anchors))).astype(np.float32)
    deltas = rng.normal(0, 0.3, (2, len(anchors), 4)).astype(np.float32)
    want = [np.asarray(a) for a in jax.jit(jax.vmap(
        lambda f, d: JR.propose_boxes(jnp.asarray(anchors), f, d, 96, 96,
                                      64, 32)))(fg, deltas)]
    got = [a.numpy() for a in PR.propose_boxes(_t(anchors), _t(fg),
                                               _t(deltas), 96, 96, 64, 32)]
    np.testing.assert_array_equal(got[1], want[1])
    assert want[1].sum(axis=1).min() > 5
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ROI_PX_ATOL)


def _assert_frcnn_close(got, want):
    cls, rois, fc7 = got
    np.testing.assert_array_equal(rois[..., 3] > rois[..., 1],
                                  want[1][..., 3] > want[1][..., 1])
    np.testing.assert_allclose(cls, want[0], rtol=0, atol=CLS_ATOL)
    np.testing.assert_allclose(rois, want[1], rtol=0, atol=ROI_PX_ATOL)
    np.testing.assert_allclose(fc7, want[2], rtol=0, atol=FC7_ATOL)


def test_faster_rcnn_matches_jax(frcnn_weights):
    """tests/test_faster_rcnn.py's small model (num_rois=8, pre_nms=64,
    96x96) on two frames."""
    v, state = frcnn_weights
    x = (np.random.RandomState(2).randn(2, 96, 96, 3) * 40).astype(
        np.float32)
    want = [np.asarray(a) for a in jax.jit(
        JR.FasterRCNN(num_rois=8, pre_nms=64).apply)(v, x)]
    got = [a.numpy() for a in PR.apply(state, _t(x), 8, 64)]
    assert [g.shape for g in got] == [(2, 8, 81), (2, 8, 5), (2, 8, 4096)]
    assert (got[1][..., 3] > got[1][..., 1]).sum() >= 8
    _assert_frcnn_close(got, want)


def _boxes(rows):
    return [[(b.x1, b.y1, b.x2, b.y2, b.score, b.label, b.track_id)
             for b in frame] for frame in rows]


def test_faster_rcnn_fewer_anchors_than_rois(frcnn_weights):
    """A 64x96 input at the production num_rois = 300: 4x6x9 = 216 anchors.
    The JAX package emits 301 rows (its nms's discard slot), the port 300:
    the port's rows are JAX's first 300, JAX's row 300 is one-hot
    background with zero rois and fc7, and FasterRCNNOutput gives equal
    lists on JAX's 301 rows and on its first 300."""
    v, state = frcnn_weights
    x = (np.random.RandomState(3).randn(1, 64, 96, 3) * 40).astype(
        np.float32)
    want = [np.asarray(a) for a in jax.jit(JR.FasterRCNN().apply)(v, x)]
    got = [a.numpy() for a in PR.apply(state, _t(x))]
    assert [w.shape[1] for w in want] == [301] * 3
    assert [g.shape[1] for g in got] == [300] * 3
    _assert_frcnn_close(got, [w[:, :300] for w in want])
    np.testing.assert_array_equal(want[0][0, 300], np.eye(81)[0])
    assert not want[1][0, 300].any() and not want[2][0, 300].any()
    kw = dict(score_threshold=0.015)
    whole = PD.faster_rcnn_output(None, *want, **kw)
    cut = PD.faster_rcnn_output(None, *(w[:, :300] for w in want), **kw)
    assert _boxes(whole[0]) == _boxes(cut[0]) and len(whole[0][0]) > 0
    for a, b in zip(whole[1], cut[1]):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ decode ops


def _jbox(b):
    return jprotobufs.BoundingBox(x1=b.x1, y1=b.y1, x2=b.x2, y2=b.y2,
                                  score=b.score, label=b.label,
                                  track_id=b.track_id)


def _random_protos(rng, n, cls=protobufs.BoundingBox):
    xy = rng.uniform(0, 80, (n, 2))
    wh = rng.uniform(4, 40, (n, 2))
    return [cls(x1=float(a), y1=float(b), x2=float(a + c), y2=float(b + d),
                score=float(s), label=int(l))
            for (a, b), (c, d), s, l in zip(xy, wh, rng.uniform(0, 1, n),
                                            rng.integers(0, 5, n))]


def _decode_case(name, rng):
    """-> (port output, JAX output) of one decode op on seeded inputs."""
    if name == "FasterRCNNOutput":
        probs = rng.dirichlet(np.full(81, 0.05), (3, 40)).astype(np.float32)
        rois = np.concatenate([np.zeros((3, 40, 1)), rng.uniform(
            0, 60, (3, 40, 2)), rng.uniform(60, 120, (3, 40, 2))],
            -1).astype(np.float32)
        fc7 = rng.normal(0, 1, (3, 40, 4096)).astype(np.float32)
        return (PD.faster_rcnn_output(None, probs, rois, fc7),
                JD.faster_rcnn_output(None, probs, rois, fc7))
    if name == "BboxNMS":
        lists = [_random_protos(rng, n) for n in (0, 5, 40)]
        return ([PD.bbox_nms(None, lists, 0.3, mode) for mode in
                 ("union", "min")],
                [JD.bbox_nms(None, [[_jbox(b) for b in bl] for bl in lists],
                             0.3, mode) for mode in ("union", "min")])
    if name == "YoloOutput":
        feats = rng.uniform(0, 1, (2, 7 * 7 * 30)).astype(np.float32)
        feats[1, :7 * 7 * 20] *= 0.3
        return (PD.yolo_output(None, feats, 0.2),
                JD.yolo_output(None, feats, 0.2))
    maps = rng.normal(-2, 2, (2, 6, 8, 125)).astype(np.float32)
    info = [protobufs.FrameInfo(height=48, width=64)] * 2
    jinfo = [jprotobufs.FrameInfo(height=48, width=64)] * 2
    return (PD.facenet_output(None, maps, info, score_threshold=0.7),
            JD.facenet_output(None, maps, jinfo, score_threshold=0.7))


def _flat(x):
    """Proto lists and arrays -> comparable python values."""
    if isinstance(x, (list, tuple)):
        return [_flat(y) for y in x]
    if isinstance(x, np.ndarray):
        return ("array", x.dtype.str, x.shape, x.tobytes())
    return (type(x).__name__, x.x1, x.y1, x.x2, x.y2, x.score, x.label,
            x.track_id)


@pytest.mark.parametrize("name", ["FasterRCNNOutput", "BboxNMS",
                                  "YoloOutput", "FacenetOutput"])
def test_decode_ops_equal_jax(name):
    got, want = _decode_case(name, np.random.default_rng(7))
    assert _flat(got) == _flat(want)
    frames = got[0] if name in ("FasterRCNNOutput", "BboxNMS") else got
    assert any(len(frame) for frame in frames)


def test_face_templates_equal_jax(tmp_path):
    np.testing.assert_array_equal(PD.default_face_templates(),
                                  JD.default_face_templates())
    path = str(tmp_path / "templates.bin")
    np.random.default_rng(8).normal(0, 9, (25, 4)).astype("<f4").tofile(path)
    np.testing.assert_array_equal(PD.load_face_templates(path),
                                  JD.load_face_templates(path))
    with open(path, "r+b") as f:
        f.truncate(40)
    with pytest.raises(ValueError, match="truncated"):
        PD.load_face_templates(path)


# ------------------------------------------------------------ NN ops


def test_nn_input_matches_jax():
    frames = np.random.default_rng(6).integers(0, 256, (2, 48, 64, 3)) \
        .astype(np.uint8)
    kw = dict(input_width=50, input_height=37, mean_colors=MEAN,
              normalize=True, transpose=True, pad_mod=8)
    want = np.asarray(jax.jit(lambda f: JN.nn_input(None, f, **kw))(frames))
    got = PN.nn_input(None, _t(frames), **kw).numpy()
    assert got.shape == want.shape == (2, 3, 40, 56)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_unported_nn_ops_refuse(tmp_path):
    """NNForward and MoEHead build over the eight registry names (the JAX
    registry's); a model the registry lacks is refused with KeyError
    (test_torch_nn_generic.py holds each forward to the JAX package)."""
    sc = st.Client(db_path=str(tmp_path / "db"), device="cpu")
    assert sorted(PN._NN_REGISTRY) == sorted(JN._NN_REGISTRY) == [
        "facenet_detector", "facenet_inception_resnet_v1", "faster_rcnn",
        "gender_levi_hassner", "openpose_body", "ssd_mobilenet_v1",
        "streetstyle_clothing", "streetstyle_hairstyle"]
    rows = sc.io.Input([st.PythonStream([np.zeros(4, np.float32)] * 2)])
    for name in PN._NN_REGISTRY:
        assert sc.ops.NNForward(input=rows, model=name) is not None
    moe = sc.ops.MoEHead(input=rows, n_experts=2, d_model=4, d_hidden=8)
    out = st.NamedStream(sc, "moe")
    sc.run(sc.io.Output(moe, [out]), st.PerfParams.manual(work_packet_size=2),
           cache_mode=st.CacheMode.Overwrite)
    assert [r.shape for r in out.load()] == [(4,), (4,)]
    with pytest.raises(KeyError, match="no registered model 'vgg_face'"):
        sc.run(sc.io.Output(sc.ops.NNForward(input=rows, model="vgg_face"),
                            [st.NamedStream(sc, "nn")]),
               st.PerfParams.manual(work_packet_size=2),
               cache_mode=st.CacheMode.Overwrite)


# ------------------------------------------------------------ pipelines


def _client(pkg, db):
    return pkg.Client(db_path=db, **(dict(device="cpu") if pkg is st
                                     else {}))


def _run(pkg, sc, cols, names):
    outs = [pkg.NamedStream(sc, n) for n in names]
    sc.run(sc.io.Output(cols, [tuple(outs)]),
           pkg.PerfParams.manual(work_packet_size=2, ingest="rgb"),
           cache_mode=pkg.CacheMode.Overwrite)
    return outs


def _assert_boxes_close(got, want, atol):
    assert [len(f) for f in got] == [len(f) for f in want]
    for fg, fw in zip(got, want):
        assert [(b.label, b.track_id) for b in fg] == \
            [(b.label, b.track_id) for b in fw]
        for a, b in zip(fg, fw):
            np.testing.assert_allclose([a.x1, a.y1, a.x2, a.y2, a.score],
                                       [b.x1, b.y1, b.x2, b.y2, b.score],
                                       rtol=0, atol=atol)


def test_detect_objects_pipeline_matches_jax(tmp_path, test_video,
                                             ssd_weights):
    """Client.run of DetectObjects over ROWS in both packages on the same
    npz: 100 rows a frame, labels equal, values within SSD_ATOL; each
    package loads the other's stream."""
    _, path, _ = ssd_weights
    streams = {}
    for pkg, tag in ((st, "t"), (jst, "j")):
        sc = _client(pkg, str(tmp_path / tag))
        frame = sc.io.Input([pkg.NamedVideoStream(sc, "v",
                                                  path=test_video["path"])])
        g = sc.streams.Gather(frame, [ROWS])
        objs = sc.ops.DetectObjects(frame=g, weights_path=path)
        streams[tag] = _run(pkg, sc, [objs], ["objects"])[0]
    got, want = (list(streams[k].load()) for k in ("t", "j"))
    assert len(got) == len(ROWS)
    assert all(len(f) == 100 and all(1 <= b.label <= 90 for b in f)
               for f in got)
    _assert_boxes_close(got, want, SSD_ATOL)
    cross_t = list(st.NamedStream(str(tmp_path / "j"), "objects").load())
    cross_j = list(jst.NamedStream(str(tmp_path / "t"), "objects").load())
    _assert_boxes_close(cross_t, want, 0)
    _assert_boxes_close(cross_j, got, 0)


def test_faster_rcnn_pipeline_matches_jax(tmp_path, test_video,
                                          frcnn_weights, monkeypatch):
    """NNInput -> FasterRCNN -> FasterRCNNOutput through Client.run in both
    packages at the production num_rois on the 96x64 video: the anchors
    (216) are fewer than the RoIs (300), so the JAX package's arrays carry
    301 rows and the port's 300, and the stored boxes and features agree
    (labels and RoI numbers equal, values within the tolerances above)."""
    v, state = frcnn_weights
    monkeypatch.setitem(JFO._MODEL_CACHE, ("nn:faster_rcnn", FRCNN_KEY), v)
    monkeypatch.setitem(PFO._MODEL_CACHE, ("faster_rcnn", FRCNN_KEY), state)
    streams = {}
    for pkg, tag in ((st, "t"), (jst, "j")):
        sc = _client(pkg, str(tmp_path / tag))
        frame = sc.io.Input([pkg.NamedVideoStream(sc, "v",
                                                  path=test_video["path"])])
        g = sc.streams.Gather(frame, [[0, 70]])
        pre = sc.ops.NNInput(frame=g, mean_colors=MEAN)
        cls_prob, rois, fc7 = sc.ops.FasterRCNN(input=pre,
                                                weights_path=FRCNN_KEY)
        boxes, feats = sc.ops.FasterRCNNOutput(
            cls_prob=cls_prob, rois=rois, fc7=fc7, score_threshold=0.015)
        streams[tag] = [list(o.load()) for o in _run(
            pkg, sc, [boxes, feats], ["frcnn_boxes", "frcnn_feats"])]
    (tb, tf), (jb, jf) = streams["t"], streams["j"]
    assert len(tb) == 2 and all(len(f) > 0 for f in tb)
    _assert_boxes_close(tb, jb, ROI_PX_ATOL)
    for a, b in zip(tf, jf):
        a = np.asarray(a, np.float32).reshape(-1, 4096)
        assert a.shape == np.asarray(b).reshape(-1, 4096).shape
        np.testing.assert_allclose(a, np.asarray(b).reshape(-1, 4096),
                                   rtol=0, atol=FC7_ATOL)
