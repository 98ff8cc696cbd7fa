"""The port's face suite (MTCNN → FaceNet → gender) held to the JAX package.

Both packages run on the same weights: the JAX package's deterministic
initialisation, written once by its ``save_params`` and read by the port
through its converter (test_torch_models_common.py holds the converter and
each net). The same inputs, made from a seed with numpy (or the conftest
video), go through the jitted JAX function and the port. On the CPU
``nms`` and ``crop_and_resize`` are their plain versions (their kernels
are held to those on the card by test_torch_kernels_cuda.py).

Those weights keep no face at the default thresholds (0.45, 0.6, 0.7) on
these inputs; ``thresholds=(0, 0, 0)`` keeps rows at every stage (O-Net
scores near 0.6), so the cascade is compared there and at the defaults.

Tolerances, and why. Keep sets (which boxes survive, their order, and the
per-frame counts) are compared exactly: thresholds, NMS and top-k turn a
one-ulp difference into another box set, and none of these seeded cases
lands on a near-tie. Within them: boxes 2e-3 px at frames of at most 128
px (crops and convolutions add in other orders, about 1e-6 relative of the
conv outputs, and calibration multiplies the regression by the box side;
measured under 1e-3 px), scores and normalized boxes 1e-5, embeddings 1e-5
(measured about 3e-7), gender labels equal. I420 ingest is held only to
the port's own numpy conversion of the same I420 frames (the JAX package's
jitted conversion rounds differently, ROADMAP queue 3).
"""

import jax
import numpy as np
import pytest
import torch

import scannertools_tpu as jst
import scannertools_tpu_torch as st
from scannertools_tpu.models import facenet as JF
from scannertools_tpu.models import gender as JG
from scannertools_tpu.models import mtcnn as JM
from scannertools_tpu.models import weights as JW
from scannertools_tpu.ops import faces as JFO
from scannertools_tpu_torch import protobufs
from scannertools_tpu_torch.io import av
from scannertools_tpu_torch.io.video import VideoDecoder
from scannertools_tpu_torch.models import mtcnn as PM
from scannertools_tpu_torch.models import weights as PW
from scannertools_tpu_torch.models.common import apply_net
from scannertools_tpu_torch.ops import faces as PFO
from scannertools_tpu_torch.utils.framechunk import FrameChunk

ZERO = (0.0, 0.0, 0.0)
BOX_PX_ATOL = 2e-3
ATOL = 1e-5
ROWS = [0, 1, 70, 130]  # two shots' first frames, the bar in other places


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    """The JAX package's deterministic weights, written by its save_params
    (FaceNet's init takes about 15 s: once per module)."""
    d = tmp_path_factory.mktemp("weights")
    key = jax.random.PRNGKey(0)
    trees = {"mtcnn": JM.init_params(key), "facenet": JF.init_params(key),
             "gender": JG.init_params(key)}
    paths = {}
    for name, tree in trees.items():
        paths[name] = str(d / f"{name}.npz")
        JW.save_params(paths[name], tree)
    return trees, paths


def _frames(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.float32)


# ------------------------------------------------------------ cascade


@pytest.mark.parametrize("thresholds", [ZERO, JM.THRESHOLDS],
                         ids=["zero", "default"])
def test_detect_batch_matches_jax(npz, thresholds):
    trees, paths = npz
    state = PM.from_flax(PW.load_params(paths["mtcnn"]))
    frames = _frames((2, 96, 128, 3), 1)
    want = [np.asarray(a) for a in jax.jit(
        lambda p, f: JM.detect_batch(p, f, thresholds))(trees["mtcnn"],
                                                        frames)]
    got = [a.numpy() for a in PM.detect_batch(state, _t(frames), thresholds)]
    np.testing.assert_array_equal(got[2], want[2])  # the keep sets
    if thresholds == ZERO:
        assert (got[2].sum(axis=1) > 10).all()
    else:
        assert not got[2].any()
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=BOX_PX_ATOL)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=ATOL)
    one = [a.numpy() for a in PM.detect_single(state, _t(frames[1]),
                                               thresholds)]
    for g, o in zip(got, one):
        np.testing.assert_array_equal(g[1], o)


def test_fused_pyramid_pnet_matches_per_level():
    """tests/test_models.py's check on the port: the fused canvas gives
    each level's P-Net values."""
    from scannertools_tpu_torch.utils.numerics import resize_hw

    state = PM.init_params(0)["pnet"]
    x = PM._normalize(_t(_frames((1, 96, 128, 3), 2)))
    layout = PM.pyramid_layout(96, 128)
    hc = layout[-1][3] + layout[-1][1]
    canvas = x.new_zeros((1, hc, max(l[2] for l in layout), 3))
    levels = []
    for s, hs, ws, oy in layout:
        xi = resize_hw(x, 1, hs, ws, "linear")
        levels.append(xi)
        canvas[:, oy:oy + hs, :ws] = xi
    probc, regc = apply_net(PM.PNet, state, canvas)
    for (s, hs, ws, oy), xi in zip(layout, levels):
        prob, reg = apply_net(PM.PNet, state, xi)
        gh, gw = (hs - 12) // 2 + 1, (ws - 12) // 2 + 1
        torch.testing.assert_close(probc[0, oy // 2:oy // 2 + gh, :gw],
                                   prob[0, :gh, :gw], rtol=0, atol=1e-5)
        torch.testing.assert_close(regc[0, oy // 2:oy // 2 + gh, :gw],
                                   reg[0, :gh, :gw], rtol=0, atol=1e-5)


def test_margins_match_jax_and_host():
    rng = np.random.default_rng(3)
    h, w = 96, 128
    xy = rng.uniform(-10, 120, (2, 20, 2))
    wh = rng.uniform(1, 60, (2, 20, 2))
    boxes = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    scores = rng.uniform(0, 1, (2, 20)).astype(np.float32)
    valid = rng.uniform(0, 1, (2, 20)) > 0.3
    got = [a.numpy() for a in PM.margins_normalize_device(
        _t(boxes), _t(scores), _t(valid), h, w)]
    want = [np.asarray(a) for a in jax.jit(jax.vmap(
        lambda b, s, v: JM.margins_normalize_device(b, s, v, h, w)))(
            boxes, scores, valid)]
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(g, wv)
    assert PM.apply_margins_and_normalize(boxes[0], scores[0], valid[0], h,
                                          w) == \
        JM.apply_margins_and_normalize(boxes[0], scores[0], valid[0], h, w)


# ------------------------------------------------------------ crop nets


def _faces_input(t=1, h=48, w=64):
    x = np.random.default_rng(5).uniform(0, 255, (t, h, w, 3)).astype(
        np.float32)
    nb = np.zeros((t, PFO.MAX_FACES, 4), np.float32)
    valid = np.zeros((t, PFO.MAX_FACES), bool)
    boxes = [(0.0, 0.0, 0.5, 0.5), (0.5, 0.0, 1.0, 0.6),
             (0.1, 0.4, 0.8, 1.0), (0.2, 0.2, 0.9, 0.9),
             (0.3, 0.3, 0.305, 0.9)]  # the last: degenerate crop
    for f in range(t):
        for j, box in enumerate(boxes[f % 2:]):
            nb[f, j] = box
            valid[f, j] = True
    return x, nb, valid


def test_embed_budget_compaction(npz):
    """tests/test_nn_pipeline.py's budget check on the port:
    within-budget slots match the exhaustive run; over-budget slots fall
    back to the zero vector and are counted."""
    _, paths = npz
    aux = PFO._MODELS["facenet"].from_flax(PW.load_params(paths["facenet"]))
    x, nb, valid = _faces_input()
    full, _, over_full = PFO.face_embed_forward(
        None, aux, _t(x), _t(nb), _t(valid), faces_budget=PFO.MAX_FACES)
    lim, _, over_lim = PFO.face_embed_forward(
        None, aux, _t(x), _t(nb), _t(valid), faces_budget=2)
    full, lim = full.numpy(), lim.numpy()
    assert over_full.tolist() == [0]
    assert over_lim.tolist() == [2]  # 4 valid crops, 1 degenerate
    assert all(np.abs(full[0, j]).sum() > 0 for j in range(4))
    assert not full[0, 4].any()  # the degenerate crop's zero vector
    np.testing.assert_allclose(lim[0, :2], full[0, :2], rtol=0, atol=ATOL)
    assert not lim[0, 2:].any()
    assert not full[0, 5:].any()


@pytest.mark.parametrize("budget", [2, 32])
def test_face_embed_forward_matches_jax(npz, budget):
    """Two frames, crops compacted across them in one call."""
    trees, paths = npz
    aux = PFO._MODELS["facenet"].from_flax(PW.load_params(paths["facenet"]))
    x, nb, valid = _faces_input(t=2)
    got = [a.numpy() for a in PFO.face_embed_forward(
        None, aux, _t(x), _t(nb), _t(valid), faces_budget=budget)]
    want = [np.asarray(a) for a in jax.jit(
        lambda aux, x, nb, v: JFO.face_embed_forward(
            None, aux, x, nb, v, faces_budget=budget))(
                trees["facenet"], x, nb, valid)]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_gender_forward_matches_jax(npz):
    trees, paths = npz
    aux = PFO._MODELS["gender"].from_flax(PW.load_params(paths["gender"]))
    x, nb, valid = _faces_input(t=2)
    got = [a.numpy() for a in PFO.gender_forward(
        None, aux, _t(x), _t(nb), _t(valid), faces_budget=3)]
    want = [np.asarray(a) for a in jax.jit(
        lambda aux, x, nb, v: JFO.gender_forward(
            None, aux, x, nb, v, faces_budget=3))(
                trees["gender"], x, nb, valid)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_bboxes_to_padded_overflow_raises():
    boxes = [[protobufs.BoundingBox(x1=0, y1=0, x2=0.1, y2=0.1,
                                    score=1.0)] * 40]
    with pytest.raises(ValueError, match="max_boxes"):
        PFO.bboxes_to_padded(None, boxes, max_boxes=32)
    nb, v = PFO.bboxes_to_padded(None, boxes, max_boxes=64)
    assert nb.shape == (1, 64, 4) and v[0, :40].all() and not v[0, 40:].any()


# ------------------------------------------------------------ pipelines


def _face_graphs(pkg, db, path, paths, ingest="rgb"):
    """faces, embeddings and genders of ROWS in one run (one shared MTCNN
    forward), chunks of 2 -> (client, [faces, embs, genders] streams)."""
    kw = dict(device="cpu") if pkg is st else {}
    sc = pkg.Client(db_path=db, **kw)
    frame = sc.io.Input([pkg.NamedVideoStream(sc, "v", path=path)])
    g = sc.streams.Gather(frame, [ROWS])
    faces = sc.ops.MTCNNDetectFaces(frame=g, weights_path=paths["mtcnn"],
                                    thresholds=ZERO)
    embs = sc.ops.EmbedFaces(frame=g, bboxes=faces,
                             weights_path=paths["facenet"],
                             faces_budget=PFO.MAX_FACES)
    genders = sc.ops.DetectGender(frame=g, bboxes=faces,
                                  weights_path=paths["gender"],
                                  faces_budget=PFO.MAX_FACES)
    outs = [pkg.NamedStream(sc, n) for n in ("faces", "embs", "genders")]
    sc.run(sc.io.Output([faces, embs, genders], [tuple(outs)]),
           pkg.PerfParams.manual(work_packet_size=2, ingest=ingest),
           cache_mode=pkg.CacheMode.Overwrite)
    return sc, outs


def _assert_faces_close(got, want, atol=ATOL):
    assert [len(f) for f in got] == [len(f) for f in want]
    for fg, fw in zip(got, want):
        for a, b in zip(fg, fw):
            np.testing.assert_allclose([a.x1, a.y1, a.x2, a.y2, a.score],
                                       [b.x1, b.y1, b.x2, b.y2, b.score],
                                       rtol=0, atol=atol)


def test_face_pipelines_match_jax(tmp_path, test_video, npz):
    """Client.run of MTCNNDetectFaces -> EmbedFaces / DetectGender (the
    composites rewire the device boxes) in both packages; then EmbedFaces
    in the port over boxes read back from the faces stream
    (BboxesToPadded), and each package loading the other's streams."""
    _, paths = npz
    path = test_video["path"]
    tsc, touts = _face_graphs(st, str(tmp_path / "t"), path, paths)
    _, jouts = _face_graphs(jst, str(tmp_path / "j"), path, paths)
    tf, te, tg = (list(o.load()) for o in touts)
    jf, je, jg = (list(o.load()) for o in jouts)
    assert len(tf) == len(ROWS) and all(len(f) > 0 for f in tf)
    _assert_faces_close(tf, jf)
    for a, b in zip(te, je):
        assert a.shape == b.shape == (len(a), 128) and a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    assert tg == jg
    assert all(g in ("M", "F") for gl in tg for g in gl)
    # each package loads the streams the other wrote
    for t_out, j_out, kind in zip(touts, jouts, ("faces", "embs", "g")):
        cross_t = list(st.NamedStream(str(tmp_path / "j"), j_out.name).load())
        cross_j = list(jst.NamedStream(str(tmp_path / "t"),
                                       t_out.name).load())
        if kind == "faces":
            _assert_faces_close(cross_t, jf, 0)
            _assert_faces_close(cross_j, tf, 0)
        elif kind == "embs":
            for a, b in zip(cross_t, je):
                np.testing.assert_array_equal(a, b)
            for a, b in zip(cross_j, te):
                np.testing.assert_array_equal(a, b)
        else:
            assert cross_t == jg and cross_j == tg

    # boxes from another source: the stored faces through BboxesToPadded
    frame = tsc.io.Input([st.NamedVideoStream(tsc, "v", path=path)])
    g = tsc.streams.Gather(frame, [ROWS])
    embs = tsc.ops.EmbedFaces(frame=g, bboxes=tsc.io.Input([touts[0]]),
                              weights_path=paths["facenet"],
                              faces_budget=PFO.MAX_FACES)
    out = st.NamedStream(tsc, "embs_padded")
    # rgb as above: "auto" would take I420 for this device-only graph
    tsc.run(tsc.io.Output(embs, [out]),
            st.PerfParams.manual(work_packet_size=2, ingest="rgb"),
            cache_mode=st.CacheMode.Overwrite)
    for a, b in zip(out.load(), te):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)


def test_face_pipeline_i420_matches_port_numpy_path(tmp_path, test_video,
                                                    npz):
    """I420 ingest against the port's own forwards on the same I420 frames
    converted by the numpy path."""
    if not av.available():
        pytest.skip("I420 ingest needs the native libav decoder")
    _, paths = npz
    path = test_video["path"]
    _, outs = _face_graphs(st, str(tmp_path / "t"), path, paths, "i420")
    faces, embs = list(outs[0].load()), list(outs[1].load())

    dec = VideoDecoder(path)
    try:
        planes = dec.read_frames_i420(ROWS)
        chunk = FrameChunk.from_i420(
            planes, test_video["h"], test_video["w"],
            full_range=getattr(dec, "i420_full_range", False),
            bt709=getattr(dec, "i420_bt709", False))
    finally:
        dec.close()
    rgb = _t(chunk.hwc_f32())  # numpy, in the written order
    mt = PFO._get_params("mtcnn", paths["mtcnn"])
    fn = PFO._get_params("facenet", paths["facenet"])
    want_faces, want_embs = [], []
    for a in range(0, len(ROWS), 2):  # the run's chunks of 2
        x = rgb[a:a + 2]
        nb, sc_, v = PFO.mtcnn_forward(None, mt, x, thresholds=ZERO)
        want_faces += PFO.mtcnn_decode(None, nb.numpy(), sc_.numpy(),
                                       v.numpy())
        e, ev, over = PFO.face_embed_forward(None, fn, x, nb, v,
                                             faces_budget=PFO.MAX_FACES)
        want_embs += PFO.embed_decode(None, e.numpy(), ev.numpy(),
                                      over.numpy())
    _assert_faces_close(faces, want_faces, 0)
    for a, b in zip(embs, want_embs):
        np.testing.assert_array_equal(a, b)
