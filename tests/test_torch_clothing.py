"""The port's attribute classifiers (StreetStyle clothing and hairstyle,
PrepareClothingBbox) held to the JAX package.

Both packages run on the same weights: the JAX package's deterministic
initialisation of both head sets (jitted once per module), carried to the
port by ``streetstyle.from_flax`` as numpy, and for the pipeline through
npz files its ``save_params`` wrote, with its MTCNN's and the port's
seeded gender net in the same layout. The same inputs, made from a seed
with numpy (or the conftest video), go through the JAX function and the
port; the 299x299 nets run at batch 2. The pipeline test drives every
face-box consumer of this slice in one ``Client(device="cpu")`` run a
package: MTCNNDetectFaces -> PrepareClothingBbox, DetectClothing,
DetectHairStyle, DetectFaceLandmarks, CropClassify(gender) and
TrackObjects(tracker="mil").

Tolerances, and why. The window scan (``detect_edge_text``,
``_prepare_one``) is numpy and cv2 in both packages: rows and boxes are
equal. The nets' logits and features within 1e-5 of their largest value
(convolutions add in other orders; measured 2.4e-7 of logits near 1).
Predictions are argmaxes: they are compared where the top two logits of
a head are further apart than that tolerance, and the count of heads
excluded as near-ties is reported (none in these seeded cases); the
pipeline's records are compared whole (no near-tie there either). Face
boxes and windows within 1e-5 (normalized; the cascade's tolerance in
test_torch_faces.py), landmarks within 1e-5 of values near 0.5 (O-Net's
dense layers add in another order), gender labels and track ids equal;
MIL's boxes are cv2's on the same frames, boxes and ``rand()`` seed, and
a track held where MIL cannot start keeps its face's pixel box, within 96
x 1e-5 px.
"""

import jax
import numpy as np
import pytest
import torch

import scannertools_tpu as jst
import scannertools_tpu_torch as st
from scannertools_tpu import protobufs as jprotobufs
from scannertools_tpu.models import mtcnn as JM
from scannertools_tpu.models import streetstyle as JS
from scannertools_tpu.models import weights as JW
from scannertools_tpu.ops import clothing as JC
from scannertools_tpu_torch import protobufs
from scannertools_tpu_torch.models import gender as PG
from scannertools_tpu_torch.models import streetstyle as PS
from scannertools_tpu_torch.models import weights as PW
from scannertools_tpu_torch.ops import clothing as PC
from scannertools_tpu_torch.ops import faces as PFO
from test_torch_legacy_extras import seed_mil

RTOL = 1e-5  # of the largest |value|
BOX_ATOL = 1e-5
LMK_ATOL = 1e-5
ZERO = (0.0, 0.0, 0.0)
ROWS = [0, 130]  # two shots' frames: 19 and 12 faces at thresholds 0
HEAD_SETS = {"clothing": JS.CLOTHING_ATTRIBUTES,
             "hairstyle": JS.HAIRSTYLE_ATTRIBUTES}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def nets():
    """Per head set: the JAX variables (numpy), the port's state from
    them, seeded batch-2 crops and the jitted JAX forward's (scores,
    features, predictions), once per module."""
    key = jax.random.PRNGKey(0)
    x = np.random.default_rng(1).uniform(
        0, 255, (2, JS.INPUT_SIZE, JS.INPUT_SIZE, 3)).astype(np.float32)
    out = {}
    for tag, attrs in HEAD_SETS.items():
        v = _np_tree(jax.jit(getattr(JS, f"init_params_{tag}"))(key))

        def fwd(v, c, attrs=attrs):
            scores, feat = JS._net(attrs).apply(v, JS.normalize(c))
            return scores, feat, JS._predict_multihead(v, c, attrs, None)

        scores, feat, preds = jax.jit(fwd)(v, x)
        out[tag] = {"variables": v, "state": PS.from_flax(v), "x": x,
                    "scores": [np.asarray(s) for s in scores],
                    "feat": np.asarray(feat), "preds": np.asarray(preds)}
    return out


def _decided(logits: np.ndarray, tol: float) -> np.ndarray:
    """Rows whose top two logits are further apart than ``tol``."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0] > tol


@pytest.mark.parametrize("tag", list(HEAD_SETS))
def test_streetstyle_logits_match_jax(nets, tag):
    n = nets[tag]
    scores, feat = PS.forward(n["state"], torch.from_numpy(n["x"]),
                              HEAD_SETS[tag])
    assert len(scores) == len(HEAD_SETS[tag])
    scale = max(float(np.abs(s).max()) for s in n["scores"])
    for got, want, (_, vals) in zip(scores, n["scores"], HEAD_SETS[tag]):
        assert got.shape == want.shape == (2, len(vals))
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=RTOL * scale)
    assert feat.shape == (2, PS.FEATURES)
    np.testing.assert_allclose(feat.numpy(), n["feat"], rtol=0,
                               atol=RTOL * float(np.abs(n["feat"]).max()))
    # predictions where no head is a near-tie
    preds = PS._predict_multihead(n["state"], torch.from_numpy(n["x"]),
                                  HEAD_SETS[tag]).numpy()
    decided = np.stack([_decided(s, RTOL * scale) for s in n["scores"]],
                       axis=1)
    assert preds.dtype == np.int32 and preds.shape == n["preds"].shape
    np.testing.assert_array_equal(preds[decided], n["preds"][decided])
    assert int((~decided).sum()) == 0  # excluded near-ties: none here


@pytest.mark.parametrize("tag", list(HEAD_SETS))
def test_stacked_masked_argmax_equals_per_head(nets, tag):
    n = nets[tag]
    attrs = HEAD_SETS[tag]
    state = n["state"]
    stacked = PS.stack_head_params(state, attrs)
    jw, jb, jm = (np.asarray(a) for a in
                  JS.stack_head_params(n["variables"], attrs))
    for got, want in zip(stacked, (jw, jb, jm)):
        np.testing.assert_array_equal(got.numpy(), want)
    scores, feat = PS.forward(state, torch.from_numpy(n["x"]), attrs)
    logits = PS.heads_logits(stacked, feat)
    kmax = max(len(v) for _, v in attrs)
    assert logits.shape == (2, len(attrs), kmax)
    for i, s in enumerate(scores):  # padded classes hold the bias 0
        np.testing.assert_allclose(logits[:, i, :s.shape[1]].numpy(),
                                   s.numpy(), rtol=0, atol=1e-6)
    masked = PS.masked_argmax(stacked, logits).numpy()
    per_head = PS._predict_multihead(state, torch.from_numpy(n["x"]),
                                     attrs).numpy()
    np.testing.assert_array_equal(masked, per_head)
    # a padded class never wins, even with every real logit negative
    neg = torch.full_like(logits, -5.0)
    neg[..., 0] = -4.0
    assert (PS.masked_argmax(stacked, neg).numpy() == 0).all()


@pytest.mark.parametrize("tag", list(HEAD_SETS))
def test_streetstyle_weights_round_trip(nets, tag, tmp_path):
    n = nets[tag]
    flat = JW._flatten(n["variables"])
    back = PW._flatten(PS.to_flax(n["state"]))
    assert sorted(back) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])
    # the npz the JAX package writes, through the ops' weight loader
    path = str(tmp_path / f"{tag}.npz")
    JW.save_params(path, n["variables"])
    state = PFO._get_params(f"streetstyle_{tag}", path)
    assert sorted(state) == sorted(n["state"])
    for k, v in n["state"].items():
        assert torch.equal(state[k], v)
    seeded = getattr(PS, f"init_params_{tag}")(3)
    assert {k: v.shape for k, v in seeded.items()} == \
        {k: v.shape for k, v in n["state"].items()}


def test_normalize_matches_jax():
    x = np.random.default_rng(2).uniform(0, 255, (2, 5, 7, 3)) \
        .astype(np.float32)
    want = np.asarray(jax.jit(JS.normalize)(x))
    got = PS.normalize(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ------------------------------------------------------------ window scan


def _frame(kind: str) -> np.ndarray:
    """200x200 low-texture frame; "boundary": a bright panel from row 120
    (a row of Canny edges); "text": 2-px stripes of 250 and 5 on rows
    118-123 (dense horizontal contrast); "noise": uniform 0-255 (rows of
    every contrast, the channels' maxima on every channel)."""
    rng = np.random.default_rng(0)
    if kind == "noise":
        return rng.integers(0, 256, (200, 200, 3)).astype(np.uint8)
    f = rng.integers(60, 90, (200, 200, 3)).astype(np.uint8)
    if kind == "boundary":
        f[120:] = 230
    elif kind == "text":
        f[118:124, 0::4] = 250
        f[118:124, 1::4] = 250
        f[118:124, 2::4] = 5
        f[118:124, 3::4] = 5
    return f


FACE = (0.4, 0.3, 0.55, 0.45)
# case -> (frame, boxes, person i, the box the window math gives)
PREPARE_CASES = {
    # the window rows 35..155; the boundary's edge row is crop row 84,
    # which the quirk divides by the frame's height
    "graphic_boundary": ("boundary", [FACE], 0, (65, 35, 125, 84)),
    "text_row": ("text", [FACE], 0, (65, 35, 125, 83)),
    "no_row": ("plain", [FACE], 0, (65, 35, 125, 121)),
    # a person below: the bottom is their top, 140 - 35
    "person_below": ("plain", [FACE, (0.42, 0.7, 0.56, 0.85)], 0,
                     (65, 35, 125, 105)),
    "person_below_other": ("plain", [FACE, (0.42, 0.7, 0.56, 0.85)], 1,
                           None),
    # a 6-px face: a window under 20 px is malformed, the face box stays
    "malformed": ("plain", [(0.4, 0.3, 0.43, 0.33)], 0, None),
    # the window clipped at the frame's top (rows 0..99, no row)
    "clipped_top": ("boundary", [(0.4, 0.02, 0.55, 0.17)], 0,
                    (65, 0, 125, 100)),
}


@pytest.mark.parametrize("case", list(PREPARE_CASES))
def test_prepare_one_matches_jax(case):
    kind, boxes, i, want_px = PREPARE_CASES[case]
    f = _frame(kind)
    jb = [jprotobufs.BoundingBox(*b, score=0.9) for b in boxes]
    tb = [protobufs.BoundingBox(*b, score=0.9) for b in boxes]
    j, t = JC._prepare_one(f, jb, i), PC._prepare_one(f, tb, i)
    got = (t.x1, t.y1, t.x2, t.y2, t.score)
    assert got == (j.x1, j.y1, j.x2, j.y2, j.score)
    if want_px is None:  # the fallback: the box unchanged
        assert got == (*boxes[i], np.float32(0.9))
    else:
        assert got[:4] == tuple(v / 200 for v in want_px)


@pytest.mark.parametrize("kind,start,want", [
    ("boundary", 30, 79), ("text", 30, 78), ("plain", 30, 160),
    ("boundary", 200, 160),  # the start past the crop: no row
    ("noise", 0, None), ("noise", 30, None),
])
def test_detect_edge_text_matches_jax(kind, start, want):
    crop = np.ascontiguousarray(_frame(kind)[40:200, 60:120])
    got = PC.detect_edge_text(crop, start)
    assert got == JC.detect_edge_text(crop, start)
    if want is not None:
        assert got == want


def test_prepare_clothing_bbox_op_matches_jax():
    frames = np.stack([_frame("boundary"), _frame("text")])
    boxes = [[FACE, (0.42, 0.7, 0.56, 0.85)], [(0.4, 0.3, 0.43, 0.33)]]
    got = PC.prepare_clothing_bbox(
        None, frames, [[protobufs.BoundingBox(*b) for b in bs]
                       for bs in boxes])
    want = JC.prepare_clothing_bbox(
        None, frames, [[jprotobufs.BoundingBox(*b) for b in bs]
                       for bs in boxes])
    assert [[(b.x1, b.y1, b.x2, b.y2) for b in f] for f in got] == \
        [[(b.x1, b.y1, b.x2, b.y2) for b in f] for f in want]


def test_records_decode():
    c = PC.Clothing(predictions=np.arange(16, dtype=np.int32) % 2)
    j = JC.Clothing(predictions=np.arange(16, dtype=np.int32) % 2)
    assert c.to_dict() == j.to_dict() and str(c) == str(j)
    h = PC.HairStyle(predictions=np.array([2, 4, 3], np.int32))
    assert h.to_dict() == JC.HairStyle(
        predictions=np.array([2, 4, 3], np.int32)).to_dict()
    assert h.to_dict()["Hair length"] == "bald"


# ------------------------------------------------------------ pipelines


@pytest.fixture(scope="module")
def npz(nets, tmp_path_factory):
    """npz files the JAX package's save_params wrote: its MTCNN (jitted
    init) and both head sets; the port's seeded gender net in the same
    layout."""
    d = tmp_path_factory.mktemp("clothing_weights")
    paths = {"mtcnn": str(d / "mtcnn.npz"), "gender": str(d / "gender.npz")}
    JW.save_params(paths["mtcnn"],
                   jax.jit(JM.init_params)(jax.random.PRNGKey(0)))
    np.savez(paths["gender"], **PW._flatten(PG.to_flax(PG.init_params(0))))
    for tag in HEAD_SETS:
        paths[tag] = str(d / f"{tag}.npz")
        JW.save_params(paths[tag], nets[tag]["variables"])
    return paths


def _register_to_pixels(pkg):
    """A python op, the same in both packages: normalized face boxes ->
    pixel boxes of the 96x64 video (TrackObjects takes pixels)."""
    @pkg.register_python_op(name="FacesToPixels", outputs=("bboxes",))
    def faces_to_pixels(ctx, bboxes):
        return [[pkg.protobufs.BoundingBox(
            x1=b.x1 * 96, y1=b.y1 * 64, x2=b.x2 * 96, y2=b.y2 * 64,
            score=b.score) for b in bbs] for bbs in bboxes]


GRAPHS = ("faces", "windows", "clothing", "hair", "landmarks", "gender",
          "tracks")


def _face_attribute_graphs(pkg, db, path, paths):
    """MTCNNDetectFaces -> PrepareClothingBbox, DetectClothing (its own
    window step), DetectHairStyle, DetectFaceLandmarks,
    CropClassify(gender) and TrackObjects(mil) over ROWS, one chunk ->
    {graph: loaded rows}."""
    kw = dict(device="cpu") if pkg is st else {}
    sc = pkg.Client(db_path=db, **kw)
    _register_to_pixels(pkg)
    frame = sc.io.Input([pkg.NamedVideoStream(sc, "v", path=path)])
    g = sc.streams.Gather(frame, [ROWS])
    faces = sc.ops.MTCNNDetectFaces(frame=g, weights_path=paths["mtcnn"],
                                    thresholds=ZERO)
    cols = [
        faces,
        sc.ops.PrepareClothingBbox(frame=g, bboxes=faces),
        sc.ops.DetectClothing(frame=g, bboxes=faces,
                              weights_path=paths["clothing"]),
        sc.ops.DetectHairStyle(frame=g, bboxes=faces,
                               weights_path=paths["hairstyle"]),
        sc.ops.DetectFaceLandmarks(frame=g, bboxes=faces,
                                   weights_path=paths["mtcnn"]),
        sc.ops.CropClassify(frame=g, bboxes=faces,
                            weights_path=paths["gender"],
                            categories=("M", "F")),
        sc.ops.TrackObjects(frames=g,
                            bboxes=sc.ops.FacesToPixels(bboxes=faces),
                            tracker="mil"),
    ]
    outs = [pkg.NamedStream(sc, n) for n in GRAPHS]
    seed_mil()
    sc.run(sc.io.Output(cols, [tuple(outs)]),
           pkg.PerfParams.manual(work_packet_size=len(ROWS), ingest="rgb"),
           cache_mode=pkg.CacheMode.Overwrite)
    return {n: list(o.load()) for n, o in zip(GRAPHS, outs)}


def _xyxy(bbs):
    return [[b.x1, b.y1, b.x2, b.y2, b.score] for b in bbs]


def test_face_attribute_pipelines_match_jax(tmp_path, test_video, npz):
    got = _face_attribute_graphs(st, str(tmp_path / "t"),
                                 test_video["path"], npz)
    want = _face_attribute_graphs(jst, str(tmp_path / "j"),
                                  test_video["path"], npz)
    faces = got["faces"]
    assert len(faces) == len(ROWS) and all(len(f) > 0 for f in faces)
    counts = [len(f) for f in faces]
    assert counts == [len(f) for f in want["faces"]]
    for name in ("faces", "windows"):
        for a, b in zip(got[name], want[name]):
            np.testing.assert_allclose(_xyxy(a), _xyxy(b), rtol=0,
                                       atol=BOX_ATOL)
    for name, cls in (("clothing", PC.Clothing), ("hair", PC.HairStyle)):
        assert [len(r) for r in got[name]] == counts
        for r, jr in zip(got[name], want[name]):
            for a, b in zip(r, jr):
                assert type(a) is cls and a.predictions.dtype == np.int32
                np.testing.assert_array_equal(a.predictions, b.predictions)
                assert a.to_dict() == b.to_dict()
    for a, b in zip(got["landmarks"], want["landmarks"]):
        assert len(a) == len(b)
        for la, lb in zip(a, b):
            assert la.shape == (5, 2) and la.dtype == np.float32
            np.testing.assert_allclose(la, lb, rtol=0, atol=LMK_ATOL)
    assert got["gender"] == want["gender"]
    assert [len(g) for g in got["gender"]] == counts
    assert all(x in ("M", "F") for g in got["gender"] for x in g)
    tracks = got["tracks"]
    for a, b in zip(tracks, want["tracks"]):
        assert [t.track_id for t in a] == [t.track_id for t in b]
        np.testing.assert_allclose(_xyxy(a), _xyxy(b), rtol=0,
                                   atol=96 * BOX_ATOL)
    assert all(len(t) > 0 for t in tracks) and tracks[0][0].track_id == 0
