"""The port's legacy extras (``CropClassify``, ``DetectFaceLandmarks``,
``TranscriptAligner``), ``TrackObjects`` and ``TorchDrawBoxes`` held to
the JAX package, op by op (test_torch_clothing.py drives the ops that
take face boxes in one pipeline against the JAX package's).

The nets run on the same weights in both packages: the port's seeded MTCNN
and gender nets, written by the port in the JAX package's npz layout.
Inputs are made from a seed with numpy.

Tolerances, and why. Landmarks within 1e-5 of values near 0.5 (O-Net's
dense layers add in another order). Labels, tracks (cv2's MIL in both
packages, on the same frames, boxes and ``rand()`` seed), drawn bytes and
the aligner's offsets and word timings (numpy in both) are equal.
"""

import ctypes
import dataclasses

import numpy as np
import pytest

import scannertools_tpu as jst
from scannertools_tpu.ops import legacy_extras as JL
from scannertools_tpu.ops import tracker as JT
from scannertools_tpu.ops import vis_labels as JV
from scannertools_tpu.storage.captions import Caption
from scannertools_tpu_torch import protobufs
from scannertools_tpu_torch.models import gender as PG
from scannertools_tpu_torch.models import mtcnn as PM
from scannertools_tpu_torch.models import weights as PW
from scannertools_tpu_torch.ops import legacy_extras as PL
from scannertools_tpu_torch.ops import tracker as PT
from scannertools_tpu_torch.ops import vis_labels as PV

ATOL = 1e-5


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    d = tmp_path_factory.mktemp("extras_weights")
    paths = {"mtcnn": str(d / "mtcnn.npz"), "gender": str(d / "gender.npz")}
    np.savez(paths["mtcnn"], **PW._flatten(PM.to_flax(PM.init_params(0))))
    np.savez(paths["gender"],
             **PW._flatten(PG.to_flax(PG.init_params(0))))
    return paths


def _xyxy(bbs):
    return [[b.x1, b.y1, b.x2, b.y2, b.score] for b in bbs]


def test_crop_classify_without_categories(npz):
    """Argmax ints without categories; degenerate boxes take the first
    class (0), as in the JAX package."""
    frames = np.random.default_rng(4).integers(0, 256, (2, 64, 96, 3)) \
        .astype(np.uint8)
    boxes = [(0.1, 0.1, 0.6, 0.9), (0.5, 0.5, 0.5, 0.9),  # degenerate
             (0.0, 0.0, 1.0, 1.0)]
    got = PL.crop_classify(
        None, frames, [[protobufs.BoundingBox(*b) for b in boxes], []],
        weights_path=npz["gender"])
    want = JL.crop_classify(
        None, frames,
        [[jst.protobufs.BoundingBox(*b) for b in boxes], []],
        weights_path=npz["gender"])
    assert got == want and got[0][1] == 0 and got[1] == []
    assert all(isinstance(x, int) for x in got[0])


def test_landmarks_degenerate_box_is_zeros(npz):
    frames = np.random.default_rng(5).integers(0, 256, (1, 64, 96, 3)) \
        .astype(np.uint8)
    boxes = [(0.2, 0.2, 0.6, 0.8), (0.3, 0.3, 0.3, 0.8)]
    got = PL.detect_face_landmarks(
        None, frames, [[protobufs.BoundingBox(*b) for b in boxes]],
        weights_path=npz["mtcnn"])
    want = JL.detect_face_landmarks(
        None, frames, [[jst.protobufs.BoundingBox(*b) for b in boxes]],
        weights_path=npz["mtcnn"])
    np.testing.assert_allclose(got[0][0], want[0][0], rtol=0, atol=ATOL)
    assert not got[0][1].any() and not want[0][1].any()


# ------------------------------------------------------------ tracking


def seed_mil():
    """cv2's MIL tracker draws its samples from the C library's
    ``rand()``, one sequence for the process: both packages' runs start
    from the same seed."""
    ctypes.CDLL(None).srand(0)


def _track(mod, pb, frames, dets, tracker):
    seed_mil()
    state = mod._track_init(None)
    state, out = mod.track_objects(None, state, frames,
                                   [[pb.BoundingBox(*d) for d in f]
                                    for f in dets], tracker=tracker)
    return out


# tracker -> (track ids at frames 6, 10, 13 and 16)
TRACK_IDS = {
    # MIL follows the square: the frame-6 detection merges into track 0
    "mil": ([0, 1], [0, 1], [0], []),
    # the held box overlaps the frame-6 detection by IoU 0.14 (< 0.25):
    # a new track; each ages out 10 frames after its last merge
    "static": ([0, 1, 2], [1, 2], [2], []),
}


@pytest.mark.parametrize("tracker", list(TRACK_IDS))
def test_track_objects_matches_jax(tracker):
    """A bright square moving 2 px a frame over seeded noise, detected at
    frames 0 and 6, and a detection of nothing at frame 3 (a new id); a
    track unmerged for 10 frames is dropped."""
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 60, (20, 64, 96, 3)).astype(np.uint8)
    for i in range(20):
        frames[i, 20:36, 10 + 2 * i:26 + 2 * i] = 230
    dets = [[] for _ in range(20)]
    dets[0] = [(10, 20, 26, 36, 1.0)]
    dets[6] = [(22, 20, 38, 36, 1.0)]
    dets[3] = [(60, 40, 76, 56, 1.0)]
    got = _track(PT, protobufs, frames, dets, tracker)
    want = _track(JT, jst.protobufs, frames, dets, tracker)
    assert [[b.track_id for b in f] for f in got] == \
        [[b.track_id for b in f] for f in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_xyxy(a), _xyxy(b))
    assert [len(f) for f in got[:4]] == [1, 1, 1, 2]
    assert tuple([b.track_id for b in got[i]] for i in (6, 10, 13, 16)) \
        == TRACK_IDS[tracker]


def test_mil_failure_warns(monkeypatch):
    """Where MIL cannot start, the port warns, naming the exception, and
    holds the box (the JAX package falls back silently)."""
    import cv2

    def broken():
        raise cv2.error("no MIL here")

    monkeypatch.setattr(cv2, "TrackerMIL_create", broken)
    frames = np.zeros((2, 32, 32, 3), np.uint8)
    dets = [[(4, 4, 12, 12, 1.0)], []]
    with pytest.warns(UserWarning, match=r"MIL tracker failed .*error"):
        got = _track(PT, protobufs, frames, dets, "mil")
    want = _track(JT, jst.protobufs, frames, dets, "mil")
    assert _xyxy(got[1]) == _xyxy(want[1]) == [[4, 4, 12, 12, 1.0]]


# ------------------------------------------------------------ drawing


@pytest.mark.parametrize("min_score", [0.5, 0.0])
def test_torch_draw_boxes_equal_bytes(min_score):
    frames = np.random.default_rng(8).integers(0, 256, (2, 48, 64, 3)) \
        .astype(np.uint8)
    boxes = [[(0.1, 0.2, 0.6, 0.7, 0.9, 1), (0.5, 0.1, 0.9, 0.5, 0.3, 90)],
             [(0.0, 0.0, 1.0, 1.0, 0.8, 12)]]  # 12: no COCO name
    got = PV.torch_draw_boxes(
        None, frames, [[protobufs.BoundingBox(*b) for b in f]
                       for f in boxes], min_score=min_score)
    want = JV.torch_draw_boxes(
        None, frames, [[jst.protobufs.BoundingBox(*b) for b in f]
                       for f in boxes], min_score=min_score)
    for a, b in zip(got, want):
        assert a.tobytes() == b.tobytes()
    assert (got[0] != frames[0]).any()  # drawn on a copy
    assert PV.COCO_CATEGORIES == JV.COCO_CATEGORIES


# ------------------------------------------------------------ alignment


def _speech(rate, spans, seconds, seed):
    rng = np.random.default_rng(seed)
    samples = np.zeros(int(seconds * rate), np.float32)
    for a, b in spans:
        samples[int(a * rate):int(b * rate)] = \
            rng.normal(0, 0.5, int(b * rate) - int(a * rate))
    return samples


@pytest.mark.parametrize("shift", [-4.0, 0.0, 2.5])
def test_transcript_offset_matches_jax(shift):
    rate = 8000
    spans = [(5, 8), (15, 20), (30, 36), (45, 50)]
    samples = _speech(rate, spans, 60, 0)
    caps = [Caption(i, a + shift, b + shift, "x")
            for i, (a, b) in enumerate(spans)]
    got, off = PL.TranscriptAligner(0.5, 10.0).align(samples, rate, caps)
    want, joff = JL.TranscriptAligner(0.5, 10.0).align(samples, rate, caps)
    assert off == joff and abs(off + shift) <= 1.0
    assert [dataclasses.astuple(c) for c in got] == \
        [dataclasses.astuple(c) for c in want]


def test_align_words_matches_jax():
    rate = 8000
    samples = _speech(rate, [(1.0, 2.0), (2.4, 4.2), (4.6, 5.2)], 10, 1)
    caps = [Caption(0, 1.0, 5.2, "one twotwo three"),
            Caption(1, 7.0, 7.1, "too short window"),  # the uniform spread
            Caption(2, 8.0, 9.0, "   ")]  # no words
    got = PL.TranscriptAligner().align_words(samples, rate, caps)
    want = JL.TranscriptAligner().align_words(samples, rate, caps)
    assert [dataclasses.astuple(w) for w in got] == \
        [dataclasses.astuple(w) for w in want]
    assert [w.word for w in got] == ["one", "twotwo", "three", "too",
                                     "short", "window"]
    assert isinstance(got[0], PL.WordAlignment)
