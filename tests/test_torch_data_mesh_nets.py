"""The net segments on the port's data mesh (``pipeline_instances_per_node=8``
over 8 logical CPU devices, the ``eight`` fixture of
test_torch_sharded_executor.py), held to the port's unsharded run and to
the JAX package's 8-device run (pytest's 8 virtual JAX CPU devices,
tests/conftest.py; tests/test_parallel.py runs its MTCNN case so).

Each graph's ops are ``batch_local`` (registry.py): output row i reads
input row i alone, so the executor splits them frames a shard, each
shard's nets at a smaller batch. Every case asserts that the segment
split (``axis:data:engaged``, by "batch_local") and that nothing ran
whole.

Tolerances, and why. Counts (faces, boxes, detections, peaks, people),
keep sets, labels and valid flags are compared exactly: a flip would be a
real difference (none of these seeded cases lands on a near-tie). Float
values: the port's sharded run against its unsharded run and the JAX
package's within the tolerance each model's own test file states for the
port against JAX, since the sharded run only adds another batch's
rounding (a convolution or a matrix product may take another algorithm
at another batch):

  * MTCNN: against the port's unsharded run, normalized boxes and scores
    within 1e-5 (JAX's bound in tests/test_parallel.py; measured 4.2e-7);
    against the JAX package, test_torch_faces.py's: boxes within 2e-3 px
    (at these 16-px-tall frames a normalized 1.25e-4: the two packages'
    regression times the box side, measured 1.44e-5 normalized, the same
    unsharded), scores within 1e-5;
  * SSD: boxes and scores within 1e-6 (test_torch_detection.py);
  * Faster R-CNN: the decode's boxes (input pixels) and scores within
    5e-3, features within 1e-3 (test_torch_detection.py);
  * Mask R-CNN: boxes 1e-5, scores 2e-5, masks 2e-4
    (test_torch_maskrcnn.py);
  * OpenPose: peak positions, valid flags, dims and feasible limbs equal;
    peak and limb scores within 1e-5 of the largest map value; poses
    within 1e-5 (test_torch_pose_pipeline.py);
  * a registered toy model through NNForward: within 1e-5 of the largest
    value.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scannertools_tpu as jst
import scannertools_tpu_torch as st
from scannertools_tpu.models import faster_rcnn as JR
from scannertools_tpu.models import mtcnn as JM
from scannertools_tpu.models import ssd as JS
from scannertools_tpu.models import weights as JW
from scannertools_tpu.ops import faces as JFO
from scannertools_tpu.ops import nn_generic as JN
from scannertools_tpu_torch.models import faster_rcnn as PR
from scannertools_tpu_torch.models import pose as PP
from scannertools_tpu_torch.models import weights as PW
from scannertools_tpu_torch.ops import faces as PFO
from scannertools_tpu_torch.ops import nn_generic as PN
from scannertools_tpu_torch.parallel import mesh
from test_torch_maskrcnn import CAPS as MRCNN_CAPS
from test_torch_maskrcnn import _jax_model, _shared_weights
from test_torch_sharded_executor import FakeVideo

ZERO = (0.0, 0.0, 0.0)
FACE_ATOL = 1e-5
BOX_PX_ATOL = 2e-3
SSD_ATOL = 1e-6
ROI_ATOL = 5e-3
FC7_ATOL = 1e-3
MASK_BOX_ATOL, MASK_SCORE_ATOL, MASK_ATOL = 1e-5, 2e-5, 2e-4
RTOL_OF_MAX = 1e-5
POSE_HEAD_SCALE = 1000.0
FRCNN_KEY = "data-mesh-faster-rcnn"
MRCNN_KEY = "data-mesh-maskrcnn"
MEAN = (102.9801, 115.9465, 122.7717)


@pytest.fixture()
def eight(monkeypatch):
    monkeypatch.setenv(mesh.LOGICAL_DEVICES_ENV, "8")


def _texture(n, h, w, seed):
    """Seeded noise smoothed by box passes (so that the nets see edges
    and blobs, not white noise), uint8 [n, h, w, 3]."""
    x = np.random.default_rng(seed).random((n, h + 8, w + 8, 3))
    for axis in (1, 2, 1, 2):
        c = np.cumsum(x, axis=axis)
        x = (np.take(c, range(4, c.shape[axis]), axis=axis)
             - np.take(c, range(0, c.shape[axis] - 4), axis=axis))
    lo, hi = x.min(), x.max()
    return ((x - lo) / (hi - lo) * 255).astype(np.uint8)[:, :h, :w]


def _run(pkg, db, fv, build, W, inst):
    """``build(sc, frame) -> (columns, names)`` over ``fv`` in chunks of
    W with pipeline_instances_per_node=inst -> (loaded streams, the port's
    profiler or None)."""
    kw = dict(device="cpu") if pkg is st else {}
    sc = pkg.Client(db_path=db, **kw)
    cols, names = build(sc, sc.io.Input([fv]))
    outs = [pkg.NamedStream(sc, n) for n in names]
    sc.run(sc.io.Output(cols, [tuple(outs)]),
           pkg.PerfParams.manual(work_packet_size=W, ingest="rgb",
                                 pipeline_instances_per_node=inst),
           cache_mode=pkg.CacheMode.Overwrite)
    return [list(o.load()) for o in outs], getattr(sc, "profiler", None)


def _three(tmp_path, fv, build, W, jax_build=None):
    """The port at 8 shards and unsharded, the JAX package at 8 devices
    -> (port 8, port 1, JAX 8) streams; asserts the port's split."""
    got, prof = _run(st, str(tmp_path / "p8"), fv, build, W, 8)
    one, _ = _run(st, str(tmp_path / "p1"), fv, build, W, 1)
    want, _ = _run(jst, str(tmp_path / "j8"), fv, jax_build or build, W, 8)
    counts = prof.counts()
    chunks = -(-len(fv) // W)
    assert counts.get("axis:data:engaged", 0) >= chunks, counts
    assert "axis:data:not_engaged" not in counts, counts
    assert {iv["meta"]["by"] for iv in
            prof.intervals("axis:data:engaged")} == {"batch_local"}
    return got, one, want


def _boxes_close(got, want, atol, labels=True):
    """Equal counts (and labels); x1, y1, x2, y2, score within ``atol``,
    a number or one a column."""
    assert [len(f) for f in got] == [len(f) for f in want]
    for fg, fw in zip(got, want):
        if labels:
            assert [b.label for b in fg] == [b.label for b in fw]
        for a, b in zip(fg, fw):
            diff = np.abs(np.subtract([a.x1, a.y1, a.x2, a.y2, a.score],
                                      [b.x1, b.y1, b.x2, b.y2, b.score]))
            assert (diff <= np.asarray(atol)).all(), (diff, atol)


def _close_of_max(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL_OF_MAX * scale,
                               err_msg=what)


# ------------------------------------------------------------ MTCNN


@pytest.fixture(scope="module")
def mtcnn_npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mtcnn") / "mtcnn.npz")
    JW.save_params(path, JM.init_params(jax.random.PRNGKey(0)))
    return path


@pytest.mark.parametrize("W", [16, 9])
def test_mtcnn_split_frames_a_shard(eight, tmp_path, mtcnn_npz, W):
    """tests/test_parallel.py's frames (24 of 16x128, seed 0) through
    MTCNNDetectFaces at thresholds 0 (the seeded weights keep no face at
    the reference's), W=16 and the ragged W=9 (chunks of 9, 9, 6: two
    frames a shard, the last shards on the replicated tail)."""
    frames = np.random.default_rng(0).integers(0, 256, (24, 16, 128, 3),
                                               np.uint8)

    def build(sc, frame):
        return [sc.ops.MTCNNDetectFaces(frame=frame, weights_path=mtcnn_npz,
                                        thresholds=ZERO)], ["faces"]

    (got,), (one,), (want,) = _three(tmp_path, FakeVideo(frames), build, W)
    assert len(got) == 24 and sum(len(f) for f in got) > 24
    _boxes_close(got, one, FACE_ATOL, labels=False)
    h, w = frames.shape[1:3]
    px = [BOX_PX_ATOL / w, BOX_PX_ATOL / h] * 2
    _boxes_close(got, want, px + [FACE_ATOL], labels=False)


# ------------------------------------------------------------ SSD


@pytest.fixture(scope="module")
def ssd_npz(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ssd") / "ssd.npz")
    JW.save_params(path, jax.jit(JS.init_params)(jax.random.PRNGKey(0)))
    return path


def test_detect_objects_split_frames_a_shard(eight, tmp_path, ssd_npz):
    fv = FakeVideo(_texture(8, 48, 64, 1))

    def build(sc, frame):
        return [sc.ops.DetectObjects(frame=frame, weights_path=ssd_npz)], \
            ["objects"]

    (got,), (one,), (want,) = _three(tmp_path, fv, build, 8)
    assert all(len(f) == 100 and all(1 <= b.label <= 90 for b in f)
               for f in got)
    _boxes_close(got, one, SSD_ATOL)
    _boxes_close(got, want, SSD_ATOL)


# ------------------------------------------------------------ Faster R-CNN


@pytest.fixture(scope="module")
def frcnn_weights():
    """tests/test_torch_detection.py's: the JAX package's small model's
    init (full widths), and the port's state of it."""
    m = JR.FasterRCNN(num_rois=8, pre_nms=64)
    v = jax.jit(m.init)(jax.random.PRNGKey(1),
                        jnp.zeros((1, 96, 96, 3), jnp.float32))
    return v, PR.from_flax(jax.tree_util.tree_map(np.array, v))


def test_faster_rcnn_split_frames_a_shard(eight, tmp_path, frcnn_weights,
                                          monkeypatch):
    """NNInput -> FasterRCNN -> FasterRCNNOutput at the production
    num_rois on 8 frames of 64x96 (216 anchors, fewer than the 300 RoIs:
    the JAX package's arrays carry 301 rows, its decoded rows agree)."""
    v, state = frcnn_weights
    monkeypatch.setitem(JFO._MODEL_CACHE, ("nn:faster_rcnn", FRCNN_KEY), v)
    monkeypatch.setitem(PFO._MODEL_CACHE, ("faster_rcnn", FRCNN_KEY), state)
    fv = FakeVideo(_texture(8, 64, 96, 2))

    def build(sc, frame):
        pre = sc.ops.NNInput(frame=frame, mean_colors=MEAN)
        cls_prob, rois, fc7 = sc.ops.FasterRCNN(input=pre,
                                                weights_path=FRCNN_KEY)
        boxes, feats = sc.ops.FasterRCNNOutput(
            cls_prob=cls_prob, rois=rois, fc7=fc7, score_threshold=0.015)
        return [boxes, feats], ["boxes", "feats"]

    got, one, want = _three(tmp_path, fv, build, 8)
    assert sum(len(f) for f in got[0]) > 0
    for other in (one, want):
        _boxes_close(got[0], other[0], ROI_ATOL)
        for a, b in zip(got[1], other[1]):
            a = np.asarray(a, np.float32).reshape(-1, 4096)
            b = np.asarray(b, np.float32).reshape(-1, 4096)
            np.testing.assert_allclose(a, b, rtol=0, atol=FC7_ATOL)


# ------------------------------------------------------------ Mask R-CNN


def test_maskrcnn_chunk_split_frames_a_shard(eight, tmp_path, monkeypatch):
    """One chunk of 8 frames of 64x96 through MaskRCNNDetectObjects
    (R-50-FPN, a 64x128 canvas at min_size 64, max_size 128, caps
    192/96/16) on test_torch_maskrcnn.py's shared weights."""
    v, state = _shared_weights("R-50-FPN", 0)
    monkeypatch.setitem(JFO._MODEL_CACHE,
                        ("maskrcnn_vars", MRCNN_KEY, "R-50-FPN"), v)
    monkeypatch.setitem(JFO._MODEL_CACHE,
                        ("maskrcnn_model", "R-50-FPN", MRCNN_CAPS),
                        _jax_model("R-50-FPN"))
    monkeypatch.setitem(PFO._MODEL_CACHE, ("maskrcnn", MRCNN_KEY, "R-50-FPN"),
                        state)
    fv = FakeVideo(_texture(8, 64, 96, 3))

    def build(sc, frame):
        return [sc.ops.MaskRCNNDetectObjects(
            frame=frame, weights_path=MRCNN_KEY, confidence_threshold=0.1,
            min_size=64, max_size=128, pre_nms=MRCNN_CAPS[0],
            post_nms=MRCNN_CAPS[1], max_det=MRCNN_CAPS[2])], ["mrcnn"]

    (got,), (one,), (want,) = _three(tmp_path, fv, build, 8)
    assert sum(len(f) for f in got) > 0
    for other in (one, want):
        assert [len(f) for f in got] == [len(f) for f in other]
        for fg, fw in zip(got, other):
            for a, b in zip(fg, fw):
                assert a["bbox"].label == b["bbox"].label
                np.testing.assert_allclose(
                    [a["bbox"].x1, a["bbox"].y1, a["bbox"].x2, a["bbox"].y2],
                    [b["bbox"].x1, b["bbox"].y1, b["bbox"].x2, b["bbox"].y2],
                    rtol=0, atol=MASK_BOX_ATOL)
                assert abs(a["bbox"].score - b["bbox"].score) <= \
                    MASK_SCORE_ATOL
                np.testing.assert_allclose(a["mask"], b["mask"], rtol=0,
                                           atol=MASK_ATOL)


# ------------------------------------------------------------ OpenPose


@pytest.fixture(scope="module")
def pose_npz(tmp_path_factory):
    """The port's seeded body, its output layers scaled (peaks appear),
    as an uncompressed npz in the JAX package's layout."""
    body = PP.init_params(0)
    for key in ("Mconv7_stage6_L1.weight", "Mconv7_stage6_L2.weight"):
        body[key] = body[key] * POSE_HEAD_SCALE
    path = str(tmp_path_factory.mktemp("pose") / "body.npz")
    np.savez(path, **PW._flatten(PP.to_flax(body)))
    return path


def test_openpose_split_frames_a_shard(eight, tmp_path, pose_npz):
    """OpenPose (the port's composite; the JAX package's forward and
    decode, as test_torch_pose_pipeline.py holds them) on 8 frames of
    64x96, with the forward's streams beside the poses. The seeded body
    gives peaks (906) and feasible limbs (1941) but, as on the test
    video, forms no person: the maps carry the comparison."""
    fv = FakeVideo(_texture(8, 64, 96, 4))

    def forward(sc, frame):
        f = sc.ops.OpenPoseForward(frame=frame, weights_path=pose_npz)
        return [f[0], f[1], f[2], f[3]]

    def port(sc, frame):
        poses = sc.ops.OpenPose(frame=frame, weights_path=pose_npz)
        return [poses] + forward(sc, frame), \
            ["poses", "peaks", "valid", "scores", "dims"]

    def ref(sc, frame):
        f = forward(sc, frame)
        poses = sc.ops.OpenPoseDecode(peaks=f[0], valid=f[1], scores=f[2],
                                      dims=f[3])
        return [poses] + f, ["poses", "peaks", "valid", "scores", "dims"]

    got, one, want = _three(tmp_path, fv, port, 8, jax_build=ref)
    assert sum(int(np.asarray(v).sum()) for v in got[2]) > 10
    assert sum(int(np.isfinite(x).sum()) for x in got[3]) > 10
    for other in (one, want):
        poses, peaks, valid, scores, dims = other
        for i in range(len(fv)):
            np.testing.assert_array_equal(got[2][i], valid[i])
            np.testing.assert_array_equal(got[4][i], dims[i])
            np.testing.assert_array_equal(got[1][i][..., :2],
                                          peaks[i][..., :2])
            _close_of_max(got[1][i][..., 2], peaks[i][..., 2], "peaks")
            feasible = np.isfinite(scores[i])
            np.testing.assert_array_equal(np.isfinite(got[3][i]), feasible)
            _close_of_max(got[3][i][feasible], scores[i][feasible],
                          "limb scores")
        assert [len(f) for f in got[0]] == [len(f) for f in poses]
        for fg, fw in zip(got[0], poses):
            for a, b in zip(fg, fw):
                assert abs(a._score - b._score) <= RTOL_OF_MAX * max(
                    1.0, abs(b._score))
                np.testing.assert_allclose(a._kp, b._kp, rtol=0,
                                           atol=RTOL_OF_MAX)


# ------------------------------------------------------------ NNForward


TOY = "data_mesh_toy_rgb"


def _register_toy(path, batch_local):
    """A toy model registered in both packages under TOY (a frame's
    channel means through a dense layer and a ReLU), its weights in the
    npz at ``path``, which both packages read."""
    w = np.random.default_rng(5).normal(size=(3, 8)).astype(np.float32)
    PW.save_params(path, {"dense": {"w": w}})

    def jax_apply(v, x):
        return jax.nn.relu(x.mean(axis=(1, 2)) @ v["dense"]["w"])

    def port_apply(state, x):
        return torch.relu(x.mean(dim=(1, 2)) @ state["dense"]["w"])

    JN.register_model(TOY, lambda rng: None, jax_apply)
    PN.register_model(TOY, lambda seed: None, port_apply,
                      batch_local=batch_local)


def _unregister(name):
    """Take ``name`` out of both packages' registries and model caches, so
    that they hold their built-in names again."""
    JN._NN_REGISTRY.pop(name, None)
    PN._NN_REGISTRY.pop(name, None)
    PN._BATCH_LOCAL.pop(name, None)
    PFO._MODELS.pop("nn:" + name, None)
    for cache in (JFO._MODEL_CACHE, PFO._MODEL_CACHE):
        for key in [k for k in cache if "nn:" + name in k[:2]]:
            del cache[key]


def _toy_graph(path):
    def build(sc, frame):
        pre = sc.ops.NNInput(frame=frame, mean_colors=(100.0, 110.0, 120.0))
        return [sc.ops.NNForward(input=pre, model=TOY,
                                 weights_path=path)], ["toy"]
    return build


def test_registered_model_splits_frames_a_shard(eight, tmp_path):
    """NNInput -> NNForward(model=TOY), the model registered with
    batch_local=True: split frames a shard over a ragged chunk (W=9)."""
    path = str(tmp_path / "toy.npz")
    _register_toy(path, batch_local=True)
    try:
        fv = FakeVideo(_texture(13, 12, 16, 6))
        (got,), (one,), (want,) = _three(tmp_path, fv, _toy_graph(path), 9)
    finally:
        _unregister(TOY)
    assert np.stack(got).shape == (13, 8)
    _close_of_max(np.stack(got), np.stack(one), "toy")
    _close_of_max(np.stack(got), np.stack(want), "toy")


def test_registered_model_not_batch_local_runs_whole(eight, tmp_path):
    """A model registered without batch_local: NNInput still splits, the
    NNForward after it runs whole on the client's device (counted), and
    the rows equal the unsharded run's."""
    path = str(tmp_path / "toy.npz")
    _register_toy(path, batch_local=False)
    try:
        fv = FakeVideo(_texture(13, 12, 16, 6))
        (got,), prof = _run(st, str(tmp_path / "p8"), fv, _toy_graph(path),
                            9, 8)
        (one,), _ = _run(st, str(tmp_path / "p1"), fv, _toy_graph(path),
                         9, 1)
    finally:
        _unregister(TOY)
    counts = prof.counts()
    assert counts["axis:data:engaged"] == counts["axis:data:not_engaged"] \
        == 2
    assert [iv["meta"]["reason"] for iv in
            prof.intervals("axis:data:not_engaged")] == [
        "not row- or batch-local: NNForward"] * 2
    _close_of_max(np.stack(got), np.stack(one), "toy")


# ------------------------------------------------------------ per-frame stats


def test_frame_statistics_split_frames_a_shard(eight, tmp_path):
    """Brightness, Contrast and Sharpness in one device segment, split
    frames a shard over a ragged chunk (W=11): float32 sums over a frame,
    so within test_torch_imgproc.py's relative 1e-5 of the unsharded run
    and of the JAX package's (Brightness's sums of integers are exact at
    this size)."""
    fv = FakeVideo(_texture(11, 24, 40, 7))

    def build(sc, frame):
        return [sc.ops.Brightness(frame=frame), sc.ops.Contrast(frame=frame),
                sc.ops.Sharpness(frame=frame)], ["b", "c", "s"]

    got, one, want = _three(tmp_path, fv, build, 11)
    for g, o, w in zip(got, one, want):
        g, o, w = np.stack(g), np.stack(o), np.stack(w)
        assert g.shape == (11, 1) and np.abs(g).min() > 0
        np.testing.assert_allclose(g, o, rtol=1e-5)
        np.testing.assert_allclose(g, w, rtol=1e-5)


# ------------------------------------------------------------ the classes


def test_every_device_op_declares_its_data_class():
    """The audit of registry.py's classes: each of the package's device
    ops' class on the data mesh (ops a test registers aside). NNForward's
    follows its model; MoEHead alone runs whole."""
    from scannertools_tpu_torch.registry import all_ops

    row_local = {"Blur", "ConvertColor", "ConvertToHSV", "FlowHistogram",
                 "FrameDifference", "Histogram", "OpticalFlow", "PassFrame",
                 "Resize"}
    batch_local = {"Brightness", "CPM2", "CPM2Input", "Contrast",
                   "FasterRCNN", "MTCNNForward", "MaskRCNNForward", "NNInput",
                   "OpenPoseForward", "SSDForward", "Sharpness"}
    inner = {"FaceEmbedForward", "GenderForward"}
    classes = {n: o.data_class({}) for n, o in all_ops().items()
               if o.kind == "device"
               and o.fn.__module__.startswith("scannertools_tpu_torch.")}
    assert classes == {**dict.fromkeys(row_local, "row_local"),
                       **dict.fromkeys(batch_local, "batch_local"),
                       **dict.fromkeys(inner, "inner_split"),
                       "MoEHead": None, "NNForward": None}
    nn = all_ops()["NNForward"]
    for name in PN._NN_REGISTRY:
        assert nn.data_class({"model": name}) == "batch_local"
    assert nn.data_class({"model": "not_registered"}) is None


def test_segment_runs_by_class():
    """The executor's runs of a segment: neighbouring row- and batch-local
    ops share a run (batch_local if any op is); an inner_split op and an
    op that runs whole make runs of their own."""
    from scannertools_tpu_torch.graph import OpNode
    from scannertools_tpu_torch.runtime.executor import _data_runs

    names = ["Resize", "Histogram", "MTCNNForward", "FaceEmbedForward",
             "GenderForward", "MoEHead", "Blur", "PassFrame"]
    seg = [OpNode(n, {}, {}) for n in names]
    runs = [(cls, [n.name for n in nodes]) for cls, nodes in _data_runs(seg)]
    assert runs == [
        ("batch_local", ["Resize", "Histogram", "MTCNNForward"]),
        ("inner_split", ["FaceEmbedForward", "GenderForward"]),
        (None, ["MoEHead"]),
        ("row_local", ["Blur", "PassFrame"])]


def test_embed_prefix_below_the_shard_count(eight, tmp_path, monkeypatch):
    """EmbedFaces over 8 logical devices with GRANULE at 2: three faces in
    one frame of an 8-frame chunk at faces_budget=4 (B = 32) give FaceNet
    a batch of 4 rows, fewer than the 8 shards, which ``split_batch``
    splits into two slices of 2. The rows equal the unsharded run's
    within FACE_ATOL, and that run's over all 32 slots."""
    from test_torch_sharded_executor import CROWD, _crowd_frames

    name = "TorchTestMeshPrefixBoxes"
    if name not in st.registry._OPS:
        @st.register_python_op(name=name, outputs=("object",))
        def prefix_boxes(ctx, frames):
            return [[st.protobufs.BoundingBox(x1=a, y1=b, x2=c, y2=d,
                                              score=1.0)
                     for a, b, c, d in CROWD]
                    if np.asarray(f)[0, 0, 0] == 255 else []
                    for f in frames]

    def build(sc, frame):
        boxes = getattr(sc.ops, name)(frames=frame)
        return [sc.ops.EmbedFaces(frame=frame, bboxes=boxes,
                                  faces_budget=4)], ["embs"]

    fv = FakeVideo(_crowd_frames())
    (padded,), _ = _run(st, str(tmp_path / "padded"), fv, build, 8, 1)
    monkeypatch.setattr(PFO, "GRANULE", 2)
    batches = []
    embed = PFO.facenet_lib.embed

    def counted(state, crops):
        batches.append(len(crops))
        return embed(state, crops)

    monkeypatch.setattr(PFO.facenet_lib, "embed", counted)
    (got,), prof = _run(st, str(tmp_path / "p8"), fv, build, 8, 8)
    (one,), one_prof = _run(st, str(tmp_path / "p1"), fv, build, 8, 1)
    assert batches == [2, 2, 4]
    for p in (prof, one_prof):
        assert [iv["meta"]["n"] for iv in p.intervals("embed:crops")] == [4]
    assert [(iv["meta"]["segment"], iv["meta"]["by"], iv["meta"]["shards"])
            for iv in prof.intervals("axis:data:engaged")] == [
        ("FaceEmbedForward", "inner_split", 8)]
    assert [len(e) for e in got] == [3] + [0] * 7
    assert np.abs(got[0]).sum(axis=1).all()
    for a, b, c in zip(got, one, padded):
        np.testing.assert_allclose(a, b, rtol=0, atol=FACE_ATOL)
        np.testing.assert_allclose(a, c, rtol=0, atol=FACE_ATOL)


@pytest.mark.parametrize("rows,slices", [(1, [1]), (3, [3]), (5, [3, 2]),
                                         (8, [2, 2, 2, 2]),
                                         (11, [3, 3, 3, 2])])
def test_split_batch_slices(rows, slices):
    """split_batch over a mesh of 4: contiguous slices at most one row
    apart, two rows or more each (fewer slices than devices for a small
    batch), slice k through states[k] on the k-th device, the rows and a
    tuple's members gathered in order."""
    from scannertools_tpu_torch.parallel.sharded import split_batch

    m = mesh.Mesh([torch.device("cpu")] * 4, ("data",))
    x = torch.arange(rows * 3, dtype=torch.float32).reshape(rows, 3)
    seen = []

    def fn(state, part):
        seen.append((state, len(part)))
        return part * state, part.sum(dim=1)

    got, sums = split_batch(fn, [10.0, 20.0, 30.0, 40.0], x, m)
    assert seen == list(zip([10.0, 20.0, 30.0, 40.0], slices))
    scale = torch.repeat_interleave(
        torch.tensor([10.0, 20.0, 30.0, 40.0][:len(slices)]),
        torch.tensor(slices))
    assert torch.equal(got, x * scale[:, None])
    assert torch.equal(sums, x.sum(dim=1))
    with pytest.raises(ValueError, match="3 weight copies for 4 devices"):
        split_batch(fn, [1.0, 2.0, 3.0], x, m)
