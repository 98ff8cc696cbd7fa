"""The port's executor over a frame-sharded data mesh
(``PerfParams(pipeline_instances_per_node)``: 8 logical CPU devices) and
its static multi-process job slicing, held to the JAX package's executor
on the session's 8 virtual CPU devices (tests/conftest.py) and to the
port's unsharded runs.

Histograms and frame differences are exact, so every comparison of them
is bit for bit, ragged tail chunks included; the flow pair stencil is
held to the port's own unsharded run with ``==``: each shard computes its
rows with the same arithmetic. ``Histogram`` launches one kernel call per
shard and chunk (here the plain version: CPU tensors). A segment holding
an op that is neither row- nor batch-local (MoEHead) runs whole, and its
rows equal the unsharded run's and the JAX package's; the face nets with
their chunk-wide crop budget stay whole and split only their compacted
crop batch (tests/test_torch_data_mesh_nets.py holds the nets split
frames a shard)."""

import numpy as np
import pytest
import torch

import scannertools_tpu as jst
import scannertools_tpu_torch as st
from scannertools_tpu_torch.io.video import VideoMetadata
from scannertools_tpu_torch.ops import histogram as H
from scannertools_tpu_torch.parallel import mesh, sharded
from scannertools_tpu_torch.utils.flags import current_mesh, sharded_mode
from scannertools_tpu_torch.utils.framechunk import FrameChunk


class FakeVideo:
    is_video = True

    def __init__(self, frames):
        self.frames = frames

    def __len__(self):
        return len(self.frames)

    def metadata(self):
        n, h, w, _ = self.frames.shape
        return VideoMetadata("fake", n, 24.0, w, h)

    def decoder(self):
        return self

    def read_frames(self, idxs, out=None):
        data = self.frames[list(idxs)]
        if out is not None:
            out[:] = data
            return out
        return data

    def close(self):
        pass


def _shots(n=24, h=16, w=128, seed=0):
    """Seeded noise with three flat-colour shots, so boundaries exist."""
    x = np.random.default_rng(seed).integers(0, 64, (n, h, w, 3), np.uint8)
    for i, c in enumerate((0, 90, 180)):
        x[i * n // 3:(i + 1) * n // 3] += np.uint8(c)
    return x


@pytest.fixture()
def eight(monkeypatch):
    monkeypatch.setenv(mesh.LOGICAL_DEVICES_ENV, "8")


def _port_run(tmp_path, fv, W, inst, tag):
    sc = st.Client(db_path=str(tmp_path / f"port{tag}"), device="cpu")
    frame = sc.io.Input([fv])
    hist = sc.ops.Histogram(frame=frame)
    bounds = sc.ops.ShotBoundaries(histograms=hist)
    oh, ob = st.NamedStream(sc, "h"), st.NamedStream(sc, "b")
    H.hist_rgb.launches = 0
    sc.run(sc.io.Output([hist, bounds], [(oh, ob)]),
           st.PerfParams.manual(work_packet_size=W,
                                pipeline_instances_per_node=inst),
           cache_mode=st.CacheMode.Overwrite)
    return (np.stack([np.stack(r) for r in oh.load()]),
            list(ob.load(rows=[0])), sc.profiler.counts())


def _jax_run(tmp_path, fv, W, tag):
    sc = jst.Client(db_path=str(tmp_path / f"jax{tag}"))
    frame = sc.io.Input([fv])
    hist = sc.ops.Histogram(frame=frame)
    bounds = sc.ops.ShotBoundaries(histograms=hist)
    oh, ob = jst.NamedStream(sc, "h"), jst.NamedStream(sc, "b")
    sc.run(sc.io.Output([hist, bounds], [(oh, ob)]),
           jst.PerfParams.manual(work_packet_size=W,
                                 pipeline_instances_per_node=8),
           cache_mode=jst.CacheMode.Overwrite)
    return (np.stack([np.stack(r) for r in oh.load()]),
            list(ob.load(rows=[0])))


@pytest.mark.parametrize("W", [16, 9])
def test_sharded_histogram_shots_match_jax(eight, tmp_path, W):
    """tests/test_parallel.py's graph (24 frames, W=16 and the ragged
    W=9: chunks of 9, 9, 6 over 8 devices) against the JAX package's
    8-device run and the port's unsharded run."""
    fv = FakeVideo(_shots())
    got_h, got_b, counts = _port_run(tmp_path, fv, W, 8, "8")
    want_h, want_b = _jax_run(tmp_path, fv, W, "8")
    one_h, one_b, _ = _port_run(tmp_path, fv, W, 1, "1")
    assert got_h.dtype == want_h.dtype and (got_h == want_h).all()
    assert (got_h == one_h).all()
    assert got_b == want_b == one_b and len(want_b[0]) > 0
    assert counts["axis:data:engaged"] == -(-24 // W)
    assert "axis:data:not_engaged" not in counts


def test_histogram_launches_once_per_shard_per_chunk(eight, tmp_path):
    fv = FakeVideo(_shots())
    _port_run(tmp_path, fv, 9, 8, "a")
    assert H.hist_rgb.launches == 0  # CPU tensors: the plain version
    calls = []
    orig = H._histogram_local

    def spy(frames):
        calls.append((len(frames), sharded_mode.get()))
        return orig(frames)

    H._histogram_local = spy
    try:
        _port_run(tmp_path, fv, 9, 8, "b")
    finally:
        H._histogram_local = orig
    # 3 chunks (9, 9, 6 rows -> 2, 2, 1 rows a shard) x 8 shards
    assert [c[0] for c in calls] == [2] * 16 + [1] * 8
    assert all(c[1] for c in calls)


@pytest.mark.parametrize("W", [8, 5])
def test_frame_difference_stencil_across_shards(eight, tmp_path, W):
    frames = np.random.default_rng(3).integers(0, 256, (13, 12, 20, 3),
                                               np.uint8)
    fv = FakeVideo(frames)
    rows = {}
    for inst in (8, 1):
        sc = st.Client(db_path=str(tmp_path / f"fd{inst}"), device="cpu")
        fd = sc.ops.FrameDifference(frames=sc.io.Input([fv]))
        out = st.NamedStream(sc, "fd")
        sc.run(sc.io.Output(fd, [out]),
               st.PerfParams.manual(work_packet_size=W,
                                    pipeline_instances_per_node=inst),
               cache_mode=st.CacheMode.Overwrite)
        rows[inst] = np.stack(list(out.load()))
    jsc = jst.Client(db_path=str(tmp_path / "jfd"))
    jfd = jsc.ops.FrameDifference(frames=jsc.io.Input([fv]))
    jout = jst.NamedStream(jsc, "fd")
    jsc.run(jsc.io.Output(jfd, [jout]),
            jst.PerfParams.manual(work_packet_size=W,
                                  pipeline_instances_per_node=8),
            cache_mode=jst.CacheMode.Overwrite)
    want = np.stack(list(jout.load()))
    assert (rows[8] == rows[1]).all() and (rows[8] == want).all()


def _texture(n=7, h=32, w=40):
    rng = np.random.default_rng(11)
    big = rng.integers(0, 256, (h, w + n + 4, 3)).astype(np.float32)
    k = np.ones(5, np.float32) / 5
    for ax in (0, 1):
        big = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), ax,
                                  big)
    big = big.astype(np.uint8)
    return np.stack([big[:, i:i + w] for i in range(n)])


def test_flow_pair_stencil_sharded_equals_unsharded(eight, tmp_path):
    """OpticalFlow's pairs (stencil (0, 1)) over 8 shards of a ragged
    chunk: each shard reads its successor's first frame, the last shard
    the chunk's decoded halo."""
    fv = FakeVideo(_texture())
    rows = {}
    for inst in (8, 1):
        sc = st.Client(db_path=str(tmp_path / f"flow{inst}"), device="cpu")
        flow = sc.ops.OpticalFlow(frames=sc.io.Input([fv]), levels=1,
                                  iters=1, out_dtype="float32")
        out = st.NamedStream(sc, "flow")
        sc.run(sc.io.Output(flow, [out]),
               st.PerfParams.manual(work_packet_size=5,
                                    pipeline_instances_per_node=inst),
               cache_mode=st.CacheMode.Overwrite)
        rows[inst] = np.stack(list(out.load()))
    assert rows[8].shape == (7, 32, 40, 2)
    assert np.array_equal(rows[8], rows[1])
    assert np.abs(rows[1]).max() > 0.1


@pytest.mark.parametrize("fmt", ["rgb", "i420"])
def test_executor_histogram_segment_sharded_rgb_and_i420(eight, fmt):
    """The executor's segment runner on one 11-frame chunk over a data
    mesh of 4 (padded to 12, 3 frames a shard, the rows gathered and cut
    back to 11) against the same segment unsharded and the plain
    histogram: a FrameChunk of either format, as phase 11 times it."""
    from scannertools_tpu_torch.graph import InputNode, NodeOutput, OpNode
    from scannertools_tpu_torch.runtime.context import OpContext
    from scannertools_tpu_torch.runtime.executor import Executor, _Value

    rng = np.random.default_rng(5)
    if fmt == "rgb":
        chunk = FrameChunk.from_hwc(
            rng.integers(0, 256, (11, 8, 10, 3), np.uint8)).device("cpu")
        want = H.hist_rgb_plain(chunk.flat, chunk.npix)
    else:
        chunk = FrameChunk.from_i420(
            rng.integers(0, 256, (11, 8 * 10 * 3 // 2), np.uint8), 8,
            10).device("cpu")
        want = H.hist_i420_plain(chunk.flat, 8, 10)
    src = InputNode([])
    node = OpNode("Histogram", {"frame": NodeOutput(src, 0)}, {})
    need = {src.id: (0, 0), node.id: (0, 0)}
    ex = Executor(st.Client(db_path="unused", device="cpu"))
    ctx = OpContext(profiler=ex.profiler, device=ex.device)
    got = {}
    for m in (sharded.data_mesh(4, "cpu"), None):
        ex._mesh = m
        values = {(src.id, 0): _Value(chunk, 0, 0, True)}
        ex._run_device_segment([node], need, values, ctx, 11)
        got[m is None] = values[(node.id, 0)].data
    assert got[False].shape == (11, 3, 16)
    assert torch.equal(got[False], want) and torch.equal(got[True], want)
    counts = ex.profiler.counts()
    assert counts["axis:data:engaged"] == 1
    assert "axis:data:not_engaged" not in counts


def test_sharded_histogram_refuses_a_shard_off_the_mesh():
    m = mesh.Mesh([torch.device("meta")] * 2, ("data",))
    chunk = FrameChunk.from_hwc(np.zeros((2, 4, 4, 3), np.uint8))
    t1, t2 = sharded_mode.set(True), current_mesh.set(m)
    try:
        with pytest.raises(ValueError, match="off the data mesh"):
            H.histogram(None, chunk.device("cpu"))
    finally:
        sharded_mode.reset(t1)
        current_mesh.reset(t2)


def test_one_device_data_mesh_is_counted_not_engaged(monkeypatch,
                                                      tmp_path):
    monkeypatch.delenv(mesh.LOGICAL_DEVICES_ENV, raising=False)
    fv = FakeVideo(_shots(n=6))
    got, _, counts = _port_run(tmp_path, fv, 4, 8, "one")
    want, _, _ = _port_run(tmp_path, fv, 4, 1, "ref")
    assert (got == want).all()
    assert counts.get("axis:data:not_engaged") == 1
    assert "axis:data:engaged" not in counts


def test_row_coupled_and_cpu_segments_stay_unsharded(eight, tmp_path):
    """MoEHead couples a chunk's rows (capacity ranks) and is not declared
    row-local: its segment runs whole, counted; a segment forced to the
    CPU stays unsharded, as in the JAX package."""
    frames = np.random.default_rng(9).integers(0, 256, (6, 4, 4, 3),
                                               np.uint8)
    fv = FakeVideo(frames)
    rows = {}
    for inst in (8, 1):
        sc = st.Client(db_path=str(tmp_path / f"moe{inst}"), device="cpu")
        frame = sc.io.Input([fv])
        y = sc.ops.MoEHead(input=frame, n_experts=4, d_model=48,
                           d_hidden=16)
        hsv = sc.ops.ConvertToHSV(frame=frame, device=st.DeviceType.CPU)
        oy, oh = st.NamedStream(sc, "y"), st.NamedStream(sc, "hsv")
        sc.run(sc.io.Output([y, hsv], [(oy, oh)]),
               st.PerfParams.manual(work_packet_size=6,
                                    pipeline_instances_per_node=inst),
               cache_mode=st.CacheMode.Overwrite)
        rows[inst] = (np.stack(list(oy.load())), np.stack(list(oh.load())),
                      sc.profiler.counts())
    assert np.array_equal(rows[8][0], rows[1][0])
    assert np.array_equal(rows[8][1], rows[1][1])
    assert rows[8][2]["axis:data:not_engaged"] == 1
    assert "axis:data:engaged" not in rows[8][2]


CROWD = ((0.0, 0.0, 0.5, 0.5), (0.5, 0.0, 1.0, 0.6), (0.1, 0.4, 0.8, 1.0))


def _crowd_frames(n=8, h=48, w=64):
    """Seeded noise below 200; frame 0's first byte is 255, the mark the
    box op below reads: three faces in frame 0, none in the others."""
    x = np.random.default_rng(13).integers(0, 200, (n, h, w, 3), np.uint8)
    x[0, 0, 0, 0] = 255
    return x


def _crowd_graph(pkg, db, fv, gender_npz, inst, embed):
    """Boxes of CROWD in the marked frame only -> DetectGender (and the
    port's EmbedFaces) with faces_budget=1 over one chunk of 8 frames:
    8 crop slots for the chunk, 1 for a frame of a shard."""
    name = "TorchTestCrowdBoxes"
    if name not in pkg.registry._OPS:
        bb = pkg.protobufs.BoundingBox

        @pkg.register_python_op(name=name, outputs=("object",))
        def crowd_boxes(ctx, frames):
            return [[bb(x1=a, y1=b, x2=c, y2=d, score=1.0)
                     for a, b, c, d in CROWD]
                    if np.asarray(f)[0, 0, 0] == 255 else []
                    for f in frames]

    kw = dict(device="cpu") if pkg is st else {}
    sc = pkg.Client(db_path=db, **kw)
    frame = sc.io.Input([fv])
    boxes = getattr(sc.ops, name)(frames=frame)
    cols = [sc.ops.DetectGender(frame=frame, bboxes=boxes, faces_budget=1,
                                weights_path=gender_npz)]
    if embed:
        cols.append(sc.ops.EmbedFaces(frame=frame, bboxes=boxes,
                                      faces_budget=1))
    outs = tuple(pkg.NamedStream(sc, f"c{i}") for i in range(len(cols)))
    sc.run(sc.io.Output(cols, [outs]),
           pkg.PerfParams.manual(work_packet_size=8,
                                 pipeline_instances_per_node=inst),
           cache_mode=pkg.CacheMode.Overwrite)
    return [list(o.load()) for o in outs], getattr(sc, "profiler", None)


def test_face_budget_segments_stay_whole_on_the_data_mesh(eight, tmp_path):
    """GenderForward and FaceEmbedForward take the first faces_budget*T
    valid crops of the WHOLE chunk, so a crowded frame beside empty ones
    needs the chunk's budget: under pipeline_instances_per_node=8 their
    segments stay whole (``inner_split``: the compaction runs on the
    client's device) and split only the compacted crop batch over the
    mesh (counted engaged, by "inner_split"), every face of the crowded
    frame is classified and embedded, and the rows equal the port's
    unsharded run and (genders) the JAX package's 8-device run on the
    same weights."""
    import jax

    from scannertools_tpu.models import gender as JG
    from scannertools_tpu.models import weights as JW

    npz = str(tmp_path / "gender.npz")
    JW.save_params(npz, JG.init_params(jax.random.PRNGKey(0)))
    fv = FakeVideo(_crowd_frames())
    (g8, e8), prof = _crowd_graph(st, str(tmp_path / "p8"), fv, npz, 8,
                                  True)
    (g1, e1), _ = _crowd_graph(st, str(tmp_path / "p1"), fv, npz, 1, True)
    (jg,), _ = _crowd_graph(jst, str(tmp_path / "j8"), fv, npz, 8, False)
    assert [len(r) for r in g8] == [3] + [0] * 7
    assert g8 == g1 == jg
    assert e8[0].shape == (3, 128) and np.abs(e8[0]).sum(axis=1).all()
    assert all(np.array_equal(a, b) for a, b in zip(e8, e1))
    counts = prof.counts()
    assert counts["axis:data:engaged"] == 2
    assert "axis:data:not_engaged" not in counts
    assert sorted((iv["meta"]["segment"], iv["meta"]["by"])
                  for iv in prof.intervals("axis:data:engaged")) == [
        ("FaceEmbedForward", "inner_split"),
        ("GenderForward", "inner_split")]


def test_static_slices_over_two_processes(tmp_path, monkeypatch):
    """RANK/WORLD_SIZE 0/2 and 1/2 each run their half of 4 jobs into one
    db; the union of their rows equals a lone process's."""
    videos = [FakeVideo(_shots(n=6, seed=j)) for j in range(4)]

    def run(db, rank=None):
        if rank is None:
            monkeypatch.delenv("RANK", raising=False)
            monkeypatch.delenv("WORLD_SIZE", raising=False)
        else:
            monkeypatch.setenv("RANK", str(rank))
            monkeypatch.setenv("WORLD_SIZE", "2")
        sc = st.Client(db_path=str(tmp_path / db), device="cpu")
        hist = sc.ops.Histogram(frame=sc.io.Input(videos))
        outs = [st.NamedStream(sc, f"h{j}") for j in range(4)]
        sc.run(sc.io.Output(hist, outs),
               st.PerfParams.manual(work_packet_size=4),
               cache_mode=st.CacheMode.Overwrite)
        return outs

    run("multi", 0)
    half = [o.committed() for o in run("multi", 0)]
    assert half == [True, True, False, False]
    outs = run("multi", 1)
    whole = run("single")
    for a, b in zip(outs, whole):
        assert a.committed()
        assert [np.stack(r).tobytes() for r in a.load()] == \
            [np.stack(r).tobytes() for r in b.load()]
