"""The executor's one-packet pipeline on the CPU: a chunk's host tail (the
ops after its last device op, and its sink writes) runs after the next
chunk's device part, in chunk order.

Tiny ``Client(device="cpu")`` runs over frames in memory, several chunks
a job. The stored rows are held to the references the histogram, pose
and face tests use: ``histogram_reference_np``, and the pose and face op
pairs called a chunk at a time (their nets replaced by stand-ins of the
same shapes, as in ``test_torch_profiler_tracing.py``). The spans and
counters say when each part ran. The card's side (its streams and
events) is ``test_torch_executor_pipeline_cuda.py``.
"""

import pickle
import threading

import numpy as np
import pytest
import torch

import scannertools_tpu_torch as st
from scannertools_tpu.ops.histogram import histogram_reference_np
from scannertools_tpu_torch import protobufs
from scannertools_tpu_torch.graph import toposort
from scannertools_tpu_torch.io.video import VideoMetadata
from scannertools_tpu_torch.models import facenet as facenet_lib
from scannertools_tpu_torch.models import pose as pose_lib
from scannertools_tpu_torch.ops import faces as faces_ops
from scannertools_tpu_torch.ops import pose as pose_ops
from scannertools_tpu_torch.ops.histogram import histogram as histogram_op
from scannertools_tpu_torch.ops.shot_detection import shot_boundaries
from scannertools_tpu_torch.registry import register_op
from scannertools_tpu_torch.runtime.context import OpContext
from scannertools_tpu_torch.runtime.executor import _Tail, _tail_start
from scannertools_tpu_torch.runtime.profiler import Profiler


class MemoryVideo:
    """Frames in memory behind the executor's decoder interface."""

    is_video = True

    def __init__(self, frames):
        self.frames = frames

    def __len__(self):
        return len(self.frames)

    def metadata(self):
        n, h, w, _ = self.frames.shape
        return VideoMetadata("memory", n, 24.0, w, h)

    def decoder(self):
        return self

    def read_frames(self, idxs, out=None):
        data = self.frames[list(idxs)]
        if out is None:
            return data
        out[...] = data
        return out

    def close(self):
        pass


def _frames(n=6, h=24, w=32, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3),
                                                np.uint8)


def _packets(n, W, jobs=1):
    return {(j, a, min(W, n - a)) for j in range(jobs)
            for a in range(0, n, W)}


def _key(iv):
    m = iv["meta"]
    return m["job"], m["row"], m["rows"]


def _perf(W=2, **kw):
    return st.PerfParams.manual(work_packet_size=W, io_packet_size=W, **kw)


def _run(sc, columns, streams, perf=None, cache_mode=st.CacheMode.Overwrite):
    sc.run(sc.io.Output(columns, streams), perf or _perf(),
           cache_mode=cache_mode)


# ------------------------------------------------------------ test ops

@register_op("PipelineTestTotals", kind="host", outputs=("object",))
def _totals(ctx, histograms):
    """Each row's histogram summed per channel."""
    return [np.asarray(h).sum(axis=-1).tolist() for h in histograms]


def _running_init(ctx):
    return {"sum": 0}


@register_op("PipelineTestRunning", kind="stateful", outputs=("object",),
             init_state=_running_init)
def _running(ctx, state, histograms):
    """The running sum of the histograms' first bins, carried chunk to
    chunk."""
    out = []
    for h in histograms:
        state["sum"] += int(np.asarray(h)[:, 0].sum())
        out.append(state["sum"])
    return state, out


@register_op("PipelineTestFrameSums", kind="host", outputs=("object",))
def _frame_sums(ctx, frame):
    """Each host frame's byte sum: keeps the frames on the host."""
    return [int(np.asarray(f, np.int64).sum()) for f in frame]


@register_op("PipelineTestBrightness", kind="host", outputs=("object",))
def _brightness(ctx, frame):
    """Each host frame's byte sum, for graphs without a device op."""
    return [int(np.asarray(f, np.int64).sum()) for f in frame]


FAULT = {"row": None, "ran": []}


@register_op("PipelineTestFaultyHistogram", kind="device",
             outputs=("histogram",))
def _faulty_histogram(ctx, frames):
    """Histogram, raising at the chunk that starts at ``FAULT["row"]``."""
    FAULT["ran"].append(ctx.packet["row"])
    if ctx.packet["row"] == FAULT["row"]:
        raise RuntimeError("planted fault")
    return histogram_op(ctx, frames)


# ------------------------------------------------------- the split itself

def _order(sc, build):
    frame = sc.io.Input([MemoryVideo(_frames(n=2))])
    cols = build(sc, frame)
    return toposort(sc.io.Output(cols, [st.NamedStream(sc, "x")] *
                                 len(cols)))


@pytest.mark.parametrize("build,tail_ops,reason", [
    (lambda sc, f: [sc.ops.Histogram(frame=f)], [], "no host tail"),
    (lambda sc, f: [sc.ops.PipelineTestBrightness(frame=f)], [],
     "no device op"),
    (lambda sc, f: [sc.ops.PipelineTestTotals(
        histograms=sc.ops.Histogram(frame=f))], ["PipelineTestTotals"],
     None),
    (lambda sc, f: [sc.ops.ShotBoundaries(
        histograms=sc.ops.Histogram(frame=f))], ["ShotBoundaries"], None),
    (lambda sc, f: [sc.ops.Histogram(frame=f),
                    sc.ops.PipelineTestFrameSums(frame=f)],
     ["PipelineTestFrameSums"], None),
    # the benchmark's graphs: FaceEmbeddingPipeline storing the faces too
    # (MTCNNDecode feeds only that sink: EmbedFaces reads MTCNN's device
    # boxes), and PoseDetectionPipeline
    (lambda sc, f: (lambda m: [sc.ops.EmbedFaces(frame=f, bboxes=m), m])(
        sc.ops.MTCNNDetectFaces(frame=f)), ["EmbedDecode", "MTCNNDecode"],
     None),
    (lambda sc, f: [sc.ops.OpenPose(frame=f)], ["OpenPoseDecode"], None),
])
def test_the_tail_is_what_follows_the_last_device_op(tmp_path, build,
                                                     tail_ops, reason):
    sc = st.Client(db_path=str(tmp_path / "db"), device="cpu")
    order = _order(sc, build)
    split, why = _tail_start(order)
    assert why == reason
    assert [getattr(n, "name", None) for n in order[split:]
            if getattr(n, "name", None) in tail_ops] == tail_ops
    if reason is not None:
        assert split == len(order)


# ---------------------------------------------------- histogram graphs

@pytest.fixture
def hist_shots(tmp_path):
    """Histogram -> ShotBoundaries over two memory videos of 7 frames in
    packets of 2 (the last short), both columns stored."""
    def run(**perf):
        sc = st.Client(db_path=str(tmp_path / "db"), device="cpu")
        frames = [_frames(n=7, seed=s) for s in (0, 1)]
        frame = sc.io.Input([MemoryVideo(f) for f in frames])
        hist = sc.ops.Histogram(frame=frame)
        bounds = sc.ops.ShotBoundaries(histograms=hist)
        outs = [(st.NamedStream(sc, f"h{i}"), st.NamedStream(sc, f"b{i}"))
                for i in range(2)]
        _run(sc, [hist, bounds], outs, _perf(**perf))
        return sc.profiler, frames, outs
    return run


def test_multi_column_rows_with_a_whole_stream_tail(hist_shots):
    _, frames, outs = hist_shots()
    for f, (h, b) in zip(frames, outs):
        want = histogram_reference_np(f)
        assert (np.stack([np.stack(r) for r in h.load()]) == want).all()
        # the stream's first row holds the boundaries, the others None
        assert list(b.load_bytes()) == [
            b"" if el is None else pickle.dumps(el)
            for el in shot_boundaries(None, want)]


def test_deferred_tails_count_all_chunks_but_the_last(hist_shots):
    prof, _, _ = hist_shots()
    ivs = prof.intervals("pipeline:deferred_tail")
    assert sorted(map(_key, ivs)) == sorted(
        k for k in _packets(7, 2, jobs=2) if k[1] != 6)
    assert "pipeline:not_engaged" not in prof.counts()


def test_next_device_part_starts_before_the_tail_ends(hist_shots):
    """Chunk n+1's device span opens before chunk n's tail copies end:
    here the tail is the copies into ShotBoundaries and the sink."""
    prof, _, _ = hist_shots()
    dev = {_key(iv): iv for iv in prof.intervals("device:Histogram")}
    waits = {}
    for iv in prof.intervals("host:wait_device"):
        waits.setdefault(_key(iv), []).append(iv)
    for (job, a, _), ws in waits.items():
        nxt = [iv for k, iv in dev.items() if k[0] == job and k[1] == a + 2]
        if not nxt:  # the job's last chunk
            continue
        assert nxt[0]["ts"] < min(w["ts"] + w["dur"] for w in ws)


@pytest.mark.parametrize("name", ["host:wait_device", "sink:write"])
def test_tail_spans_carry_their_own_chunk(hist_shots, name):
    prof, _, _ = hist_shots()
    assert {_key(iv) for iv in prof.intervals(name)} == _packets(7, 2, jobs=2)


ROW_KEYS = ("job", "row", "rows")
#: what one chunk of the hist_shots graph records, on the CPU: the names
#: the benchmark's metrics read, each with its meta keys
CHUNK_EVENTS = sorted([
    ("source:wait_slot", ROW_KEYS), ("source:read", ROW_KEYS),
    ("source:upload", ROW_KEYS), ("device:Histogram", ROW_KEYS),
    # ShotBoundaries' accumulated input and the histogram sink's copy
    ("host:wait_device", ROW_KEYS), ("host:wait_device", ROW_KEYS),
    ("sink:write", ROW_KEYS),
])


@pytest.mark.parametrize("depth", [0, None])
def test_span_and_counter_names_per_chunk(hist_shots, tmp_path, depth):
    import json

    prof, _, _ = hist_shots(**({} if depth is None else
                               {"prefetch_depth": depth}))
    prof.write_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    chunks, per_job = {}, []
    for ev in events:
        m = ev["args"]
        if "row" in m and m["rows"] != 7:
            chunks.setdefault((m["job"], m["row"], m["rows"]), []).append(
                (ev["name"], tuple(sorted(m))))
        else:
            per_job.append((ev["name"], tuple(sorted(m.items()))))
    last = {(0, 6, 1), (1, 6, 1)}
    assert set(chunks) == _packets(7, 2, jobs=2)
    for key, got in chunks.items():
        deferred = [] if key in last else [("pipeline:deferred_tail",
                                            ROW_KEYS)]
        assert sorted(got) == sorted(CHUNK_EVENTS + deferred), key
    assert sorted(per_job) == sorted([
        ("job:run", (("job", 0),)), ("job:run", (("job", 1),)),
        ("job:warm", (("job", 1),)),
        ("op:ShotBoundaries", (("job", 0), ("row", 0), ("rows", 7))),
        ("op:ShotBoundaries", (("job", 1), ("row", 0), ("rows", 7))),
    ])
    # the slot wait ends before the read, which holds the upload
    spans = {}
    for ev in events:
        if ev["name"].startswith("source:"):
            spans[(ev["name"], ev["args"]["job"], ev["args"]["row"])] = ev
    for job, row, _ in _packets(7, 2, jobs=2):
        wait, read, up = (spans[(n, job, row)] for n in (
            "source:wait_slot", "source:read", "source:upload"))
        assert wait["ts"] + wait["dur"] <= read["ts"] <= up["ts"]
        assert up["ts"] + up["dur"] <= read["ts"] + read["dur"]


def test_a_graph_ending_on_a_device_op_keeps_todays_order(tmp_path):
    sc = st.Client(db_path=str(tmp_path / "db"), device="cpu")
    frames = [_frames(n=5, seed=s) for s in (2, 3)]
    outs = [st.NamedStream(sc, f"o{i}") for i in range(2)]
    _run(sc, sc.ops.Histogram(frame=sc.io.Input(
        [MemoryVideo(f) for f in frames])), outs)
    counts = sc.profiler.counts()
    assert counts["pipeline:not_engaged"] == 2  # once a job
    assert "pipeline:deferred_tail" not in counts
    assert {iv["meta"]["reason"] for iv in sc.profiler.intervals(
        "pipeline:not_engaged")} == {"no host tail"}
    # the chunk's sink copy runs before the next chunk's device part
    dev = {_key(iv): iv for iv in sc.profiler.intervals("device:Histogram")}
    for w in sc.profiler.intervals("host:wait_device"):
        job, a, _ = _key(w)
        nxt = dev.get((job, a + 2, min(2, 5 - a - 2)))
        if nxt is not None:
            assert w["ts"] + w["dur"] <= nxt["ts"]
    for f, o in zip(frames, outs):
        got = np.stack([np.stack(r) for r in o.load()])
        assert (got == histogram_reference_np(f)).all()


def test_a_graph_without_device_ops_is_not_engaged(tmp_path):
    sc = st.Client(db_path=str(tmp_path / "db"), device="cpu")
    frames = _frames(n=5)
    out = st.NamedStream(sc, "b")
    _run(sc, sc.ops.PipelineTestBrightness(frame=sc.io.Input(
        [MemoryVideo(frames)])), [out])
    [iv] = sc.profiler.intervals("pipeline:not_engaged")
    assert iv["meta"] == {"job": 0, "reason": "no device op"}
    assert list(out.load()) == [int(f.astype(np.int64).sum())
                                for f in frames]


def test_a_stateful_host_tail_sees_chunks_in_order(tmp_path):
    sc = st.Client(db_path=str(tmp_path / "db"), device="cpu")
    frames = _frames(n=9, seed=4)
    hist = sc.ops.Histogram(frame=sc.io.Input([MemoryVideo(frames)]))
    out = st.NamedStream(sc, "run")
    _run(sc, sc.ops.PipelineTestRunning(histograms=hist), [out])
    want = np.cumsum(histogram_reference_np(frames)[:, :, 0].sum(axis=1))
    assert list(out.load()) == want.tolist()
    assert sc.profiler.counts()["pipeline:deferred_tail"] == 4


def test_a_job_of_one_chunk_defers_nothing(tmp_path):
    sc = st.Client(db_path=str(tmp_path / "db"), device="cpu")
    frames = _frames(n=3, seed=5)
    hist = sc.ops.Histogram(frame=sc.io.Input([MemoryVideo(frames)]))
    out = st.NamedStream(sc, "t")
    _run(sc, sc.ops.PipelineTestTotals(histograms=hist), [out], _perf(W=4))
    counts = sc.profiler.counts()
    assert "pipeline:deferred_tail" not in counts
    assert "pipeline:not_engaged" not in counts
    assert counts["op:PipelineTestTotals"] == 1
    want = histogram_reference_np(frames).sum(axis=-1).tolist()
    assert list(out.load()) == want


@pytest.mark.parametrize("host_frames", [False, True])
@pytest.mark.parametrize("depth", [0, 1, None])
def test_no_deadlock_at_any_prefetch_depth(tmp_path, depth, host_frames):
    """The ring's slots at prefetch depth 0, 1 and the default, with the
    frames uploaded (released after the device part) or kept on the host
    for the tail (released after it)."""
    sc = st.Client(db_path=str(tmp_path / "db"), device="cpu")
    frames = _frames(n=11, seed=6)
    frame = sc.io.Input([MemoryVideo(frames)])
    hist = sc.ops.Histogram(frame=frame)
    cols = [sc.ops.PipelineTestTotals(histograms=hist)]
    if host_frames:
        cols.append(sc.ops.PipelineTestFrameSums(frame=frame))
    outs = [tuple(st.NamedStream(sc, f"c{i}") for i in range(len(cols)))]
    perf = {} if depth is None else {"prefetch_depth": depth}
    done = []
    worker = threading.Thread(target=lambda: done.append(
        _run(sc, cols, outs, _perf(**perf))), daemon=True)
    worker.start()
    worker.join(timeout=120)
    assert not worker.is_alive() and done
    assert sc.profiler.counts()["pipeline:deferred_tail"] == 5
    want = histogram_reference_np(frames).sum(axis=-1).tolist()
    assert list(outs[0][0].load()) == want
    if host_frames:
        assert list(outs[0][1].load()) == [int(f.astype(np.int64).sum())
                                           for f in frames]


def test_a_fault_in_the_next_device_part_keeps_the_stored_chunk(tmp_path):
    """Shard-mode resume: chunk 4's device part raises; chunks 0 and 2
    (2's tail runs as the fault unwinds) are stored as shards, and the
    resumed run computes chunk 4 alone."""
    sc = st.Client(db_path=str(tmp_path / "db"), device="cpu")
    frames = _frames(n=6, seed=7)

    def run():
        hist = sc.ops.PipelineTestFaultyHistogram(
            frame=sc.io.Input([MemoryVideo(frames)]))
        out = st.NamedStream(sc, "f")
        _run(sc, sc.ops.PipelineTestTotals(histograms=hist), [out],
             cache_mode=st.CacheMode.Resume)
        return out

    FAULT.update(row=4, ran=[])
    try:
        with pytest.raises(RuntimeError, match="planted fault"):
            run()
        assert FAULT["ran"] == [0, 2, 4]
        FAULT.update(row=None, ran=[])
        out = run()
        assert FAULT["ran"] == [4]
    finally:
        FAULT.update(row=None, ran=[])
    want = histogram_reference_np(frames).sum(axis=-1).tolist()
    assert list(out.load()) == want


# ------------------------------------------------------------- pose

def _person_stage(state, x, scales, upsample="linear", pipe_mesh=None):
    """OpenPoseForward's device side replaced: one person a frame, its
    parts placed by the frame's mean, every limb feasible between slot 0
    peaks."""
    t = x.shape[0]
    k = pose_lib.MAX_PEAKS
    shift = x.reshape(t, -1).mean(dim=1).floor() % 7
    peaks = torch.zeros((t, 18, k, 3))
    parts = torch.arange(18, dtype=torch.float32)
    peaks[:, :, 0, 0] = 10 + 2 * parts + shift[:, None]
    peaks[:, :, 0, 1] = 5 + parts
    peaks[:, :, 0, 2] = 0.9
    valid = torch.zeros((t, 18, k), dtype=torch.bool)
    valid[:, :, 0] = True
    scores = torch.full((t, pose_lib.N_LIMBS, k, k), -float("inf"))
    scores[:, :, 0, 0] = 0.8
    return peaks, valid, scores


@pytest.fixture
def pose_run(tmp_path, monkeypatch):
    monkeypatch.setattr(pose_lib, "device_stage", _person_stage)
    monkeypatch.setattr(pose_ops, "_get_params",
                        lambda *a, **k: {"w": torch.zeros(2)})

    def run(frames, W=2):
        sc = st.Client(db_path=str(tmp_path / "db"), device="cpu")
        node = sc.ops.OpenPose(frame=sc.io.Input([MemoryVideo(frames)]))
        out = st.NamedStream(sc, "poses")
        _run(sc, node, [out], _perf(W=W))
        return sc.profiler, list(out.load())
    return run


def _pose_rows(rows):
    return [[p.serialize() for p in frame] for frame in rows]


def test_pose_rows_equal_chunk_at_a_time_calls(pose_run):
    frames = _frames(n=7, seed=8)
    _, rows = pose_run(frames)
    want = []
    for a in range(0, 7, 2):
        x = torch.from_numpy(frames[a:a + 2])
        want += pose_ops.openpose_decode(
            None, *pose_ops.openpose_forward(None, {}, x))
    assert all(len(f) == 1 for f in want)
    assert _pose_rows(rows) == _pose_rows(want)


def test_pose_forward_of_the_next_chunk_precedes_the_decode(pose_run):
    prof, _ = pose_run(_frames(n=7, seed=8))
    fwd = {_key(iv): iv for iv in prof.intervals("device:OpenPoseForward")}
    dec = {_key(iv): iv for iv in prof.intervals("op:OpenPoseDecode")}
    assert set(dec) == set(fwd) == _packets(7, 2)
    for (job, a, _), d in dec.items():
        nxt = [iv for k, iv in fwd.items() if k[1] == a + 2]
        if a + 2 < 7:
            # chunk n+1's forward ran, whole, before chunk n's decode
            assert nxt[0]["ts"] + nxt[0]["dur"] <= d["ts"]
    deferred = {_key(iv) for iv in prof.intervals("pipeline:deferred_tail")}
    assert deferred == _packets(7, 2) - {(0, 6, 1)}


def test_pose_waits_stay_inside_their_own_decode(pose_run):
    prof, _ = pose_run(_frames(n=7, seed=8))
    decodes = {_key(iv): iv for iv in prof.intervals("op:OpenPoseDecode")}
    waits = prof.intervals("host:wait_device")
    assert sorted(map(_key, waits)) == sorted(decodes)
    for w in waits:
        d = decodes[_key(w)]
        assert d["ts"] <= w["ts"] and w["ts"] + w["dur"] <= d["ts"] + d["dur"]


# ------------------------------------------------------------- faces

BOXES = [[(0.1, 0.1, 0.5, 0.6)], [], [(0.2, 0.2, 0.4, 0.4),
                                      (0.5, 0.1, 0.9, 0.7)],
         [(0.0, 0.0, 1.0, 1.0)], [(0.3, 0.3, 0.6, 0.6)]]


def _boxes(rows):
    return [[protobufs.BoundingBox(x1=a, y1=b, x2=c, y2=d, score=1.0)
             for a, b, c, d in BOXES[r]] for r in rows]


@register_op("PipelineTestBoxes", kind="host", outputs=("bboxes",))
def _test_boxes(ctx, frame):
    start = ctx.packet["row"]
    return _boxes(range(start, start + len(frame)))


def _stub_embed(aux, crops):
    return crops.mean(dim=(1, 2, 3))[:, None].expand(-1, 128).contiguous()


def test_face_rows_equal_chunk_at_a_time_calls(tmp_path, monkeypatch):
    """MTCNN's place taken by a host op of known boxes (in the device
    part), FaceNet by a stand-in; the tail is EmbedDecode and both
    sinks."""
    monkeypatch.setattr(faces_ops, "_get_params",
                        lambda *a, **k: {"w": torch.zeros(1)})
    monkeypatch.setattr(facenet_lib, "embed", _stub_embed)
    frames = _frames(n=5, h=48, w=64, seed=9)
    sc = st.Client(db_path=str(tmp_path / "db"), device="cpu")
    frame = sc.io.Input([MemoryVideo(frames)])
    boxes = sc.ops.PipelineTestBoxes(frame=frame)
    embs = sc.ops.EmbedFaces(frame=frame, bboxes=boxes, faces_budget=2)
    outs = [(st.NamedStream(sc, "e"), st.NamedStream(sc, "b"))]
    _run(sc, [embs, boxes], outs)
    counts = sc.profiler.counts()
    assert counts["pipeline:deferred_tail"] == 2
    want = []
    for a in range(0, 5, 2):
        nb, v = faces_ops.bboxes_to_padded(None, _boxes(range(a, min(a + 2,
                                                                  5))))
        fwd = faces_ops.face_embed_forward(
            None, {}, torch.from_numpy(frames[a:a + 2]),
            torch.from_numpy(nb), torch.from_numpy(v), faces_budget=2)
        want += faces_ops.embed_decode(None, *(x.numpy() for x in fwd))
    got = list(outs[0][0].load())
    assert len(got) == 5
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g).reshape(-1, 128), w)
    stored = [[(b.x1, b.y1, b.x2, b.y2) for b in r]
              for r in outs[0][1].load()]
    assert stored == [[tuple(np.float32(c) for c in b) for b in r]
                      for r in BOXES]
    # the decode ran after the next chunk's forward, with its own meta
    fwd = {_key(iv): iv for iv in sc.profiler.intervals(
        "device:FaceEmbedForward")}
    for d in sc.profiler.intervals("op:EmbedDecode"):
        job, a, _ = _key(d)
        nxt = [iv for k, iv in fwd.items() if k[1] == a + 2]
        if nxt:
            assert nxt[0]["ts"] < d["ts"]


# --------------------------------------------- the tail's wait, alone

def test_settle_runs_inside_each_wait_span():
    prof = Profiler()
    ctx = OpContext(job=1, profiler=prof)
    ctx.packet = {"job": 1, "row": 4, "rows": 2}
    calls = []
    ctx.settle = lambda: calls.append(len(prof.intervals(
        "host:wait_device")))
    with ctx.wait_device():
        pass
    with ctx.wait_device():
        pass
    # called at each wait's start, before its span closed
    assert calls == [0, 1]
    assert [iv["meta"] for iv in prof.intervals("host:wait_device")] == \
        [{"job": 1, "row": 4, "rows": 2}] * 2


def test_a_tail_off_cuda_runs_with_its_packet_and_no_settle():
    ctx = OpContext(job=0)
    tail = _Tail(4, 2, {"job": 0, "row": 4, "rows": 2}, {})
    tail.defer(None)
    with tail.running(ctx):
        assert ctx.packet == {"job": 0, "row": 4, "rows": 2}
        assert ctx.settle is None
    assert tail.ready is None and tail.stream is None
