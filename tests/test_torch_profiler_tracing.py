"""The port's profiler on its own clock: device-stream spans (``stream:``)
from CUDA event pairs, the executor's waits on the device
(``host:wait_device``), first-use loads (``load:``), FaceNet's crop
counters (``embed:crops``, ``embed:faces``) and the packet meta every
span of a packet carries.

The event arithmetic runs here on a fake event class; the executor's
spans on tiny ``Client(device="cpu")`` runs over frames in memory, the
nets' forwards replaced by stand-ins of the same shapes (the spans and
counters do not depend on the weights). A run on the CPU records no
``stream:`` interval. The card's own stream spans are checked by the
``cuda`` test at the end (and by the benchmark's clock check).
"""

import json

import numpy as np
import pytest
import torch

import scannertools_tpu_torch as st
from scannertools_tpu_torch import protobufs
from scannertools_tpu_torch.io.video import VideoMetadata
from scannertools_tpu_torch.models import facenet as facenet_lib
from scannertools_tpu_torch.models import pose as pose_lib
from scannertools_tpu_torch.ops import faces as faces_ops
from scannertools_tpu_torch.ops import pose as pose_ops
from scannertools_tpu_torch.registry import register_op
from scannertools_tpu_torch.runtime import profiler as profiler_mod
from scannertools_tpu_torch.runtime.context import OpContext
from scannertools_tpu_torch.runtime.profiler import Profiler

PACKET_KEYS = {"job", "row", "rows"}


# ------------------------------------------------------------ fake events

class FakeClock:
    """The card's event clock and the host's perf_counter, in seconds,
    set by the test."""

    def __init__(self):
        self.device = 100.0
        self.host = 5.0
        self.syncs = 0


class FakeEvent:
    clock: FakeClock = None

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.t = None
        self.done = False

    def record(self, stream=None):
        self.t = self.clock.device

    def query(self):
        return self.done

    def synchronize(self):
        self.clock.syncs += 1
        self.done = True

    def elapsed_time(self, other):
        # a stream reaches its events in order: the later one done means
        # the earlier is too
        assert (self.done or other.done) and None not in (self.t, other.t)
        return (other.t - self.t) * 1e3


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    monkeypatch.setattr(FakeEvent, "clock", c)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(profiler_mod.time, "perf_counter", lambda: c.host)
    return c


def _span(prof, clock, name, start, end, device="cuda:0", **meta):
    """A stream span whose events the card reaches at ``start`` and
    ``end`` (device seconds)."""
    clock.device = start
    with prof.stream_span(name, torch.device(device), **meta):
        clock.device = end
    return prof._pending[-1]


def test_stream_span_maps_device_time_to_the_host_clock(clock):
    prof = Profiler()  # t0 = 5.0
    prof.calibrate(torch.device("cuda:0"))  # device 100.0 <-> host 5.0
    clock.host = 9.0  # the host clock moves on; nothing reads it now
    _span(prof, clock, "stream:Op", 100.25, 100.75, job=0, row=8, rows=4)
    [iv] = prof.intervals("stream:Op")
    assert iv["ts"] == pytest.approx(0.25e6)
    assert iv["dur"] == pytest.approx(0.5e6)
    assert iv["track"] == "cuda:0"
    assert iv["meta"] == {"job": 0, "row": 8, "rows": 4}


def test_calibration_is_taken_after_the_event_is_reached(clock):
    prof = Profiler()
    syncs = clock.syncs
    prof.calibrate(torch.device("cuda:0"))
    assert clock.syncs == syncs + 1
    cal, t_cal = prof._cal["cuda:0"]
    assert cal.done and cal.t == 100.0 and t_cal == 5.0


def test_each_span_keeps_the_calibration_it_was_recorded_under(clock):
    prof = Profiler()
    prof.calibrate(torch.device("cuda:0"))
    _span(prof, clock, "stream:A", 101.0, 102.0)
    # a later job calibrates again: device 200.0 <-> host 50.0
    clock.device, clock.host = 200.0, 50.0
    prof.calibrate(torch.device("cuda:0"))
    _span(prof, clock, "stream:B", 201.0, 203.0)
    [a] = prof.intervals("stream:A")
    [b] = prof.intervals("stream:B")
    assert a["ts"] == pytest.approx(1e6) and a["dur"] == pytest.approx(1e6)
    assert b["ts"] == pytest.approx(46e6) and b["dur"] == pytest.approx(2e6)


def test_poll_resolves_finished_pairs_without_waiting(clock):
    prof = Profiler()
    prof.calibrate(torch.device("cuda:0"))
    syncs = clock.syncs
    first = _span(prof, clock, "stream:A", 100.1, 100.2)
    second = _span(prof, clock, "stream:B", 100.3, 100.4)
    second[3].done = second[4].done = True
    prof.poll()
    assert clock.syncs == syncs
    assert [p[0] for p in prof._pending] == ["stream:A"]
    assert [iv["name"] for iv in prof._intervals] == ["stream:B"]
    first[3].done = first[4].done = True
    prof.poll()
    assert prof._pending == [] and clock.syncs == syncs
    assert sorted(iv["name"] for iv in prof._intervals) == ["stream:A",
                                                            "stream:B"]


def test_poll_keeps_the_order_of_unfinished_pairs(clock):
    prof = Profiler()
    prof.calibrate(torch.device("cuda:0"))
    for i in range(4):
        _span(prof, clock, f"stream:{i}", 100 + i, 100.5 + i)
    prof._pending[2][3].done = prof._pending[2][4].done = True
    prof.poll()
    assert [p[0] for p in prof._pending] == ["stream:0", "stream:1",
                                             "stream:3"]


@pytest.mark.parametrize("read", ["intervals", "totals", "counts",
                                  "write_trace"])
def test_read_methods_wait_for_pending_pairs(clock, read, tmp_path):
    prof = Profiler()
    prof.calibrate(torch.device("cuda:0"))
    _span(prof, clock, "stream:Op", 100.5, 101.0)
    syncs = clock.syncs
    if read == "intervals":
        assert len(prof.intervals("stream:Op")) == 1
    elif read == "totals":
        assert prof.totals()["stream:Op"] == pytest.approx(0.5)
    elif read == "counts":
        assert prof.counts() == {"stream:Op": 1}
    else:
        prof.write_trace(str(tmp_path / "t.json"))
    assert clock.syncs == syncs + 1 and prof._pending == []


def test_a_device_without_calibration_is_calibrated_at_its_first_span(clock):
    prof = Profiler()
    _span(prof, clock, "stream:Op", 100.5, 100.75, device="cuda:1")
    assert set(prof._cal) == {"cuda:1"}
    [iv] = prof.intervals("stream:Op")
    # the calibration event was reached at device 100.5 <-> host 5.0
    assert iv["ts"] == pytest.approx(0.0)
    assert iv["dur"] == pytest.approx(0.25e6)
    assert iv["track"] == "cuda:1"


def test_stream_span_records_when_the_block_raises(clock):
    prof = Profiler()
    prof.calibrate(torch.device("cuda:0"))
    with pytest.raises(RuntimeError):
        with prof.stream_span("stream:Op", torch.device("cuda:0")):
            raise RuntimeError("op failed")
    assert prof.counts() == {"stream:Op": 1}


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_no_stream_span_off_cuda(device):
    prof = Profiler()
    prof.calibrate(torch.device(device))
    with prof.stream_span("stream:Op", torch.device(device), job=0):
        pass
    prof.poll()
    assert prof._cal == {} and prof._pending == []
    assert prof.counts() == {}


def test_write_trace_puts_streams_on_a_track_per_device(clock, tmp_path):
    prof = Profiler()
    with prof.span("device:Op", job=1, row=0, rows=2):
        pass
    _span(prof, clock, "stream:Op", 100.5, 101.0, device="cuda:0", job=1,
          row=0, rows=2)
    _span(prof, clock, "stream:Op", 100.6, 101.5, device="cuda:3", job=1,
          row=0, rows=2)
    path = tmp_path / "trace.json"
    prof.write_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e["ph"] == "X"]
    host = [e for e in spans if e["name"] == "device:Op"]
    dev = sorted((e for e in spans if e["name"] == "stream:Op"),
                 key=lambda e: e["tid"])
    assert [e["pid"] for e in host] == [0]
    assert [(e["pid"], e["tid"]) for e in dev] == [(1, 0), (1, 3)]
    assert all(e["args"] == {"job": 1, "row": 0, "rows": 2}
               for e in host + dev)
    names = {(e["name"], e.get("tid")): e["args"]["name"] for e in events
             if e["ph"] == "M"}
    assert names == {("process_name", None): "device streams",
                     ("thread_name", 0): "cuda:0",
                     ("thread_name", 3): "cuda:3"}


def test_write_trace_without_streams_is_host_spans_alone(tmp_path):
    prof = Profiler()
    with prof.span("op:X", job=0):
        pass
    path = tmp_path / "trace.json"
    prof.write_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    assert [(e["name"], e["ph"], e["pid"]) for e in events] == [
        ("op:X", "X", 0)]


# --------------------------------------------------------- the op context

def test_op_context_wait_and_count_carry_the_packet():
    prof = Profiler()
    ctx = OpContext(job=3, profiler=prof)
    assert ctx.packet == {"job": 3}
    ctx.packet = {"job": 3, "row": 12, "rows": 6}
    with ctx.wait_device():
        pass
    ctx.count("embed:crops", 48)
    [w] = prof.intervals("host:wait_device")
    [c] = prof.intervals("embed:crops")
    assert w["meta"] == {"job": 3, "row": 12, "rows": 6}
    assert c["meta"] == {"job": 3, "row": 12, "rows": 6, "n": 48}
    assert c["dur"] == 0


def test_op_context_without_a_profiler_records_nothing():
    ctx = OpContext()
    with ctx.wait_device():
        pass
    ctx.count("embed:faces", 2)


# ------------------------------------------------------ runs on the CPU

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


def _frames(n=6, h=48, w=64, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3),
                                                np.uint8)


def _run(sc, node, videos, W=2, name="out"):
    outs = [st.NamedStream(sc, f"{name}{i}") for i in range(len(videos))]
    sc.run(sc.io.Output(node, outs), st.PerfParams.manual(
        work_packet_size=W, io_packet_size=W),
        cache_mode=st.CacheMode.Overwrite)
    return outs


def _packets(n, W, jobs=1):
    return {(j, a, min(W, n - a)) for j in range(jobs)
            for a in range(0, n, W)}


def _key(iv):
    m = iv["meta"]
    return m["job"], m["row"], m["rows"]


@pytest.fixture
def hist_run(tmp_path):
    """Histogram -> ShotBoundaries over two memory videos of 6 frames in
    packets of 2, both columns stored."""
    sc = st.Client(db_path=str(tmp_path / "db"), device="cpu")
    videos = [MemoryVideo(_frames(seed=s)) for s in (0, 1)]
    frame = sc.io.Input(videos)
    hist = sc.ops.Histogram(frame=frame)
    bounds = sc.ops.ShotBoundaries(histograms=hist)
    outs = [(st.NamedStream(sc, f"h{i}"), st.NamedStream(sc, f"b{i}"))
            for i in range(2)]
    sc.run(sc.io.Output([hist, bounds], outs),
           st.PerfParams.manual(work_packet_size=2, io_packet_size=2),
           cache_mode=st.CacheMode.Overwrite)
    return sc.profiler


@pytest.mark.parametrize("name", ["source:wait_slot", "source:read",
                                  "source:upload", "device:Histogram",
                                  "host:wait_device", "sink:write"])
def test_packet_meta_on_each_span_kind(hist_run, name):
    ivs = hist_run.intervals(name)
    assert ivs and all(set(iv["meta"]) == PACKET_KEYS for iv in ivs)
    want = _packets(6, 2, jobs=2)
    got = {_key(iv) for iv in ivs}
    assert got == want, name


def test_whole_stream_op_span_names_the_whole_job(hist_run):
    ivs = hist_run.intervals("op:ShotBoundaries")
    assert sorted(_key(iv) for iv in ivs) == [(0, 0, 6), (1, 0, 6)]


def test_one_packet_shares_its_identifier_across_layers(hist_run):
    """Every stage of packet (1, 2, 2): read, upload, the device op, the
    waits, the store: each span kind names it once or more."""
    kinds = {}
    for name in ("source:read", "source:upload", "device:Histogram",
                 "host:wait_device", "sink:write"):
        kinds[name] = [iv for iv in hist_run.intervals(name)
                       if _key(iv) == (1, 2, 2)]
    assert all(kinds.values()), kinds
    # two copies from the device a packet: ShotBoundaries' input and the
    # stored histogram column
    assert len(kinds["host:wait_device"]) == 2


def test_no_stream_interval_on_the_cpu(hist_run):
    assert not any(n.startswith("stream:") for n in hist_run.counts())
    assert hist_run._cal == {}


def test_calibrate_is_asked_at_each_job(tmp_path, monkeypatch):
    asked = []
    monkeypatch.setattr(Profiler, "calibrate",
                        lambda self, device: asked.append(str(device)))
    sc = st.Client(db_path=str(tmp_path / "db"), device="cpu")
    videos = [MemoryVideo(_frames(n=4, seed=s)) for s in (0, 1, 2)]
    _run(sc, sc.ops.Histogram(frame=sc.io.Input(videos)), videos)
    assert asked == ["cpu"] * 3


# pose: OpenPoseForward's net replaced by a stand-in of its shapes

@pytest.fixture
def pose_stub(monkeypatch):
    def device_stage(state, x, scales, upsample="linear", pipe_mesh=None):
        t = x.shape[0]
        k = pose_lib.MAX_PEAKS
        peaks = torch.zeros((t, 18, k, 3)) + x.mean()
        return (peaks, torch.zeros((t, 18, k), dtype=torch.bool),
                torch.full((t, pose_lib.N_LIMBS, k, k), -float("inf")))

    loads = []

    def get_params(model, weights_path, arch=None, device="cpu"):
        loads.append((model, weights_path))
        return {"w": torch.zeros(2)}

    monkeypatch.setattr(pose_lib, "device_stage", device_stage)
    monkeypatch.setattr(pose_ops, "_get_params", get_params)
    return loads


def _pose(sc, videos, **params):
    node = sc.ops.OpenPose(frame=sc.io.Input(videos), **params)
    return _run(sc, node, videos, name="pose")


def test_pose_waits_nest_inside_the_decode(tmp_path, pose_stub):
    sc = st.Client(db_path=str(tmp_path / "db"), device="cpu")
    outs = _pose(sc, [MemoryVideo(_frames(n=5))])
    assert [list(r) for r in outs[0].load()] == [[]] * 5
    waits = sc.profiler.intervals("host:wait_device")
    decodes = sc.profiler.intervals("op:OpenPoseDecode")
    assert {_key(iv) for iv in decodes} == _packets(5, 2)
    # the decode's copies are the only waits: the poses leave on the host
    assert sorted(map(_key, waits)) == sorted(map(_key, decodes))
    by_packet = {_key(d): d for d in decodes}
    for w in waits:
        d = by_packet[_key(w)]
        assert d["ts"] <= w["ts"] and w["ts"] + w["dur"] <= d["ts"] + d["dur"]
        assert w["tid"] == d["tid"]


def test_pose_decode_alone_records_one_wait_per_call():
    prof = Profiler()
    ctx = OpContext(job=0, profiler=prof)
    ctx.packet = {"job": 0, "row": 4, "rows": 2}
    k = pose_lib.MAX_PEAKS
    out = pose_ops.openpose_decode(
        ctx, torch.zeros((2, 18, k, 3)), torch.zeros((2, 18, k), dtype=torch.bool),
        torch.full((2, pose_lib.N_LIMBS, k, k), -float("inf")),
        torch.tensor([[48, 64]] * 2, dtype=torch.int32))
    assert out == [[], []]
    [w] = prof.intervals("host:wait_device")
    assert w["meta"] == {"job": 0, "row": 4, "rows": 2}


def test_load_spans_fire_once_per_aux_key(tmp_path, pose_stub):
    sc = st.Client(db_path=str(tmp_path / "db"), device="cpu")
    videos = [MemoryVideo(_frames(n=4))]
    _pose(sc, videos)
    _pose(sc, videos)
    assert sc.profiler.counts()["load:OpenPoseForward"] == 1
    # other parameters are another aux key: one more load
    _pose(sc, videos, weights_path="other.npz")
    loads = sc.profiler.intervals("load:OpenPoseForward")
    assert len(loads) == 2
    assert [iv["meta"] for iv in loads] == [{"device": "cpu"}] * 2
    assert pose_stub == [("openpose", None), ("openpose", "other.npz")]


def test_load_span_covers_the_weights_read(tmp_path, monkeypatch,
                                           pose_stub):
    import time

    def slow(model, weights_path, arch=None, device="cpu"):
        time.sleep(0.05)
        return {"w": torch.zeros(2)}

    monkeypatch.setattr(pose_ops, "_get_params", slow)
    sc = st.Client(db_path=str(tmp_path / "db"), device="cpu")
    _pose(sc, [MemoryVideo(_frames(n=2))])
    [load] = sc.profiler.intervals("load:OpenPoseForward")
    [dev] = sc.profiler.intervals("device:OpenPoseForward")
    assert load["dur"] >= 0.05e6
    # the load is the op's first call, inside its device span
    assert dev["ts"] <= load["ts"] and load["dur"] <= dev["dur"]


# faces: FaceNet replaced by a stand-in; the boxes come from a host op

BOXES = [[(0.1, 0.1, 0.5, 0.6)], [], [(0.2, 0.2, 0.4, 0.4),
                                      (0.5, 0.1, 0.9, 0.7)],
         [(0.0, 0.0, 1.0, 1.0)], [(0.3, 0.3, 0.6, 0.6)]]


@register_op("TracingTestBoxes", kind="host", outputs=("bboxes",))
def _tracing_test_boxes(ctx, frame):
    start = ctx.packet["row"]
    return [[protobufs.BoundingBox(x1=a, y1=b, x2=c, y2=d, score=1.0)
             for a, b, c, d in BOXES[start + i]] for i in range(len(frame))]


@pytest.fixture
def embed_run(tmp_path, monkeypatch):
    monkeypatch.setattr(faces_ops, "_get_params",
                        lambda *a, **k: {"w": torch.zeros(1)})
    monkeypatch.setattr(facenet_lib, "embed",
                        lambda aux, crops: crops.mean(dim=(1, 2, 3))[:, None]
                        .expand(-1, 128).contiguous())

    def run(budget):
        sc = st.Client(db_path=str(tmp_path / f"db{budget}"), device="cpu")
        frame = sc.io.Input([MemoryVideo(_frames(n=5))])
        embs = sc.ops.EmbedFaces(frame=frame,
                                 bboxes=sc.ops.TracingTestBoxes(frame=frame),
                                 faces_budget=budget)
        outs = _run(sc, embs, [None], name=f"emb{budget}")
        return sc.profiler, [np.asarray(r) for r in outs[0].load()]
    return run


FACES = {(0, 0, 2): 1, (0, 2, 2): 3, (0, 4, 1): 1}  # valid boxes a packet


@pytest.mark.parametrize("budget,granule", [
    pytest.param(2, None, id="2"), pytest.param(4, None, id="4"),
    pytest.param(32, None, id="32"), pytest.param(2, 2, id="2-granule2"),
    pytest.param(4, 2, id="4-granule2")])
def test_crop_counters_on_a_tiny_embed_run(embed_run, monkeypatch, budget,
                                           granule):
    if granule is not None:
        monkeypatch.setattr(faces_ops, "GRANULE", granule)
    g = faces_ops.GRANULE
    prof, rows = embed_run(budget)
    assert [len(r) for r in rows] == [len(b) for b in BOXES]
    crops = {_key(iv): iv["meta"]["n"] for iv in prof.intervals(
        "embed:crops")}
    faces = {_key(iv): iv["meta"]["n"] for iv in prof.intervals(
        "embed:faces")}
    # the net's batch: a packet's valid crops rounded up to the granule,
    # at most B = min(T * MAX_FACES, T * budget)
    want = {}
    for key, n in FACES.items():
        B = key[2] * min(budget, faces_ops.MAX_FACES)
        want[key] = min(B, -(-n // g) * g)
    assert crops == want
    if granule is not None:
        assert want == {(0, 0, 2): 2, (0, 2, 2): 4, (0, 4, 1): 2}
    assert faces == FACES


def test_crop_counters_add_no_wait(embed_run):
    """The counters read shapes and host arrays: the waits are the
    executor's copies of EmbedDecode's three inputs, before the op (the
    boxes enter from the host, the embeddings leave from it), and
    FaceEmbedForward's one read of its valid crop count, inside the op."""
    prof, _ = embed_run(4)
    waits = prof.intervals("host:wait_device")
    decodes = prof.intervals("op:EmbedDecode")
    forwards = prof.intervals("device:FaceEmbedForward")
    assert sorted(map(_key, waits)) == sorted(
        [_key(d) for d in decodes] * 3 + [_key(f) for f in forwards])
    inside = []
    for w in waits:
        f = next(f for f in forwards if _key(f) == _key(w))
        d = next(d for d in decodes if _key(d) == _key(w))
        if f["ts"] <= w["ts"] and w["ts"] + w["dur"] <= f["ts"] + f["dur"]:
            inside.append(_key(w))
        else:
            assert w["ts"] + w["dur"] <= d["ts"]
    assert sorted(inside) == sorted(map(_key, forwards))


# ------------------------------------------------------------- the card

@pytest.mark.cuda
def test_stream_spans_on_the_card(tmp_path):
    """A packet's ``stream:`` interval holds the device op's kernels: it
    starts after the calibration and lasts at least the kernels' own
    time, measured by CUDA events around the same op."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sc = st.Client(db_path=str(tmp_path / "db"))
    videos = [MemoryVideo(_frames(n=64, h=480, w=640))]
    _run(sc, sc.ops.Histogram(frame=sc.io.Input(videos)), videos, W=16)
    streams = sc.profiler.intervals("stream:Histogram")
    devices = sc.profiler.intervals("device:Histogram")
    assert {_key(iv) for iv in streams} == _packets(64, 16)
    assert all(iv["track"] == "cuda:0" for iv in streams)
    # the stream reaches an op's work after the host enqueued its first
    # kernel and finishes it before the host copies the column out
    for s in streams:
        d = next(d for d in devices if _key(d) == _key(s))
        assert s["ts"] >= d["ts"] - 50.0  # 50 us of clock slack
        assert s["dur"] > 0
