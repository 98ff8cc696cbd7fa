"""The readers of the program's stream, wait and load spans and FaceNet's
crop counters, on runs made by hand; the widened span collection on a
profiler filled by hand; and the clock check's arithmetic."""

import json
import types
from pathlib import Path

import pytest

from portbench import harness
from portbench.metrics import _program
from portbench.tools import clock

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = ("mtcnn_stream_ms_per_frame", "facenet_stream_ms_per_frame",
       "openpose_stream_ms_per_frame", "device_wait_ms_per_frame",
       "device_wait_ms_per_frame.pose", "weights_load_s", "facenet_crop_use")


def metric(name):
    return harness.load_metric(ROOT / "portbench" / "metrics" / f"{name}.py")


def make_run(spans=None, counters=None, busy_s=25.0, frames=100):
    s = _program.Spans(spans or {})
    s.counters = counters or {}
    return types.SimpleNamespace(t0=10.0, t1=20.0, frames=frames, spans=s,
                                 busy_s=busy_s)


@pytest.mark.parametrize("name,span", [
    ("mtcnn_stream_ms_per_frame", "stream:MTCNNForward"),
    ("facenet_stream_ms_per_frame", "stream:FaceEmbedForward"),
    ("openpose_stream_ms_per_frame", "stream:OpenPoseForward"),
    ("device_wait_ms_per_frame", "host:wait_device"),
    ("device_wait_ms_per_frame.pose", "host:wait_device"),
])
def test_span_readers_clip_to_the_window(name, span):
    # 0.5 s before the window is cut to 0.25 s, 1 s inside, 0.5 s past
    # the end cut to 0.25 s, one after the window left out: 1.5 s over
    # 100 frames
    run = make_run({span: [(9.75, 10.25), (12.0, 13.0), (19.75, 20.25),
                           (21.0, 22.0)],
                    "stream:Other": [(11.0, 12.0)]})
    mod = metric(name)
    assert mod.UNIT == "ms"
    assert mod.read(run) == pytest.approx(15.0)


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_gives_none(name):
    assert metric(name).read(make_run()) is None


@pytest.mark.parametrize("name", NEW)
def test_off_the_card_gives_none(name):
    run = make_run({"stream:MTCNNForward": [(11.0, 12.0)],
                    "stream:FaceEmbedForward": [(11.0, 12.0)],
                    "stream:OpenPoseForward": [(11.0, 12.0)],
                    "host:wait_device": [(11.0, 12.0)],
                    "load:X": [(1.0, 2.0)]},
                   {"embed:crops": [(11.0, 8)], "embed:faces": [(11.0, 2)]},
                   busy_s=None)
    assert metric(name).read(run) is None


def test_weights_load_s_sums_every_load_of_the_run():
    run = make_run({"load:MTCNNForward": [(1.0, 1.5)],
                    "load:FaceEmbedForward": [(2.0, 4.25)],
                    "host:wait_device": [(11.0, 12.0)]})
    mod = metric("weights_load_s")
    assert mod.UNIT == "s" and mod.read(run) == pytest.approx(2.75)


def test_facenet_crop_use_counts_inside_the_window():
    run = make_run(counters={
        "embed:crops": [(9.0, 4608), (11.0, 4608), (15.0, 4608),
                        (21.0, 4608)],
        "embed:faces": [(9.5, 4000), (11.5, 2462), (15.5, 2462),
                        (21.5, 4000)]})
    mod = metric("facenet_crop_use")
    assert mod.UNIT == "%"
    assert mod.read(run) == pytest.approx(100.0 * 4924 / 9216)


def test_facenet_crop_use_reads_zero_faces():
    run = make_run(counters={"embed:crops": [(11.0, 4608)],
                             "embed:faces": [(11.5, 0)]})
    assert metric("facenet_crop_use").read(run) == 0.0


def test_every_new_metric_is_listed_with_its_cells():
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    face = ["face_embedding.crowd", "face_embedding.sparse"]
    pose = ["pose_detection.crowd", "pose_detection.sparse"]
    for name in NEW:
        m = per_layer[name]
        want = (sorted(face + pose) if name == "weights_load_s"
                else pose if "openpose" in name or name.endswith(".pose")
                else face)
        assert sorted(m["workloads"]) == sorted(want), name
        assert m["moves"] == ("setup_s" if name == "weights_load_s"
                              else "frames_per_s.pose" if want == pose
                              else "frames_per_s")


class _Sc:
    def __init__(self, prof):
        self.profiler = prof


def test_widened_spans_collect_the_program_spans_and_counters():
    from scannertools_tpu_torch.runtime.profiler import Profiler

    prof = Profiler()
    prof.count("portbench:window")
    anchor = prof.intervals("portbench:window")[0]["ts"] / 1e6
    base = prof._t0
    prof.add_interval("source:read", base + 1.0, base + 2.0)
    prof.add_interval("stream:Op", base + 2.0, base + 3.0)
    prof.add_interval("host:wait_device", base + 3.0, base + 3.5)
    prof.add_interval("load:Op", base + 0.25, base + 0.75)
    prof.add_interval("op:Other", base + 4.0, base + 5.0)
    prof.add_interval("embed:crops", base + 6.0, base + 6.0, n=64)
    prof.add_interval("embed:faces", base + 7.0, base + 7.0, n=9)
    _program.install()
    _program.install()
    assert harness._spans.widened
    # the anchor was recorded at perf_counter 100.0 + its offset
    out = harness._spans(_Sc(prof), ["source:read"], 100.0 + anchor,
                         "portbench:window")
    assert set(out) == {"source:read", "stream:Op", "host:wait_device",
                        "load:Op"}
    assert out["stream:Op"] == [pytest.approx((102.0, 103.0))]
    assert out["load:Op"] == [pytest.approx((100.25, 100.75))]
    assert out.counters == {"embed:crops": [pytest.approx((106.0, 64))],
                            "embed:faces": [pytest.approx((107.0, 9))]}


def test_widened_spans_of_a_program_without_them():
    from scannertools_tpu_torch.runtime.profiler import Profiler

    prof = Profiler()
    prof.count("portbench:window")
    _program.install()
    out = harness._spans(_Sc(prof), ["source:read"], 0.0, "portbench:window")
    assert out == {"source:read": []}
    assert out.counters == {"embed:crops": [], "embed:faces": []}


def test_clock_check_share_and_end_offset():
    events = [("kernel_a", 1.0, 0.2), ("kernel_b", 1.25, 0.25),
              ("Memcpy HtoD (Pageable -> Device)", 0.5, 0.4),
              ("Memcpy DtoH (Device -> Pageable)", 2.9, 0.05),
              ("kernel_c", 2.0, 0.5),  # half outside every interval
              ("kernel_d", 3.5, 0.1)]  # after the window
    spans = {"stream:A": [(0.99, 1.51)], "stream:B": [(2.25, 2.6)],
             "device:A": [(0.0, 9.0)]}
    out = clock.check(events, spans, 0.0, 3.0)
    assert out["kernel_s"] == pytest.approx(0.95)
    assert out["inside_s"] == pytest.approx(0.7)
    assert out["share"] == pytest.approx(100 * 0.7 / 0.95)
    assert out["intervals"] == 2
    # A ends 0.01 s after kernel_b; B holds no kernel start
    assert out["median_end_offset_us"] == pytest.approx(1e4)
    assert out["spans_s"] == {"stream:A": pytest.approx(0.52),
                              "stream:B": pytest.approx(0.35),
                              "device:A": pytest.approx(3.0)}


def test_clock_check_overlapping_intervals_count_once():
    events = [("k", 1.0, 1.0)]
    spans = {"stream:A": [(0.5, 1.75)], "stream:B": [(1.5, 2.5)]}
    out = clock.check(events, spans, 0.0, 3.0)
    assert out["share"] == pytest.approx(100.0)
    # A holds the kernel's start and ends before it: a negative offset
    assert out["median_end_offset_us"] == pytest.approx(-0.25e6)
