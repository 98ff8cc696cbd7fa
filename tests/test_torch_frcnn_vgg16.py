"""Faster R-CNN VGG16 at py-faster-rcnn's TEST proposal settings on the
port, held to the benchmark's plain reference
(``portbench/reference/frcnn_vgg16.py``: plain torch, no kernel of the
port) on seeded random weights whose heads the reference sets, at a tiny
size on the CPU: 96x128 frames at the test size 120x160 (a 7x10 map, 630
anchors), 64 RoIs a frame.

* ``FasterRCNN`` (``NNInput`` before it) against the reference's forward
  over seeds, a ``pre_nms`` pool below and above the anchor count, and
  packets of 2 and 4 frames: ``cls_prob`` within ``PROB_ATOL``, the RoIs
  within ``ROI_ATOL`` pixels, fc7 within ``FC7_RTOL`` of its largest
  value (float32 on both sides; the CPU's convolutions may take another
  algorithm at another batch), and ``FasterRCNNOutput``'s detections
  equal to the reference decode's, value for value.
* The op's new parameters: -1 takes the JAX package's pool (2048 and
  300), as before they existed.
* The anchors and NNInput's mean are made once per map size (or mean)
  and device, with ``anchors_for``'s values.
* ``frcnn:rois``, ``frcnn:rois_valid`` and ``frcnn:detections`` on the
  CPU, and the forward's three stages in order.
* ``FasterRCNNDetectionPipeline`` through ``Client.run``: the stored
  boxes equal the reference's detections.
"""

import functools

import numpy as np
import pytest
import torch

import scannertools_tpu_torch as st
from portbench import drive
from portbench.reference import frcnn_vgg16 as R
from scannertools_tpu.models import faster_rcnn as JR
from scannertools_tpu_torch.io.video import VideoMetadata
from scannertools_tpu_torch.models import faster_rcnn as PR
from scannertools_tpu_torch.ops import detection_decode as PD
from scannertools_tpu_torch.ops import faces as PFO
from scannertools_tpu_torch.ops import nn_generic as PN
from scannertools_tpu_torch.pipelines import std
from scannertools_tpu_torch.runtime.context import OpContext
from scannertools_tpu_torch.runtime.profiler import Profiler

H, W = 96, 128
SIZE = {"scale": 120, "max_size": 160}
ROIS = 64
MEAN = (102.9801, 115.9465, 122.7717)
SEEDS = [2 ** 31 + 13, 7]
# 630 anchors at 120x160: a pool below them, and py-faster-rcnn's above
PRE_NMS = [256, 6000]
PACKETS = [2, 4]
N_FRAMES = 4
TRAFFIC = {"width": W, "height": H, "pool_frames": 6, "blobs": [1, 2],
           "calibration_frames": 2,
           "heads": {"rpn": {"scale": 1.0, "small_shift": 4.0,
                             "reg_std": 0.1},
                     "cls": {"scale": 6.0, "detections_per_frame": 2}}}
# float32 on both sides; the tolerances take the other summation orders a
# convolution or product may take at another batch on the CPU
PROB_ATOL = 1e-5
ROI_ATOL = 1e-3
FC7_RTOL = 1e-5


def _cfg(pre_nms):
    return {"scale": SIZE["scale"], "max_size": SIZE["max_size"],
            "pre_nms": pre_nms, "num_rois": ROIS, "rpn_nms_thresh": 0.7,
            "rpn_min_size": 16, "score_thresh": 0.7, "nms_thresh": 0.3,
            "mean_bgr": list(MEAN)}


@functools.lru_cache(maxsize=None)
def _setup(seed):
    """(weights with the reference's heads, the pool's frames [6, H, W, 3]
    uint8) of ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    pool = drive.draw_pool(TRAFFIC, gen, "cpu")
    return R.build(_cfg(6000), TRAFFIC, pool, gen, "cpu"), pool


@functools.lru_cache(maxsize=None)
def _reference(seed, pre_nms):
    p, pool = _setup(seed)
    with torch.no_grad():
        prob, rois, fc7, valid = R.forward(_cfg(pre_nms), p, pool[:N_FRAMES])
    return prob, rois, fc7, valid, R.detections(_cfg(pre_nms), prob, rois)


def _port_packet(state, frames, pre_nms, ctx=None):
    x = PN.nn_input(ctx, frames, input_width=160, input_height=120,
                    mean_colors=MEAN)
    return PN.faster_rcnn_forward(ctx, state, x, pre_nms=pre_nms,
                                  num_rois=ROIS)


@functools.lru_cache(maxsize=None)
def _port(seed, pre_nms, packet):
    p, pool = _setup(seed)
    outs = []
    with torch.no_grad():
        for a in range(0, N_FRAMES, packet):
            outs.append(_port_packet(p, pool[a:a + packet], pre_nms))
    prob, rois, fc7 = (torch.cat(o) for o in zip(*outs))
    boxes, _ = PD.faster_rcnn_output(None, prob.numpy(), rois.numpy(),
                                     fc7.numpy())
    return prob, rois, fc7, boxes


@pytest.fixture(scope="module", autouse=True)
def _free_the_weights():
    """The cached weights and outputs go with the module."""
    yield
    for fn in (_setup, _reference, _port):
        fn.cache_clear()


def _rows(boxes):
    return np.asarray([[b.x1, b.y1, b.x2, b.y2, b.score, b.label,
                        b.track_id] for b in boxes], np.float32).reshape(-1, 7)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("pre_nms", PRE_NMS)
@pytest.mark.parametrize("packet", PACKETS)
@pytest.mark.parametrize("what", ["cls_prob", "rois", "fc7"])
def test_forward_matches_reference(seed, pre_nms, packet, what):
    prob, rois, fc7, valid, _ = _reference(seed, pre_nms)
    got = dict(zip(("cls_prob", "rois", "fc7"),
                   _port(seed, pre_nms, packet)[:3]))[what]
    if what == "cls_prob":
        # the rows the NMS did not keep are the one-hot background
        assert torch.equal(got[~valid], prob[~valid])
        torch.testing.assert_close(got, prob, rtol=0, atol=PROB_ATOL)
    elif what == "rois":
        assert torch.equal(got[..., 0], torch.zeros_like(got[..., 0]))
        torch.testing.assert_close(got[..., 1:], rois, rtol=0, atol=ROI_ATOL)
    else:
        assert torch.equal(got[~valid], torch.zeros_like(got[~valid]))
        torch.testing.assert_close(got, fc7, rtol=0,
                                   atol=FC7_RTOL * float(fc7.abs().max()))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("pre_nms", PRE_NMS)
@pytest.mark.parametrize("packet", PACKETS)
def test_detections_match_reference(seed, pre_nms, packet):
    want = _reference(seed, pre_nms)[4]
    got = _port(seed, pre_nms, packet)[3]
    assert sum(len(d) for d in want) > 0
    for g, r in zip(got, want):
        np.testing.assert_array_equal(_rows(g), r.astype(np.float32))


@pytest.mark.parametrize("seed", SEEDS)
def test_pool_below_the_anchors_keeps_fewer(seed):
    """The pool decides the proposals: 256 of 630 anchors keep no more
    RoIs than all of them."""
    small = _reference(seed, 256)[3].sum(dim=1)
    full = _reference(seed, 6000)[3].sum(dim=1)
    assert bool((small <= full).all()) and int(full.min()) > 0


def test_defaults_are_the_jax_pool():
    """-1 takes the JAX package's static pool, so every parity test against
    it stands unchanged."""
    assert (PR.PRE_NMS, PR.NUM_ROIS) == (JR.PRE_NMS, JR.NUM_ROIS) == (2048,
                                                                     300)
    p, pool = _setup(SEEDS[0])
    x = PN.nn_input(None, pool[:1], input_width=160, input_height=120,
                    mean_colors=MEAN)
    with torch.no_grad():
        default = PN.faster_rcnn_forward(None, p, x)
        explicit = PN.faster_rcnn_forward(None, p, x, pre_nms=JR.PRE_NMS,
                                          num_rois=JR.NUM_ROIS)
        direct = PR.apply(p, x)
    assert default[0].shape == (1, 300, 81)
    for a, b, c in zip(default, explicit, direct):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("hw", [(7, 10), (37, 50), (3, 1)])
def test_anchors_made_once(hw):
    dev = torch.device("cpu")
    a = PR.device_anchors(*hw, dev)
    assert PR.device_anchors(*hw, dev) is a
    assert a.dtype == torch.float32 and a.device == dev
    np.testing.assert_array_equal(a.numpy(),
                                  PR.anchors_for(*hw).astype(np.float32))
    # py-faster-rcnn's generate_anchors, written apart in the reference
    np.testing.assert_array_equal(a.numpy(), R.anchors(*hw, "cpu").numpy())


def test_forward_reads_the_kept_anchors(monkeypatch):
    """A second forward at the same map size makes no anchors."""
    p, pool = _setup(SEEDS[0])
    made = []
    real = PR.anchors_for
    monkeypatch.setattr(PR, "anchors_for",
                        lambda h, w: made.append((h, w)) or real(h, w))
    PR.device_anchors.cache_clear()
    with torch.no_grad():
        for _ in range(2):
            _port_packet(p, pool[:1], 6000)
    assert made == [(7, 10)]


def test_nn_input_mean_made_once():
    dev = torch.device("cpu")
    m = PN._device_mean(MEAN, torch.float32, dev)
    assert PN._device_mean(MEAN, torch.float32, dev) is m
    assert m.tolist() == list(np.float32(MEAN))
    frames = np.random.default_rng(3).integers(0, 256, (2, 8, 6, 3),
                                               np.uint8)
    got = PN.nn_input(None, frames, mean_colors=MEAN)
    want = torch.from_numpy(frames).float() - torch.tensor(MEAN)
    assert torch.equal(got, want)


class _Stages(Profiler):
    """A profiler that records the forward's stage names (the CPU records
    no stream interval)."""

    def __init__(self):
        super().__init__()
        self.stages = []

    def stream_span(self, name, device, **meta):
        self.stages.append((name, meta))
        return super().stream_span(name, device, **meta)


def test_counters_and_stages_on_cpu():
    p, pool = _setup(SEEDS[0])
    prof = _Stages()
    ctx = OpContext(job=3, profiler=prof, device=torch.device("cpu"))
    ctx.packet = {"job": 3, "row": 8, "rows": 2}
    with torch.no_grad():
        prob, rois, fc7 = _port_packet(p, pool[:2], 6000, ctx)
    assert [n for n, _ in prof.stages] == [
        "stream:FasterRCNN:trunk", "stream:FasterRCNN:proposals",
        "stream:FasterRCNN:roi_head"]
    assert all(m == ctx.packet for _, m in prof.stages)
    boxes, feats = PD.faster_rcnn_output(ctx, prob.numpy(), rois.numpy(),
                                         fc7.numpy())
    valid = _reference(SEEDS[0], 6000)[3][:2]
    counts = {n: [iv["meta"] for iv in prof.intervals(n)]
              for n in ("frcnn:rois", "frcnn:rois_valid",
                        "frcnn:detections")}
    assert counts["frcnn:rois"] == [dict(ctx.packet, n=2 * ROIS)]
    assert counts["frcnn:rois_valid"] == [dict(ctx.packet,
                                               n=int(valid.sum()))]
    assert counts["frcnn:detections"] == [dict(
        ctx.packet, n=sum(len(b) for b in boxes))]
    assert [len(f) for f in feats] == [len(b) for b in boxes]


@pytest.mark.parametrize("hw,want", [((480, 640), (600, 800)),
                                     ((1080, 1920), (562, 1000)),
                                     ((720, 1280), (562, 1000)),
                                     ((600, 600), (600, 600)),
                                     ((96, 128), (600, 800))])
def test_test_size(hw, want):
    """py-faster-rcnn's TEST scale (600 within 1000), in the runner and in
    the reference alike."""
    assert std.frcnn_test_size(*hw) == want
    assert R.scaled_size(*hw, {"scale": 600, "max_size": 1000}) == want


def test_runner_entry():
    """``std.detect_objects_frcnn`` is the runner's one-call entry (the
    package's ``pipelines`` exports the JAX package's names only)."""
    assert std.detect_objects_frcnn.__name__ == \
        "run_FasterRCNNDetectionPipeline"
    assert std.detect_objects_frcnn.__doc__ == \
        std.FasterRCNNDetectionPipeline.__doc__


def _memory_video(sc, name, frames):
    class MemoryVideo(st.NamedVideoStream):
        def __len__(self):
            return len(frames)

        def video_path(self):
            return "memory"

        def metadata(self):
            return VideoMetadata("memory", len(frames), 30.0, W, H)

        def decoder(self):
            return self

        i420_supported = False

        def read_frames(self, rows, out=None):
            data = frames[list(rows)]
            if out is None:
                return data
            out[...] = data
            return out

        def close(self):
            pass

    return MemoryVideo(sc, name)


@pytest.mark.parametrize("packet", PACKETS)
def test_runner_matches_reference(tmp_path, monkeypatch, packet):
    """The runner through Client.run on the CPU at the test's size stores
    the reference's detections; its counters are the packets'."""
    seed = SEEDS[0]
    p, pool = _setup(seed)
    monkeypatch.setitem(PFO._MODEL_CACHE, ("faster_rcnn", None, "cpu"), p)
    for k, v in dict(SIZE, num_rois=ROIS, pre_nms=6000,
                     run_opts={"work_packet_size": packet,
                               "io_packet_size": packet}).items():
        monkeypatch.setattr(std.FasterRCNNDetectionPipeline, k, v)
    sc = st.Client(db_path=str(tmp_path / "db"), device="cpu")
    video = _memory_video(sc, "clip", pool[:N_FRAMES].numpy())
    out = std.detect_objects_frcnn(sc, videos=[video], cache=False)
    got = list(out[0].load())
    want = _reference(seed, 6000)[4]
    assert len(got) == N_FRAMES
    for g, r in zip(got, want):
        np.testing.assert_array_equal(_rows(g), r.astype(np.float32))
    counts = sc.profiler.counts()
    assert counts["frcnn:rois"] == N_FRAMES // packet
    n = sum(iv["meta"]["n"] for iv in sc.profiler.intervals(
        "frcnn:detections"))
    assert n == sum(len(r) for r in want)
