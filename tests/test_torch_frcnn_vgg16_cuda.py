"""Faster R-CNN VGG16 on the card (``cuda`` tests; each skips without a
CUDA device). No JAX here: the reference is the benchmark's plain one
(``portbench/reference/frcnn_vgg16.py``), on seeded weights whose heads it
sets, at 240x320 frames (a 15x20 map, 2700 anchors: the proposals' ``nms``
takes its device-memory path) with py-faster-rcnn's 6000 and 300.

* The forward (NNInput, then FasterRCNN with its stage intervals) makes
  no synchronising call once warm: it runs under
  ``torch.cuda.set_sync_debug_mode("error")``.
* Through ``Client.run``, each packet's ``stream:FasterRCNN:trunk``,
  ``:proposals`` and ``:roi_head`` lie inside its ``stream:FasterRCNN``,
  in that order.
* The runner's stored boxes are the reference's, computed a packet at a
  time as the program computes them.
"""

import functools

import numpy as np
import pytest
import torch

import scannertools_tpu_torch as st
from portbench import drive
from portbench.reference import frcnn_vgg16 as R
from scannertools_tpu_torch.io.video import VideoMetadata
from scannertools_tpu_torch.ops import faces as PFO
from scannertools_tpu_torch.ops import nn_generic as PN
from scannertools_tpu_torch.pipelines import std
from scannertools_tpu_torch.runtime.context import OpContext
from scannertools_tpu_torch.runtime.profiler import Profiler

pytestmark = pytest.mark.cuda

H, W = 240, 320
PACKET, N_FRAMES = 4, 8
MEAN = (102.9801, 115.9465, 122.7717)
CFG = {"scale": 240, "max_size": 320, "pre_nms": 6000, "num_rois": 300,
       "rpn_nms_thresh": 0.7, "rpn_min_size": 16, "score_thresh": 0.7,
       "nms_thresh": 0.3, "mean_bgr": list(MEAN)}
TRAFFIC = {"width": W, "height": H, "pool_frames": N_FRAMES, "blobs": [2, 4],
           "calibration_frames": 4,
           "heads": {"rpn": {"scale": 1.0, "small_shift": 4.0,
                             "reg_std": 0.1},
                     "cls": {"scale": 6.0, "detections_per_frame": 5}}}
# the event clock's resolution, and its float32 milliseconds
CLOCK_S = 2e-5


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from scannertools_tpu_torch.kernels import build

    build.build_all()
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def _setup():
    gen = torch.Generator(device="cuda").manual_seed(2 ** 31 + 17)
    pool = drive.draw_pool(TRAFFIC, gen, "cuda")
    return R.build(CFG, TRAFFIC, pool, gen, "cuda"), pool


@pytest.fixture(scope="module", autouse=True)
def _free_the_weights():
    """The cached weights on the card go with the module."""
    yield
    _setup.cache_clear()


def _forward(state, frames, ctx):
    x = PN.nn_input(ctx, frames, input_width=W, input_height=H,
                    mean_colors=MEAN)
    return PN.faster_rcnn_forward(ctx, state, x, pre_nms=6000, num_rois=300)


def test_forward_makes_no_sync(cuda_device):
    state, pool = _setup()
    ctx = OpContext(profiler=Profiler(), device=cuda_device)
    frames = pool[:PACKET]
    _forward(state, frames, ctx)  # warm: the anchors, mean and taps made
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = _forward(state, frames, ctx)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert out[0].shape == (PACKET, 300, 81)
    names = ctx.profiler.counts()
    assert all(names[f"stream:FasterRCNN:{s}"] == 2
               for s in ("trunk", "proposals", "roi_head"))


def _memory_video(sc, name, frames):
    class MemoryVideo(st.NamedVideoStream):
        i420_supported = False

        def __len__(self):
            return len(frames)

        def video_path(self):
            return "memory"

        def metadata(self):
            return VideoMetadata("memory", len(frames), 30.0, W, H)

        def decoder(self):
            return self

        def read_frames(self, rows, out=None):
            data = frames[list(rows)]
            if out is None:
                return data
            out[...] = data
            return out

        def close(self):
            pass

    return MemoryVideo(sc, name)


@pytest.fixture(scope="module")
def runner_run(tmp_path_factory):
    """(the Client, the stored boxes a frame) of the runner over the pool's
    frames in packets of PACKET, the weights in the model cache."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from scannertools_tpu_torch.kernels import build

    build.build_all()
    state, pool = _setup()
    saved = {k: getattr(std.FasterRCNNDetectionPipeline, k)
             for k in ("scale", "max_size", "run_opts")}
    host = {k: v.cpu() for k, v in state.items()}
    keys = [("faster_rcnn", None, d) for d in ("cuda", "cuda:0")]
    for k in keys:
        PFO._MODEL_CACHE[k] = host
    try:
        std.FasterRCNNDetectionPipeline.scale = CFG["scale"]
        std.FasterRCNNDetectionPipeline.max_size = CFG["max_size"]
        std.FasterRCNNDetectionPipeline.run_opts = {
            "work_packet_size": PACKET, "io_packet_size": PACKET}
        sc = st.Client(db_path=str(tmp_path_factory.mktemp("frcnn") / "db"))
        video = _memory_video(sc, "clip", pool[:N_FRAMES].cpu().numpy())
        out = std.detect_objects_frcnn(sc, videos=[video], cache=False)
        yield sc, list(out[0].load())
    finally:
        for k, v in saved.items():
            setattr(std.FasterRCNNDetectionPipeline, k, v)
        for k in keys:
            PFO._MODEL_CACHE.pop(k, None)


def test_stage_intervals_nest(runner_run):
    sc, _ = runner_run
    outer = sc.profiler.intervals("stream:FasterRCNN")
    assert len(outer) == N_FRAMES // PACKET
    for o in outer:
        s0, e0 = o["ts"] / 1e6, (o["ts"] + o["dur"]) / 1e6
        parts = []
        for part in ("trunk", "proposals", "roi_head"):
            iv = [i for i in sc.profiler.intervals(
                f"stream:FasterRCNN:{part}") if i["meta"] == o["meta"]]
            assert len(iv) == 1
            s, e = iv[0]["ts"] / 1e6, (iv[0]["ts"] + iv[0]["dur"]) / 1e6
            assert s0 - CLOCK_S <= s <= e <= e0 + CLOCK_S
            parts.append((s, e))
        for (_, e), (s, _) in zip(parts, parts[1:]):
            assert e <= s + CLOCK_S


def test_runner_matches_reference_on_card(runner_run):
    _, got = runner_run
    state, pool = _setup()
    want = []
    with torch.no_grad():
        for a in range(0, N_FRAMES, PACKET):
            prob, rois, _, _ = R.forward(CFG, state, pool[a:a + PACKET])
            want += R.detections(CFG, prob, rois)
    rows = [{"detections": np.asarray(
        [[b.x1, b.y1, b.x2, b.y2, b.score, b.label, b.track_id] for b in f],
        np.float64).reshape(-1, 7)} for f in got]
    numbers = R.compare(CFG, rows, [{"detections": w} for w in want], None)
    assert numbers["detections_compared"] > 0
    assert numbers["det_miss"] == 0, numbers
    assert numbers["box_gap_px"] <= 1e-3 and numbers["score_gap"] <= 1e-5, \
        numbers
