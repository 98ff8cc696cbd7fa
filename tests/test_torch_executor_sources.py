"""The executor's per-input ``_Source`` on the CPU: its upload and I420
decisions, its staging ring's size, and where the job releases its ring
slots (after a chunk's device part for uploaded frames, after its host
tail for frames kept on the host).

The graphs and memory videos are ``test_torch_executor_pipeline.py``'s.
"""

import numpy as np
import pytest

import scannertools_tpu_torch as st
from scannertools_tpu.ops.histogram import histogram_reference_np
from scannertools_tpu_torch.graph import InputNode, toposort
from scannertools_tpu_torch.io import prefetch
from scannertools_tpu_torch.runtime.executor import (_Source, _tail_start,
                                                     _video_meta)
from test_torch_executor_pipeline import MemoryVideo, _frames, _perf, _run

W, DEPTH = 2, 2


class ClosingVideo(MemoryVideo):
    """A memory video that records its decoder's close."""

    closed = False

    def close(self):
        self.closed = True


class I420Video(MemoryVideo):
    """A memory video whose decoder says it can decode to I420."""

    i420_supported = True


def _plan(tmp_path, build, video):
    """The source of ``build``'s graph over ``video`` -> (executor's
    ``need``, order, its Input node, whether the graph has a host
    tail)."""
    sc = st.Client(db_path=str(tmp_path / "db"), device="cpu")
    cols = build(sc, sc.io.Input([video]))
    order = toposort(sc.io.Output(cols, [st.NamedStream(sc, "x")] *
                                  len(cols)))
    node = next(n for n in order if isinstance(n, InputNode))
    host_tail = _tail_start(order)[0] < len(order)
    return sc._executor._intervals(order), order, node, host_tail


def _open(tmp_path, build, video, ingest="auto"):
    need, order, node, host_tail = _plan(tmp_path, build, video)
    return _Source.open(node, video, list(range(len(video))),
                        _video_meta(video), None, order, need, ingest, W,
                        DEPTH, host_tail)


HIST = (lambda sc, f: [sc.ops.Histogram(frame=f)])
HIST_TOTALS = (lambda sc, f: [sc.ops.PipelineTestTotals(
    histograms=sc.ops.Histogram(frame=f))])
MIXED = (lambda sc, f: [sc.ops.Histogram(frame=f),
                        sc.ops.PipelineTestFrameSums(frame=f)])
HOST_ONLY = (lambda sc, f: [sc.ops.PipelineTestBrightness(frame=f)])
FACES = (lambda sc, f: (lambda m: [sc.ops.EmbedFaces(frame=f, bboxes=m),
                                   m])(sc.ops.MTCNNDetectFaces(frame=f)))


@pytest.mark.parametrize("build,upload,slots", [
    # device consumers only: uploaded by the prefetch thread, depth + 2
    # slots with or without a host tail
    (HIST, True, DEPTH + 2),
    (HIST_TOTALS, True, DEPTH + 2),
    (FACES, True, DEPTH + 2),
    # frames on the host: a deferred tail holds its chunk's slot
    (MIXED, False, DEPTH + 3),
    # no device op, so no host tail to defer
    (HOST_ONLY, False, DEPTH + 2),
], ids=["device", "device+tail", "faces", "mixed", "host-only"])
def test_upload_decision_and_ring_slots(tmp_path, build, upload, slots):
    frames = _frames(n=5, h=24, w=32)
    src = _open(tmp_path, build, MemoryVideo(frames))
    try:
        assert src.upload is upload
        assert src.yuv is False
        assert src.ring.nslots == slots
        assert src.ring.slot_bytes == W * 24 * 32 * 3
    finally:
        src.close()


@pytest.mark.parametrize("build,ingest,yuv", [
    (HIST, "auto", True),
    (HIST, "i420", True),
    (HIST, "rgb", False),
    # host consumers take RGB: no I420 without an upload
    (MIXED, "i420", False),
])
def test_i420_only_for_uploaded_frames(tmp_path, build, ingest, yuv):
    src = _open(tmp_path, build, I420Video(_frames(n=5, h=24, w=32)),
                ingest)
    try:
        assert src.yuv is yuv
        per_frame = 24 * 32 * 3 // 2 if yuv else 24 * 32 * 3
        assert src.frame_bytes == per_frame
        assert src.ring.slot_bytes == W * per_frame
    finally:
        src.close()


def test_i420_refused_on_a_decoder_without_it(tmp_path):
    video = ClosingVideo(_frames(n=5))
    with pytest.raises(ValueError, match="planar I420"):
        _open(tmp_path, HIST, video, ingest="i420")
    assert video.closed  # the decoder opened for the source is closed


def test_the_stencil_halo_widens_the_ring_slot(tmp_path):
    frames = _frames(n=5, h=24, w=32)
    need, order, node, host_tail = _plan(
        tmp_path, lambda sc, f: [sc.ops.FrameDifference(frame=f)],
        MemoryVideo(frames))
    lo, hi = need[node.id]
    assert hi - lo == 1
    src = _Source.open(node, MemoryVideo(frames), list(range(5)),
                       _video_meta(MemoryVideo(frames)), None, order, need,
                       "auto", W, DEPTH, host_tail)
    try:
        assert (src.lo, src.hi) == (lo, hi)
        assert src.ring.slot_bytes == (W + 1) * 24 * 32 * 3
    finally:
        src.close()


@pytest.mark.parametrize("host_frames", [False, True])
def test_slots_are_released_at_their_release_point(tmp_path, monkeypatch,
                                                   host_frames):
    """Histogram -> Totals over 7 frames in chunks of 2. At each release
    the profiler has recorded ``d`` device parts and ``t`` tails: an
    uploaded chunk j's slot goes right after its device part (d = j + 1,
    t = j - 1: chunk j - 1's tail still pending); a host chunk's after its
    own tail (t = j + 1), which runs after chunk j + 1's device part."""
    sc = st.Client(db_path=str(tmp_path / "db"), device="cpu")
    seen = []
    release = prefetch.ChunkRing.release

    def recording(ring):
        seen.append((len(sc.profiler.intervals("device:Histogram")),
                     len(sc.profiler.intervals("op:PipelineTestTotals"))))
        release(ring)

    monkeypatch.setattr(prefetch.ChunkRing, "release", recording)
    frames = _frames(n=7, seed=3)
    frame = sc.io.Input([MemoryVideo(frames)])
    cols = [sc.ops.PipelineTestTotals(histograms=sc.ops.Histogram(
        frame=frame))]
    if host_frames:
        cols.append(sc.ops.PipelineTestFrameSums(frame=frame))
    outs = [tuple(st.NamedStream(sc, f"c{i}") for i in range(len(cols)))]
    _run(sc, cols, outs, _perf(W=W))
    n = 4
    if host_frames:
        want = [(min(j + 2, n), j + 1) for j in range(n)]
    else:
        want = [(j + 1, max(j - 1, 0)) for j in range(n)]
    assert seen == want
    assert list(outs[0][0].load()) == \
        histogram_reference_np(frames).sum(axis=-1).tolist()
    if host_frames:
        assert list(outs[0][1].load()) == [
            int(np.asarray(f, np.int64).sum()) for f in frames]
