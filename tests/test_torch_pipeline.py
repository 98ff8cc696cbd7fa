"""The PyTorch port's main path end to end on the CPU:
decode -> staging ring -> FrameChunk -> Histogram -> ShotBoundaries ->
NamedStream, through the public API (``Client(device="cpu")``), held to the
synthetic video's known cuts and to the JAX package's pipeline on the same
video. Stream files are byte-identical across the two packages and each
loads what the other wrote.
"""

import os

import numpy as np
import pytest
import torch

import scannertools_tpu as jst
import scannertools_tpu_torch as st
from scannertools_tpu.ops.histogram import histogram_reference_np
from scannertools_tpu_torch.io import av
from scannertools_tpu_torch.registry import register_op


@pytest.fixture()
def tsc(tmp_path):
    return st.Client(db_path=str(tmp_path / "db"), device="cpu")


@pytest.fixture()
def tvideo(tsc, test_video):
    return st.NamedVideoStream(tsc, "test1", path=test_video["path"])


def _histogram_and_shots(sc, pkg, video, ingest="rgb", work_packet_size=32):
    """Run Histogram -> ShotBoundaries with both columns sunk; -> (per-frame
    histogram rows [N, 3, 16], boundaries, the two sink streams)."""
    frame = sc.io.Input([video])
    hist = sc.ops.Histogram(frame=frame)
    bounds = sc.ops.ShotBoundaries(histograms=hist)
    hist_out = pkg.NamedStream(sc, f"hist_{ingest}")
    shots_out = pkg.NamedStream(sc, f"shots_{ingest}")
    sc.run(sc.io.Output([hist, bounds], [(hist_out, shots_out)]),
           pkg.PerfParams.manual(work_packet_size=work_packet_size,
                                 ingest=ingest),
           cache_mode=pkg.CacheMode.Overwrite)
    rows = np.stack([np.stack(r) for r in hist_out.load()])
    return rows, next(shots_out.load(rows=[0])), hist_out, shots_out


@pytest.mark.parametrize("ingest", ["rgb", "i420", "auto"])
def test_shot_boundaries_on_test_video(tsc, tvideo, test_video, ingest):
    if ingest != "rgb" and not av.available():
        pytest.skip("I420 ingest needs the native libav decoder")
    rows, cuts, _, _ = _histogram_and_shots(tsc, st, tvideo, ingest)
    assert cuts == test_video["cuts"]
    assert rows.shape == (test_video["n"], 3, 16)
    assert (rows.sum(axis=2) == test_video["h"] * test_video["w"]).all()


def test_verify_recipe(tmp_path):
    """The verify skill's recipe with only the import changed (and the
    device named): cuts at exactly the frames where the colour changes."""
    import cv2

    path = str(tmp_path / "v.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 24, (96, 64))
    for i in range(120):
        shot = 0 if i < 40 else (1 if i < 80 else 2)
        f = np.zeros((64, 96, 3), np.uint8)
        f[:, :] = [(200, 40, 40), (40, 200, 40), (40, 40, 200)][shot][::-1]
        x = (i * 2) % 96
        f[:, x:x + 8] = 255
        w.write(f)
    w.release()

    sc = st.Client(db_path=str(tmp_path / "db"), device="cpu")
    video = st.NamedVideoStream(sc, "v", path=path)
    frame = sc.io.Input([video])
    hist = sc.ops.Histogram(frame=frame)
    bounds = sc.ops.ShotBoundaries(histograms=hist)
    out = st.NamedStream(sc, "shots")
    sc.run(sc.io.Output(bounds, [out]),
           st.PerfParams.manual(work_packet_size=32),
           cache_mode=st.CacheMode.Overwrite)
    assert next(out.load(rows=[0])) == [40, 80]
    totals = sc.profiler.totals()
    for span in ("source:read", "source:upload", "device:Histogram",
                 "op:ShotBoundaries"):
        assert span in totals, span


def test_rgb_rows_and_stream_files_match_jax_pipeline(tmp_path, test_video,
                                                      video_frames):
    jsc = jst.Client(db_path=str(tmp_path / "jax_db"))
    jvideo = jst.NamedVideoStream(jsc, "test1", path=test_video["path"])
    jrows, jcuts, jhist, jshots = _histogram_and_shots(jsc, jst, jvideo,
                                                       work_packet_size=64)
    tsc = st.Client(db_path=str(tmp_path / "torch_db"), device="cpu")
    tvideo = st.NamedVideoStream(tsc, "test1", path=test_video["path"])
    rows, cuts, thist, tshots = _histogram_and_shots(tsc, st, tvideo,
                                                     work_packet_size=64)
    np.testing.assert_array_equal(rows, jrows)
    np.testing.assert_array_equal(rows, histogram_reference_np(video_frames))
    assert cuts == jcuts == test_video["cuts"]
    for j, t in ((jhist, thist), (jshots, tshots)):
        for fn in ("data.pack", "manifest.json"):
            with open(os.path.join(j._dir, fn), "rb") as fj, \
                    open(os.path.join(t._dir, fn), "rb") as ft:
                assert fj.read() == ft.read(), (j.name, fn)
    # each package loads the stream the other wrote
    cross_t = st.NamedStream(str(tmp_path / "jax_db"), jhist.name)
    cross_j = jst.NamedStream(str(tmp_path / "torch_db"), thist.name)
    np.testing.assert_array_equal(
        np.stack([np.stack(r) for r in cross_t.load()]), jrows)
    np.testing.assert_array_equal(
        np.stack([np.stack(r) for r in cross_j.load()]), rows)
    assert next(st.NamedStream(str(tmp_path / "jax_db"),
                               jshots.name).load(rows=[0])) == jcuts


def test_gather(tsc, tvideo, video_frames):
    idx = [0, 10, 33, 239]
    frame = tsc.io.Input([tvideo])
    hist = tsc.ops.Histogram(frame=tsc.streams.Gather(frame, [idx]))
    out = st.NamedStream(tsc, "hist_gather")
    tsc.run(tsc.io.Output(hist, [out]), st.PerfParams.estimate(),
            cache_mode=st.CacheMode.Overwrite)
    got = np.stack([np.stack(r) for r in out.load()])
    np.testing.assert_array_equal(got,
                                  histogram_reference_np(video_frames[idx]))


def test_cache_modes(tsc, tvideo):
    frame = tsc.io.Input([tvideo])
    hist = tsc.ops.Histogram(frame=frame)
    out = st.NamedStream(tsc, "hist_cache")
    o = tsc.io.Output(hist, [out])
    pp = st.PerfParams.manual(work_packet_size=64)
    tsc.run(o, pp, cache_mode=st.CacheMode.Overwrite)
    reads = tsc.profiler.totals()["source:read"]
    with pytest.raises(RuntimeError):
        tsc.run(o, pp, cache_mode=st.CacheMode.Error)
    tsc.run(o, pp, cache_mode=st.CacheMode.Ignore)  # skips silently
    tsc.run(o, pp, cache_mode=st.CacheMode.Resume)  # committed: skipped
    assert tsc.profiler.totals()["source:read"] == reads
    tsc.run(o, pp, cache_mode=st.CacheMode.Overwrite)  # recomputes
    assert tsc.profiler.totals()["source:read"] > reads
    assert out.committed() and len(out) == len(tvideo)


def test_forced_cpu_segment(tsc, tvideo, video_frames):
    frame = tsc.io.Input([tvideo])
    hist = tsc.ops.Histogram(frame=frame, device=st.DeviceType.CPU)
    out = st.NamedStream(tsc, "hist_cpu")
    tsc.run(tsc.io.Output(hist, [out]),
            st.PerfParams.manual(work_packet_size=64, ingest="rgb"),
            cache_mode=st.CacheMode.Overwrite)
    assert "device:Histogram@cpu" in tsc.profiler.totals()
    got = np.stack([np.stack(r) for r in out.load(rows=[0, 100])])
    np.testing.assert_array_equal(
        got, histogram_reference_np(video_frames[[0, 100]]))


def test_python_stream_of_frames(tsc):
    """Frames that are not a FrameChunk (NHWC u8 from a PythonStream) take
    the RGB byte-stream path with c = C."""
    frames = np.random.default_rng(0).integers(0, 256, (5, 12, 10, 3),
                                               np.uint8)
    frame = tsc.io.Input([st.PythonStream(list(frames))])
    hist = tsc.ops.Histogram(frame=frame)
    out = st.NamedStream(tsc, "hist_py")
    tsc.run(tsc.io.Output(hist, [out]),
            st.PerfParams.manual(work_packet_size=2),
            cache_mode=st.CacheMode.Overwrite)
    got = np.stack([np.stack(r) for r in out.load()])
    np.testing.assert_array_equal(got, histogram_reference_np(frames))


def test_trace_dir_writes_a_torch_profiler_trace(tsc, tvideo, tmp_path):
    frame = tsc.io.Input([tvideo])
    out = st.NamedStream(tsc, "hist_traced")
    tsc.run(tsc.io.Output(tsc.ops.Histogram(frame=frame), [out]),
            st.PerfParams.manual(work_packet_size=128),
            cache_mode=st.CacheMode.Overwrite,
            trace_dir=str(tmp_path / "trace"))
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0


def test_client_default_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: Client() uses it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        st.Client(db_path=str(tmp_path / "db"))


def test_claims_job_distribution_is_refused(tsc, tvideo, tmp_path):
    """Claims mode runs (one worker, two jobs) and its rows equal the
    static run's; a job distribution that is neither still raises."""
    frame = tsc.io.Input([tvideo, tvideo])
    hist = tsc.ops.Histogram(frame=frame)
    perf = st.PerfParams.manual(work_packet_size=64, ingest="rgb")
    static = [st.NamedStream(tsc, f"hist_static{j}") for j in range(2)]
    tsc.run(tsc.io.Output(hist, static), perf,
            cache_mode=st.CacheMode.Overwrite)
    claims = [st.NamedStream(tsc, f"hist_claims{j}") for j in range(2)]
    tsc.run(tsc.io.Output(hist, claims), perf,
            cache_mode=st.CacheMode.Overwrite, job_distribution="claims")
    for a, b in zip(static, claims):
        assert [np.stack(r).tobytes() for r in a.load()] == \
            [np.stack(r).tobytes() for r in b.load()]
    assert os.listdir(os.path.join(tsc.config.db_path, "_claims"))
    with pytest.raises(NotImplementedError):
        tsc.run(tsc.io.Output(hist, claims), job_distribution="hosts")


@pytest.mark.parametrize("make", ["manual", "estimate"])
@pytest.mark.parametrize("knob", ["pipeline_instances_per_node",
                                  "pipeline_stages", "spatial_shards",
                                  "expert_shards"])
def test_unported_perf_knobs_are_refused(make, knob):
    """The data mesh and the pipeline/spatial/expert axes used to be
    unported, and their knobs raised. They are ported now: each knob is
    kept with the JAX package's meaning, and a knob the port does not
    have is still refused rather than silently ignored."""
    perf = getattr(st.PerfParams, make)(**{knob: 2})
    assert getattr(perf, knob) == 2
    with pytest.raises(TypeError):
        getattr(st.PerfParams, make)(**{knob + "_unknown": 2})


@pytest.mark.parametrize("make", ["manual", "estimate"])
def test_recycle_rss_mb_is_accepted(make):
    """Worker recycling is ported: the knob is kept, and resolve() carries
    it into a job's concrete params."""
    perf = getattr(st.PerfParams, make)(recycle_rss_mb=2)
    assert perf.recycle_rss_mb == 2
    assert perf.resolve(1920 * 1080 * 3).recycle_rss_mb == 2


@register_op("TorchTestScaled", kind="device",
             aux=lambda ctx, params: {"scale": np.float32([params["k"]])})
def _scaled(ctx, aux, frames, k=1.0):
    assert aux["scale"].device == ctx.device  # moved once by the executor
    return frames.hwc_f32().mean(dim=(1, 2, 3)) * aux["scale"]


def test_aux_is_moved_to_the_device_once(tsc, tvideo, video_frames):
    frame = tsc.io.Input([tvideo])
    out = st.NamedStream(tsc, "scaled")
    tsc.run(tsc.io.Output(tsc.ops.TorchTestScaled(frame=frame, k=2.0),
                          [out]),
            st.PerfParams.manual(work_packet_size=64, ingest="rgb"),
            cache_mode=st.CacheMode.Overwrite)
    got = np.array([np.asarray(x).item() for x in out.load(rows=[0, 5])])
    want = video_frames[[0, 5]].astype(np.float32).mean(axis=(1, 2, 3)) * 2
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert len(tsc._executor._aux) == 1


@register_op("TorchTestCompact", kind="device", compact_sink="out_dtype")
def _compact(ctx, frames, out_dtype="float32"):
    return frames.hwc_f32()[:, :1, :1, 0]


def test_sink_dtype_steering_drops_stale_params(tsc, tvideo):
    """An injected compact-sink param is dropped once the node gains an op
    consumer, or when steering is off; an explicit param is never touched
    (the JAX executor kept the stale param in its auto branch)."""
    from scannertools_tpu_torch.graph import toposort
    from scannertools_tpu_torch.runtime.executor import Executor

    frame = tsc.io.Input([tvideo])
    node = tsc.ops.TorchTestCompact(frame=frame)
    sink_only = tsc.io.Output(node, [st.NamedStream(tsc, "c")])
    steer = Executor._steer_sink_dtypes
    steer(st.PerfParams.manual(), toposort(sink_only), sink_only)
    assert node.params["out_dtype"] == "float16"
    steer(st.PerfParams.manual(sink_dtype="float32"), toposort(sink_only),
          sink_only)
    assert "out_dtype" not in node.params
    steer(st.PerfParams.manual(), toposort(sink_only), sink_only)
    consumed = tsc.io.Output([node, tsc.ops.Histogram(frame=node)],
                             [(st.NamedStream(tsc, "c"),
                               st.NamedStream(tsc, "h"))])
    steer(st.PerfParams.manual(), toposort(consumed), consumed)
    assert "out_dtype" not in node.params
    explicit = tsc.ops.TorchTestCompact(frame=frame, out_dtype="float32")
    out = tsc.io.Output(explicit, [st.NamedStream(tsc, "e")])
    steer(st.PerfParams.manual(), toposort(out), out)
    assert explicit.params["out_dtype"] == "float32"
