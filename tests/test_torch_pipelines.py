"""The port's legacy pipeline runners and block graphs
(scannertools_tpu_torch/pipelines) held to the JAX package's, the cases of
tests/test_pipelines.py among them.

The exact runners (histograms, HSV histograms, shots, brightness,
contrast, sharpness) run in both packages over the conftest video with
``Client(device="cpu")`` for the port, and give equal rows; the flow
runners give flow within the bounds of test_torch_optical_flow.py (a
median of 1e-4 px and at most 5e-3 px 16 px inside the border, 1e-2
anywhere) and flow histograms within an L1 distance of 4 a frame (the
bound test_torch_imgproc.py states for ``atan2``), which also covers the
bins those flow differences move; the angles of the last row, the last
frame paired with itself (a flow below 1e-3 px), are rounding noise in
both packages and are not compared. The net runners (faces, embeddings, genders, objects, poses)
give rows equal to the port's own direct graphs of the same ops; and one
face case runs both packages on one npz of the JAX package's weights
through a ``build_pipeline`` subclass, held as test_torch_faces.py holds
the face graphs.
"""

import jax
import numpy as np
import pytest

import scannertools_tpu as jst
import scannertools_tpu.pipelines as jpl
import scannertools_tpu_torch as st
import scannertools_tpu_torch.pipelines as ppl
from scannertools_tpu.models import mtcnn as JM
from scannertools_tpu.models import weights as JW
from scannertools_tpu.ops.histogram import histogram_reference_np
from test_torch_jax_decoder import jax_native_decoder
from test_torch_optical_flow import _assert_flow_close

ZERO = (0.0, 0.0, 0.0)
BOX_ATOL = 1e-5  # normalized boxes and scores, as test_torch_faces.py


def _clients(tmp_path):
    jax_native_decoder()  # "auto" ingest: both packages decode I420 alike
    return (st.Client(db_path=str(tmp_path / "p"), device="cpu"),
            jst.Client(db_path=str(tmp_path / "j")))


def _rows(outs):
    return [list(o.load()) for o in outs]


def _video(pkg, sc, path, name="test1"):
    return pkg.NamedVideoStream(sc, name, path=path)


def test_pipelines_export_every_runner():
    names = [n for n in jpl.__all__]
    assert sorted(ppl.__all__) == sorted(names)
    for n in names:  # the runners and classes; the submodules aside
        assert callable(getattr(ppl, n)) or n in ("blocks", "prelude",
                                                  "std"), n


# ------------------------------------------------ the JAX package's cases


def test_compute_histograms_runner(tmp_path, test_video, video_frames):
    psc, jsc = _clients(tmp_path)
    frames = [list(range(0, 40, 5))]
    outs = ppl.compute_histograms(
        psc, videos=[_video(st, psc, test_video["path"])], frames=frames)
    assert len(outs) == 1
    got = list(outs[0].load())
    assert len(got) == 8
    want = histogram_reference_np(video_frames[0:40:5])
    assert (np.stack(got[0]) == want[0]).all()
    # job-level cache: a second run skips the committed output
    outs2 = ppl.compute_histograms(
        psc, videos=[_video(st, psc, test_video["path"])], frames=frames)
    assert outs2[0].committed() and outs2[0].name == outs[0].name
    jouts = jpl.compute_histograms(
        jsc, videos=[_video(jst, jsc, test_video["path"])], frames=frames)
    assert [np.stack(r).tolist() for r in got] == \
        [np.stack(r).tolist() for r in jouts[0].load()]


def test_runner_takes_a_path(tmp_path, test_video):
    """A path string ingests under the file's base name."""
    psc, _ = _clients(tmp_path)
    outs = ppl.compute_brightness(psc, videos=[test_video["path"]],
                                  frames=[[0, 1, 2]])
    assert outs[0].name == "short_video_brightness"
    vals = list(outs[0].load())
    assert len(vals) == 3 and all(0 <= float(v[0]) <= 255 for v in vals)


# Contrast and Sharpness are means of squared deviations, summed in
# another order: a relative difference of at most 1e-5, as
# test_torch_imgproc.py states; the others are bit-equal
RUNNER_RTOL = {"compute_contrast": 1e-5, "compute_sharpness": 1e-5}


@pytest.mark.parametrize("runner", [
    "compute_brightness", "compute_contrast", "compute_sharpness",
    "compute_hsv_histograms", "compute_histograms"])
def test_exact_runner_equals_jax(tmp_path, test_video, runner):
    psc, jsc = _clients(tmp_path)
    frames = [[0, 1, 59, 60, 61, 130, 239]]
    got = getattr(ppl, runner)(
        psc, videos=[_video(st, psc, test_video["path"])], frames=frames)
    want = getattr(jpl, runner)(
        jsc, videos=[_video(jst, jsc, test_video["path"])], frames=frames)
    assert got[0].name == want[0].name
    g, w = _rows(got)[0], _rows(want)[0]
    assert len(g) == len(w) == 7
    for a, b in zip(g, w):
        if runner in RUNNER_RTOL:
            np.testing.assert_allclose(a, b, rtol=RUNNER_RTOL[runner],
                                       atol=0)
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_shot_detection_pipeline_runner(tmp_path, test_video):
    psc, jsc = _clients(tmp_path)
    got = ppl.detect_shots(psc, videos=[_video(st, psc, test_video["path"])])
    want = jpl.detect_shots(jsc, videos=[_video(jst, jsc,
                                                test_video["path"])])
    found = next(got[0].load(rows=[0]))
    assert found == test_video["cuts"] == next(want[0].load(rows=[0]))
    # each package reads the other's stream: equal bytes
    theirs = jst.NamedStream(str(tmp_path / "p"), got[0].name)
    ours = st.NamedStream(str(tmp_path / "j"), want[0].name)
    assert len(theirs) == len(ours) == test_video["n"]
    assert list(theirs.load_bytes()) == list(ours.load_bytes())


def test_flow_runners_equal_jax(tmp_path, texture_video):
    """compute_flow and compute_flow_histograms over 8 frames of the
    texture video in both packages."""
    psc, jsc = _clients(tmp_path)
    frames = [list(range(8))]
    out = {}
    for pkg, lib, sc in ((st, ppl, psc), (jst, jpl, jsc)):
        video = _video(pkg, sc, texture_video["path"], "tex")
        flow = lib.compute_flow(sc, videos=[video], frames=frames)
        hist = lib.compute_flow_histograms(sc, videos=[video], frames=frames)
        out[pkg] = (np.stack(list(flow[0].load())),
                    np.stack(list(hist[0].load())))
    (pf, ph), (jf, jh) = out[st], out[jst]
    assert pf.shape == jf.shape == (8, texture_video["h"],
                                    texture_video["w"], 2)
    _assert_flow_close(pf, jf)
    assert ph.shape == jh.shape == (8, 2, 64)
    d = np.abs(ph.astype(np.int64) - jh)
    assert (d[:, 0].sum(axis=1) <= 4).all()  # magnitudes
    # angles: the last row pairs the last frame with itself, a flow below
    # 1e-3 px whose angles are the signs of rounding noise in each package
    assert np.abs(pf[-1]).max() < 1e-3 and np.abs(jf[-1]).max() < 1e-3
    assert (d[:-1, 1].sum(axis=1) <= 4).all()


def test_block_graph_api(tmp_path, test_video):
    """Block/BlockGraph wiring (reference old/pipeline.py:12-211): blocks
    resolve inputs by output name, toposort themselves, run through
    sinks; the same graph in the JAX package gives the same rows."""
    psc, jsc = _clients(tmp_path)
    rows = {}
    for pkg, lib, sc in ((st, ppl, psc), (jst, jpl, jsc)):
        video = _video(pkg, sc, test_video["path"])
        g = lib.BlockGraph(sc)
        g.add(lib.ShotBoundariesBlock())  # out of order: toposort fixes it
        g.add(lib.FrameSourceBlock(video))
        g.add(lib.HistogramBlock())
        out = pkg.NamedStream(sc, "block_shots")
        g.run(sinks={"boundaries": out},
              perf_params=pkg.PerfParams.manual(work_packet_size=64))
        rows[pkg] = next(out.load(rows=[0]))
    assert rows[st] == rows[jst] == test_video["cuts"]
    video = _video(st, psc, test_video["path"])
    g2 = ppl.BlockGraph(psc)
    g2.add(ppl.HistogramBlock())
    with pytest.raises(ValueError, match="unsatisfiable"):
        g2.wire()
    g3 = ppl.BlockGraph(psc)
    g3.add(ppl.FrameSourceBlock(video))
    with pytest.raises(KeyError, match="no block produced"):
        g3.run(sinks={"nope": st.NamedStream(psc, "x")})


def test_gather_block_and_face_block(tmp_path):
    """GatherBlock feeds a block that takes ``sampled``; FaceDetectBlock
    takes ``frame``: each block graph's rows equal the direct graph's."""
    from scannertools_tpu_torch import testing

    psc, _ = _clients(tmp_path)
    video, _ = testing.ingest_test_video(psc, "short", n=12, cuts=(6,))

    class SampledHistogram(ppl.Block):
        outputs = ["sampled_hist"]

        def build(self, sampled):
            return self.Output(
                sampled_hist=self.sc.ops.Histogram(frame=sampled))

    perf = st.PerfParams.manual(work_packet_size=4)
    g = ppl.BlockGraph(psc)
    for block in (ppl.FrameSourceBlock(video), ppl.GatherBlock([[0, 7]]),
                  SampledHistogram(), ppl.FaceDetectBlock()):
        g.add(block)
    hist, faces = st.NamedStream(psc, "bh"), st.NamedStream(psc, "bf")
    g.run(sinks={"sampled_hist": hist, "face_bboxes": faces},
          perf_params=perf)
    frame = psc.io.Input([video])
    direct = {"dh": psc.ops.Histogram(frame=psc.streams.Gather(frame,
                                                               [[0, 7]])),
              "df": psc.ops.MTCNNDetectFaces(frame=frame)}
    for name, node in direct.items():
        psc.run(psc.io.Output(node, [st.NamedStream(psc, name)]), perf,
                cache_mode=st.CacheMode.Overwrite)
    assert len(hist) == 2 and len(faces) == 12
    assert list(hist.load_bytes()) == list(st.NamedStream(
        psc, "dh").load_bytes())
    assert list(faces.load_bytes()) == list(st.NamedStream(
        psc, "df").load_bytes())


# ------------------------------------------------ net runners


NET_RUNNERS = {
    # runner: (direct graph of the same ops over frame g)
    "detect_faces": lambda sc, g: sc.ops.MTCNNDetectFaces(frame=g),
    "embed_faces": lambda sc, g: sc.ops.EmbedFaces(
        frame=g, bboxes=sc.ops.MTCNNDetectFaces(frame=g)),
    "detect_genders": lambda sc, g: sc.ops.DetectGender(
        frame=g, bboxes=sc.ops.MTCNNDetectFaces(frame=g)),
    "detect_objects": lambda sc, g: sc.ops.DetectObjects(frame=g),
    "detect_poses": lambda sc, g: sc.ops.OpenPose(frame=g),
}


def _equal_rows(a, b):
    if isinstance(a, np.ndarray):
        return a.shape == b.shape and np.array_equal(a, b)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal_rows(x, y)
                                        for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("runner", list(NET_RUNNERS))
def test_net_runner_equals_direct_graph(tmp_path, test_video, runner):
    psc, _ = _clients(tmp_path)
    frames = [[0, 70]]
    video = _video(st, psc, test_video["path"])
    got = getattr(ppl, runner)(psc, videos=[video], frames=frames)
    g = psc.streams.Gather(psc.io.Input([video]), frames)
    want = st.NamedStream(psc, f"direct_{runner}")
    psc.run(psc.io.Output(NET_RUNNERS[runner](psc, g), [want]),
            st.PerfParams.estimate(), cache_mode=st.CacheMode.Overwrite)
    g_rows, w_rows = list(got[0].load()), list(want.load())
    assert len(g_rows) == 2
    assert _equal_rows(g_rows, w_rows)


def test_face_runner_subclass_equals_jax(tmp_path, test_video):
    """FaceDetectionPipeline's documented extension point, build_pipeline,
    passing weights and thresholds: both packages on one npz of the JAX
    package's weights give the same faces (boxes and scores within 1e-5)."""
    path = str(tmp_path / "mtcnn.npz")
    JW.save_params(path, JM.init_params(jax.random.PRNGKey(0)))
    psc, jsc = _clients(tmp_path)
    rows = {}
    for pkg, lib, sc in ((st, ppl, psc), (jst, jpl, jsc)):
        class Faces(lib.FaceDetectionPipeline):
            run_opts = {"work_packet_size": 2, "ingest": "rgb"}

            def build_pipeline(self):
                return self._sc.ops.MTCNNDetectFaces(
                    frame=self._sources["frame"], weights_path=path,
                    thresholds=ZERO)

        outs = Faces.make_runner()(sc, videos=[_video(pkg, sc,
                                                      test_video["path"])],
                                   frames=[[0, 1, 70, 130]])
        assert outs[0].name == "test1_faces"
        rows[pkg] = list(outs[0].load())
    got, want = rows[st], rows[jst]
    assert [len(f) for f in got] == [len(f) for f in want]
    assert all(len(f) > 0 for f in got)
    for fg, fw in zip(got, want):
        for a, b in zip(fg, fw):
            np.testing.assert_allclose([a.x1, a.y1, a.x2, a.y2, a.score],
                                       [b.x1, b.y1, b.x2, b.y2, b.score],
                                       rtol=0, atol=BOX_ATOL)


def test_testing_helpers(tmp_path):
    """testing.py: a throwaway client on the CPU and the standard test
    video, whose shots cut where it says."""
    from scannertools_tpu_torch import testing

    sc = testing.make_client(str(tmp_path / "db"), device="cpu")
    assert sc.device.type == "cpu"
    stream, info = testing.ingest_test_video(sc, n=48, cuts=(16, 32))
    assert len(stream) == 48
    outs = ppl.detect_shots(sc, videos=[stream])
    assert next(outs[0].load(rows=[0])) == [16, 32] == info["cuts"]
    marker = testing.needs_cuda()
    assert marker.name == "skipif"
