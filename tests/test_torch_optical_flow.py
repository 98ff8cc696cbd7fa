"""Farnebäck optical flow of the PyTorch port held to the JAX package.

Each stage and the whole of ``farneback_pairs`` take the same inputs, made
from a seed with numpy, through the JAX function (``jax.jit`` on the CPU,
as the JAX package's own tests run it) and its port. The port evaluates
every formula in the JAX package's written order, each operation rounded
on its own, and divides by a constant as jitted XLA does (a product with
the float32 reciprocal). Where it still differs, the bounds and reasons:

* Jitted XLA fuses a product and a sum into one fused multiply-add
  (``_sepconv``, ``_poly_exp``, the warps and equations of
  ``_update_matrices``, ``_solve_flow``), and its resize einsum adds its
  taps in its own order: a few float32 ulps a value. Run op by op (not
  jitted), JAX gives the port's values bit for bit in ``_sepconv``,
  ``_poly_exp`` and ``_solve_flow``, which these tests check too.
* ``_box_blur`` takes differences of float32 prefix sums, which are not
  exact: ``torch.cumsum`` accumulates in double on the CPU (in float32, in
  a parallel scan, on the card) where XLA adds in float32, so a window sum
  can differ by a few ulps of the prefix sums it comes from.
* The whole flow: those differences, through 12 solves, move the flow by
  a median of about 1e-5 px in the interior (at most 0.002 px measured at
  64x96 and 96x128, 3e-5 px over the texture video's pipelines; bound
  1e-4 median and 5e-3 max 16 px inside the border, 1e-2 anywhere), far
  inside the JAX package's own bar between its fast and exact warps
  (median 0.05 px).
* I420 ingest: the port converts YUV to RGB in the written order, jitted
  JAX does not (ROADMAP queue 3), so a gray pixel can differ by 1 before
  the flow. None did on the texture video (the same 3e-5 px as RGB); the
  bound leaves room for such a pixel: 0.05 px inside the border, 0.1
  anywhere.

``flow_update`` on a CPU tensor is its plain version; its CUDA kernel is
held to the plain version on the card by test_torch_kernels_cuda.py.
"""

import os

import cv2
import jax
import numpy as np
import pytest
import torch

import scannertools_tpu as jst
import scannertools_tpu_torch as st
from scannertools_tpu.ops import optical_flow as J
from scannertools_tpu_torch.ops import optical_flow as P
from test_torch_jax_decoder import jax_native_decoder


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _rel(got, want):
    """Largest difference over the largest magnitude of the reference."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _image(shape, seed=0):
    return (np.random.default_rng(seed).random(shape) * 255).astype(
        np.float32)


# ------------------------------------------------------------ stages


@pytest.mark.parametrize("mode", ["reflect", "edge"])
@pytest.mark.parametrize("shape,sigma,radius", [
    ((2, 33, 47), 1.5, 4),
    # the Gaussian before the 1/8 level (levels=3): radius 9 at full size,
    # on frames of at most 19 rows, and of fewer rows than the pad (numpy
    # reflects again, where torch's F.pad refuses)
    ((1, 19, 23), 3.5, 9),
    ((1, 6, 10), 3.5, 9)])
def test_sepconv(mode, shape, sigma, radius):
    img = _image(shape)
    k = J._gaussian_kernel1d(sigma, radius)
    np.testing.assert_array_equal(P._gaussian_kernel1d(sigma, radius), k)
    got = P._sepconv(*_t(img), k, k, mode).numpy()
    np.testing.assert_array_equal(got, np.asarray(J._sepconv(img, k, k,
                                                             mode)))
    want = np.asarray(jax.jit(lambda x: J._sepconv(x, k, k, mode))(img))
    assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("src,dst", [((33, 47), (17, 24)), ((17, 24), (8, 12)),
                                     ((8, 12), (4, 6)), ((4, 6), (8, 12)),
                                     ((8, 12), (17, 24)),
                                     ((17, 24), (33, 47))])
def test_resize_bilinear_odd_pyramid_sizes(src, dst):
    """The pyramid's own sizes, int(round(H * scale)) of 33x47, down and
    (the flow's x2 upsample) up again."""
    img = _image((2,) + src, seed=1)
    got = P._resize_bilinear(*_t(img), *dst).numpy()
    want = np.asarray(jax.jit(lambda x: J._resize_bilinear(x, *dst))(img))
    assert _rel(got, want) <= 1e-6


def test_poly_exp():
    img = _image((2, 33, 47), seed=2)
    got = P._poly_exp(*_t(img), 5, 1.2).numpy()
    np.testing.assert_array_equal(got, np.asarray(J._poly_exp(img, 5, 1.2)))
    want = np.asarray(jax.jit(lambda x: J._poly_exp(x, 5, 1.2))(img))
    assert got.shape == (2, 33, 47, 5) and _rel(got, want) <= 1e-5


def _update_inputs(t, h, w, seed=3):
    rng = np.random.default_rng(seed)
    r0 = rng.normal(0, 10, (t, h, w, 5)).astype(np.float32)
    r1 = rng.normal(0, 10, (t, h, w, 5)).astype(np.float32)
    # displacements past warp_px and past the frame, to exercise the clamps
    flow = rng.normal(0, 8, (t, h, w, 2)).astype(np.float32)
    return r0, r1, flow


@pytest.mark.parametrize("warp_px", [16, 4, 0])
@pytest.mark.parametrize("t,h,w", [(2, 33, 47),
                                   (1, 8, 12),   # ry, rx < warp_px
                                   (1, 2, 5)])   # a 2-row level
def test_update_matrices(warp_px, t, h, w):
    r0, r1, flow = _update_inputs(t, h, w)
    before = P.flow_update.launches
    got = P._update_matrices(*_t(r0, r1, flow), warp_px).numpy()
    assert P.flow_update.launches == before  # CPU tensors: plain version
    np.testing.assert_array_equal(
        got, P.flow_update_plain(*_t(r0, r1, flow), warp_px).numpy())
    want = np.asarray(jax.jit(
        lambda a, b, c: J._update_matrices(a, b, c, warp_px))(r0, r1, flow))
    assert got.shape == (t, h, w, 5) and _rel(got, want) <= 1e-5


def test_shift_warp_equals_the_select_over_shifts_loop():
    """The gathered shift-warp is the JAX loop's value, term for term:
    run op by op, JAX gives it bit for bit."""
    rng = np.random.default_rng(4)
    img = rng.normal(0, 10, (2, 21, 30, 5)).astype(np.float32)
    fy = (np.arange(21, dtype=np.float32)[None, :, None]
          + rng.normal(0, 9, (2, 21, 30)).astype(np.float32))
    fx = (np.arange(30, dtype=np.float32)[None, None, :]
          + rng.normal(0, 9, (2, 21, 30)).astype(np.float32))
    for warp_px in (16, 5, 1):
        np.testing.assert_array_equal(
            P._shift_warp(*_t(img, fy, fx), warp_px).numpy(),
            np.asarray(J._shift_warp(img, fy, fx, warp_px)))
    np.testing.assert_array_equal(
        P._bilinear_sample(*_t(img, fy, fx)).numpy(),
        np.asarray(J._bilinear_sample(img, fy, fx)))


def test_box_blur():
    m = np.random.default_rng(5).normal(0, 100, (2, 33, 47, 5)).astype(
        np.float32)
    got = P._box_blur(*_t(m), 15).numpy()
    want = np.asarray(jax.jit(lambda x: J._box_blur(x, 15))(m))
    # window sums of prefix sums whose magnitude is up to 20 x 60 values
    assert got.shape == m.shape and _rel(got, want) <= 1e-4


def test_solve_flow():
    rng = np.random.default_rng(6)
    a = rng.normal(0, 3, (2, 33, 47, 2, 2)).astype(np.float32)
    g = np.einsum("...ij,...kj->...ik", a, a) + np.eye(2, dtype=np.float32)
    h = rng.normal(0, 5, (2, 33, 47, 2)).astype(np.float32)
    m = np.stack([g[..., 0, 0], g[..., 0, 1], g[..., 1, 1], h[..., 0],
                  h[..., 1]], axis=-1).astype(np.float32)
    m[0, 0, 0] = 0.0  # singular: no update
    got = P._solve_flow(*_t(m)).numpy()
    np.testing.assert_array_equal(got, np.asarray(J._solve_flow(m)))
    want = np.asarray(jax.jit(J._solve_flow)(m))
    assert (got[0, 0, 0] == 0).all()
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("make", [
    lambda r0, r1, f: (r0.double(), r1, f),
    lambda r0, r1, f: (r0, r1, f.transpose(1, 2)),
    lambda r0, r1, f: (r0, r1[:, :-1], f),
    lambda r0, r1, f: (r0[..., :4], r1, f)])
def test_flow_update_refuses_bad_arguments(make):
    r0, r1, flow = _t(*_update_inputs(1, 6, 6))
    with pytest.raises((TypeError, ValueError)):
        P.flow_update(*make(r0, r1, flow))
    with pytest.raises(ValueError):
        P.flow_update(r0, r1, flow, warp_px=-1)


# ------------------------------------------------------------ whole flow


def _make_pair(shift, hw=(96, 128), seed=0):
    rng = np.random.default_rng(seed)
    base = cv2.GaussianBlur(
        rng.integers(0, 256, hw, np.uint8).astype(np.float32), (0, 0), 3.0)
    m = np.float32([[1, 0, shift[0]], [0, 1, shift[1]]])
    return base, np.clip(cv2.warpAffine(base, m, hw[::-1]), 0, 255)


def _assert_flow_close(got, want, margin=16, median=1e-4, interior=5e-3,
                       anywhere=1e-2):
    d = np.abs(np.asarray(got, np.float64) - want)
    inner = d[:, margin:-margin, margin:-margin]
    assert np.median(inner) <= median and inner.max() <= interior \
        and d.max() <= anywhere, (np.median(inner), inner.max(), d.max())


@pytest.mark.parametrize("warp_px", [16, 0])
@pytest.mark.parametrize("t,h,w", [(2, 64, 96), (1, 96, 128)])
def test_farneback_pairs_matches_jax(t, h, w, warp_px):
    pairs = [_make_pair((1.5 + s, -0.7 * (s + 1)), (h, w), seed=s)
             for s in range(t)]
    g0 = np.stack([p[0] for p in pairs])
    g1 = np.stack([p[1] for p in pairs])
    got = P.farneback_pairs(*_t(g0, g1), warp_px=warp_px).numpy()
    want = np.asarray(jax.jit(
        lambda a, b: J.farneback_pairs(a, b, warp_px=warp_px))(g0, g1))
    assert got.shape == (t, h, w, 2)
    _assert_flow_close(got, want)


@pytest.mark.parametrize("shift,hw,margin,bound", [
    ((2.3, -1.7), (96, 128), 24, 0.15),
    # past the per-iteration increment, inside the warp bound
    ((10.4, -6.2), (240, 320), 40, 0.2)])
def test_flow_recovers_translation(shift, hw, margin, bound):
    g0, g1 = _make_pair(shift, hw, seed=7 if hw[0] == 240 else 0)
    flow = P.farneback_pairs(*_t(g0[None], g1[None])).numpy()[0]
    err = np.linalg.norm(flow[margin:-margin, margin:-margin]
                         - np.array(shift), axis=-1)
    assert np.median(err) < bound, np.median(err)


def test_optical_flow_op_dtypes():
    frames = np.random.default_rng(8).integers(0, 256, (3, 20, 24, 3),
                                               np.uint8)
    op = st.registry.get_op("OpticalFlow")
    assert op.stencil == (0, 1) and op.compact_sink == "out_dtype"
    f32 = op.fn(None, torch.from_numpy(frames))
    f16 = op.fn(None, torch.from_numpy(frames), out_dtype="float16")
    assert f32.shape == (2, 20, 24, 2) and f32.dtype == torch.float32
    assert torch.equal(f16, f32.to(torch.float16))
    with pytest.raises(ValueError, match="out_dtype"):
        op.fn(None, torch.from_numpy(frames), out_dtype="bfloat16")


# ------------------------------------------------------------ pipelines


def _flow_stream(pkg, db, texture_video, sample, ingest, name="flow",
                 **flow_kw):
    kw = dict(device="cpu") if pkg is st else {}
    if pkg is jst and ingest != "rgb":
        jax_native_decoder()
    sc = pkg.Client(db_path=db, **kw)
    video = pkg.NamedVideoStream(sc, "tex", path=texture_video["path"])
    frame = sc.io.Input([video])
    flow = sc.ops.OpticalFlow(frames=sample(sc, frame), **flow_kw)
    out = pkg.NamedStream(sc, name)
    sc.run(sc.io.Output(flow, [out]),
           pkg.PerfParams.manual(work_packet_size=8, ingest=ingest),
           cache_mode=pkg.CacheMode.Overwrite)
    return np.stack(list(out.load())), out


SAMPLINGS = {
    "range": lambda sc, f: sc.streams.Range(f, [(0, 16)]),
    "stride": lambda sc, f: sc.streams.Stride(f, [3]),
}


@pytest.mark.parametrize("sampling,ingest", [("range", "rgb"),
                                             ("stride", "rgb"),
                                             ("range", "i420")])
def test_flow_pipeline_matches_jax(tmp_path, texture_video, sampling,
                                   ingest):
    """Both packages' Client.run over the conftest texture video, 16
    sampled rows in chunks of 8: the last row pairs the last frame with
    itself (the stencil's clamp at the stream end)."""
    sample = SAMPLINGS[sampling]
    got, tout = _flow_stream(st, str(tmp_path / "t"), texture_video, sample,
                             ingest, out_dtype="float32")
    want, jout = _flow_stream(jst, str(tmp_path / "j"), texture_video,
                              sample, ingest, out_dtype="float32")
    h, w = texture_video["h"], texture_video["w"]
    assert got.shape == want.shape == (16, h, w, 2)
    assert got.dtype == np.float32
    if ingest == "rgb":
        _assert_flow_close(got, want)
    else:
        _assert_flow_close(got, want, interior=0.05, anywhere=0.1)
    assert np.abs(got[-1]).max() < 1e-3  # the last frame against itself
    # the pan: 1 px per source frame, content moving left
    step = 3 if sampling == "stride" else 1
    inner = got[:-1, 16:-16, 16:-16]
    assert abs(np.median(inner[..., 0]) + step) < 0.3
    assert abs(np.median(inner[..., 1])) < 0.3
    # each package loads the stream the other wrote
    cross = st.NamedStream(os.path.dirname(jout._dir), jout.name)
    np.testing.assert_array_equal(np.stack(list(cross.load())), want)
    cross = jst.NamedStream(os.path.dirname(tout._dir), tout.name)
    np.testing.assert_array_equal(np.stack(list(cross.load())), got)


@pytest.mark.parametrize("case", ["auto", "consumed", "explicit", "off"])
def test_flow_f16_sink_auto_steering(tmp_path, texture_video, case):
    """The JAX package's test_flow_f16_sink_auto_steering, on the port:
    the same stored bytes in all four cases."""
    h, w = texture_video["h"], texture_video["w"]
    sc = st.Client(db_path=str(tmp_path / "db"), device="cpu")
    video = st.NamedVideoStream(sc, "tex", path=texture_video["path"])
    flow = sc.ops.OpticalFlow(
        frames=sc.streams.Range(sc.io.Input([video]), [(0, 4)]),
        **({"out_dtype": "float32"} if case == "explicit" else {}))
    outs = st.NamedStream(sc, f"steerflow_{case}")
    cols, sinks = flow, [outs]
    if case == "consumed":
        cols = [flow, sc.ops.FlowHistogram(flow=flow)]
        sinks = [(outs, st.NamedStream(sc, "steerfh"))]
    perf = st.PerfParams.manual(
        work_packet_size=4,
        **({"sink_dtype": "float32"} if case == "off" else {}))
    sc.run(sc.io.Output(cols, sinks), perf,
           cache_mode=st.CacheMode.Overwrite)
    elems = list(outs.load())
    assert all(e.dtype == np.float32 and e.shape == (h, w, 2)
               for e in elems)
    stored = sum(len(b) for b in outs.load_bytes(range(4)))
    f16_bytes = 4 * (8 + h * w * 2 * 2)
    f32_bytes = 4 * (8 + h * w * 2 * 4)
    assert stored == (f16_bytes if case == "auto" else f32_bytes)
