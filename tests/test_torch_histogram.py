"""Histogram kernels of the PyTorch port held to the JAX package.

The port's plain versions (``hist_rgb_plain``, ``hist_i420_plain``) are what
its wrappers compute for CPU tensors, and the yardstick its CUDA kernels are
held to on the card. Here they are held to the JAX package's formulations
on the same inputs, made from a seed with numpy:

* RGB: bit-equal to ``histogram_reference_np``, ``_histogram_jnp_flat``,
  ``_histogram_jnp_flat_exact`` and the Pallas kernel run by the Pallas
  interpreter, at a sub-tile geometry with tail-byte masking and a geometry
  with a ragged last row tile, and for 1- and 4-channel byte streams.
* I420: bit-equal to the JAX package's numpy conversion (``hwc_u8`` of a
  host chunk) for all four coefficient sets, and within an L1 distance of
  ``2 + 2*ceil(npix/100000)`` per frame of the jitted JAX op. XLA does not
  evaluate the conversion in the written order (it rewrites ``(Y-16)*ys``
  as ``Y*ys - 16*ys``), which moves a value that lies within one float32
  ulp of an integer across the floor; test_torch_framechunk.py bounds how
  often (rare flips, each by 1).

The CUDA kernels themselves are compared with the plain versions by
test_torch_kernels_cuda.py on the card.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scannertools_tpu.ops import histogram as jhist
from scannertools_tpu.utils.framechunk import FrameChunk as JFrameChunk
from scannertools_tpu_torch.ops import histogram as H
from scannertools_tpu_torch.utils.framechunk import FrameChunk

RGB_GEOMETRIES = [(3, 33, 17, 3), (2, 120, 128, 3)]
COEF_SETS = [(False, False), (False, True), (True, False), (True, True)]


def _rgb_frames(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _i420_planes(t, h, w, seed=1):
    return np.random.default_rng(seed).integers(
        0, 256, (t, h * w * 3 // 2), np.uint8)


def _jax_reference(name, frames):
    chunk = JFrameChunk.from_hwc(frames)
    c = frames.shape[-1]
    if name == "histogram_reference_np":
        return jhist.histogram_reference_np(frames)
    if name == "jnp_flat":
        return np.asarray(jhist._histogram_jnp_flat(
            jnp.asarray(chunk.flat), chunk.npix, c))
    if name == "jnp_flat_exact":
        return np.asarray(jhist._histogram_jnp_flat_exact(
            jnp.asarray(chunk.flat), chunk.npix, c))
    assert name == "pallas_interpret"
    return np.asarray(jhist._histogram_pallas(chunk, interpret=True))


@pytest.mark.parametrize("shape", RGB_GEOMETRIES, ids=str)
@pytest.mark.parametrize("reference", ["histogram_reference_np", "jnp_flat",
                                       "jnp_flat_exact", "pallas_interpret"])
def test_hist_rgb_plain_matches_jax(shape, reference):
    frames = _rgb_frames(shape)
    chunk = FrameChunk.from_hwc(frames)
    got = H.hist_rgb_plain(torch.from_numpy(chunk.flat), chunk.npix, 3)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_reference(reference, frames))


def test_rgb_geometries_exercise_both_ragged_modes():
    # sub-tile tail: the byte count is no multiple of the 128-byte lane row
    assert (33 * 17 * 3) % 128 != 0
    # ragged last tile: more rows than one Pallas tile, not a multiple
    rows = 120 * 128 * 3 // 128
    assert rows > jhist._TILE and rows % jhist._TILE != 0


@pytest.mark.parametrize("c", [1, 4])
@pytest.mark.parametrize("reference", ["jnp_flat", "jnp_flat_exact"])
def test_hist_rgb_plain_other_channel_counts(c, reference):
    frames = _rgb_frames((2, 21, 19, c), seed=c)
    chunk = FrameChunk.from_hwc(frames)
    got = H.hist_rgb_plain(torch.from_numpy(chunk.flat), chunk.npix, c)
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_reference(reference, frames))


@pytest.mark.parametrize("c", [1, 3, 4])
def test_histogram_op_nhwc_tensor_matches_jax(c):
    """A non-FrameChunk input (NHWC u8, e.g. frames from a PythonStream) is
    the same byte stream: the op serves it with npix = H*W*C, c = C."""
    frames = _rgb_frames((3, 17, 23, c), seed=10 + c)
    got = H.histogram(None, torch.from_numpy(frames))
    want = np.asarray(jhist.histogram(None, jnp.asarray(frames)))
    assert got.shape == (3, c, 16)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_take_plain_version_for_cpu_tensors():
    frames = _rgb_frames((2, 9, 11, 3))
    chunk = FrameChunk.from_hwc(frames)
    planes = _i420_planes(2, 10, 12)
    before = (H.hist_rgb.launches, H.hist_i420.launches)
    flat = torch.from_numpy(chunk.flat)
    assert torch.equal(H.hist_rgb(flat, chunk.npix, 3),
                       H.hist_rgb_plain(flat, chunk.npix, 3))
    ichunk = FrameChunk.from_i420(planes, 10, 12)
    iflat = torch.from_numpy(ichunk.flat)
    assert torch.equal(H.hist_i420(iflat, 10, 12),
                       H.hist_i420_plain(iflat, 10, 12))
    assert (H.hist_rgb.launches, H.hist_i420.launches) == before


def test_histogram_op_rejects_other_bin_counts():
    chunk = FrameChunk.from_hwc(_rgb_frames((1, 4, 4, 3))).device("cpu")
    with pytest.raises(ValueError):
        H.histogram(None, chunk, bins=8)


@pytest.mark.parametrize("bt709,full_range", COEF_SETS)
def test_hist_i420_plain_matches_jax_numpy_path(bt709, full_range):
    t, h, w = 3, 34, 46
    planes = _i420_planes(t, h, w, seed=2)
    jchunk = JFrameChunk.from_i420(planes, h, w, full_range=full_range,
                                   bt709=bt709)
    want = jhist.histogram_reference_np(jchunk.hwc_u8())
    chunk = FrameChunk.from_i420(planes, h, w, full_range=full_range,
                                 bt709=bt709)
    got = H.hist_i420_plain(torch.from_numpy(chunk.flat), h, w,
                            full_range, bt709)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bt709,full_range", COEF_SETS)
def test_hist_i420_plain_within_tolerance_of_jitted_jax(bt709, full_range):
    t, h, w = 4, 240, 320
    planes = _i420_planes(t, h, w, seed=3)
    jchunk = JFrameChunk.from_i420(planes, h, w, full_range=full_range,
                                   bt709=bt709)
    want = np.asarray(jhist.histogram(None, jchunk.device()))
    chunk = FrameChunk.from_i420(planes, h, w, full_range=full_range,
                                 bt709=bt709)
    got = H.hist_i420(torch.from_numpy(chunk.flat), h, w, full_range,
                      bt709).numpy()
    l1 = np.abs(got.astype(np.int64) - want).sum(axis=(1, 2))
    tol = 2 + 2 * math.ceil(h * w * 3 / 100_000)
    assert (l1 <= tol).all(), (l1, tol)
    # every frame's channels still count every pixel
    assert (got.sum(axis=2) == h * w).all()
