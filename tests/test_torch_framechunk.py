"""FrameChunk of the PyTorch port held to the JAX package's, bit for bit:
the flat byte layouts, the u8 and float32 HWC views, and the YUV->RGB
conversion in numpy and in torch (inputs made from a seed with numpy)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scannertools_tpu.utils import framechunk as jfc
from scannertools_tpu_torch.utils import framechunk as tfc

COEF_SETS = [(False, False), (False, True), (True, False), (True, True)]


def _frames(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _planes(t, h, w, seed=1):
    return _frames((t, h * w * 3 // 2), seed)


@pytest.mark.parametrize("shape", [(2, 33, 17, 3), (3, 16, 8, 3),
                                   (2, 5, 7, 4)], ids=str)
def test_from_hwc_flat_bytes_and_views(shape):
    frames = _frames(shape)
    got = tfc.FrameChunk.from_hwc(frames)
    want = jfc.FrameChunk.from_hwc(frames)
    assert got.flat.shape == want.flat.shape
    np.testing.assert_array_equal(got.flat, want.flat)
    assert (got.npix, got.payload) == (want.npix, want.payload)
    np.testing.assert_array_equal(got.hwc_u8(), frames)
    dev = got.device("cpu")
    np.testing.assert_array_equal(dev.hwc_u8().numpy(), frames)
    np.testing.assert_array_equal(dev.hwc_f32().numpy(),
                                  np.asarray(want.hwc_f32()))
    np.testing.assert_array_equal(got.hwc_f32(), frames.astype(np.float32))


@pytest.mark.parametrize("bt709,full_range", COEF_SETS)
def test_i420_views_match_jax_numpy_path(bt709, full_range):
    t, h, w = 3, 18, 26
    planes = _planes(t, h, w)
    got = tfc.FrameChunk.from_i420(planes, h, w, full_range, bt709)
    want = jfc.FrameChunk.from_i420(planes, h, w, full_range, bt709)
    np.testing.assert_array_equal(got.flat, want.flat)
    assert got.payload == want.payload == h * w * 3 // 2
    np.testing.assert_array_equal(got.hwc_f32(), want.hwc_f32())
    np.testing.assert_array_equal(got.hwc_u8(), want.hwc_u8())
    # the torch path on the device gives the same bytes
    dev = got.device("cpu")
    np.testing.assert_array_equal(dev.hwc_f32().numpy(), want.hwc_f32())
    np.testing.assert_array_equal(dev.hwc_u8().numpy(), want.hwc_u8())


@pytest.mark.parametrize("bt709,full_range", COEF_SETS)
def test_yuv420_to_rgb_torch_matches_numpy(bt709, full_range):
    rng = np.random.default_rng(7)
    y = rng.integers(0, 256, (2, 40, 60)).astype(np.float32)
    u = rng.integers(0, 256, (2, 20, 30)).astype(np.float32)
    v = rng.integers(0, 256, (2, 20, 30)).astype(np.float32)
    want = jfc.yuv420_to_rgb(y, u, v, full_range, bt709, xp=np)
    got_np = tfc.yuv420_to_rgb(y, u, v, full_range, bt709, xp=np)
    got_t = tfc.yuv420_to_rgb(torch.from_numpy(y), torch.from_numpy(u),
                              torch.from_numpy(v), full_range, bt709,
                              xp=torch)
    assert got_t.dtype == torch.float32 and got_t.shape == (2, 40, 60, 3)
    np.testing.assert_array_equal(got_np, want)
    np.testing.assert_array_equal(got_t.numpy(), want)


def test_device_copy_never_aliases_host_buffer():
    frames = _frames((2, 8, 8, 3))
    chunk = tfc.FrameChunk.from_hwc(frames)
    dev = chunk.device("cpu")
    chunk.flat[...] = 0  # a staging slot reused by the decoder
    np.testing.assert_array_equal(dev.hwc_u8().numpy(), frames)
    back = dev.host()
    assert isinstance(back.flat, np.ndarray) and back.on_host
    np.testing.assert_array_equal(back.hwc_u8(), frames)


def test_slice_rows():
    t, h, w = 6, 10, 12
    planes = _planes(t, h, w, seed=4)
    chunk = tfc.FrameChunk.from_i420(planes, h, w)
    sl = chunk.slice_rows(2, 3)
    assert sl.fmt == "i420" and len(sl) == 3
    np.testing.assert_array_equal(sl.hwc_u8(), chunk.hwc_u8()[2:5])
    dev = chunk.device("cpu").slice_rows(2, 3)
    np.testing.assert_array_equal(dev.hwc_u8().numpy(), chunk.hwc_u8()[2:5])


@pytest.mark.parametrize("bt709,full_range", COEF_SETS)
def test_jitted_jax_conversion_differs_only_by_rare_floor_flips(bt709,
                                                                full_range):
    """Why the port's I420 histograms are held to jitted JAX by a tolerance:
    XLA does not evaluate yuv420_to_rgb in the written order (it rewrites
    (Y-16)*ys as Y*ys - 16*ys, for one), so a value within a float32 ulp of
    an integer can floor the other way. The port follows the written order
    and equals the numpy path exactly; jitted JAX differs from both in at
    most 10 of the 921,600 channel values here, each by 1."""
    t, h, w = 4, 240, 320
    planes = _planes(t, h, w, seed=3)
    jchunk = jfc.FrameChunk.from_i420(planes, h, w, full_range, bt709)
    written = jchunk.hwc_f32()
    jitted = np.asarray(jax.jit(
        lambda x: jfc.FrameChunk(x, h, w, 3, "i420", full_range,
                                 bt709).hwc_f32())(jnp.asarray(jchunk.flat)))
    port = tfc.FrameChunk.from_i420(planes, h, w, full_range,
                                    bt709).device("cpu").hwc_f32().numpy()
    np.testing.assert_array_equal(port, written)
    diff = np.abs(jitted - written)
    assert diff.max() <= 1.0
    assert (diff > 0).sum() <= 10
