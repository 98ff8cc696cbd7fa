"""The port's CUDA kernels held to their plain versions on the card
(difference 0), at small geometries that cover the ragged cases: lane
padding, unaligned NHWC rows (the byte-load path), 1 to 6 channels, all
four I420 coefficient sets, I420 widths that are not a multiple of 16 and
unaligned I420 frames; and at 1080p on the inputs that stress the
counters: flat-colour frames (every count of a channel in one bin) and
frames whose values all fall in bin 15 (for I420, values past 255, which
the kernel counts apart and folds into bin 15). The flow update kernel is
held to its plain version in both warp modes at ragged sizes: odd sides,
levels of at most 16 rows (where the shift-warp's bound is below
warp_px) and a 2-row level. Inputs are made from a seed with numpy.

Every test here needs a CUDA device and nvcc, and skips elsewhere. The
module imports no JAX, so it runs where only the port is installed:

    python -m pytest tests/test_torch_kernels_cuda.py -q

``chip_smoke.py`` repeats these checks at the main path's shapes.
"""

import numpy as np
import pytest
import torch

from scannertools_tpu_torch.ops import histogram as H
from scannertools_tpu_torch.ops import optical_flow as OF
from scannertools_tpu_torch.utils.framechunk import FrameChunk

pytestmark = pytest.mark.cuda

COEF_SETS = [(False, False), (False, True), (True, False), (True, True)]


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("t,h,w,c", [(3, 33, 17, 3), (2, 120, 128, 3),
                                     (2, 31, 29, 1), (2, 45, 37, 4)])
def test_hist_rgb_kernel_matches_plain(cuda_device, t, h, w, c):
    frames = np.random.default_rng(5).integers(0, 256, (t, h, w, c),
                                               np.uint8)
    flat = torch.from_numpy(FrameChunk.from_hwc(frames).flat)
    for x in (flat, torch.from_numpy(frames)):  # lane rows, NHWC rows
        x = x.to(cuda_device)
        before = H.hist_rgb.launches
        got = H.hist_rgb(x, h * w * c, c)
        assert H.hist_rgb.launches == before + 1
        assert torch.equal(got.cpu(), H.hist_rgb_plain(x, h * w * c, c).cpu())


@pytest.mark.parametrize("bt709,full_range", COEF_SETS)
def test_hist_i420_kernel_matches_plain(cuda_device, bt709, full_range):
    t, h, w = 3, 34, 46
    planes = np.random.default_rng(6).integers(0, 256, (t, h * w * 3 // 2),
                                               np.uint8)
    chunk = FrameChunk.from_i420(planes, h, w)
    flat = torch.from_numpy(chunk.flat).to(cuda_device)
    before = H.hist_i420.launches
    got = H.hist_i420(flat, h, w, full_range, bt709)
    assert H.hist_i420.launches == before + 1
    want = H.hist_i420_plain(flat, h, w, full_range, bt709)
    assert torch.equal(got.cpu(), want.cpu())


def test_histogram_op_on_device_chunk(cuda_device):
    frames = np.random.default_rng(7).integers(0, 256, (4, 40, 52, 3),
                                               np.uint8)
    chunk = FrameChunk.from_hwc(frames).device(cuda_device)
    got = H.histogram(None, chunk)
    assert got.device.type == "cuda"
    want = H.hist_rgb_plain(torch.from_numpy(frames), 40 * 52 * 3, 3)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("c", [2, 5, 6])
def test_hist_rgb_kernel_other_channel_counts(cuda_device, c):
    t, h, w = 2, 23, 41
    frames = np.random.default_rng(8).integers(0, 256, (t, h, w, c),
                                               np.uint8)
    x = torch.from_numpy(frames).to(cuda_device)
    assert torch.equal(H.hist_rgb(x, h * w * c, c).cpu(),
                       H.hist_rgb_plain(x, h * w * c, c).cpu())


def _unaligned(flat2d):
    """The same frames, contiguous from one byte past a 16-byte boundary:
    the kernels take their byte-load path."""
    buf = torch.zeros(flat2d.numel() + 16, dtype=torch.uint8,
                      device=flat2d.device)
    out = buf[1:flat2d.numel() + 1].view(flat2d.shape)
    out.copy_(flat2d)
    return out


def test_hist_rgb_vector_path_matches_byte_path(cuda_device):
    """c == 3 at 1080p: 16-byte loads of aligned frames against the
    guarded byte loads of the same frames shifted by one byte."""
    t, h, w = 2, 1080, 1920
    frames = np.random.default_rng(9).integers(0, 256, (t, h * w * 3),
                                               np.uint8)
    x = torch.from_numpy(frames).to(cuda_device)
    got = H.hist_rgb(x, h * w * 3, 3)
    assert torch.equal(got, H.hist_rgb(_unaligned(x), h * w * 3, 3))
    assert torch.equal(got.cpu(), H.hist_rgb_plain(x, h * w * 3, 3).cpu())


def _i420_flat(t, h, w, yuv):
    planes = np.empty((t, h * w * 3 // 2), np.uint8)
    planes[:, :h * w] = yuv[0]
    planes[:, h * w:h * w * 5 // 4] = yuv[1]
    planes[:, h * w * 5 // 4:] = yuv[2]
    return planes


@pytest.mark.parametrize("kind", ["flat", "bin15"])
def test_hist_rgb_kernel_counter_stress_1080p(cuda_device, kind):
    t, h, w = 2, 1080, 1920
    if kind == "flat":
        frames = np.empty((t, h, w, 3), np.uint8)
        frames[:] = (200, 40, 40)
    else:
        frames = np.random.default_rng(10).integers(240, 256, (t, h, w, 3),
                                                    np.uint8)
    x = torch.from_numpy(FrameChunk.from_hwc(frames).flat).to(cuda_device)
    got = H.hist_rgb(x, h * w * 3, 3).cpu()
    assert torch.equal(got, H.hist_rgb_plain(x, h * w * 3, 3).cpu())
    if kind == "bin15":
        assert (got[:, :, 15] == h * w).all()


@pytest.mark.parametrize("kind", ["flat", "bin15"])
def test_hist_i420_kernel_counter_stress_1080p(cuda_device, kind):
    t, h, w = 2, 1080, 1920
    if kind == "flat":  # red, limited range BT.601
        planes = _i420_flat(t, h, w, (81, 90, 240))
    else:  # near-white luma, grey chroma: R, G, B all >= 255
        rng = np.random.default_rng(11)
        planes = _i420_flat(t, h, w, (0, 128, 128))
        planes[:, :h * w] = rng.integers(235, 256, (t, h * w), np.uint8)
    x = torch.from_numpy(FrameChunk.from_i420(planes, h, w).flat).to(
        cuda_device)
    got = H.hist_i420(x, h, w).cpu()
    assert torch.equal(got, H.hist_i420_plain(x, h, w).cpu())
    if kind == "bin15":
        assert (got[:, :, 15] == h * w).all()


@pytest.mark.parametrize("h,w", [(34, 18), (64, 1918), (1080, 1918)])
def test_hist_i420_kernel_ragged_width(cuda_device, h, w):
    """Widths that are not a multiple of 16 take the guarded byte path."""
    assert w % 16
    planes = np.random.default_rng(12).integers(0, 256, (2, h * w * 3 // 2),
                                                np.uint8)
    x = torch.from_numpy(FrameChunk.from_i420(planes, h, w).flat).to(
        cuda_device)
    for bt709, full_range in COEF_SETS:
        assert torch.equal(
            H.hist_i420(x, h, w, full_range, bt709).cpu(),
            H.hist_i420_plain(x, h, w, full_range, bt709).cpu())


def test_hist_i420_kernel_unaligned_frames(cuda_device):
    t, h, w = 2, 64, 96
    planes = np.random.default_rng(13).integers(0, 256, (t, h * w * 3 // 2),
                                                np.uint8)
    x = torch.from_numpy(planes).to(cuda_device)
    got = H.hist_i420(_unaligned(x), h, w)
    assert torch.equal(got, H.hist_i420(x, h, w))
    assert torch.equal(got.cpu(), H.hist_i420_plain(x, h, w).cpu())


def test_kernels_take_one_frame_and_empty_chunks(cuda_device):
    x = torch.from_numpy(np.random.default_rng(14).integers(
        0, 256, (1, 37 * 3), np.uint8)).to(cuda_device)
    assert torch.equal(H.hist_rgb(x, 37 * 3, 3).cpu(),
                       H.hist_rgb_plain(x, 37 * 3, 3).cpu())
    before = (H.hist_rgb.launches, H.hist_i420.launches)
    assert H.hist_rgb(x[:0], 37 * 3, 3).shape == (0, 3, 16)
    assert H.hist_i420(x[:0], 4, 6).shape == (0, 3, 16)
    assert (H.hist_rgb.launches, H.hist_i420.launches) == before


def _flow_inputs(t, h, w, seed):
    rng = np.random.default_rng(seed)
    r0 = rng.normal(0, 10, (t, h, w, 5)).astype(np.float32)
    r1 = rng.normal(0, 10, (t, h, w, 5)).astype(np.float32)
    # displacements past warp_px and past the frame: every clamp is taken
    flow = rng.normal(0, 12, (t, h, w, 2)).astype(np.float32)
    return [torch.from_numpy(a) for a in (r0, r1, flow)]


@pytest.mark.parametrize("warp_px", [16, 0, 3])
@pytest.mark.parametrize("t,h,w", [(2, 33, 47), (3, 15, 17), (1, 2, 5),
                                   (2, 61, 80)])
def test_flow_update_kernel_matches_plain(cuda_device, warp_px, t, h, w):
    args = [a.to(cuda_device) for a in _flow_inputs(t, h, w, 15)]
    before = OF.flow_update.launches
    got = OF.flow_update(*args, warp_px)
    assert OF.flow_update.launches == before + 1
    want = OF.flow_update_plain(*args, warp_px)
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), OF.flow_update_plain(
        *_flow_inputs(t, h, w, 15), warp_px))


def test_flow_update_kernel_refuses_bad_inputs(cuda_device):
    r0, r1, flow = [a.to(cuda_device) for a in _flow_inputs(2, 9, 11, 16)]
    before = OF.flow_update.launches
    with pytest.raises(TypeError):
        OF.flow_update(r0.double(), r1, flow)
    with pytest.raises(ValueError):
        OF.flow_update(r0, r1, flow.transpose(1, 2).contiguous()
                       .transpose(1, 2))
    with pytest.raises(ValueError):
        OF.flow_update(r0, r1.cpu(), flow)
    assert OF.flow_update.launches == before
    empty = OF.flow_update(r0[:0], r1[:0], flow[:0])
    assert empty.shape == (0, 9, 11, 5)
    assert OF.flow_update.launches == before
