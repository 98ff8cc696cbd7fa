"""The port's CUDA kernels held to their plain versions on the card
(difference 0), at small geometries that cover the ragged cases: lane
padding, unaligned NHWC rows (the byte-load path), 1 to 4 channels, and all
four I420 coefficient sets. Inputs are made from a seed with numpy.

Every test here needs a CUDA device and nvcc, and skips elsewhere. The
module imports no JAX, so it runs where only the port is installed:

    python -m pytest tests/test_torch_kernels_cuda.py -q

``chip_smoke.py`` repeats these checks at the main path's shapes.
"""

import numpy as np
import pytest
import torch

from scannertools_tpu_torch.ops import histogram as H
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
