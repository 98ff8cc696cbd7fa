"""Per-frame RGB histogram (16 bins/channel, int32).

Reference parity: the ``Histogram`` op — cv::calcHist over [0,256) with 16
bins per channel, 3×16 int32 per frame
(histogram_kernel_cpu.cpp:8,25-45; GPU variant histogram_kernel_gpu.cpp).

The bin is ``byte >> 4``. Input is the FrameChunk byte stream
(utils/framechunk.py). Two hand-written CUDA kernels
(kernels/csrc/histogram.cu) carry the op on the card:

  * ``hist_rgb`` — an interleaved byte stream of ``c`` channels; the
    channel of a byte is its flat index mod ``c``. Serves RGB24 chunks and
    plain NHWC u8 tensors alike.
  * ``hist_i420`` — planar YUV 4:2:0 chunks, with the YUV->RGB conversion
    of ``yuv420_to_rgb`` fused into the binning.

Each wrapper launches its kernel for a CUDA tensor and counts the launch
in ``<wrapper>.launches``; for a CPU tensor it computes its plain version
(``*_plain``, beside it), which is also the yardstick the kernels are held
to on the card. There is no fallback from a CUDA tensor to a plain version.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..kernels import build as _build
from ..registry import register_op
from ..utils.framechunk import _YUV_COEFS, FrameChunk

BINS = 16
_MAX_CHANNELS = 6  # kMaxChannels in csrc/histogram.cu


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("histogram")
    p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.st_hist_rgb.restype = i
    lib.st_hist_rgb.argtypes = [p, i64, i64, i64, i, i, p, p]
    lib.st_hist_i420.restype = i
    lib.st_hist_i420.argtypes = [p, i64, i64, i, i, p, p, p]
    return lib


def _frames_2d(flat: torch.Tensor, name: str) -> torch.Tensor:
    """[T, ...] u8 -> its [T, stride] view; raises on what the kernels do
    not take."""
    if flat.dtype != torch.uint8:
        raise TypeError(f"{name}: expected uint8 frames, got {flat.dtype}")
    if flat.dim() < 2:
        raise ValueError(f"{name}: expected [T, ...] frames, got "
                         f"{tuple(flat.shape)}")
    if not flat.is_contiguous():
        raise ValueError(f"{name}: frames must be contiguous")
    return flat.reshape(flat.shape[0], -1)


def _check_launch(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


# ---------------------------------------------------------------- RGB


def hist_rgb_plain(flat: torch.Tensor, npix: int, c: int = 3
                   ) -> torch.Tensor:
    """[T, ...] u8 byte stream -> [T, c, 16] int32: bytes at flat index
    < ``npix`` only, channel = index % c. Looped per frame so that memory
    stays bounded."""
    x = _frames_2d(flat, "hist_rgb_plain")
    codes_base = (torch.arange(npix, device=x.device) % c) * BINS
    out = torch.empty((x.shape[0], c, BINS), dtype=torch.int32,
                      device=x.device)
    for t in range(x.shape[0]):
        codes = codes_base + (x[t, :npix] >> 4).to(torch.int64)
        out[t] = torch.bincount(codes, minlength=c * BINS).view(c, BINS)
    return out


def hist_rgb(flat: torch.Tensor, npix: int, c: int = 3) -> torch.Tensor:
    """[T, ...] u8 byte stream -> [T, c, 16] int32 (see hist_rgb_plain).
    Launches the CUDA kernel for a CUDA tensor."""
    x = _frames_2d(flat, "hist_rgb")
    if x.device.type == "cpu":
        return hist_rgb_plain(x, npix, c)
    if x.device.type != "cuda":
        raise ValueError(f"hist_rgb: unsupported device {x.device}")
    t, stride = x.shape
    if not 1 <= c <= _MAX_CHANNELS:
        raise ValueError(f"hist_rgb: 1..{_MAX_CHANNELS} channels, got {c}")
    if not 0 <= npix <= stride:
        raise ValueError(f"hist_rgb: npix {npix} outside a {stride}-byte "
                         "frame")
    if t > 65535:
        raise ValueError(f"hist_rgb: at most 65535 frames, got {t}")
    out = torch.zeros((t, c, BINS), dtype=torch.int32, device=x.device)
    vec = int(stride % 16 == 0 and x.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().st_hist_rgb(x.data_ptr(), t, stride, npix, c, vec,
                                out.data_ptr(), stream)
    _check_launch(rc, "hist_rgb")
    hist_rgb.launches += 1
    return out


hist_rgb.launches = 0


# ---------------------------------------------------------------- I420


def hist_i420_plain(flat: torch.Tensor, h: int, w: int,
                    full_range: bool = False, bt709: bool = False
                    ) -> torch.Tensor:
    """[T, ...] u8 packed I420 rows -> [T, 3, 16] int32 of the RGB that
    ``yuv420_to_rgb`` gives: torch conversion -> u8 -> hist_rgb_plain."""
    x = _frames_2d(flat, "hist_i420_plain")
    out = torch.empty((x.shape[0], 3, BINS), dtype=torch.int32,
                      device=x.device)
    for t in range(x.shape[0]):  # one frame at a time bounds the f32 temps
        rgb = FrameChunk(x[t:t + 1], h, w, 3, "i420", full_range,
                         bt709).hwc_u8()
        out[t] = hist_rgb_plain(rgb, h * w * 3, 3)[0]
    return out


def hist_i420(flat: torch.Tensor, h: int, w: int, full_range: bool = False,
              bt709: bool = False) -> torch.Tensor:
    """[T, ...] u8 packed I420 rows -> [T, 3, 16] int32 (see
    hist_i420_plain). Launches the CUDA kernel for a CUDA tensor."""
    x = _frames_2d(flat, "hist_i420")
    if x.device.type == "cpu":
        return hist_i420_plain(x, h, w, full_range, bt709)
    if x.device.type != "cuda":
        raise ValueError(f"hist_i420: unsupported device {x.device}")
    t, stride = x.shape
    if h <= 0 or w <= 0 or h % 2 or w % 2:
        raise ValueError(f"hist_i420: even positive dimensions only, got "
                         f"{h}x{w}")
    if h * w * 3 // 2 > stride:
        raise ValueError(f"hist_i420: {h}x{w} I420 needs "
                         f"{h * w * 3 // 2} bytes, rows hold {stride}")
    if stride % 2 or x.data_ptr() % 2:
        raise ValueError("hist_i420: rows must start 2-byte aligned")
    if t > 65535:
        raise ValueError(f"hist_i420: at most 65535 frames, got {t}")
    coefs = (ctypes.c_float * 6)(*_YUV_COEFS[(bool(bt709),
                                              bool(full_range))])
    out = torch.zeros((t, 3, BINS), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().st_hist_i420(x.data_ptr(), t, stride, h, w, coefs,
                                 out.data_ptr(), stream)
    _check_launch(rc, "hist_i420")
    hist_i420.launches += 1
    return out


hist_i420.launches = 0


# ---------------------------------------------------------------- op


@register_op("Histogram", kind="device", outputs=("histogram",))
def histogram(ctx, frames, bins: int = BINS):
    """frames: FrameChunk (rgb or i420) or a [T, H, W, C] u8 tensor ->
    [T, C, 16] int32 on the frames' device."""
    if bins != BINS:
        raise ValueError(
            "reference fixes 16 bins (histogram_kernel_cpu.cpp:8)")
    if not isinstance(frames, FrameChunk):
        x = torch.as_tensor(frames)
        return hist_rgb(x, int(np.prod(x.shape[1:])), int(x.shape[-1]))
    if frames.fmt == "i420":
        return hist_i420(frames.flat, frames.h, frames.w,
                         frames.full_range, frames.bt709)
    return hist_rgb(frames.flat, frames.npix, frames.c)
