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

The kernels' launch geometry is computed here (``rgb_geometry``,
``i420_geometry``), from the resident blocks the card reports, and passed
to them; the CPU tests check that it covers every byte once.

On a frame-sharded data mesh (``PerfParams(pipeline_instances_per_node)``,
the JAX package's ``_histogram_pallas_sharded``: its ``pallas_call`` under
``shard_map``) each shard histograms its own frames on its own device with
the same kernel, and no collective: frames are independent. The executor
pads the chunk to a multiple of the mesh, runs the op once a shard with
``utils/flags.sharded_mode`` set, and gathers the rows, cut back to the
chunk's (runtime/executor.py, ``_run_sharded_segment``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import numpy as np
import torch

from ..kernels import build as _build
from ..registry import register_op
from ..utils.framechunk import _YUV_COEFS, FrameChunk

BINS = 16
_MAX_CHANNELS = 6  # kMaxChannels in csrc/histogram.cu
THREADS = 128  # kThreads in csrc/histogram.cu: threads per block
# Work items a block should get, so that the last blocks to finish trail
# the others by about one item in this many. Fewer, larger items won on an
# H100 (tools/hist_probe.py, 64 x 1080p): hist_i420 0.122 ms at 4 (items of
# 7 rounds) against 0.133 ms at 16 and 64 (1 round); hist_rgb 0.149 ms at
# 4 and 16, 0.151 ms at 64.
ITEMS_PER_BLOCK = 4
MAX_ITEM_ROUNDS = 8  # at most THREADS * this many units per work item
_I32_MAX = 2 ** 31 - 1


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("histogram")
    p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.st_hist_rgb.restype = i
    lib.st_hist_rgb.argtypes = [p, i64, i64, i64, i, i, i64, i64, i64, p, p]
    lib.st_hist_i420.restype = i
    lib.st_hist_i420.argtypes = [p, i64, i64, i, i, p, i, i64, i64, i64, p,
                                 p]
    pi = ctypes.POINTER(i)
    lib.st_hist_rgb_occupancy.restype = i
    lib.st_hist_rgb_occupancy.argtypes = [i, i, pi]
    lib.st_hist_i420_occupancy.restype = i
    lib.st_hist_i420_occupancy.argtypes = [i, pi]
    return lib


# ---------------------------------------------------------------- geometry


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Launch geometry of a histogram kernel.

    Each of ``t`` frames is ``units`` units: 16*c bytes for ``hist_rgb``
    (those of the last warp's units may lie partly or wholly past the
    frame's bytes), cells of 16 luma columns of two rows for ``hist_i420``
    (the last of a row may be narrower). A frame is split into
    ``items_per_frame`` work items of ``item_units`` units (a multiple of
    THREADS; the last item of a frame may be short). ``grid`` persistent
    blocks share the ``t * items_per_frame`` items: block b takes the
    contiguous run ``block_items(b)``, in frame order, and flushes its
    counters when it moves to another frame and when it ends. The kernels
    follow exactly this mapping.
    """

    t: int
    units: int
    item_units: int
    items_per_frame: int
    grid: int

    @property
    def items(self) -> int:
        return self.t * self.items_per_frame

    def block_items(self, b: int) -> range:
        return range(self.items * b // self.grid,
                     self.items * (b + 1) // self.grid)

    def item_units_of(self, item: int):
        """-> (frame, first unit, end unit) of work item ``item``."""
        frame, slab = divmod(item, self.items_per_frame)
        lo = slab * self.item_units
        return frame, lo, min(lo + self.item_units, self.units)


def split_work(t: int, units: int, resident: int,
               items_per_block: int = ITEMS_PER_BLOCK) -> Geometry:
    """The persistent grid (at most ``resident`` blocks: what fits on the
    card at once) and the work items for ``t`` frames of ``units`` units.
    An item is as many rounds of THREADS units as keeps about
    ``items_per_block`` items for each block, between 1 and
    MAX_ITEM_ROUNDS."""
    if t < 1 or units < 1 or resident < 1 or items_per_block < 1:
        raise ValueError(f"split_work: t={t}, units={units}, "
                         f"resident={resident}, "
                         f"items_per_block={items_per_block}")
    rounds = -(-units // THREADS)  # per frame
    per_item = max(1, min(MAX_ITEM_ROUNDS,
                          t * rounds // (items_per_block * resident)))
    item_units = THREADS * per_item
    items_per_frame = -(-units // item_units)
    return Geometry(t, units, item_units, items_per_frame,
                    min(resident, t * items_per_frame))


def rgb_geometry(t: int, npix: int, c: int, resident: int,
                 items_per_block: int = ITEMS_PER_BLOCK) -> Geometry:
    """Geometry of ``hist_rgb`` over ``t`` frames of ``npix`` bytes of
    ``c`` channels. A unit is 16*c bytes: c pieces of 16 bytes, striped so
    that the 32 units of a warp tile 512*c bytes (``rgb_unit_pieces``); a
    frame has whole warps' worth, ``32 * ceil(npix / (512 c))`` units."""
    return split_work(t, 32 * -(-npix // (512 * c)), resident,
                      items_per_block)


def rgb_unit_pieces(q: int, c: int):
    """Byte offsets of the c 16-byte pieces of unit ``q`` of a frame, as
    ``hist_rgb`` reads them (bytes at or past npix are not counted)."""
    lane = q % 32
    return [16 * c * (q - lane) + 16 * lane + 512 * i for i in range(c)]


def i420_geometry(t: int, h: int, w: int, resident: int,
                  items_per_block: int = ITEMS_PER_BLOCK) -> Geometry:
    """Geometry of ``hist_i420`` over ``t`` h x w frames: units are cells
    of 16 luma columns of two rows, ceil(w/16) cells per chroma row."""
    return split_work(t, (h // 2) * -(-w // 16), resident,
                      items_per_block)


@functools.cache
def _coefs(bt709: bool, full_range: bool):
    """The (ys, yo, rv, gu, gv, bu) of a coefficient set as a C float[6]."""
    return (ctypes.c_float * 6)(*_YUV_COEFS[(bt709, full_range)])


@functools.cache
def _resident(device: int, kernel: str, c: int, vec: bool) -> int:
    """Blocks of ``kernel`` that fit on the card at once: the occupancy
    query's blocks per SM (largest shared-memory carveout) times SMs."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        if kernel == "rgb":
            rc = _lib().st_hist_rgb_occupancy(c, int(vec),
                                              ctypes.byref(blocks))
        else:
            rc = _lib().st_hist_i420_occupancy(int(vec),
                                               ctypes.byref(blocks))
    if rc != 0 or blocks.value < 1:
        raise RuntimeError(f"hist_{kernel}: occupancy query failed "
                           f"(error {rc}, {blocks.value} blocks per SM)")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return blocks.value * sms


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
    return flat.reshape(flat.shape[0], math.prod(flat.shape[1:]))


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
    if npix > _I32_MAX:
        raise ValueError(f"hist_rgb: {npix} bytes a frame overflow the "
                         "int32 counts")
    out = torch.zeros((t, c, BINS), dtype=torch.int32, device=x.device)
    if t == 0 or npix == 0:
        return out  # nothing to count: no launch
    vec = stride % 16 == 0 and x.data_ptr() % 16 == 0
    geo = rgb_geometry(t, npix, c, _resident(x.device.index, "rgb", c, vec))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().st_hist_rgb(x.data_ptr(), t, stride, npix, c, int(vec),
                                geo.grid, geo.item_units,
                                geo.items_per_frame, out.data_ptr(), stream)
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
    if h * w > _I32_MAX:
        raise ValueError(f"hist_i420: {h}x{w} pixels overflow the int32 "
                         "counts")
    out = torch.zeros((t, 3, BINS), dtype=torch.int32, device=x.device)
    if t == 0:
        return out  # nothing to count: no launch
    vec = stride % 16 == 0 and x.data_ptr() % 16 == 0 and w % 16 == 0
    geo = i420_geometry(t, h, w, _resident(x.device.index, "i420", 3, vec))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().st_hist_i420(x.data_ptr(), t, stride, h, w,
                                 _coefs(bool(bt709), bool(full_range)),
                                 int(vec), geo.grid, geo.item_units,
                                 geo.items_per_frame, out.data_ptr(), stream)
    _check_launch(rc, "hist_i420")
    hist_i420.launches += 1
    return out


hist_i420.launches = 0


# ---------------------------------------------------------------- op


@register_op("Histogram", kind="device", outputs=("histogram",),
             row_local=True)
def histogram(ctx, frames, bins: int = BINS):
    """frames: FrameChunk (rgb or i420) or a [T, H, W, C] u8 tensor ->
    [T, C, 16] int32 on the frames' device. Under ``sharded_mode`` the
    frames are one shard's, on a device of the data mesh."""
    from ..utils.flags import current_mesh, sharded_mode

    if bins != BINS:
        raise ValueError(
            "reference fixes 16 bins (histogram_kernel_cpu.cpp:8)")
    mesh = current_mesh.get()
    if sharded_mode.get() and mesh is not None:
        dev = frames.flat.device if isinstance(frames, FrameChunk) \
            else torch.as_tensor(frames).device
        if dev not in mesh.device_list():
            raise ValueError(f"Histogram: a shard on {dev}, off the data "
                             f"mesh {mesh.names()}")
    return _histogram_local(frames)


def _histogram_local(frames) -> torch.Tensor:
    """One launch of the chunk's kernel on the frames' device."""
    if not isinstance(frames, FrameChunk):
        x = torch.as_tensor(frames)
        return hist_rgb(x, int(np.prod(x.shape[1:])), int(x.shape[-1]))
    if frames.fmt == "i420":
        return hist_i420(frames.flat, frames.h, frames.w,
                         frames.full_range, frames.bt709)
    return hist_rgb(frames.flat, frames.npix, frames.c)


def histogram_reference_np(frames: np.ndarray) -> np.ndarray:
    """Host golden model (cv::calcHist semantics) for parity tests: uint8
    [T, H, W, 3] -> int32 [T, 3, BINS]."""
    T = frames.shape[0]
    out = np.zeros((T, 3, BINS), np.int32)
    for t in range(T):
        for c in range(3):
            out[t, c] = np.bincount(
                frames[t, :, :, c].reshape(-1) >> 4, minlength=BINS)
    return out
