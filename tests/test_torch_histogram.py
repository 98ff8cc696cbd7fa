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


# ------------------------------------------------ launch geometry (CPU)
#
# The CUDA kernels take their launch geometry from rgb_geometry and
# i420_geometry; these cases hold that geometry to the work it must cover,
# at ragged sizes, for the resident block counts a card may report.

RGB_SPLITS = [  # (t, npix, c, resident blocks)
    (1, 33 * 17 * 3, 3, 7),      # npix no multiple of 16 or 48
    (3, 1000, 1, 5),
    (2, 777, 2, 3),
    (1, 4099, 4, 2),
    (2, 12345, 5, 11),
    (3, 9001, 6, 1),
    (1, 7, 3, 132 * 9),          # one ragged chunk, more blocks than work
    (5, 1080 * 1920 * 3, 3, 132 * 9),
]
I420_SPLITS = [  # (t, h, w, resident blocks)
    (1, 34, 18, 3),              # w no multiple of 16
    (3, 34, 46, 7),
    (2, 2, 2, 5),
    (1, 120, 136, 1),
    (2, 1080, 1918, 132 * 8),
    (3, 1080, 1920, 132 * 8),
]


def _runs(geo):
    """Each block's run of items as [(frame, lo, hi)], in block order."""
    return [[geo.item_units_of(i) for i in geo.block_items(b)]
            for b in range(geo.grid)]


def _check_split(geo):
    """Every unit of every frame in exactly one item, no item past its
    frame, each block's items in frame order, blocks within one item of
    each other."""
    seen = np.zeros((geo.t, geo.units), np.int32)
    sizes = []
    for run in _runs(geo):
        sizes.append(len(run))
        frames = [f for f, _, _ in run]
        assert frames == sorted(frames)
        for frame, lo, hi in run:
            assert 0 <= frame < geo.t
            assert 0 <= lo < hi <= geo.units
            seen[frame, lo:hi] += 1
    assert (seen == 1).all()
    assert geo.item_units % H.THREADS == 0
    assert 1 <= geo.grid <= geo.items
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1


@pytest.mark.parametrize("t,npix,c,resident", RGB_SPLITS, ids=str)
def test_rgb_geometry_covers_every_byte_once(t, npix, c, resident):
    geo = H.rgb_geometry(t, npix, c, resident)
    _check_split(geo)
    assert geo.grid <= resident
    # a warp's 32 units tile 512*c bytes; the frame's last warp reaches
    # into its last 512*c bytes, and reads none past them
    warp = 512 * c
    assert geo.units % 32 == 0
    assert (geo.units // 32 - 1) * warp < npix <= geo.units // 32 * warp
    covered = np.zeros(geo.units // 32 * warp, np.int32)
    for run in _runs(geo):
        for frame, lo, hi in run:
            if frame == 0:
                for q in range(lo, hi):
                    for o in H.rgb_unit_pieces(q, c):
                        assert o // warp == q // 32  # inside its warp's span
                        covered[o:o + 16] += 1
    assert (covered == 1).all()  # every byte below npix counts once


@pytest.mark.parametrize("t,h,w,resident", I420_SPLITS, ids=str)
def test_i420_geometry_covers_every_block_once(t, h, w, resident):
    geo = H.i420_geometry(t, h, w, resident)
    _check_split(geo)
    assert geo.grid <= resident
    gpr = -(-w // 16)  # cells per chroma row
    assert geo.units == (h // 2) * gpr
    blocks = np.zeros((h // 2, w // 2), np.int32)  # 2x2 luma blocks
    for run in _runs(geo):
        for frame, lo, hi in run:
            if frame != 0:
                continue
            for q in range(lo, hi):
                r, g = divmod(q, gpr)
                assert r < h // 2 and 16 * g < w  # inside the frame
                blocks[r, 8 * g:min(8 * g + 8, w // 2)] += 1
    assert (blocks == 1).all()


@pytest.mark.parametrize("t,h,w,resident", I420_SPLITS, ids=str)
def test_i420_row_column_walk_matches_flat_index(t, h, w, resident):
    """The kernel walks a thread's cells by (row, column) with a carry:
    (dr, dg) per step of THREADS cells, (ir, ig) per item, reset at a new
    frame. Mirror that walk and hold it to divmod of the flat index."""
    geo = H.i420_geometry(t, h, w, resident)
    gpr = -(-w // 16)
    dr, dg = divmod(H.THREADS, gpr)
    ir, ig = divmod(geo.item_units, gpr)
    for b in range(geo.grid):
        run = geo.block_items(b)
        for tid in (0, 1, 37, H.THREADS - 1):
            slab = run.start % geo.items_per_frame
            r, g = divmod(slab * geo.item_units + tid, gpr)
            for item in run:
                _, lo, hi = geo.item_units_of(item)
                rr, gg = r, g
                for c in range(lo + tid, hi, H.THREADS):
                    assert (rr, gg) == divmod(c, gpr)
                    gg, rr = gg + dg, rr + dr
                    if gg >= gpr:
                        gg, rr = gg - gpr, rr + 1
                slab += 1
                if slab == geo.items_per_frame:
                    slab = 0
                    r, g = divmod(tid, gpr)
                else:
                    g, r = g + ig, r + ir
                    if g >= gpr:
                        g, r = g - gpr, r + 1


@pytest.mark.parametrize("t,npix,c,resident", RGB_SPLITS, ids=str)
def test_rgb_counters_cannot_overflow_between_flushes(t, npix, c, resident):
    """A thread's 32-bit shared counter takes at most one count per byte
    of its chunks in one frame before its block flushes; the int32 output
    at most every byte of one channel of a frame."""
    geo = H.rgb_geometry(t, npix, c, resident)
    per_thread_units = -(-geo.units // H.THREADS)  # one frame, all items
    assert per_thread_units * 16 * c < 2 ** 32
    # a unit's pieces start 16 * lane + 512 * i past a multiple of c bytes:
    # its channels are a rotation the kernel fixes once per thread
    for q in range(64):
        for i, o in enumerate(H.rgb_unit_pieces(q, c)):
            assert o % c == (16 * (q % 32) + 512 * i) % c
    assert -(-npix // c) <= 2 ** 31 - 1


@pytest.mark.parametrize("t,h,w,resident", I420_SPLITS, ids=str)
def test_i420_counters_cannot_overflow_between_flushes(t, h, w, resident):
    geo = H.i420_geometry(t, h, w, resident)
    per_thread_units = -(-geo.units // H.THREADS)
    assert per_thread_units * 32 < 2 ** 32  # 32 luma samples a cell
    assert h * w <= 2 ** 31 - 1


@pytest.mark.parametrize("items_per_block", [1, 16, 64])
@pytest.mark.parametrize("kernel", ["rgb", "i420"])
def test_other_work_splits_cover_every_unit_once(kernel, items_per_block):
    """The splits the probe times beside ITEMS_PER_BLOCK are valid too."""
    geo = (H.rgb_geometry(4, 1080 * 1920 * 3, 3, 11, items_per_block)
           if kernel == "rgb" else
           H.i420_geometry(4, 1080, 1920, 11, items_per_block))
    _check_split(geo)
    assert geo.item_units <= H.THREADS * H.MAX_ITEM_ROUNDS
    with pytest.raises(ValueError):
        H.split_work(4, 100, 11, 0)


def test_work_split_balances_items_per_block():
    # enough items for every block: about ITEMS_PER_BLOCK each at 1080p
    geo = H.rgb_geometry(64, 1080 * 1920 * 3, 3, 132 * 9)
    assert geo.units == 1080 * 1920 * 3 // 48  # 1080p: whole warps
    assert geo.grid == 132 * 9
    assert geo.items >= H.ITEMS_PER_BLOCK * geo.grid
    assert geo.item_units <= H.THREADS * H.MAX_ITEM_ROUNDS
    # little work: one round of THREADS units per item, fewer blocks
    geo = H.rgb_geometry(1, 100, 3, 132 * 9)
    assert (geo.item_units, geo.items, geo.grid) == (H.THREADS, 1, 1)
    with pytest.raises(ValueError):
        H.split_work(0, 10, 4)
