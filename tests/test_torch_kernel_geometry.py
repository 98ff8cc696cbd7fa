"""The launch geometry that the ``nms`` and ``crop_and_resize`` wrappers
compute in Python (``models/common.py``: ``nms_geometry``,
``crop_geometry``), held to the work each launch must cover, and the
wrappers' limits held to the constants of the kernels they launch.

The kernels themselves run only on the card (tests/test_torch_kernels_cuda.py
holds them to their plain versions at the same tile edges, widths and
channel counts); these cases check on the CPU that the shapes the wrappers
hand them cover every output row once at ragged sizes, and that the
wrappers pick the path and the kernel they mean to.
"""

import pathlib
import re

import numpy as np
import pytest

from scannertools_tpu_torch.models import common as MC
from scannertools_tpu_torch.models import pose as PP

CSRC = pathlib.Path(MC.__file__).resolve().parent.parent / "kernels" / "csrc"


def _cu_const(source: str, name: str) -> int:
    """The value of ``constexpr int <name> = <int>;`` in csrc/<source>."""
    text = (CSRC / source).read_text()
    found = re.findall(rf"constexpr int {name} = (\d+);", text)
    assert len(found) == 1, (source, name, found)
    return int(found[0])


@pytest.mark.parametrize("source,name,value", [
    ("nms.cu", "kSharedMaxK", lambda: MC.NMS_SHARED_MAX_K),
    ("nms.cu", "kMaxWords", lambda: -(-MC.NMS_MAX_K // 64)),
    ("crop_resize.cu", "kMaxOw", lambda: MC.CROP_MAX_OW),
    ("crop_resize.cu", "kMaxLevels", lambda: len(MC.FPN_STRIDES)),
    ("peaks.cu", "kMaxPeaks", lambda: PP.MAX_PEAKS),
    ("peaks.cu", "kParts", lambda: PP.N_PARTS),
    ("peaks.cu", "kCluster", lambda: PP.PEAKS_CLUSTER),
    ("crop_resize.cu", "kMaxBandRows",
     lambda: max(MC.crop_geometry(1, oh, 8, 3, True)["band_rows"]
                 for oh in range(1, 300))),
])
def test_wrapper_limits_match_the_kernels(source, name, value):
    """Each limit the wrappers apply in Python is the one the kernel
    enforces (a kernel refuses a launch past it with an error code)."""
    assert _cu_const(source, name) == value()


# ------------------------------------------------------------ nms


def test_nms_shared_path_limit():
    """The one-launch path takes K up to 1280 (the largest whose layout
    fits a block's 227 KB, nms.cu's static_assert); above it every frame
    count takes the device-memory path, up to NMS_MAX_K."""
    assert MC.NMS_SHARED_MAX_K == 1280
    assert MC.nms_geometry(32, 1280)["path"] == "shared"
    assert MC.nms_geometry(1000, 1281)["path"] == "global"
    assert MC.nms_geometry(1, MC.NMS_MAX_K) == {"path": "global",
                                                 "words": 256}
    with pytest.raises(ValueError):
        MC.nms_geometry(1, MC.NMS_MAX_K + 1)
    with pytest.raises(ValueError):
        MC.nms_geometry(1, -1)


@pytest.mark.parametrize("t,k,path", [(1, 0, "shared"), (1, 64, "shared"),
                                      (1, 256, "shared"),
                                      (80, 128, "shared"), (1, 512, "shared"),
                                      (1, 513, "global"), (1, 1000, "global"),
                                      (31, 1000, "global"),
                                      (32, 1000, "shared"),
                                      (31, 1280, "global"),
                                      (32, 1280, "shared"),
                                      (64, 1281, "global"),
                                      (2, 2048, "global")])
def test_nms_path_choice(t, k, path):
    """Small K on one SM a frame; large K spread over device memory unless
    the frames alone are many."""
    assert MC.nms_geometry(t, k)["path"] == path


@pytest.mark.parametrize("k", [0, 1, 63, 64, 65, 127, 128, 129, 256, 1000,
                               1280])
def test_nms_words_cover_every_row(k):
    """A row's 64-bit mask words (the device-memory path's scratch [T, K,
    words]) hold one bit for each of the K rows, and no word more."""
    words = MC.nms_geometry(1, k)["words"]
    assert 64 * words >= k and 64 * (words - 1) < max(k, 1)
    assert words <= _cu_const("nms.cu", "kMaxWords")


# ------------------------------------------------------------ crop


def _bands(geo, oh):
    for band in range(geo["bands"]):
        y0 = band * geo["band_rows"]
        yield y0, min(geo["band_rows"], oh - y0)


@pytest.mark.parametrize("oh", [1, 2, 7, 14, 15, 16, 17, 24, 31, 33, 48,
                                160, 227])
def test_crop_bands_cover_every_row_once(oh):
    geo = MC.crop_geometry(3, oh, oh, 3, True)
    seen = np.zeros(oh, int)
    for y0, rows in _bands(geo, oh):
        assert 0 < rows <= geo["band_rows"] <= 16
        seen[y0:y0 + rows] += 1
    assert (seen == 1).all()
    assert geo["blocks"] == 3 * geo["bands"]
    assert geo["bands"] == -(-oh // 16)  # as few bands as 16 rows allow
    # the kernel's own check of the geometry it is given (crop_resize.cu)
    assert geo["bands"] == -(-oh // geo["band_rows"])


@pytest.mark.parametrize("c,aligned,pixels", [(1, True, False),
                                              (3, True, False),
                                              (4, True, False),
                                              (6, True, False),
                                              (8, True, True),
                                              (8, False, False),
                                              (256, True, True)])
def test_crop_geometry_picks_the_kernel(c, aligned, pixels):
    assert MC.crop_geometry(4, 7, 7, c, aligned)["pixels"] is pixels


def test_level_crop_strides_scale_boxes_exactly():
    """The level crop's strides are powers of two, so the kernel's product
    with 1 / stride is the plain version's (and the JAX package's) division
    by the stride, bit for bit."""
    import torch

    from scannertools_tpu_torch.utils.numerics import recip

    x = torch.from_numpy(np.random.default_rng(0).uniform(
        -50, 1400, 4096).astype(np.float32))
    for s in MC.FPN_STRIDES:
        assert s & (s - 1) == 0 and recip(s) * s == 1.0
        assert torch.equal(x * recip(s), x / s)


@pytest.mark.parametrize("aligned,pixels", [((True,) * 4, True),
                                            ((True, True, False, True),
                                             False)])
def test_level_crop_geometry(aligned, pixels):
    """One launch of crop_geometry's bands for every box of every level;
    the channel-vector kernel only where every level is 16-byte aligned
    (the wrapper's all())."""
    geo = MC.crop_geometry(8000, 7, 7, 256, all(aligned))
    assert geo["pixels"] is pixels
    assert geo["blocks"] == 8000 * geo["bands"] and geo["bands"] == 1
    assert MC.crop_geometry(800, 14, 14, 256, True)["blocks"] == 800
