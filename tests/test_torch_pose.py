"""The port's pose pieces held to the JAX package: peak finding, the limb
integrals, the grouping, the gray pose crop, the map resizes and the Pose
type.

The same inputs, made from a seed with numpy, go through the jitted JAX
function and the port's plain torch version (on the CPU ``find_peaks`` and
the crop are their plain versions; test_torch_kernels_cuda.py holds the
kernels to those on the card). A numpy model of the ``pose_peaks``
kernel's decomposition (its row bands, warp walks, cut-offs, merge and
fill, with the constants read from peaks.cu) is held to
``find_peaks_plain`` bit for bit at the kernel's edge cases.

Tolerances, and why:
  * ``find_peaks``: bit for bit, the fill rows of maps with fewer than 24
    peaks included.
  * ``limb_scores``: the feasible set equal (which pairs are -inf); the
    scores within 1e-6 (a mean of ten products of values below 4; jitted
    XLA sums in its own order and may fuse a product into the sum: measured
    under 3e-7).
  * ``group_people``: the people equal to the JAX oracle's
    (tests/test_pose.py), score within 1e-4 and keypoints within 1e-4, as
    the JAX package's own test holds it.
  * the gray crop: within 1e-5 of jitted ``_crop_batch_device`` on values
    in [-0.5, 0.5] (XLA's hat-matrix einsums may fuse a product into the
    sum: measured under 3e-6).
  * the resizes: within 1e-5 of the largest value (``jax.image.resize``
    contracts both weight matrices in one einsum; the port applies the
    taps one axis at a time: measured about 1e-6).
  * the Pose type: serialized bytes equal.
"""

import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from scannertools_tpu.models import pose as JP
from scannertools_tpu.ops import pose as JOP
from scannertools_tpu_torch.models import pose as PP
from scannertools_tpu_torch.models.common import crop_and_resize_plain
from scannertools_tpu_torch.ops import pose as POP
from scannertools_tpu_torch.tools.timing import band_edge_maps, blob_maps
from scannertools_tpu_torch.utils.numerics import resize_hw
from test_pose import _draw_limb, _oracle_connect_limbs_coco

LIMB_ATOL = 1e-6
PEOPLE_ATOL = 1e-4
CROP_ATOL = 1e-5
RESIZE_RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).copy())


def _nchw(hwc):
    """[H, W, C] numpy -> [1, C, H, W] tensor."""
    return _t(np.moveaxis(hwc, -1, 0)[None])


_jit_peaks = jax.jit(JP.find_peaks)
_jit_limbs = jax.jit(JP.limb_scores)


# ------------------------------------------------------------ peaks


def _heat(case: str) -> np.ndarray:
    rng = np.random.default_rng(["plateau", "edges", "few", "many",
                                 "random", "small"].index(case))
    h, w = (7, 5) if case == "small" else (40, 56)
    hm = np.zeros((h, w, JP.N_HEAT), np.float32)
    if case == "plateau":  # equal neighbours pass >=: every pixel a peak
        hm[10:13, 20:24, 0] = 0.7
        hm[5:7, 5:7, 3] = 0.4
        hm[30, 40:43, 3] = 0.4  # ties with the first plateau's value
    elif case == "edges":  # on the map's border and corners
        for part in range(JP.N_PARTS):
            hm[0, part, part] = 0.5
            hm[h - 1, w - 1 - part, part] = 0.6
            hm[part % h, 0, part] = 0.3
        hm[0, 0, 17] = hm[h - 1, 0, 17] = 0.9
    elif case == "few":  # fewer than 24: the fill rows
        hm[3, 4, 1] = 0.9
        hm[0, 1, 1] = 0.8  # a peak among the lowest indices
        hm[0, 0, 2] = 0.2
        hm[1, 1, 5] = 0.05  # below the threshold
    elif case == "many":  # more than 24, spread values, some ties
        ys, xs = np.meshgrid(np.arange(1, h, 3), np.arange(1, w, 3))
        vals = rng.uniform(0.11, 1.0, ys.size).astype(np.float32)
        vals[::7] = 0.5
        for part in range(JP.N_PARTS):
            hm[ys.ravel(), xs.ravel(), part] = np.roll(vals, part)
    else:  # NaN-free random maps: many local maxima, values about 0
        hm = rng.normal(0.2, 0.4, (h, w, JP.N_HEAT)).astype(np.float32)
    return hm


@pytest.mark.parametrize("case", ["plateau", "edges", "few", "many",
                                  "random", "small"])
def test_find_peaks_plain_equals_jax(case):
    hm = _heat(case)
    want = [np.asarray(a) for a in _jit_peaks(hm)]
    got = [a[0].numpy() for a in PP.find_peaks_plain(_nchw(hm))]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    n = want[1].sum(axis=1)
    if case == "few":
        assert n[1] == 2 and n[2] == 1 and n[5] == 0
        # part 1: the peaks, then the lowest non-peak indices 0, 2, 3, ...
        assert got[0][1, 2, :2].tolist() == [0.0, 0.0]
        assert got[0][1, 3, :2].tolist() == [2.0, 0.0]
        assert (got[0][1, 2:, 2] == -1.0).all()
    if case in ("many", "random"):
        assert (n == JP.MAX_PEAKS).all()


def test_find_peaks_plain_batches_frames():
    """[T, 19, H, W] at once equals each frame alone."""
    hms = np.stack([_heat("random"), _heat("many"), _heat("few")])
    peaks, valid = PP.find_peaks_plain(_t(np.moveaxis(hms, -1, 1)))
    for i, hm in enumerate(hms):
        want = [np.asarray(a) for a in _jit_peaks(hm)]
        np.testing.assert_array_equal(peaks[i].numpy(), want[0])
        np.testing.assert_array_equal(valid[i].numpy(), want[1])


# ------------------------------------------------------------ the kernel's
# decomposition, on the CPU

def _peaks_const(name: str) -> int:
    """``constexpr int <name> = <int>;`` of kernels/csrc/peaks.cu."""
    text = (pathlib.Path(PP.__file__).resolve().parent.parent / "kernels"
            / "csrc" / "peaks.cu").read_text()
    found = re.findall(rf"constexpr int {name} = (\d+);", text)
    assert len(found) == 1, (name, found)
    return int(found[0])


def _compact(buf, cut, cluster_cut):
    """A warp's buffer of more than 24 keys -> its top 24 and the raised
    cut-off (the warp's and the cluster's)."""
    buf = sorted(buf, reverse=True)[:JP.MAX_PEAKS]
    cut = max(cut, buf[-1])
    cluster_cut[0] = max(cluster_cut[0], buf[-1])
    return buf, cut


def _model_chunks(y0, y1, strips, g, warp, warps):
    """The chunks a warp walks: its share of the band's row-strips
    (strip-major), each strip's rows [ys, ye) in chunks of g rows from
    a = ys - 1, a chunk testing rows a - 1 .. a + g - 2 -> [(strip, first
    tested row, rows [ys, ye))]."""
    rows = y1 - y0
    total = strips * rows
    q, hi = warp * total // warps, (warp + 1) * total // warps
    while q < hi:
        s = q // rows
        end = min(hi, (s + 1) * rows)
        ys, ye = y0 + q - s * rows, y0 + end - s * rows
        a = ys - 1
        while a - 1 < ye:
            yield s, a - 1, ys, ye
            a += g
        q = end


def _model_block(keys, y0, y1, vec, warp_order, cluster_cut):
    """One block's band [y0, y1) of a map's keys [H, W] (0 where no peak) ->
    its best 24 keys, by the kernel's walk: row-strips split over the
    warps and walked in chunks, candidates appended a slot (a lane's row
    and column) at a time above the cut-off, the buffer ranked at
    capacity, keys below the cluster's cut-off dropped, the block's list
    concatenated or sorted."""
    h, w = keys.shape
    v = 4 if vec else 1
    g = _peaks_const("kRowsVec" if vec else "kRowsScalar")
    warps = _peaks_const("kThreads") // 32
    cap = _peaks_const("kWarpCap")
    strips = -(-w // (32 * v))
    lists = [None] * warps
    for warp in warp_order:
        buf, cut = [], 0
        for s, y, ys, ye in _model_chunks(y0, y1, strips, g, warp, warps):
            # [rows, lanes, v] of the chunk's tested pixels (0 elsewhere)
            unit = np.zeros((g, 32 * v), np.uint64)
            lo, hi = max(y, ys), min(y + g, ye)
            cols = keys[lo:hi, s * 32 * v:(s + 1) * 32 * v]
            unit[lo - y:hi - y, :cols.shape[1]] = cols
            cut = max(cut, cluster_cut[0])
            if not unit.any():
                continue
            unit = unit.reshape(g, 32, v)
            for i in range(g):
                for k in range(v):
                    batch = [int(b) for b in unit[i, :, k] if b > cut]
                    if len(buf) + len(batch) > cap:
                        buf, cut = _compact(buf, cut, cluster_cut)
                        batch = [b for b in batch if b > cut]
                    buf += batch
                    assert len(buf) <= cap  # the kernel's shared buffer
        if len(buf) > JP.MAX_PEAKS:
            buf, cut = _compact(buf, cut, cluster_cut)
        cut = max(cut, cluster_cut[0])
        lists[warp] = [b for b in buf if b >= cut]
    every = [b for buf in lists for b in buf]
    if len(every) <= JP.MAX_PEAKS:
        return every
    return sorted(every, reverse=True)[:JP.MAX_PEAKS]


@pytest.mark.parametrize("h,w,vec", [(480, 640, True), (61, 83, False),
                                     (7, 5, False), (3, 600, True)])
def test_kernel_walk_tests_each_pixel_once(h, w, vec):
    """The warps' chunks test every pixel of every band exactly once."""
    cluster = _peaks_const("kCluster")
    warps = _peaks_const("kThreads") // 32
    v = 4 if vec else 1
    g = _peaks_const("kRowsVec" if vec else "kRowsScalar")
    seen = np.zeros((h, -(-w // (32 * v))), int)
    band = -(-h // cluster)
    for rank in range(cluster):
        y0 = min(h, rank * band)
        y1 = min(h, y0 + band)
        for warp in range(warps):
            for s, y, ys, ye in _model_chunks(y0, y1, seen.shape[1], g,
                                              warp, warps):
                assert y0 <= ys and ye <= y1 and y < ye
                seen[max(y, ys):min(y + g, ye), s] += 1
    assert (seen == 1).all()


def _model_find_peaks(heat: np.ndarray, vec: bool, warp_order=None):
    """find_peaks by the kernel's decomposition, in numpy: heat [T, C, H,
    W] -> (peaks [T, 18, 24, 3], valid [T, 18, 24])."""
    t, _, h, w = heat.shape
    cluster = _peaks_const("kCluster")
    warps = _peaks_const("kThreads") // 32
    warp_order = range(warps) if warp_order is None else warp_order
    thre = np.float32(JP.THRE_PEAK)
    peaks = np.zeros((t, JP.N_PARTS, JP.MAX_PEAKS, 3), np.float32)
    band = -(-h // cluster)
    for f in range(t):
        for part in range(JP.N_PARTS):
            hm = heat[f, part]
            pad = np.pad(hm, 1, constant_values=-1.0)
            peak = hm > thre
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if dy or dx:
                        peak &= hm >= pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            flat = np.arange(h * w, dtype=np.uint32).reshape(h, w)
            keys = (hm.view(np.uint32).astype(np.uint64) << np.uint64(32)) | \
                (~flat).astype(np.uint64)
            keys = np.where(peak, keys, np.uint64(0))
            merged, cluster_cut = [], [0]
            for rank in range(cluster):
                y0 = min(h, rank * band)
                merged += _model_block(keys, y0, min(h, y0 + band), vec,
                                       warp_order, cluster_cut)
            top = sorted(merged, reverse=True)[:JP.MAX_PEAKS]
            idx = [int(~np.uint32(k & 0xffffffff)) for k in top]
            score = [float(np.uint32(k >> 32).view(np.float32)) for k in top]
            free = [i for i in range(min(2 * JP.MAX_PEAKS, h * w))
                    if i not in idx]
            idx += free[:JP.MAX_PEAKS - len(top)]
            score += [-1.0] * (JP.MAX_PEAKS - len(top))
            idx = np.array(idx)
            peaks[f, part] = np.stack([idx % w, idx // w, score], -1)
    return peaks, peaks[..., 2] > 0


def _kernel_maps(case: str) -> np.ndarray:
    """[T, C, H, W] maps at the kernel's edges: a band is ceil(H / 8)
    rows, a strip 128 (16-byte loads) or 32 columns."""
    rng = np.random.default_rng(["band_edge", "band_plateau", "constant",
                                 "misaligned", "short", "one_row", "ramp",
                                 "random", "blobs"].index(case))
    if case in ("band_edge", "band_plateau"):  # bands of 8 rows
        return band_edge_maps(case[5:], 2, 64, 260,
                              _peaks_const("kCluster"))
    if case == "constant":  # every pixel a peak
        return np.full((1, 19, 40, 64), 0.5, np.float32)
    if case == "ramp":  # peaks rising along the walk: the buffers fill
        n = 48 * 136
        hm = np.zeros(n, np.float32)
        hm[::3] = np.linspace(0.2, 0.9, len(hm[::3]), dtype=np.float32)
        return np.broadcast_to(hm.reshape(1, 1, 48, 136),
                               (1, 19, 48, 136)).copy()
    if case == "blobs":
        return blob_maps(1, 19, 240, 320, seed=3, sigma=3.5,
                         device="cpu").numpy()
    shape = {"misaligned": (2, 19, 61, 83), "short": (2, 19, 7, 5),
             "one_row": (2, 19, 3, 600), "random": (2, 19, 45, 140)}[case]
    return rng.normal(0.2, 0.4, shape).astype(np.float32)


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("case", ["band_edge", "band_plateau", "constant",
                                  "misaligned", "short", "one_row", "ramp",
                                  "random", "blobs"])
def test_kernel_decomposition_equals_plain(case, vec):
    """The kernel's bands, warp units, cut-offs, merge and fill, modelled in
    numpy, equal find_peaks_plain (and so JAX) bit for bit; the 4-byte
    form where the 16-byte one cannot take the width."""
    hm = _kernel_maps(case)
    vec = vec and hm.shape[3] % 4 == 0
    want = PP.find_peaks_plain(_t(hm))
    got = _model_find_peaks(hm, vec)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())
    if case == "constant":  # slots 0..23 are indices 0..23
        assert (got[0][..., 1] * 64 + got[0][..., 0] ==
                np.arange(JP.MAX_PEAKS)).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_decomposition_is_order_free(seed):
    """The warps' cut-offs depend on the order they run in; the result does
    not (seeded random maps, dense with peaks, warps in seeded orders)."""
    rng = np.random.default_rng(seed)
    hm = rng.normal(0.3, 0.3, (1, 19, 50, 96)).astype(np.float32)
    want = PP.find_peaks_plain(_t(hm))
    order = rng.permutation(_peaks_const("kThreads") // 32)
    for vec in (True, False):
        got = _model_find_peaks(hm, vec, order)
        np.testing.assert_array_equal(got[0], want[0].numpy())


# ------------------------------------------------------------ limbs


@pytest.mark.parametrize("seed,h,w", [(0, 7, 5), (1, 32, 40), (2, 30, 33)])
def test_limb_scores_match_jax(seed, h, w):
    rng = np.random.default_rng(seed)
    hm = rng.uniform(-0.5, 1, (h, w, JP.N_HEAT)).astype(np.float32)
    peaks, valid = (np.asarray(a) for a in _jit_peaks(hm))
    paf = rng.normal(0, 0.5, (h, w, JP.N_PAF)).astype(np.float32)
    want = np.asarray(_jit_limbs(paf, peaks, valid))
    got = PP.limb_scores(_nchw(paf), _t(peaks[None]), _t(valid[None]))[0]
    got = got.numpy()
    feasible = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), feasible)
    assert feasible.sum() > 10
    np.testing.assert_allclose(got[feasible], want[feasible], rtol=0,
                               atol=LIMB_ATOL)


def test_limb_scores_batch_over_frames():
    rng = np.random.default_rng(4)
    h, w = 24, 32
    hm = rng.uniform(-0.5, 1, (2, h, w, JP.N_HEAT)).astype(np.float32)
    paf = rng.normal(0, 0.5, (2, h, w, JP.N_PAF)).astype(np.float32)
    peaks, valid = PP.find_peaks_plain(_t(np.moveaxis(hm, -1, 1)))
    both = PP.limb_scores(_t(np.moveaxis(paf, -1, 1)), peaks, valid)
    for i in range(2):
        one = PP.limb_scores(_nchw(paf[i]), peaks[i:i + 1], valid[i:i + 1])
        torch.testing.assert_close(both[i], one[0], rtol=0, atol=0)


# ------------------------------------------------------------ grouping


def _port_people(heat, paf):
    peaks, valid = PP.find_peaks_plain(_nchw(heat))
    scores = PP.limb_scores(_nchw(paf), peaks, valid)
    peaks, valid = peaks[0].numpy(), valid[0].numpy()
    return (PP.group_people(peaks, valid, scores[0].numpy()),
            _oracle_connect_limbs_coco(paf, peaks, valid))


def _assert_people(got, want, n):
    assert len(got) == len(want) == n
    for (gs, gkp), (ws, wkp) in zip(got, want):
        assert abs(gs - ws) < PEOPLE_ATOL
        np.testing.assert_allclose(gkp, wkp, rtol=0, atol=PEOPLE_ATOL)


def _case_two_people():
    """tests/test_pose.py:27-64: two neck->nose->shoulder people."""
    H, W = 48, 64
    heat = np.zeros((H, W, JP.N_HEAT), np.float32)
    paf = np.zeros((H, W, JP.N_PAF), np.float32)
    for x in (16, 48):
        heat[30, x, 1] = heat[18, x, 0] = 0.9
        paf[18:31, x - 1:x + 2, 29] = -1.0
        heat[30, x - 8, 2] = 0.9
        paf[29:32, x - 8:x + 1, 12] = -1.0
    return heat, paf, 2


def _case_crowded():
    H, W = 64, 96
    heat = np.zeros((H, W, JP.N_HEAT), np.float32)
    paf = np.zeros((H, W, JP.N_PAF), np.float32)
    for p, (x, mag) in enumerate([(24, 1.0), (36, 0.9), (48, 0.8)]):
        heat[40, x, 1] = 0.9 - 0.05 * p
        heat[24, x, 0] = 0.85 - 0.05 * p
        heat[40, x - 8, 2] = 0.8 - 0.05 * p
        heat[40, x + 7, 5] = 0.8 - 0.05 * p
        _draw_limb(paf, 28, 29, x, 40, x, 24, mag=mag)
        _draw_limb(paf, 12, 13, x, 40, x - 8, 40, mag=mag)
        _draw_limb(paf, 20, 21, x, 40, x + 7, 40, mag=mag)
    return heat, paf, 3


def _case_shared_peak():
    H, W = 64, 96
    heat = np.zeros((H, W, JP.N_HEAT), np.float32)
    paf = np.zeros((H, W, JP.N_PAF), np.float32)
    heat[24, 40, 0] = 0.9
    for x, mag in [(32, 1.0), (48, 0.7)]:
        heat[40, x, 1] = 0.9
        heat[40, x - 6, 2] = 0.8
        heat[40, x + 6, 5] = 0.8
        _draw_limb(paf, 28, 29, x, 40, 40, 24, mag=mag)
        _draw_limb(paf, 12, 13, x, 40, x - 6, 40, mag=mag)
        _draw_limb(paf, 20, 21, x, 40, x + 6, 40, mag=mag)
    return heat, paf, 2


def _case_chain():
    H, W = 96, 96
    heat = np.zeros((H, W, JP.N_HEAT), np.float32)
    paf = np.zeros((H, W, JP.N_PAF), np.float32)
    x = 48
    pts = {1: (x, 30), 0: (x, 16), 8: (x - 6, 50), 9: (x - 6, 70),
           10: (x - 6, 88), 2: (x - 10, 30), 16: (x - 4, 10),
           14: (x - 2, 12)}
    for part, (px, py) in pts.items():
        heat[py, px, part] = 0.9
    _draw_limb(paf, 28, 29, x, 30, x, 16)
    _draw_limb(paf, 0, 1, x, 30, x - 6, 50)
    _draw_limb(paf, 2, 3, x - 6, 50, x - 6, 70)
    _draw_limb(paf, 4, 5, x - 6, 70, x - 6, 88)
    _draw_limb(paf, 12, 13, x, 30, x - 10, 30)
    _draw_limb(paf, 30, 31, x, 16, x - 2, 12)
    _draw_limb(paf, 34, 35, x - 2, 12, x - 4, 10)
    _draw_limb(paf, 18, 19, x - 10, 30, x - 4, 10)
    return heat, paf, 1


@pytest.mark.parametrize("case", [_case_two_people, _case_crowded,
                                  _case_shared_peak, _case_chain],
                         ids=["two", "crowded", "shared_peak", "chain"])
def test_group_people_matches_oracle(case):
    heat, paf, n = case()
    got, want = _port_people(heat, paf)
    _assert_people(got, want, n)
    # and the JAX package's path on the same maps
    peaks, valid = _jit_peaks(heat)
    jax_people = JP.group_people(np.asarray(peaks), np.asarray(valid),
                                 np.asarray(_jit_limbs(paf, peaks, valid)))
    _assert_people(got, jax_people, n)


def test_group_people_oracle_fuzz():
    """tests/test_pose.py's fuzz (smooth random PAFs, random peaks), two
    seeds: decision for decision."""
    from scipy.ndimage import gaussian_filter

    H, W = 48, 64
    for seed in range(2):
        rng = np.random.default_rng(seed)
        heat = np.zeros((H, W, JP.N_HEAT), np.float32)
        n_pk = rng.integers(1, 4, JP.N_PARTS)
        for part in range(JP.N_PARTS):
            for _ in range(n_pk[part]):
                y, x = rng.integers(4, H - 4), rng.integers(4, W - 4)
                heat[y, x, part] = float(rng.uniform(0.3, 1.0))
        paf = np.stack([gaussian_filter(rng.normal(size=(H, W)), 4.0)
                        for _ in range(JP.N_PAF)], axis=-1)
        paf = (paf * 6.0).astype(np.float32)
        got, want = _port_people(heat, paf)
        _assert_people(got, want, len(want))


# ------------------------------------------------------------ crop


def _items(rng, kind: str, t: int, n: int) -> np.ndarray:
    if kind == "inside":
        xy = rng.uniform(0.05, 0.5, (n, 2))
        wh = rng.uniform(0.05, 0.45, (n, 2))
    elif kind == "across":  # over an edge of the frame
        xy = rng.uniform(-0.3, 0.9, (n, 2))
        wh = rng.uniform(0.2, 0.6, (n, 2))
    else:  # outside it, and boxes narrower than a pixel
        xy = rng.choice([-1.5, 1.2], (n, 2)) + rng.uniform(0, 0.2, (n, 2))
        wh = rng.uniform(0.0, 0.3, (n, 2))
        wh[::3] = 0.001
    items = np.concatenate([rng.integers(0, t, (n, 1)), xy, xy + wh], 1)
    return items.astype(np.float32)


@pytest.mark.parametrize("kind", ["inside", "across", "outside"])
@pytest.mark.parametrize("size", [16, 37])
def test_gray_crop_matches_jax(kind, size):
    rng = np.random.default_rng(size)
    frames = rng.integers(0, 256, (2, 48, 64, 3)).astype(np.float32)
    items = _items(rng, kind, 2, 24)
    want = np.asarray(jax.jit(JOP._crop_batch_device, static_argnums=2)(
        frames, items, size))
    got = POP.crop_batch(_t(frames), _t(items), size).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=CROP_ATOL)
    if kind == "outside":
        # wholly outside: gray, 128 / 255 - 0.5, everywhere
        gray = np.float32(128) * np.float32(1 / 255) - np.float32(0.5)
        outside = np.all(np.abs(items[:, 1:3]) > 1.0, axis=1)
        assert outside.any()
        assert (got[outside] == gray).all()


def test_gray_crop_plain_is_the_crop_inside_the_frame():
    """Inside the frame and away from its edge the gray mode is the plain
    crop mapped by / 255 - 0.5 (coverage 1 up to an ulp)."""
    rng = np.random.default_rng(9)
    frames = _t(rng.integers(0, 256, (1, 40, 50, 3)).astype(np.float32))
    boxes = _t(np.array([[5, 6, 30, 25], [10, 3, 44, 36]], np.float32))
    fi = torch.zeros(2, dtype=torch.int64)
    gray = crop_and_resize_plain(frames, boxes, (20, 20), fi, gray=True)
    plain = crop_and_resize_plain(frames, boxes, (20, 20), fi)
    torch.testing.assert_close(gray, plain / 255 - 0.5, rtol=0, atol=1e-6)


# ------------------------------------------------------------ resizes


@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_merge_scale_maps_matches_jax(method):
    """Two scales at non-integer ratios (13x17 -> 24x32 -> 96x128)."""
    rng = np.random.default_rng(11)
    base = rng.normal(size=(2, 24, 32, 5)).astype(np.float32)
    small = rng.normal(size=(2, 13, 17, 5)).astype(np.float32)
    want = np.asarray(jax.jit(
        lambda a, b: JP.merge_scale_maps([a, b], (96, 128), method))(
            base, small))
    got = PP.merge_scale_maps([_t(np.moveaxis(base, -1, 1)),
                               _t(np.moveaxis(small, -1, 1))], (96, 128),
                              method)
    got = np.moveaxis(got.numpy(), 1, -1)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RESIZE_RTOL * np.abs(want).max())


@pytest.mark.parametrize("method", ["linear", "cubic"])
def test_map_upsample_and_input_scale_match_jax(method):
    """infer_maps' upsample of the net grid (11x13 -> 90x100, a
    non-integer ratio) and device_stage's downscale of the input at scale
    0.9 (64x96 -> 56x80, antialias=False)."""
    rng = np.random.default_rng(12)
    m = rng.normal(size=(1, 11, 13, 4)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jax.image.resize(
        a, (1, 90, 100, 4), method))(m))
    got = np.moveaxis(resize_hw(_t(np.moveaxis(m, -1, 1)), 2, 90, 100,
                                method).numpy(), 1, -1)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RESIZE_RTOL * np.abs(want).max())
    x = rng.uniform(-0.5, 0.5, (1, 64, 96, 3)).astype(np.float32)
    h, w = (max(8, int(round(n * 0.9)) // 8 * 8) for n in (64, 96))
    want = np.asarray(jax.jit(lambda a: jax.image.resize(
        a, (1, h, w, 3), "linear", antialias=False))(x))
    got = np.moveaxis(resize_hw(_t(np.moveaxis(x, -1, 1)), 2, h, w,
                                "linear").numpy(), 1, -1)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RESIZE_RTOL * np.abs(want).max())


# ------------------------------------------------------------ Pose type


def _kp():
    kp = np.zeros((POP.Pose.kp_count(), 3), np.float32)
    P = POP.Pose
    for part, v in ((P.Nose, (0.5, 0.3, 0.9)), (P.REye, (0.45, 0.28, 0.8)),
                    (P.LEye, (0.55, 0.28, 0.8)), (P.REar, (0.4, 0.3, 0.7)),
                    (P.LEar, (0.6, 0.3, 0.7)), (P.Neck, (0.5, 0.45, 0.9)),
                    (P.RElbow, (0.3, 0.5, 0.9)), (P.RWrist, (0.3, 0.7, 0.8)),
                    (P.LElbow, (0.7, 0.5, 0.6)), (P.LWrist, (0.75, 0.6, 0.9))):
        kp[part] = v
    kp[30:40] = np.random.default_rng(0).uniform(0, 1, (10, 3))
    return kp


def test_pose_serde_bytes_equal():
    kp = _kp()
    mine, theirs = POP.Pose(0.87, kp), JOP.Pose(0.87, kp)
    assert mine.serialize() == theirs.serialize()
    assert len(mine.serialize()) == POP.Pose.kp_size() * 4
    from scannertools_tpu import types as jtypes
    from scannertools_tpu_torch import types as ptypes

    lists = [mine, POP.Pose(0.5, kp * 0.5)]
    buf = ptypes.get_type("pose_list").serialize(lists)
    assert buf == jtypes.get_type("pose_list").serialize(
        [JOP.Pose(p._score, p._kp) for p in lists])
    back = jtypes.get_type("pose_list").parse(buf)
    assert [p.serialize() for p in back] == [p.serialize() for p in lists]
    q = POP.Pose.deserialize(theirs.serialize())
    np.testing.assert_array_equal(q._kp, kp)


def test_pose_boxes_and_write_back_equal_jax():
    kp = _kp()
    mine, theirs = POP.Pose(0.9, kp), JOP.Pose(0.9, kp)
    assert np.array_equal(np.asarray(mine.face_bbox(), dtype=object),
                          np.asarray(theirs.face_bbox(), dtype=object))
    assert mine.body_bbox() == theirs.body_bbox()
    assert mine.distance_to(POP.Pose(0.1, kp * 0.9)) == \
        theirs.distance_to(JOP.Pose(0.1, kp * 0.9))
    for wrist, elbow in ((POP.Pose.RWrist, POP.Pose.RElbow),
                         (POP.Pose.LWrist, POP.Pose.LElbow)):
        assert POP._hand_box(mine, wrist, elbow) == \
            JOP._hand_box(theirs, wrist, elbow)
    a = np.zeros((POP.Pose.kp_count(), 3), np.float32)
    b = a.copy()
    crop = np.random.default_rng(1).uniform(0, 1, (21, 3)).astype(np.float32)
    POP._write_back(a, 88, 21, (0.2, 0.4, 0.6, 0.8), crop)
    JOP._write_back(b, 88, 21, (0.2, 0.4, 0.6, 0.8), crop)
    np.testing.assert_array_equal(a, b)
