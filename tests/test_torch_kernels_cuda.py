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
warp_px) and a 2-row level. ``nms`` and ``crop_and_resize`` are held to
their plain versions on the card and on the CPU: seeded box clouds with
tied scores, K = 1 and K not a multiple of 64, K at the walk's tile edges
(63-65, 127-129), at the one-launch path's shared-memory limit (1280) and
one past it, and on the device-memory path (2048, 4096), max_out above K
and below the kept count, alternating chains within and across tiles,
all-invalid frames; crops up- and downsampled, on and past the frame's
edge, degenerate, from several frames in one launch, with C = 1, 3, 4 and
256 channels (both crop kernels), output widths 227 and 1, rows that start
off a 16-byte boundary, and frames that do; the level crop (a map a box)
over ragged FPN levels, with a level off a 16-byte boundary and a bad level
that traps; Mask R-CNN's two ``nms`` calls on both paths and its forward's
launches; ``pose_peaks`` (a cluster of 8 row bands a map) on plateaus,
edges, ties and fill rows, on peaks and plateaus across the bands' edges,
a constant plateau (every pixel a peak), maps off a 16-byte boundary
(the 4-byte path), maps of fewer rows than the cluster has blocks, rising
and falling ramps of peaks that refill the warps' buffers, 64 frames and
trained-like maps; ``ctc_viterbi`` on both paths (a warp a caption
window; a block a window past 256 states or past shared memory's Tmax) on
all-zero emissions (every move ties), repeated tokens, T equal to the
lattice's mandatory frames, a batch of windows of mixed T and S, windows
and batches of S on the warp lanes' edges (2-3, 31-33, 63-65, 191-193,
255-257), a window of 1025 states (more than a block has threads), a Tmax
past the shared-memory limit, V not a multiple of 4, V above 32 and
emissions off a 16-byte boundary (the 4-byte ring fill), skip flags on
states 0 and 1 (no state below 0 is read), and no scratch on the warp
path; both paths' floor probes against their recurrence. Inputs are made
from a seed with numpy.

Every test here needs a CUDA device and nvcc, and skips elsewhere. The
module imports no JAX, so it runs where only the port is installed:

    python -m pytest tests/test_torch_kernels_cuda.py -q

``chip_smoke.py`` repeats these checks at the main path's shapes.
"""

import numpy as np
import pytest
import torch

from scannertools_tpu_torch.models import common as MC
from scannertools_tpu_torch.ops import histogram as H
from scannertools_tpu_torch.ops import optical_flow as OF
from scannertools_tpu_torch.tools.timing import band_edge_maps
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


def _box_cloud(rng, t, k, span=60.0):
    c = rng.uniform(0, span, (t, k, 2))
    wh = rng.uniform(2, 20, (t, k, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], axis=-1).astype(
        np.float32)


@pytest.mark.parametrize("mode", ["union", "min"])
@pytest.mark.parametrize("t,k,max_out", [(1, 1, 1), (3, 5, 9), (4, 96, 96),
                                         (2, 130, 64), (2, 256, 256),
                                         (1, 1280, 1280)])
def test_nms_kernel_matches_plain(cuda_device, mode, t, k, max_out):
    """Seeded clouds with tied scores and rows at the score threshold;
    K = 1, K past max_out, max_out past K, K not a multiple of 64."""
    rng = np.random.default_rng(17 + k)
    boxes = torch.from_numpy(_box_cloud(rng, t, k))
    scores = rng.uniform(0, 1, (t, k)).astype(np.float32)
    scores[:, ::7] = 0.5
    scores[:, 1::11] = 0.1
    scores = torch.from_numpy(scores)
    b, s = boxes.to(cuda_device), scores.to(cuda_device)
    before = MC.nms.launches
    got = MC.nms(b, s, 0.45, max_out, 0.1, mode)
    assert MC.nms.launches == before + 1
    for g, p, c in zip(got, MC.nms_plain(b, s, 0.45, max_out, 0.1, mode),
                       MC.nms_plain(boxes, scores, 0.45, max_out, 0.1,
                                    mode)):
        assert torch.equal(g, p)
        assert torch.equal(g.cpu(), c)


def test_nms_kernel_chain_and_invalid_frames(cuda_device):
    """The 32-deep alternating chain (each box overlaps only the next), an
    all-invalid frame and an all-tied frame, in one launch."""
    n = 64
    chain = np.stack([np.arange(n) * 6.0, np.zeros(n),
                      np.arange(n) * 6.0 + 10, np.full(n, 10.0)],
                     axis=1).astype(np.float32)
    boxes = torch.from_numpy(np.stack([chain, chain, chain[::-1].copy()]))
    scores = torch.from_numpy(np.stack([
        np.linspace(1.0, 0.5, n), np.zeros(n), np.full(n, 0.5)]).astype(
            np.float32))
    b, s = boxes.to(cuda_device), scores.to(cuda_device)
    got = MC.nms(b, s, 0.2, n)
    for g, p in zip(got, MC.nms_plain(boxes, scores, 0.2, n)):
        assert torch.equal(g.cpu(), p)
    assert got[2][0].sum() == n // 2 and not got[2][1].any()


def _dense_case(rng, t, k, span=40.0):
    boxes = _box_cloud(rng, t, k, span)
    scores = rng.uniform(0, 1, (t, k)).astype(np.float32)
    scores[:, ::6] = 0.5       # ties
    scores[:, 1::3] = 0.0      # invalid rows among the valid ones
    return torch.from_numpy(boxes), torch.from_numpy(scores)


@pytest.mark.parametrize("k", [63, 64, 65, 127, 128, 129, 1280, 1281, 2048,
                               4096])
def test_nms_kernel_tile_edges_and_both_paths(cuda_device, k):
    """K at the walk's tile edges, at the one-launch path's limit and one
    past it, and on the device-memory path; dense clouds, so suppression
    crosses tiles; max_out above K and below the kept count."""
    # at the limit, enough frames for the one-launch path
    t = 3 if k <= 256 else (MC.NMS_SPREAD_BELOW_T if k == 1280 else 2)
    boxes, scores = _dense_case(np.random.default_rng(k), t, k,
                                span=40.0 * max(1.0, (k / 128) ** 0.5))
    b, s = boxes.to(cuda_device), scores.to(cuda_device)
    assert MC.nms_geometry(t, k)["path"] == ("shared" if k <= 1280 else
                                             "global")
    for mode in ("union", "min"):  # the plain version on the card
        kept = int(MC.nms_plain(b, s, 0.3, k, 0.0, mode)[2].sum(
            dim=1).min())
        for max_out in (k + 3, max(1, kept // 2)):
            before = MC.nms.launches
            got = MC.nms(b, s, 0.3, max_out, 0.0, mode)
            assert MC.nms.launches == before + 1
            for g, p in zip(got, MC.nms_plain(b, s, 0.3, max_out, 0.0,
                                              mode)):
                assert torch.equal(g, p)


@pytest.mark.parametrize("n", [150, 1500])
def test_nms_kernel_chain_across_tiles(cuda_device, n):
    """The alternating chain across tiles, on both paths: every tile's
    first row depends on the last kept row of the tile before it."""
    chain = np.stack([np.arange(n) * 6.0, np.zeros(n),
                      np.arange(n) * 6.0 + 10, np.full(n, 10.0)],
                     axis=1).astype(np.float32)
    boxes = torch.from_numpy(np.stack([chain, chain]))
    scores = torch.from_numpy(np.stack([np.linspace(1.0, 0.5, n),
                                        np.full(n, 0.5)]).astype(np.float32))
    got = MC.nms(boxes.to(cuda_device), scores.to(cuda_device), 0.2, n)
    for g, p in zip(got, MC.nms_plain(boxes, scores, 0.2, n)):
        assert torch.equal(g.cpu(), p)
    assert int(got[2][0].sum()) == -(-n // 2)


@pytest.mark.parametrize("t,k,max_out", [(8, 512, 100), (3, 64, 80),
                                         (32, 1000, 1000), (3, 1000, 100),
                                         (2, 2048, 300)])
def test_nms_kernel_index_matches_plain(cuda_device, t, k, max_out):
    """The kept source rows on both paths (SSD's [8, 512] call, K = 1000
    shared and in device memory, the proposals' [2, 2048]), max_out above
    and below the kept count, tied scores and an all-invalid frame; the
    boxes, scores and valid flags equal the call without the index."""
    boxes, scores = _dense_case(np.random.default_rng(31 + k), t, k,
                                span=40.0 * max(1.0, (k / 128) ** 0.5))
    scores[-1] = 0.0
    b, s = boxes.to(cuda_device), scores.to(cuda_device)
    before = MC.nms.launches
    got = MC.nms(b, s, 0.6, max_out, 0.0, index=True)
    assert MC.nms.launches == before + 1
    want = MC.nms_plain(boxes, scores, 0.6, max_out, 0.0, index=True)
    for g, p in zip(got, want):
        assert torch.equal(g.cpu(), p)
    for g, p in zip(got[:3], MC.nms(b, s, 0.6, max_out, 0.0)):
        assert torch.equal(g, p)
    assert (got[3][-1] == -1).all() and (got[3][0] >= 0).any()


def test_detection_forwards_launch_once_a_chunk(cuda_device):
    """SSD's detect launches one nms for all frames; the Faster R-CNN
    forward one nms and one crop; both give the outputs of the same
    forward on the card with the kernels' plain versions."""
    from unittest import mock

    from scannertools_tpu_torch.models import faster_rcnn as PR
    from scannertools_tpu_torch.models import ssd as PS

    rng = np.random.default_rng(41)
    frames = torch.from_numpy(rng.uniform(0, 255, (3, 64, 96, 3)).astype(
        np.float32)).to(cuda_device)
    for lib, args in ((PS, ()), (PR, (8, 64))):
        state = {k: v.to(cuda_device) for k, v in lib.init_params(0).items()}
        run = (lambda: PS.detect(state, frames)) if lib is PS else \
            (lambda: PR.apply(state, frames, *args))
        n0, c0 = MC.nms.launches, MC.crop_and_resize.launches
        got = run()
        assert MC.nms.launches == n0 + 1
        assert MC.crop_and_resize.launches == c0 + (lib is PR)
        with mock.patch.object(lib, "nms", MC.nms_plain), \
                mock.patch.object(PR, "crop_and_resize",
                                  MC.crop_and_resize_plain):
            want = run()
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_nms_kernel_refuses_bad_inputs(cuda_device):
    b = torch.zeros((2, 8, 4), device=cuda_device)
    s = torch.zeros((2, 8), device=cuda_device)
    before = MC.nms.launches
    with pytest.raises(TypeError):
        MC.nms(b.double(), s.double(), 0.5, 4)
    with pytest.raises(ValueError):
        MC.nms(b.transpose(0, 1).contiguous().transpose(0, 1), s, 0.5, 4)
    with pytest.raises(ValueError):
        MC.nms(b, s.cpu(), 0.5, 4)
    with pytest.raises(ValueError):  # not 16-byte aligned
        MC.nms(torch.zeros(2 * 8 * 4 + 1, device=cuda_device)[1:].view(
            2, 8, 4), s, 0.5, 4)
    assert MC.nms.launches == before


def _crop_case(rng, t, h, w, b):
    frames = rng.uniform(-1, 255, (t, h, w, 3)).astype(np.float32)
    xy = rng.uniform(-8, max(h, w), (b, 2))
    wh = rng.uniform(-3, max(h, w), (b, 2))  # some degenerate
    boxes = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    boxes[0] = (0, 0, w, h)          # the whole frame
    boxes[1] = (w - 3, h - 4, w, h)  # on the bottom-right edge: upsampled
    boxes[2] = (5, 5, 5, 9)          # degenerate
    fi = rng.integers(0, t, b).astype(np.int64)
    return [torch.from_numpy(a) for a in (frames, boxes, fi)]


@pytest.mark.parametrize("t,h,w,b,size", [(1, 40, 50, 9, 24),
                                          (3, 61, 47, 20, 48),
                                          (2, 120, 160, 12, 160),
                                          (2, 96, 128, 7, 227),
                                          (2, 33, 35, 5, 7)])
def test_crop_and_resize_kernel_matches_plain(cuda_device, t, h, w, b,
                                              size):
    """Up- and downsampled boxes, boxes on and past the frame's edge,
    degenerate boxes, crops from several frames in one launch."""
    frames, boxes, fi = _crop_case(np.random.default_rng(19 + size), t, h,
                                   w, b)
    args = [a.to(cuda_device) for a in (frames, boxes)]
    fid = fi.to(cuda_device)
    before = MC.crop_and_resize.launches
    got = MC.crop_and_resize(*args, (size, size), fid)
    assert MC.crop_and_resize.launches == before + 1
    assert got.shape == (b, size, size, 3)
    assert torch.equal(got, MC.crop_and_resize_plain(*args, (size, size),
                                                     fid))
    assert torch.equal(got.cpu(), MC.crop_and_resize_plain(
        frames, boxes, (size, size), fi))


def test_crop_and_resize_kernel_roi_align_c512(cuda_device):
    """Faster R-CNN's RoIAlign: 7x7 crops of a 512-channel stride-16 map
    (channel vectors), RoIs in map pixels from several frames, zero boxes
    among them (the proposals' padding rows)."""
    rng = np.random.default_rng(23)
    maps = torch.from_numpy(rng.standard_normal((3, 6, 9, 512)).astype(
        np.float32)).to(cuda_device)
    xy = rng.uniform(0, 8, (40, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0, 6, (40, 2))], 1)
    boxes[::9] = 0.0
    boxes = torch.from_numpy(boxes.astype(np.float32)).to(cuda_device)
    fi = torch.from_numpy(rng.integers(0, 3, 40)).to(cuda_device)
    assert MC.crop_geometry(40, 7, 7, 512, True)["pixels"]
    got = MC.crop_and_resize(maps, boxes, (7, 7), fi)
    assert torch.equal(got, MC.crop_and_resize_plain(maps, boxes, (7, 7),
                                                     fi))


def test_crop_and_resize_kernel_refuses_bad_inputs(cuda_device):
    frames, boxes, fi = [a.to(cuda_device) for a in _crop_case(
        np.random.default_rng(23), 2, 20, 30, 6)]
    before = MC.crop_and_resize.launches
    with pytest.raises(TypeError):
        MC.crop_and_resize(frames.double(), boxes, (8, 8), fi)
    with pytest.raises(TypeError):
        MC.crop_and_resize(frames, boxes, (8, 8), fi.int())
    with pytest.raises(ValueError):
        MC.crop_and_resize(frames.transpose(1, 2), boxes, (8, 8), fi)
    with pytest.raises(ValueError):
        MC.crop_and_resize(frames, boxes, (8, 8), fi.cpu())
    assert MC.crop_and_resize.launches == before
    assert MC.crop_and_resize(frames, boxes[:0], (8, 8), fi[:0]).shape == \
        (0, 8, 8, 3)
    assert MC.crop_and_resize.launches == before


def test_crop_and_resize_kernel_traps_on_a_frame_past_the_batch(cuda_device):
    """A frame index outside [0, T) stops the kernel before it reads (in a
    child process: the trap loses the CUDA context)."""
    import subprocess
    import sys

    code = """
import torch
from scannertools_tpu_torch.models import common as MC
frames = torch.zeros((2, 20, 30, 3), device="cuda")
boxes = torch.tensor([[0.0, 0.0, 10.0, 10.0]], device="cuda")
MC.crop_and_resize(frames, boxes, (8, 8),
                   torch.tensor([2], device="cuda"))
try:
    torch.cuda.synchronize()
except RuntimeError:
    print("RAISED")
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert "RAISED" in res.stdout, res.stdout + res.stderr


@pytest.mark.parametrize("c", [1, 3, 4, 256])
@pytest.mark.parametrize("ow", [227, 1])
def test_crop_and_resize_kernel_channels_and_widths(cuda_device, c, ow):
    """Both crop kernels (rows for C <= 4, channel vectors for C = 256) at
    output widths 227 (rows of 227 * C values: most start off a 16-byte
    boundary) and 1, and on frames that start off a 16-byte boundary
    (then C = 256 takes the row kernel)."""
    rng = np.random.default_rng(29 + c + ow)
    t, h, w, b, oh = 2, 37, 45, 5, 9
    frames = torch.from_numpy(rng.uniform(-1, 255, (t, h, w, c)).astype(
        np.float32))
    xy = rng.uniform(-4, 40, (b, 2))
    boxes = torch.from_numpy(np.concatenate(
        [xy, xy + rng.uniform(-2, 30, (b, 2))], axis=1).astype(np.float32))
    fi = torch.from_numpy(rng.integers(0, t, b).astype(np.int64))
    want = MC.crop_and_resize_plain(frames, boxes, (oh, ow), fi)
    dev = frames.to(cuda_device)
    off = torch.empty(dev.numel() + 1, device=cuda_device)[1:].view(
        dev.shape)
    off.copy_(dev)  # the same frames, 4 bytes past a 16-byte boundary
    for imgs in (dev, off):
        before = MC.crop_and_resize.launches
        got = MC.crop_and_resize(imgs, boxes.to(cuda_device), (oh, ow),
                                 fi.to(cuda_device))
        assert MC.crop_and_resize.launches == before + 1
        assert torch.equal(got.cpu(), want)


def test_crop_and_resize_kernel_fpn_map(cuda_device):
    """A detection model's RoI crop: 64 boxes of one 256-channel map at
    7x7 and 14x14."""
    rng = np.random.default_rng(31)
    fmap = torch.from_numpy(rng.standard_normal((1, 50, 84, 256)).astype(
        np.float32))
    xy = rng.uniform(0, 70, (64, 2))
    boxes = torch.from_numpy(np.concatenate(
        [xy, xy + rng.uniform(1, 40, (64, 2))], axis=1).astype(np.float32))
    fi = torch.zeros(64, dtype=torch.int64)
    for size in (7, 14):
        got = MC.crop_and_resize(fmap.to(cuda_device),
                                 boxes.to(cuda_device), (size, size),
                                 fi.to(cuda_device))
        assert torch.equal(got.cpu(), MC.crop_and_resize_plain(
            fmap, boxes, (size, size), fi))


def _level_case(rng, t, canvas, c, n, levels=4):
    """The FPN levels of a ``canvas`` (ragged: sides not a multiple of 32)
    and ``n`` canvas boxes on every level, at and past the edges, zero
    boxes, from ``t`` frames."""
    h, w = canvas
    maps = [torch.from_numpy(rng.standard_normal(
        (t, -(-h // s), -(-w // s), c)).astype(np.float32))
        for s in MC.FPN_STRIDES[:levels]]
    xy = rng.uniform(-20, max(h, w), (n, 2))
    wh = np.exp(rng.uniform(np.log(2), np.log(4 * max(h, w)), (n, 2)))
    boxes = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    boxes[::7] = 0.0
    boxes[1] = (0, 0, w, h)
    boxes[2] = (w - 3, h - 2, w + 40, h + 9)
    level = rng.integers(0, levels, n)
    fi = rng.integers(0, t, n)
    return maps, torch.from_numpy(boxes), torch.from_numpy(level), \
        torch.from_numpy(fi)


@pytest.mark.parametrize("c", [3, 256])
@pytest.mark.parametrize("levels,size", [(4, 7), (4, 14), (2, 5), (1, 9)])
def test_crop_and_resize_levels_kernel_matches_plain(cuda_device, c, levels,
                                                     size):
    """The level crop (a map a box) against its plain version, ``==``, on
    the card and on the CPU: ragged maps, every level, boxes at and past the
    edges, zero boxes, several frames, both crop kernels (C = 3 rows, C =
    256 channel vectors), fewer than four levels."""
    maps, boxes, level, fi = _level_case(
        np.random.default_rng(43 + c + size), 3, (100, 140), c, 90, levels)
    dev = [m.to(cuda_device) for m in maps]
    args = (boxes.to(cuda_device), level.to(cuda_device), fi.to(cuda_device),
            (size, size))
    before = MC.crop_and_resize_levels.launches
    got = MC.crop_and_resize_levels(dev, *args)
    assert MC.crop_and_resize_levels.launches == before + 1
    assert torch.equal(got, MC.crop_and_resize_levels_plain(dev, *args))
    assert torch.equal(got.cpu(), MC.crop_and_resize_levels_plain(
        maps, boxes, level, fi, (size, size)))


def test_crop_and_resize_levels_kernel_unaligned_map(cuda_device):
    """A level off a 16-byte boundary: C = 256 takes the row kernel."""
    maps, boxes, level, fi = _level_case(np.random.default_rng(47), 2,
                                         (64, 96), 256, 30)
    dev = [m.to(cuda_device) for m in maps]
    off = torch.empty(dev[2].numel() + 1, device=cuda_device)[1:].view(
        dev[2].shape)
    off.copy_(dev[2])
    args = (boxes.to(cuda_device), level.to(cuda_device), fi.to(cuda_device),
            (7, 7))
    got = MC.crop_and_resize_levels(dev[:2] + [off] + dev[3:], *args)
    assert torch.equal(got, MC.crop_and_resize_levels(dev, *args))


def test_crop_and_resize_levels_kernel_traps_on_a_bad_level(cuda_device):
    """A level outside [0, len(maps)) stops the kernel before it reads (in
    a child process: the trap loses the CUDA context)."""
    import subprocess
    import sys

    code = """
import torch
from scannertools_tpu_torch.models import common as MC
maps = [torch.zeros((1, 20 // s, 30 // s, 8), device="cuda") for s in (1, 2)]
boxes = torch.tensor([[0.0, 0.0, 10.0, 10.0]], device="cuda")
zero = torch.tensor([0], device="cuda")
MC.crop_and_resize_levels(maps, boxes, torch.tensor([2], device="cuda"),
                          zero, (4, 4))
try:
    torch.cuda.synchronize()
except RuntimeError:
    print("RAISED")
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert "RAISED" in res.stdout, res.stdout + res.stderr


@pytest.mark.parametrize("path", ["shared", "global"])
@pytest.mark.parametrize("t,k,max_out,index", [(40, 1000, 1000, False),
                                               (8, 1000, 100, True)])
def test_nms_kernel_maskrcnn_calls_both_paths(cuda_device, path, t, k,
                                              max_out, index):
    """Mask R-CNN's two calls of a chunk, on each path forced: the
    proposals of five levels of 8 frames, [40, 1000] -> 1000, and the final
    class-shifted selection with the kept index, [8, 1000] -> 100 at score
    threshold 0.05."""
    from scannertools_tpu_torch.tools.nms_probe import path as forced

    boxes, scores = _dense_case(np.random.default_rng(53 + t), t, k,
                                span=40.0 * (k / 128) ** 0.5)
    thresh = 0.05 if index else 0.0
    b, s = boxes.to(cuda_device), scores.to(cuda_device)
    want = MC.nms_plain(boxes, scores, 0.5, max_out, thresh, index=index)
    with forced(path):
        assert MC.nms_geometry(t, k)["path"] == path
        before = MC.nms.launches
        got = MC.nms(b, s, 0.5, max_out, thresh, index=index)
        assert MC.nms.launches == before + 1
    for g, p in zip(got, want):
        assert torch.equal(g.cpu(), p)


def test_maskrcnn_forward_launches_twice_each(cuda_device):
    """One Mask R-CNN forward launches two nms (the proposals, the finals)
    and two level crops (7x7, 14x14), and gives the outputs of the same
    forward with the kernels' plain versions."""
    from unittest import mock

    from scannertools_tpu_torch.models import maskrcnn as PM

    frames = torch.from_numpy(np.random.default_rng(59).uniform(
        0, 255, (2, 96, 128, 3)).astype(np.float32)).to(cuda_device)
    state = {k: v.to(cuda_device) for k, v in PM.init_params(0).items()}
    images, _ = PM.preprocess(frames, 96, 160)
    n0 = MC.nms.launches
    c0 = MC.crop_and_resize_levels.launches
    got = PM.infer(state, images, "R-50-FPN", 300, 200, 20)
    assert MC.nms.launches == n0 + 2
    assert MC.crop_and_resize_levels.launches == c0 + 2
    with mock.patch.object(PM, "nms", MC.nms_plain), \
            mock.patch.object(PM, "crop_and_resize_levels",
                              MC.crop_and_resize_levels_plain):
        want = PM.infer(state, images, "R-50-FPN", 300, 200, 20)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ------------------------------------------------------------ pose


def _pose_heat(case: str, t: int = 2, c: int = 19, h: int = 40,
               w: int = 56) -> torch.Tensor:
    """[T, C, H, W] float32 heat maps: plateaus (equal neighbours), peaks on
    the edges, fewer than 24 peaks (the fill rows), many equal values, and
    NaN-free random maps (many local maxima)."""
    rng = np.random.default_rng(["plateau", "edges", "few", "ties",
                                 "random"].index(case))
    hm = np.zeros((t, c, h, w), np.float32)
    if case == "plateau":
        hm[:, 0, 10:13, 20:24] = 0.7
        hm[:, 3, 5:7, 5:7] = hm[:, 3, 30, 40:43] = 0.4
    elif case == "edges":
        for part in range(18):
            hm[:, part, 0, part] = 0.5
            hm[:, part, h - 1, w - 1 - part] = 0.6
            hm[:, part, part % h, 0] = 0.3
    elif case == "few":
        hm[0, 1, 3, 4] = 0.9
        hm[0, 1, 0, 1] = 0.8
        hm[1, 2, 0, 0] = 0.2
        hm[1, 5, 1, 1] = 0.05
    elif case == "ties":  # more than 24 peaks of one value: index order
        hm[:, :, 1::3, 1::3] = 0.5
        hm[:, :, 1::9, 1::9] = 0.75
    else:
        hm = rng.normal(0.2, 0.4, (t, c, h, w)).astype(np.float32)
    return torch.from_numpy(hm)


@pytest.mark.parametrize("case", ["plateau", "edges", "few", "ties",
                                  "random"])
def test_pose_peaks_kernel_matches_plain(cuda_device, case):
    from scannertools_tpu_torch.models import pose as PP

    heat = _pose_heat(case)
    want = PP.find_peaks_plain(heat)
    before = PP.find_peaks.launches
    got = PP.find_peaks(heat.to(cuda_device))
    assert PP.find_peaks.launches == before + 1
    for g, p in zip(got, want):
        assert torch.equal(g.cpu(), p)


@pytest.mark.parametrize("t,c,h,w", [(1, 18, 7, 5), (3, 57, 33, 29),
                                     (2, 19, 480, 640), (1, 19, 1, 600)])
def test_pose_peaks_kernel_shapes(cuda_device, t, c, h, w):
    """Ragged and small maps (35 pixels), a channel count past the 19 parts
    (the parts first), the main path's 480x640, a one-row map; smooth
    random maps (an upsampled coarse grid, as the net's maps are) and maps
    whose best peaks all fall to one thread (a column in the block's
    stride)."""
    from scannertools_tpu_torch.models import pose as PP

    rng = np.random.default_rng(h + w)
    coarse = torch.from_numpy(rng.normal(0.2, 0.5, (
        t, c, max(h // 8, 1), max(w // 8, 1))).astype(np.float32))
    smooth = torch.nn.functional.interpolate(coarse, size=(h, w),
                                             mode="bilinear").contiguous()
    one_thread = torch.zeros((t, c, h, w))
    flat = one_thread.view(t, c, -1)
    flat[:, :, ::512] = torch.linspace(0.2, 0.9, flat[:, :, ::512].shape[-1])
    for heat in (smooth, one_thread):
        want = PP.find_peaks_plain(heat)
        got = PP.find_peaks(heat.to(cuda_device))
        for g, p in zip(got, want):
            assert torch.equal(g.cpu(), p)


def test_pose_peaks_kernel_refuses_bad_inputs(cuda_device):
    from scannertools_tpu_torch.models import pose as PP

    heat = _pose_heat("random").to(cuda_device)
    before = PP.find_peaks.launches
    with pytest.raises(ValueError):
        PP.find_peaks(heat.double())
    with pytest.raises(ValueError):
        PP.find_peaks(heat[:, :17].contiguous())
    with pytest.raises(ValueError):
        PP.find_peaks(heat.transpose(2, 3))
    with pytest.raises(ValueError):
        PP.find_peaks(heat[:, :, :4, :5].contiguous())
    assert PP.find_peaks.launches == before
    empty = PP.find_peaks(heat[:0])
    assert empty[0].shape == (0, 18, 24, 3)
    assert PP.find_peaks.launches == before


def _assert_peaks_equal(heat: torch.Tensor):
    """find_peaks on the card equals find_peaks_plain (run on the card too:
    the same torch ops), in one launch; -> the kernel's outputs."""
    from scannertools_tpu_torch.models import pose as PP

    before = PP.find_peaks.launches
    got = PP.find_peaks(heat)
    assert PP.find_peaks.launches == before + 1
    want = PP.find_peaks_plain(heat)
    for g, p in zip(got, want):
        assert torch.equal(g, p)
    return got


@pytest.mark.parametrize("case", ["edge", "plateau"])
@pytest.mark.parametrize("h,w", [(480, 640), (64, 100), (61, 83)])
def test_pose_peaks_kernel_band_edges(cuda_device, case, h, w):
    """Peaks and plateaus across the cluster's band edges, on the 16-byte
    path (480x640, 64x100) and the 4-byte one (61x83)."""
    heat = torch.from_numpy(band_edge_maps(case, 2, h, w)).to(cuda_device)
    _, valid = _assert_peaks_equal(heat)
    assert valid.any()


def test_pose_peaks_kernel_constant_plateau(cuda_device):
    """Every pixel a peak (0.5 everywhere): slots 0..23 are indices 0..23,
    and every warp's buffer fills at its first group."""
    heat = torch.full((2, 19, 480, 640), 0.5, device=cuda_device)
    peaks, valid = _assert_peaks_equal(heat)
    idx = torch.arange(24, device=cuda_device, dtype=torch.float32)
    assert valid.all()
    assert torch.equal(peaks[..., 0], idx.expand(2, 18, 24))
    assert (peaks[..., 1] == 0).all() and (peaks[..., 2] == 0.5).all()


def test_pose_peaks_kernel_misaligned(cuda_device):
    """The 4-byte path: W % 4 != 0 with an odd H * W and C = 19 (maps that
    start off a 16-byte boundary), and a 480x640 chunk whose tensor starts
    one float past an aligned address."""
    rng = np.random.default_rng(11)
    odd = rng.normal(0.2, 0.4, (3, 19, 61, 83)).astype(np.float32)
    _assert_peaks_equal(torch.from_numpy(odd).to(cuda_device))
    coarse = torch.from_numpy(rng.normal(0.2, 0.5, (2, 19, 60, 80)).astype(
        np.float32)).to(cuda_device)
    maps = torch.nn.functional.interpolate(coarse, size=(480, 640),
                                           mode="bilinear")
    store = torch.empty(maps.numel() + 1, device=cuda_device)
    shifted = store[1:].view(maps.shape)
    shifted.copy_(maps)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    _, valid = _assert_peaks_equal(shifted)
    assert valid.any()


@pytest.mark.parametrize("h,w", [(7, 5), (3, 600), (2, 12)])
def test_pose_peaks_kernel_short_maps(cuda_device, h, w):
    """Fewer rows than blocks in the cluster (empty bands): random maps,
    many peaks and the fill rows."""
    rng = np.random.default_rng(h * w)
    heat = rng.normal(0.2, 0.4, (4, 19, h, w)).astype(np.float32)
    heat[1] = 0.0
    heat[2, :, :, :] = -1.0
    heat[2, :, 0, 1] = 0.3
    _assert_peaks_equal(torch.from_numpy(heat).to(cuda_device))


@pytest.mark.parametrize("direction", ["rising", "falling"])
def test_pose_peaks_kernel_ramp(cuda_device, direction):
    """A peak every third pixel, values rising (or falling) along the
    walk: each warp's buffer fills again and again (rising) or once
    (falling), and the cut-offs must keep only what cannot win."""
    n = 480 * 640
    vals = np.linspace(0.2, 0.9, len(range(0, n, 3)), dtype=np.float32)
    flat = np.zeros(n, np.float32)
    flat[::3] = vals if direction == "rising" else vals[::-1]
    heat = np.broadcast_to(flat.reshape(1, 1, 480, 640), (2, 19, 480, 640))
    _assert_peaks_equal(torch.from_numpy(heat.copy()).to(cuda_device))


def test_pose_peaks_kernel_64_frames(cuda_device):
    """t = 64: 9,216 blocks in 1,152 clusters, on smooth random maps."""
    rng = np.random.default_rng(64)
    coarse = torch.from_numpy(rng.normal(0.2, 0.5, (64, 19, 15, 20)).astype(
        np.float32)).to(cuda_device)
    heat = torch.nn.functional.interpolate(coarse, size=(120, 160),
                                           mode="bilinear").contiguous()
    _assert_peaks_equal(heat)


def test_pose_peaks_kernel_trained_like(cuda_device):
    """The trained-like density at 480x640: 15 Gaussian blobs of 7 px and
    height 0.9 a part (about 3% of the pixels above the threshold), so 15
    tied peaks and 9 fill rows a map."""
    from scannertools_tpu_torch.tools.timing import blob_maps

    heat = blob_maps(8, 19, 480, 640, seed=0, device=cuda_device)
    _, valid = _assert_peaks_equal(heat)
    assert (valid.sum(-1) <= 15).all() and valid.sum() > 8 * 18 * 12


def test_pose_peaks_kernel_info(cuda_device):
    """The kernel's resources: no spills, and clusters of 8 blocks fit."""
    from scannertools_tpu_torch.models import pose as PP

    for vec in (True, False):
        info = PP.find_peaks_info(vec)
        assert info["local_bytes"] == 0
        assert info["blocks_per_sm"] >= 1 and info["clusters"] >= 1


def _gray_items(rng, t: int, n: int) -> np.ndarray:
    """Normalized (frame, x0, y0, x1, y1) rows: inside the frame, across its
    edges, wholly outside, and narrower than a pixel."""
    xy = rng.uniform(-0.6, 1.2, (n, 2))
    wh = rng.uniform(0.0, 0.7, (n, 2))
    xy[: n // 4] = rng.uniform(0.1, 0.4, (n // 4, 2))
    xy[n // 4: n // 3] = rng.choice([-1.5, 1.3], (n // 3 - n // 4, 2))
    wh[::5] = 0.001
    return np.concatenate([rng.integers(0, t, (n, 1)), xy, xy + wh],
                          1).astype(np.float32)


@pytest.mark.parametrize("c,size", [(3, 368), (3, 37), (1, 20), (256, 9)])
def test_gray_crop_kernel_matches_plain(cuda_device, c, size):
    """The crop kernel's gray mode (OpenPose's face and hand crops) on both
    crop kernels."""
    from scannertools_tpu_torch.ops import pose as POP

    rng = np.random.default_rng(61 + size + c)
    frames = torch.from_numpy(rng.uniform(0, 255, (3, 48, 64, c)).astype(
        np.float32))
    items = torch.from_numpy(_gray_items(rng, 3, 40))
    want = POP.crop_batch(frames, items, size)
    before = MC.crop_and_resize.launches
    got = POP.crop_batch(frames.to(cuda_device), items.to(cuda_device),
                         size)
    assert MC.crop_and_resize.launches == before + 1
    assert torch.equal(got.cpu(), want)


def test_openpose_forward_and_decode_launch_the_kernels(cuda_device):
    """One OpenPoseForward chunk launches pose_peaks once; the decode with
    compute_face/compute_hands launches the gray crop once a net; both
    give what their plain versions give."""
    from unittest import mock

    from scannertools_tpu_torch.models import pose as PP
    from scannertools_tpu_torch.ops import pose as POP

    frames = torch.from_numpy(np.random.default_rng(67).uniform(
        0, 255, (2, 64, 96, 3)).astype(np.float32)).to(cuda_device)
    state = PP.init_params(0, 2)
    for k in ("Mconv7_stage2_L1.weight", "Mconv7_stage2_L2.weight"):
        state[k] = state[k] * 1000.0
    state = {k: v.to(cuda_device) for k, v in state.items()}
    before = PP.find_peaks.launches
    got = POP.openpose_forward(None, state, frames)
    assert PP.find_peaks.launches == before + 1
    with mock.patch.object(PP, "find_peaks", PP.find_peaks_plain):
        want = POP.openpose_forward(None, state, frames)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    kp = np.zeros((18, 3), np.float32)
    for part, xy in ((0, (48, 14)), (14, (44, 11)), (15, (52, 11)),
                     (16, (40, 13)), (17, (57, 13)), (3, (30, 40)),
                     (4, (26, 54)), (6, (66, 40)), (7, (72, 52))):
        kp[part] = (*xy, 0.9)
    with mock.patch.object(PP, "group_people",
                           lambda *a: [(0.9, kp.copy())]):
        crops = MC.crop_and_resize.launches
        poses = POP.openpose_decode(None, *got, frame=frames,
                                    compute_face=True, compute_hands=True,
                                    crop_net_size=32)
        assert MC.crop_and_resize.launches == crops + 2
        with mock.patch.object(POP, "crop_and_resize",
                               MC.crop_and_resize_plain):
            plain = POP.openpose_decode(None, *got, frame=frames,
                                        compute_face=True,
                                        compute_hands=True,
                                        crop_net_size=32)
    assert [p.serialize() for f in poses for p in f] == \
        [p.serialize() for f in plain for p in f]


# ------------------------------------------------- attribute nets, MoE

CARD_CPU_RTOL = 1e-4  # float32 nets: largest difference over largest value


def _card_vs_cpu(fn, state, x, cuda_device):
    """fn(state, x) on the CPU and on the card -> (largest difference,
    largest value) over every output."""
    cpu = fn(state, x)
    card = fn({k: v.to(cuda_device) for k, v in state.items()},
              x.to(cuda_device))
    if not isinstance(cpu, (list, tuple)):
        cpu, card = [cpu], [card]
    err = max(float((b.cpu() - a).abs().max()) for a, b in zip(cpu, card))
    return err, max(float(a.abs().max()) for a in cpu)


@pytest.mark.parametrize("tag", ["clothing", "hairstyle"])
def test_streetstyle_card_matches_cpu(cuda_device, tag):
    """The 299x299 trunk and heads on the card against the CPU (full
    float32: TF32 would show as about 1e-3), and the predictions of the
    classifier op's device call equal where no head is a near-tie."""
    from scannertools_tpu_torch.models import streetstyle as PS

    attrs = {"clothing": PS.CLOTHING_ATTRIBUTES,
             "hairstyle": PS.HAIRSTYLE_ATTRIBUTES}[tag]
    state = getattr(PS, f"init_params_{tag}")(0)
    x = torch.from_numpy(np.random.default_rng(70).uniform(
        0, 255, (4, PS.INPUT_SIZE, PS.INPUT_SIZE, 3)).astype(np.float32))
    err, scale = _card_vs_cpu(
        lambda s, c: PS.forward(s, c, attrs)[0], state, x, cuda_device)
    assert err <= CARD_CPU_RTOL * scale, (err, scale)
    stacked = PS.stack_head_params(
        {k: v.to(cuda_device) for k, v in state.items()}, attrs)
    _, feat = PS.forward({k: v.to(cuda_device) for k, v in state.items()},
                         x.to(cuda_device), attrs)
    masked = PS.masked_argmax(stacked, PS.heads_logits(stacked, feat))
    per_head = PS._predict_multihead(state, x, attrs)
    assert torch.equal(masked.cpu(), per_head)


def test_facenet_detector_card_matches_cpu(cuda_device):
    from scannertools_tpu_torch.models import facenet_detector as PFD

    x = torch.from_numpy(np.random.default_rng(71).uniform(
        -128, 128, (2, 120, 160, 3)).astype(np.float32))
    err, scale = _card_vs_cpu(PFD.apply, PFD.init_params(0), x, cuda_device)
    assert err <= CARD_CPU_RTOL * scale, (err, scale)


def test_moe_card_matches_cpu(cuda_device):
    """Routing equal on the card and the CPU, dropped rows included, then
    the values."""
    from scannertools_tpu_torch.parallel import expert as PE

    params = PE.init_moe_params(0, 8, 128, 256)
    x = torch.from_numpy(np.random.default_rng(72).normal(
        size=(64, 128)).astype(np.float32))
    route = [torch.argmax(x.to(d) @ params["router"].to(d), -1).cpu()
             for d in (torch.device("cpu"), cuda_device)]
    assert torch.equal(*route)
    err, scale = _card_vs_cpu(
        lambda p, r: PE.moe_reference(p, r, capacity=4), params, x,
        cuda_device)
    assert err <= CARD_CPU_RTOL * scale, (err, scale)


def test_detect_clothing_on_the_card(cuda_device):
    """DetectClothing and DetectHairStyle with a context on the card: the
    crops go up in one copy and the records equal the CPU's."""
    import types

    from scannertools_tpu_torch import protobufs
    from scannertools_tpu_torch.ops import clothing as PC

    frames = np.random.default_rng(73).integers(
        0, 256, (2, 120, 160, 3)).astype(np.uint8)
    boxes = [[protobufs.BoundingBox(0.3, 0.1, 0.5, 0.4, 0.9),
              protobufs.BoundingBox(0.6, 0.5, 0.6, 0.7, 0.9)],
             [protobufs.BoundingBox(0.1, 0.2, 0.4, 0.5, 0.9)]]
    card = types.SimpleNamespace(device=cuda_device)
    for op in (PC.detect_clothing, PC.detect_hairstyle):
        got = op(card, frames, boxes)
        want = op(None, frames, boxes)
        assert [[r.predictions.tolist() for r in f] for f in got] == \
            [[r.predictions.tolist() for r in f] for f in want]


# ---------------------------------------------------------------- ctc_viterbi


def _ctc_check_packed(packed, device, path):
    """ctc_viterbi on the card against ctc_viterbi_plain on the CPU, over
    one packed batch: one launch on ``path``, states equal, scores
    bit-equal."""
    from scannertools_tpu_torch.ops import ctc_align as CA

    packed = [torch.from_numpy(x) if isinstance(x, np.ndarray) else x
              for x in packed]
    before = CA.ctc_viterbi.launches, dict(CA.ctc_viterbi.path_launches)
    states, scores = CA.ctc_viterbi(*[x.to(device) for x in packed])
    torch.cuda.synchronize()
    assert CA.ctc_viterbi.launches == before[0] + 1
    assert CA.ctc_viterbi.path_launches[path] == before[1][path] + 1
    want_states, want_scores = CA.ctc_viterbi_plain(*packed)
    assert torch.equal(states.cpu(), want_states)
    assert torch.equal(scores.cpu(), want_scores)


def _ctc_check(windows, device, path="warp"):
    from scannertools_tpu_torch.ops import ctc_align as CA

    _ctc_check_packed(CA.pack_windows(windows), device, path)


@pytest.mark.parametrize("case", ["ties", "repeats", "t_equals_need",
                                  "mixed", "smax_1025", "ties_block"])
def test_ctc_viterbi_kernel_matches_plain(cuda_device, case):
    from scannertools_tpu_torch.ops import ctc_align as CA
    from scannertools_tpu_torch.tools.timing import (ctc_track,
                                                     planted_emissions)

    rng = np.random.default_rng(80)
    v = 32
    path = "warp"
    if case in ("ties", "ties_block"):  # every move ties at every cell
        windows = [(np.zeros((t, v), np.float32),
                    [2 + k % 29 for k in range(n)])
                   for t, n in [(1, 1), (4, 1), (3, 3), (20, 6), (300, 60)]]
        if case == "ties_block":
            windows.append((np.zeros((600, v), np.float32),
                            [2 + k % 29 for k in range(512)]))
            path = "block"
    elif case == "repeats":  # the skip barred between equal tokens
        windows = [(planted_emissions(rng, tok, t, v), tok)
                   for tok, t in [([5, 5], 3), ([5, 5, 5, 7, 7], 12),
                                  ([9] * 40, 79), ([9] * 40, 200)]]
        windows += [(np.zeros((t, v), np.float32), tok)
                    for tok, t in [([5, 5], 3), ([9] * 40, 79)]]
    elif case == "t_equals_need":  # the tightest lattice
        windows = []
        for n in (1, 7, 60):
            tok = rng.integers(1, 4, n).tolist()
            need = n + sum(a == b for a, b in zip(tok, tok[1:]))
            windows.append((planted_emissions(rng, tok, need, v), tok))
    elif case == "mixed":  # padded frames and states must not leak
        windows = [(lp, tok) for lp, _, tok in ctc_track(
            81, 40, CA.char_vocab(), t_range=(5, 350), n_range=(1, 80))]
    else:  # more states than a 1024-thread block has threads
        tok = rng.integers(1, v, 512).tolist()
        windows = [(planted_emissions(rng, tok, 700, v), tok)]
        windows += [(lp, tok) for lp, _, tok in ctc_track(
            82, 3, CA.char_vocab())]
        assert max(2 * len(t) + 1 for _, t in windows) == 1025
        path = "block"
    _ctc_check(windows, cuda_device, path)


@pytest.mark.parametrize("smax", [2, 3, 31, 32, 33, 63, 64, 65, 191, 192,
                                  193, 255, 256, 257])
def test_ctc_viterbi_kernel_at_lane_edges(cuda_device, smax):
    """A batch of Smax on a lane edge (K = ceil(Smax / 32) changes at
    32, 64, ..., 256; 257 takes the block path), with a window of every
    edge S up to Smax."""
    from scannertools_tpu_torch.tools.timing import (CTC_LANE_EDGES,
                                                     ctc_edge_batch)

    s_values = [s for s in CTC_LANE_EDGES if s <= smax]
    _ctc_check_packed(ctc_edge_batch(100 + smax, s_values), cuda_device,
                      "warp" if smax <= 256 else "block")


def test_ctc_viterbi_long_window_takes_block_path(cuda_device):
    """A Tmax whose packed moves overflow a block's shared memory goes
    to the block path, at few states; the longest Tmax that fits stays
    on the warp path."""
    from scannertools_tpu_torch.ops import ctc_align as CA
    from scannertools_tpu_torch.tools.timing import planted_emissions

    fit = max(t for t in range(3000, 4000)
              if CA.window_bytes(t, 32) <= CA.SHARED_MAX)
    rng = np.random.default_rng(110)
    for tmax, path in ((fit + 1, "block"), (fit, "warp")):
        tok = rng.integers(1, 32, 40).tolist()
        windows = [(planted_emissions(rng, tok, tmax, 32), tok),
                   (planted_emissions(rng, [3, 4], 9, 32), [3, 4])]
        _ctc_check(windows, cuda_device, path)


@pytest.mark.parametrize("v,offset", [(29, 0), (5, 0), (48, 0), (33, 0),
                                      (512, 0), (32, 1), (32, 4)])
def test_ctc_viterbi_ring_fills(cuda_device, v, offset):
    """The warp path's emission ring filled by bulk copies (V % 4 == 0,
    emissions on a 16-byte boundary) and by 4-byte copies (V % 4 != 0, or
    emissions off the boundary: a view ``offset`` floats into a buffer),
    at V below, on and above a warp's 32 lanes."""
    from scannertools_tpu_torch.ops import ctc_align as CA
    from scannertools_tpu_torch.tools.timing import ctc_edge_batch

    packed = [torch.from_numpy(x) for x in ctc_edge_batch(
        120 + v + offset, [3, 33, 81, 161, 20], v=v, extra=40)]
    lp = packed[0]
    buf = torch.empty(lp.numel() + offset, dtype=torch.float32,
                      device=cuda_device)
    view = buf[offset:].view(lp.shape)
    view.copy_(lp.to(cuda_device))
    geo = CA.viterbi_geometry(lp.shape[0], lp.shape[1], 161, v,
                              aligned=view.data_ptr() % 16 == 0)
    assert geo["bulk"] == (v % 4 == 0 and offset % 4 == 0)
    before = CA.ctc_viterbi.launches
    got = CA.ctc_viterbi(view, *[x.to(cuda_device) for x in packed[1:]])
    torch.cuda.synchronize()
    assert CA.ctc_viterbi.launches == before + 1
    want = CA.ctc_viterbi_plain(*packed)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


def test_ctc_viterbi_warp_path_allocates_no_scratch(cuda_device):
    """On the warp path the call allocates its outputs and nothing else:
    the back-pointers live in shared memory."""
    from scannertools_tpu_torch.ops import ctc_align as CA
    from scannertools_tpu_torch.tools.timing import ctc_track

    track = ctc_track(84, 200, CA.char_vocab())
    args = [torch.from_numpy(x).to(cuda_device)
            for x in CA.pack_windows([(lp, tok) for lp, _, tok in track])]
    b, tmax = args[0].shape[:2]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda_device)
    torch.cuda.reset_peak_memory_stats(cuda_device)
    states, scores = CA.ctc_viterbi(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(cuda_device) - base
    assert peak <= states.untyped_storage().nbytes() + 512 * 2 + b * 4


@pytest.mark.parametrize("path", ["warp", "block"])
def test_ctc_viterbi_kernel_reads_no_state_below_0(cuda_device, path):
    """allow_skip set on states 0 and 1 of every window: the kernel reads
    no alpha below state 0 and agrees with its plain version, for which
    the flags change nothing. A window of 300 states moves the batch to
    the block path."""
    from scannertools_tpu_torch.ops import ctc_align as CA
    from scannertools_tpu_torch.tools.timing import (ctc_track,
                                                     planted_emissions)

    rng = np.random.default_rng(83)
    windows = [(lp, tok) for lp, _, tok in ctc_track(
        83, 8, CA.char_vocab(), t_range=(3, 60), n_range=(1, 20))]
    windows.append((np.zeros((5, 32), np.float32), [4, 4]))
    windows.append((planted_emissions(rng, [7], 2, 32), [7]))
    windows.append((planted_emissions(rng, [1], 1, 32), [1]))
    if path == "block":
        tok = rng.integers(1, 32, 150).tolist()
        windows.append((planted_emissions(rng, tok, 200, 32), tok))
    packed = [torch.from_numpy(x) for x in CA.pack_windows(windows)]
    want = CA.ctc_viterbi_plain(*packed)
    packed[3][:, :2] = True
    before = CA.ctc_viterbi.path_launches[path]
    got = CA.ctc_viterbi(*[x.to(cuda_device) for x in packed])
    torch.cuda.synchronize()
    assert CA.ctc_viterbi.path_launches[path] == before + 1
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("steps,smax,path", [
    (0, 2, None), (1, 3, None), (349, 161, None), (40, 1025, None),
    (7, 2, "warp"), (33, 32, "warp"), (33, 33, "warp"), (70, 65, "warp"),
    (300, 256, "warp"), (349, 161, "block"), (5, 3, "block")])
def test_ctc_step_probe_matches_its_recurrence(cuda_device, steps, smax,
                                               path):
    """The floor probes run the forward recurrence they claim to: the
    last alpha equals a torch loop of the same steps, on the warp path's
    lanes (K = 1..8) and in the block path's block."""
    from scannertools_tpu_torch.ops import ctc_align as CA

    got = CA.viterbi_step_probe(steps, smax, cuda_device, path).cpu()
    s = torch.arange(smax)
    emit = torch.where(s % 2 == 1, -0.5, -0.25).float()
    neg = torch.full((smax,), CA.NEG, dtype=torch.float32)
    alpha = torch.where(s <= 1, 0.0, neg).float()
    for _ in range(steps):
        adv = torch.cat([neg[:1], alpha[:-1]])
        skp = torch.cat([neg[:2], alpha[:-2]])
        alpha = torch.maximum(alpha, torch.maximum(adv, skp)) + emit
    assert torch.equal(got, alpha)
