"""Shared device primitives for the detection models: IoU, static-shape NMS,
crop-and-resize, padded top-k box selection.

Reference parity: the reference does NMS on host (`best_nms` in
facenet_output_kernel_cpu.cpp:156, MTCNN's numpy NMS inside the facenet
repo, SSD's TF NMS). As in the JAX package (scannertools_tpu's
models/common.py), everything is fixed-size: boxes live in padded [K, 4]
arrays with validity masks, and variable-count results only materialize on
the host at sinks. Each function also takes a leading frame axis
([T, K, 4]), which the kernels batch over.

Two of them are hand-written CUDA kernels, launched for CUDA tensors; CPU
tensors take their plain torch versions beside them:

  * ``nms`` (kernels/csrc/nms.cu): the greedy keep set as a bitmask NMS,
    one block per frame: a sort, the suppression bitmask of the valid rows
    and a walk of the rows 64 at a time, all in shared memory for K up to
    ``NMS_SHARED_MAX_K`` (above it, and for large K at few frames, the
    mask lives in device memory: ``nms_geometry``), then the kept rows
    compacted to the front, with each kept row's source row where the
    caller asks for it (``index=True``). ``nms_plain`` sorts with a stable
    ``torch.sort`` and iterates the JAX package's fixed point; both
    evaluate the overlap in the written order, so they agree bit for bit.
  * ``crop_and_resize`` (kernels/csrc/crop_resize.cu): bilinear crops as a
    two-tap gather per axis, y first, with a per-box frame index; one block
    per box and band of output rows. ``crop_and_resize_plain`` gathers the
    same taps in torch. ``crop_and_resize_levels`` is the same kernel with
    a map a box (Mask R-CNN's RoIAlign over the FPN levels), beside its
    plain version ``crop_and_resize_levels_plain``; ``gray=True`` is its
    mode for OpenPose's face and hand crops (a gray border outside the
    frame).

The launch geometry of both kernels (``nms_geometry``, ``crop_geometry``)
is computed here, so the CPU tests can check it.

``topk_boxes`` is plain torch. Where the JAX package takes ``lax.top_k``
or ``argsort``, which keep the index order among equal values, the port
sorts with ``torch.sort(stable=True)``: ``torch.topk`` promises no order
among ties.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from ..kernels import build as _build
from ..utils.numerics import div, recip

# the largest K of the device-memory path of nms: its mask is K * ceil(K /
# 64) * 8 bytes a frame (32 MB at this K)
NMS_MAX_K = 16384
# the widest crop: the block keeps a crop's column taps in shared memory
CROP_MAX_OW = 2048
# the FPN levels P2..P5 that the level crop reads, by their strides (powers
# of two: a box scales to its level exactly); crop_resize.cu's kMaxLevels
FPN_STRIDES = (4, 8, 16, 32)
_INT32_MAX = 2**31 - 1


@contextlib.contextmanager
def full_f32():
    """Convolutions in full float32 inside the block. cuDNN runs float32
    convolutions in TF32 by default on this card
    (``torch.backends.cudnn.allow_tf32``), about three decimal digits; the
    nets of the port run in float32, as on the CPU, without changing the
    setting outside their forwards. (Matrix products stay float32 by
    default: ``torch.backends.cuda.matmul.allow_tf32`` is False.)"""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        yield


def same_pad(x: torch.Tensor, k: int, stride: int,
             value: float = 0.0) -> torch.Tensor:
    """flax's ``padding="SAME"`` of an NCHW input for a k x k window (lax's
    rule): out = ceil(n / stride), the total padding p = max((out - 1) *
    stride + k - n, 0) split (p // 2, p - p // 2), the extra one after. At
    stride 2 on an even side that is (0, 1), not torch's symmetric (1,
    1)."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad takes the last axis first
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return torch.nn.functional.pad(x, pads, value=value) if any(pads) \
        else x


def max_pool_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """flax ``max_pool(x, (k, k), (s, s), padding="SAME")`` on NCHW: padded
    with -inf by ``same_pad``, then pooled VALID."""
    return torch.nn.functional.max_pool2d(
        same_pad(x, k, s, float("-inf")), k, s)


def batch_norm(bn: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode BatchNorm over dim 1 on its running statistics, in flax's
    order of operations: ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias``."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mul = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    return (x - bn.running_mean.view(shape)) * mul.view(shape) \
        + bn.bias.view(shape)


@functools.cache
def _skeleton(cls, *init) -> torch.nn.Module:
    """One weightless instance of a net (on the meta device) per class and
    constructor arguments."""
    with torch.device("meta"):
        return cls(*init).eval()


def apply_net(cls, state, *args, init=()):
    """``cls(*init)(*args)`` with the weights of ``state`` (a state_dict of
    tensors on the inputs' device, as the ops' aux trees hold them), in
    full float32."""
    with full_f32():
        return torch.func.functional_call(_skeleton(cls, *init), dict(state),
                                          args)


def _area(b: torch.Tensor) -> torch.Tensor:
    return (torch.clamp_min(b[..., 2] - b[..., 0], 0.0)
            * torch.clamp_min(b[..., 3] - b[..., 1], 0.0))


def _inter(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    x1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    y1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    x2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    y2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    return torch.clamp_min(x2 - x1, 0.0) * torch.clamp_min(y2 - y1, 0.0)


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a: [..., N, 4], b: [..., M, 4] (x1, y1, x2, y2) -> [..., N, M] IoU."""
    inter = _inter(a, b)
    union = _area(a)[..., :, None] + _area(b)[..., None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def _overlap(b: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "union":
        return iou_matrix(b, b)
    area = _area(b)  # "min": inter / min(area_i, area_j)
    mn = torch.minimum(area[..., :, None], area[..., None, :])
    return torch.where(mn > 0, _inter(b, b) / mn, 0.0)


def _batched(x: torch.Tensor, dim: int):
    """-> (x with a leading frame axis, whether one was added)."""
    return (x.unsqueeze(0), True) if x.dim() == dim else (x, False)


def _check_nms(boxes, scores, max_out: int, mode: str, name: str) -> None:
    if boxes.dim() not in (2, 3) or boxes.shape[-1] != 4 \
            or tuple(scores.shape) != tuple(boxes.shape[:-1]):
        raise ValueError(f"{name}: boxes must be [K, 4] or [T, K, 4] and "
                         f"scores [K] or [T, K], got {tuple(boxes.shape)} "
                         f"and {tuple(scores.shape)}")
    for label, x in (("boxes", boxes), ("scores", scores)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: {label} must be float32, got "
                            f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
    if scores.device != boxes.device:
        raise ValueError(f"{name}: scores on {scores.device}, boxes on "
                         f"{boxes.device}")
    if mode not in ("union", "min"):
        raise ValueError(f"{name}: mode must be 'union' or 'min', got "
                         f"{mode!r}")
    if max_out < 0:
        raise ValueError(f"{name}: max_out must be >= 0, got {max_out}")


def greedy_keep(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float,
                score_thresh: float = 0.0, mode: str = "union"):
    """The greedy keep set of NMS on [T, K, 4] boxes and [T, K] scores ->
    (order [T, K] int64: the source rows in stable descending score order,
    scores in that order, keep [T, K] bool, sup [T, K, K] bool: valid row j
    suppresses row i after it)."""
    t, k = scores.shape
    s, order = torch.sort(scores, dim=1, descending=True, stable=True)
    b = boxes.gather(1, order[..., None].expand(t, k, 4))
    valid = s > score_thresh
    idx = torch.arange(k, device=boxes.device)
    sup = ((_overlap(b, mode) > iou_thresh) & (idx[:, None] < idx[None, :])
           & valid[..., :, None])
    # the greedy keep set is the unique fixed point of keep_i = valid_i &
    # ~any_j(sup[j, i] & keep_j); iterating from keep = valid converges in
    # at most the longest suppressor chain (the JAX package's while_loop)
    keep = valid
    while True:
        nxt = valid & ~(keep[..., :, None] & sup).any(dim=1)
        if torch.equal(nxt, keep):
            break
        keep = nxt
    return order, s, keep, sup


def nms_plain(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float,
              max_out: int, score_thresh: float = 0.0, mode: str = "union",
              index: bool = False):
    """Static-shape greedy NMS in plain torch; see ``nms``."""
    _check_nms(boxes, scores, max_out, mode, "nms_plain")
    boxes, squeeze = _batched(boxes, 2)
    scores, _ = _batched(scores, 1)
    t, k = scores.shape
    order, s, keep, _ = greedy_keep(boxes, scores, iou_thresh, score_thresh,
                                    mode)
    b = boxes.gather(1, order[..., None].expand(t, k, 4))
    # kept rows to the front in score order; the rest to a discard slot
    n = max(max_out, k)
    dest = torch.where(keep, torch.cumsum(keep, dim=1) - 1, n)
    out = [b.new_zeros((t, n + 1, 4)).scatter_(
               1, dest[..., None].expand(t, k, 4), b)[:, :max_out],
           s.new_zeros((t, n + 1)).scatter_(1, dest, s)[:, :max_out],
           keep.new_zeros((t, n + 1)).scatter_(1, dest, keep)[:, :max_out]]
    if index:
        out.append(order.new_full((t, n + 1), -1).scatter_(
            1, dest, order)[:, :max_out])
    return tuple(o[0] for o in out) if squeeze else tuple(out)


# the largest K whose whole frame fits one block's shared memory (nms.cu's
# kSharedMaxK, held to its Layout there by a static_assert)
NMS_SHARED_MAX_K = 1280
# The one-launch path gives a frame's K^2 / 2 overlaps one SM; the
# device-memory path spreads them over ceil(K / 64) blocks, at the cost of
# a second launch and a walk through L2. Timed on an H100 by
# tools/nms_probe.py: the one-launch path is the faster up to K = 512 at any
# frame count (equal at 512), and at K = 1000 from about 32 frames a call
# (at 1-16 frames 0.16 ms against 0.10-0.11).
NMS_SPREAD_ABOVE_K = 512
NMS_SPREAD_BELOW_T = 32


def nms_geometry(t: int, k: int) -> dict:
    """The launch geometry of ``nms`` for T frames of K rows: ``path``
    "shared" (one launch, one block per frame, everything in shared memory,
    no scratch) up to NMS_SHARED_MAX_K rows, where the frames or K are not
    better served spread out (above), else "global" (the mask in device
    memory, two launches); ``words`` the 64-bit mask words of a row."""
    if not 0 <= k <= NMS_MAX_K:
        raise ValueError(f"nms: at most {NMS_MAX_K} boxes a frame, got {k}")
    shared = k <= NMS_SHARED_MAX_K and (k <= NMS_SPREAD_ABOVE_K
                                        or t >= NMS_SPREAD_BELOW_T)
    return {"path": "shared" if shared else "global", "words": -(-k // 64)}


@functools.cache
def _nms_lib() -> ctypes.CDLL:
    lib = _build.load("nms")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.st_nms.restype = i
    lib.st_nms.argtypes = [p, p, i, i, f, f, i, i, p, p, p, p, p, p, p, p,
                           p]
    return lib


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float,
        max_out: int, score_thresh: float = 0.0, mode: str = "union",
        index: bool = False):
    """Static-shape greedy NMS.

    boxes: [K, 4] or [T, K, 4] float32; scores: [K] or [T, K] float32, not
    NaN (invalid entries must carry score <= score_thresh). Returns
    (boxes [.., max_out, 4], scores [.., max_out], valid [.., max_out]
    bool): the rows kept by sequential greedy suppression in stable
    descending score order (a row is suppressed when a kept row before it
    overlaps it by more than ``iou_thresh``), compacted to the front, the
    rest zeros. With ``index`` a fourth output, [.., max_out] int64: each
    kept row's position in the input (-1 in rows not kept), so that
    callers can gather what they carry beside the boxes (SSD's labels and
    unshifted boxes).

    mode="min" reproduces the reference's `best_nms` variant that divides
    the intersection by the *smaller* area (used by FacenetOutput with
    threshold 0.1, facenet_output_kernel_cpu.cpp:156-190).

    For CUDA tensors one launch of the bitmask kernel serves all T frames
    (two where ``nms_geometry`` spreads the mask over device memory); CPU
    tensors take ``nms_plain``. Where ``max_out`` > K the JAX package
    returns max_out + 1 rows, its discard slot among them (ROADMAP queue
    3); this returns max_out.
    """
    _check_nms(boxes, scores, max_out, mode, "nms")
    if boxes.device.type == "cpu":
        return nms_plain(boxes, scores, iou_thresh, max_out, score_thresh,
                         mode, index)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms: unsupported device {boxes.device}")
    if boxes.data_ptr() % 16:
        raise ValueError("nms: boxes must be 16-byte aligned")
    boxes_b, squeeze = _batched(boxes, 2)
    scores_b, _ = _batched(scores, 1)
    t, k = scores_b.shape
    geo = nms_geometry(t, k)
    dev = boxes.device
    out_b = torch.empty((t, max_out, 4), dtype=torch.float32, device=dev)
    out_s = torch.empty((t, max_out), dtype=torch.float32, device=dev)
    out_v = torch.empty((t, max_out), dtype=torch.bool, device=dev)
    out_i = torch.empty((t, max_out), dtype=torch.int64, device=dev) \
        if index else None
    if out_s.numel():
        scratch = [None] * 4  # the shared path needs none
        if geo["path"] == "global":
            if t > 65535:
                raise ValueError(f"nms: at most 65535 frames on the "
                                 f"device-memory path, got {t}")
            scratch = [torch.empty(shape, dtype=dtype, device=dev)
                       for shape, dtype in (((t, k, 4), torch.float32),
                                            ((t, k), torch.int32),
                                            ((t, k, geo["words"]),
                                             torch.int64),
                                            ((t, 2), torch.int32))]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            rc = _nms_lib().st_nms(
                boxes_b.data_ptr(), scores_b.data_ptr(), t, k,
                float(iou_thresh), float(score_thresh),
                int(mode == "min"), max_out,
                *(x if x is None else x.data_ptr() for x in scratch),
                out_b.data_ptr(), out_s.data_ptr(), out_v.data_ptr(),
                None if out_i is None else out_i.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"nms: CUDA launch failed with error {rc}")
        nms.launches += 1
    out = (out_b, out_s, out_v) + ((out_i,) if index else ())
    return tuple(o[0] for o in out) if squeeze else out


nms.launches = 0


# ------------------------------------------------------------ crop

def _check_crop(images, boxes, frame_idx, out_hw, name: str) -> None:
    if images.dim() != 4:
        raise ValueError(f"{name}: images must be [T, H, W, C], got "
                         f"{tuple(images.shape)}")
    if boxes.dim() != 2 or boxes.shape[1] != 4:
        raise ValueError(f"{name}: boxes must be [B, 4], got "
                         f"{tuple(boxes.shape)}")
    if tuple(frame_idx.shape) != (boxes.shape[0],):
        raise ValueError(f"{name}: frame_idx must be [B], got "
                         f"{tuple(frame_idx.shape)}")
    for label, x, dtype in (("images", images, torch.float32),
                            ("boxes", boxes, torch.float32),
                            ("frame_idx", frame_idx, torch.int64)):
        if x.dtype != dtype:
            raise TypeError(f"{name}: {label} must be {dtype}, got "
                            f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
        if x.device != images.device:
            raise ValueError(f"{name}: {label} is on {x.device}, images on "
                             f"{images.device}")
    if min(out_hw) < 1 or min(images.shape[1:3]) < 1:
        raise ValueError(f"{name}: empty frames {tuple(images.shape)} or "
                         f"output size {tuple(out_hw)}")


def _crop_inputs(images, boxes, frame_idx):
    """The JAX signature (one [H, W, C] image) as a one-frame batch."""
    if images.dim() == 3:
        images = images.unsqueeze(0)
        if frame_idx is None:
            frame_idx = torch.zeros(boxes.shape[0], dtype=torch.int64,
                                    device=boxes.device)
    if frame_idx is None:
        raise ValueError("crop_and_resize: frame_idx is needed for a batch "
                         "of frames")
    return images, frame_idx


def _sample_positions(lo: torch.Tensor, hi: torch.Tensor, n_out: int,
                      size: int, clamp: bool = True) -> torch.Tensor:
    """[B] box sides -> [B, n_out] sample positions, clamped to the crop
    window and then (``clamp``) to the frame, in the JAX package's written
    order."""
    d = hi - lo
    p = torch.arange(n_out, dtype=torch.float32, device=lo.device) + 0.5
    v = div(d[:, None] * p, n_out) - 0.5
    s = lo[:, None] + torch.minimum(torch.clamp_min(v, 0.0),
                                    torch.clamp_min(d - 1.0, 0.0)[:, None])
    return torch.clamp(s, 0.0, size - 1.0) if clamp else s


def _taps(lo: torch.Tensor, hi: torch.Tensor, n_out: int, size: int,
          gray: bool = False):
    """-> the two nonzero hat taps of each sample position: (i0, i1 [B,
    n_out] int64, w0, w1 [B, n_out] float32). ``gray``: positions not
    clamped to the frame; a tap outside it weighs 0, its index clamped to
    the edge."""
    s = _sample_positions(lo, hi, n_out, size, clamp=not gray)
    f0 = torch.floor(s)
    f1 = f0 + 1.0
    w0 = torch.clamp_min(1.0 - torch.abs(s - f0), 0.0)
    w1 = torch.clamp_min(1.0 - torch.abs(s - f1), 0.0)
    if gray:
        last = size - 1.0
        w0 = torch.where((f0 >= 0.0) & (f0 <= last), w0, 0.0)
        w1 = torch.where((f1 >= 0.0) & (f1 <= last), w1, 0.0)
        return (torch.clamp(f0, 0.0, last).to(torch.int64),
                torch.clamp(f1, 0.0, last).to(torch.int64), w0, w1)
    i0 = f0.to(torch.int64)
    return i0, torch.clamp(i0 + 1, max=size - 1), w0, w1


def crop_and_resize_plain(images: torch.Tensor, boxes: torch.Tensor,
                          out_hw, frame_idx=None,
                          gray: bool = False) -> torch.Tensor:
    """The two-tap gather in plain torch; see ``crop_and_resize``."""
    images, frame_idx = _crop_inputs(images, boxes, frame_idx)
    _check_crop(images, boxes, frame_idx, out_hw, "crop_and_resize_plain")
    oh, ow = out_hw
    _, h, w, _ = images.shape
    y0, y1, wy0, wy1 = _taps(boxes[:, 1], boxes[:, 3], oh, h, gray)
    x0, x1, wx0, wx1 = _taps(boxes[:, 0], boxes[:, 2], ow, w, gray)
    f = frame_idx[:, None, None]

    def at(rows, cols):  # [B, oh, ow, C]
        return images[f, rows[:, :, None], cols[:, None, :]]

    wy0_, wy1_ = wy0[:, :, None, None], wy1[:, :, None, None]
    t0 = wy0_ * at(y0, x0) + wy1_ * at(y1, x0)  # y-pass at column x0
    t1 = wy0_ * at(y0, x1) + wy1_ * at(y1, x1)  # and at x1
    out = wx0[:, None, :, None] * t0 + wx1[:, None, :, None] * t1
    if not gray:
        return out
    cov = (wy0 + wy1)[:, :, None] * (wx0 + wx1)[:, None, :]
    return div(out + ((1.0 - cov) * 128.0)[..., None], 255.0) - 0.5


def crop_geometry(b: int, oh: int, ow: int, c: int,
                  images_aligned: bool) -> dict:
    """The launch geometry of ``crop_and_resize``: ``bands`` blocks a box,
    each of ``band_rows`` output rows (at most 16, the bands as even as
    whole rows allow, the last the rest), ``blocks`` in all; ``pixels`` for
    the channel-vector kernel (C a multiple of 4 above 4 on 16-byte
    aligned images), else the row kernel."""
    bands = -(-oh // 16)
    band_rows = -(-oh // bands)
    bands = -(-oh // band_rows)
    return {"band_rows": band_rows, "bands": bands, "blocks": b * bands,
            "pixels": c % 4 == 0 and c > 4 and images_aligned}


@functools.cache
def _crop_lib() -> ctypes.CDLL:
    lib = _build.load("crop_resize")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.st_crop_resize.restype = i
    lib.st_crop_resize.argtypes = [p, i, i, i, i, p, p, i, i, i, f, f, i, i,
                                   i, i, p, p]
    lib.st_crop_resize_levels.restype = i
    lib.st_crop_resize_levels.argtypes = [p, p, p, i, i, i, p, p, p, i, i, i,
                                          f, f, i, i, i, p, p]
    return lib


def crop_and_resize(images: torch.Tensor, boxes: torch.Tensor, out_hw,
                    frame_idx=None, gray: bool = False) -> torch.Tensor:
    """images: [H, W, C] (the JAX signature) or [T, H, W, C] float32;
    boxes: [B, 4] (x1, y1, x2, y2) pixels float32; frame_idx: [B] int64 in
    [0, T), the frame of each box (None for one image) -> [B, oh, ow, C]
    bilinear crops. An index outside [0, T) raises: IndexError on the CPU;
    on the card the kernel traps before it reads, without a host sync, and
    the next synchronising call raises (the CUDA context is then lost).

    Sample positions clamp to the CROP window, then to the frame: the host
    path (cv2.resize on frame[y1:y2, x1:x2]) border-replicates at crop
    edges, so when upsampling (box smaller than out_hw) the first/last taps
    stay inside the box instead of blending in pixels outside it. A
    degenerate box (x2 <= x1) samples its x1 column, as the JAX package's
    hat matrices do.

    ``gray`` is OpenPose's crop (the JAX package's ``_crop_batch_device``,
    on boxes already rounded to whole pixels): sample positions are not
    clamped to the frame, a tap outside it weighs 0, the uncovered share of
    each value is filled with gray, v + (1 - covy * covx) * 128 where cov
    is an axis's sum of weights, and the result is mapped to [-0.5, 0.5] as
    v / 255 - 0.5.

    For CUDA tensors one launch of the crop kernel serves every box (at
    most CROP_MAX_OW output columns; the index arithmetic inside a frame
    and a crop is 32-bit); CPU tensors take ``crop_and_resize_plain``."""
    images, frame_idx = _crop_inputs(images, boxes, frame_idx)
    _check_crop(images, boxes, frame_idx, out_hw, "crop_and_resize")
    if images.device.type == "cpu":
        return crop_and_resize_plain(images, boxes, out_hw, frame_idx, gray)
    if images.device.type != "cuda":
        raise ValueError(f"crop_and_resize: unsupported device "
                         f"{images.device}")
    if boxes.data_ptr() % 16:
        raise ValueError("crop_and_resize: boxes must be 16-byte aligned")
    oh, ow = (int(v) for v in out_hw)
    t, h, w, c = images.shape
    b = boxes.shape[0]
    geo = crop_geometry(b, oh, ow, c, images.data_ptr() % 16 == 0)
    if ow > CROP_MAX_OW or max(h * w * c, oh * ow * c,
                               geo["blocks"]) > _INT32_MAX:
        raise ValueError(f"crop_and_resize: frames {tuple(images.shape)} or "
                         f"{b} crops of {oh}x{ow} exceed the kernel's 32-bit "
                         f"indices or its {CROP_MAX_OW} output columns")
    out = torch.empty((b, oh, ow, c), dtype=torch.float32,
                      device=images.device)
    if out.numel() == 0:
        return out  # nothing to compute: no launch
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _crop_lib().st_crop_resize(
            images.data_ptr(), t, h, w, c, boxes.data_ptr(),
            frame_idx.data_ptr(), b, oh, ow, recip(oh), recip(ow),
            geo["band_rows"], geo["bands"], int(geo["pixels"]), int(gray),
            out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"crop_and_resize: CUDA launch failed with error "
                           f"{rc}")
    crop_and_resize.launches += 1
    return out


crop_and_resize.launches = 0


def _check_levels(maps, boxes, level, frame_idx, out_hw, name: str) -> None:
    if not 1 <= len(maps) <= len(FPN_STRIDES):
        raise ValueError(f"{name}: 1 to {len(FPN_STRIDES)} maps, got "
                         f"{len(maps)}")
    for m in maps:
        _check_crop(m, boxes, frame_idx, out_hw, name)
        if (m.shape[0], m.shape[3]) != (maps[0].shape[0], maps[0].shape[3]):
            raise ValueError(f"{name}: maps of other frame or channel counts: "
                             f"{[tuple(x.shape) for x in maps]}")
    if tuple(level.shape) != (boxes.shape[0],) or level.dtype != torch.int64 \
            or not level.is_contiguous() or level.device != boxes.device:
        raise ValueError(f"{name}: level must be a contiguous [B] int64 "
                         f"tensor beside the boxes, got {tuple(level.shape)} "
                         f"{level.dtype} on {level.device}")


def crop_and_resize_levels_plain(maps, boxes: torch.Tensor,
                                 level: torch.Tensor, frame_idx: torch.Tensor,
                                 out_hw) -> torch.Tensor:
    """The level crop in plain torch: each level's boxes, scaled to it, by
    ``crop_and_resize_plain``; see ``crop_and_resize_levels``."""
    maps = list(maps)
    _check_levels(maps, boxes, level, frame_idx, out_hw,
                  "crop_and_resize_levels_plain")
    if bool(((level < 0) | (level >= len(maps))).any()):
        raise IndexError(f"crop_and_resize_levels_plain: a level outside "
                         f"[0, {len(maps)})")
    out = boxes.new_empty((boxes.shape[0], *out_hw, maps[0].shape[3]))
    for lvl, (m, stride) in enumerate(zip(maps, FPN_STRIDES)):
        sel = torch.nonzero(level == lvl).squeeze(1)
        if sel.numel():
            out[sel] = crop_and_resize_plain(m, boxes[sel] / stride, out_hw,
                                             frame_idx[sel])
    return out


def crop_and_resize_levels(maps, boxes: torch.Tensor, level: torch.Tensor,
                           frame_idx: torch.Tensor, out_hw) -> torch.Tensor:
    """maps: 1-4 [T, H_l, W_l, C] float32 (the FPN levels P2..P5, strides
    FPN_STRIDES); boxes: [B, 4] (x1, y1, x2, y2) float32 in canvas pixels;
    level: [B] int64 in [0, len(maps)), the map of each box; frame_idx: [B]
    int64 in [0, T) -> [B, oh, ow, C]: each box divided by its level's
    stride (exact: a power of two) and cropped from that level as
    ``crop_and_resize`` crops. An index outside its range raises: IndexError
    on the CPU; on the card the kernel traps, as for a bad frame index.

    It replaces the JAX package's ``roi_align_multilevel``, which crops
    every box from all four levels and sums them weighted by a one-hot of
    the level: the same values (0 * x + y == y), but a zero's sign may
    differ, so compare with ``==``. For CUDA tensors one launch of the crop
    kernel serves every box of every level; CPU tensors take
    ``crop_and_resize_levels_plain``."""
    maps = list(maps)
    _check_levels(maps, boxes, level, frame_idx, out_hw,
                  "crop_and_resize_levels")
    if boxes.device.type == "cpu":
        return crop_and_resize_levels_plain(maps, boxes, level, frame_idx,
                                            out_hw)
    if boxes.device.type != "cuda":
        raise ValueError(f"crop_and_resize_levels: unsupported device "
                         f"{boxes.device}")
    if boxes.data_ptr() % 16:
        raise ValueError("crop_and_resize_levels: boxes must be 16-byte "
                         "aligned")
    oh, ow = (int(v) for v in out_hw)
    t, _, _, c = maps[0].shape
    b = boxes.shape[0]
    geo = crop_geometry(b, oh, ow, c,
                        all(m.data_ptr() % 16 == 0 for m in maps))
    if ow > CROP_MAX_OW or max(max(m.shape[1] * m.shape[2] * c for m in maps),
                               oh * ow * c, geo["blocks"]) > _INT32_MAX:
        raise ValueError(f"crop_and_resize_levels: maps "
                         f"{[tuple(m.shape) for m in maps]} or {b} crops of "
                         f"{oh}x{ow} exceed the kernel's 32-bit indices or "
                         f"its {CROP_MAX_OW} output columns")
    out = torch.empty((b, oh, ow, c), dtype=torch.float32,
                      device=boxes.device)
    if out.numel() == 0:
        return out  # nothing to compute: no launch
    n = len(maps)
    images = (ctypes.c_void_p * n)(*(m.data_ptr() for m in maps))
    hw = (ctypes.c_int * (2 * n))(*(int(s) for m in maps
                                    for s in m.shape[1:3]))
    inv_stride = (ctypes.c_float * n)(*(recip(s) for s in FPN_STRIDES[:n]))
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _crop_lib().st_crop_resize_levels(
            images, hw, inv_stride, n, t, c, boxes.data_ptr(),
            frame_idx.data_ptr(), level.data_ptr(), b, oh, ow, recip(oh),
            recip(ow), geo["band_rows"], geo["bands"], int(geo["pixels"]),
            out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"crop_and_resize_levels: CUDA launch failed with "
                           f"error {rc}")
    crop_and_resize_levels.launches += 1
    return out


crop_and_resize_levels.launches = 0


def topk_stable(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest values and
    their indices, equal values in increasing index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_boxes(boxes: torch.Tensor, scores: torch.Tensor, k: int):
    """Pad/truncate to the k highest-scoring boxes. boxes [.., N, 4], scores
    [.., N] -> (boxes [.., k, 4], scores [.., k]); missing slots carry score
    -inf."""
    n = scores.shape[-1]
    if n < k:
        boxes = torch.cat([boxes, boxes.new_zeros(
            (*boxes.shape[:-2], k - n, 4))], dim=-2)
        scores = torch.cat([scores, scores.new_full(
            (*scores.shape[:-1], k - n), float("-inf"))], dim=-1)
    s, idx = topk_stable(scores, k)
    b = boxes.gather(-2, idx[..., None].expand(*idx.shape, 4))
    return b, s
