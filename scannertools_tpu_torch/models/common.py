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

  * ``nms`` (kernels/csrc/nms.cu): the greedy keep set as a bitmask NMS —
    a rank sort, a K x K suppression bitmask, and one warp per frame
    walking the rows in score order, then the kept rows compacted to the
    front. ``nms_plain`` sorts with a stable ``torch.sort`` and iterates
    the JAX package's fixed point; both evaluate the overlap in the written
    order, so they agree bit for bit.
  * ``crop_and_resize`` (kernels/csrc/crop_resize.cu): bilinear crops as a
    two-tap gather per axis, y first, with a per-box frame index.
    ``crop_and_resize_plain`` gathers the same taps in torch.

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

# the bitmask kernel's scratch is K * ceil(K / 64) * 8 bytes a frame
NMS_MAX_K = 16384


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


@functools.cache
def _skeleton(cls) -> torch.nn.Module:
    """One weightless instance of a net (on the meta device) per class."""
    with torch.device("meta"):
        return cls().eval()


def apply_net(cls, state, *args):
    """``cls()(*args)`` with the weights of ``state`` (a state_dict of
    tensors on the inputs' device, as the ops' aux trees hold them), in
    full float32."""
    with full_f32():
        return torch.func.functional_call(_skeleton(cls), dict(state), args)


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


def nms_plain(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float,
              max_out: int, score_thresh: float = 0.0, mode: str = "union"):
    """Static-shape greedy NMS in plain torch; see ``nms``."""
    _check_nms(boxes, scores, max_out, mode, "nms_plain")
    boxes, squeeze = _batched(boxes, 2)
    scores, _ = _batched(scores, 1)
    t, k = scores.shape
    s, order = torch.sort(scores, dim=1, descending=True, stable=True)
    b = boxes.gather(1, order[..., None].expand(t, k, 4))
    valid = s > score_thresh
    idx = torch.arange(k, device=boxes.device)
    # [t, j, i]: j (earlier in score order, valid) suppresses i
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
    # kept rows to the front in score order; the rest to a discard slot
    n = max(max_out, k)
    dest = torch.where(keep, torch.cumsum(keep, dim=1) - 1, n)
    out_b = b.new_zeros((t, n + 1, 4)).scatter_(
        1, dest[..., None].expand(t, k, 4), b)[:, :max_out]
    out_s = s.new_zeros((t, n + 1)).scatter_(1, dest, s)[:, :max_out]
    out_v = keep.new_zeros((t, n + 1)).scatter_(1, dest, keep)[:, :max_out]
    if squeeze:
        return out_b[0], out_s[0], out_v[0]
    return out_b, out_s, out_v


@functools.cache
def _nms_lib() -> ctypes.CDLL:
    lib = _build.load("nms")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.st_nms.restype = i
    lib.st_nms.argtypes = [p, p, i, i, f, f, i, i, p, p, p, p, p, p, p]
    return lib


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_thresh: float,
        max_out: int, score_thresh: float = 0.0, mode: str = "union"):
    """Static-shape greedy NMS.

    boxes: [K, 4] or [T, K, 4] float32; scores: [K] or [T, K] float32, not
    NaN (invalid entries must carry score <= score_thresh). Returns
    (boxes [.., max_out, 4], scores [.., max_out], valid [.., max_out]
    bool): the rows kept by sequential greedy suppression in stable
    descending score order (a row is suppressed when a kept row before it
    overlaps it by more than ``iou_thresh``), compacted to the front, the
    rest zeros.

    mode="min" reproduces the reference's `best_nms` variant that divides
    the intersection by the *smaller* area (used by FacenetOutput with
    threshold 0.1, facenet_output_kernel_cpu.cpp:156-190).

    For CUDA tensors one launch of the bitmask kernel serves all T frames;
    CPU tensors take ``nms_plain``. Where ``max_out`` > K the JAX package
    returns max_out + 1 rows, its discard slot among them (ROADMAP queue
    3); this returns max_out.
    """
    _check_nms(boxes, scores, max_out, mode, "nms")
    if boxes.device.type == "cpu":
        return nms_plain(boxes, scores, iou_thresh, max_out, score_thresh,
                         mode)
    if boxes.device.type != "cuda":
        raise ValueError(f"nms: unsupported device {boxes.device}")
    if boxes.data_ptr() % 16:
        raise ValueError("nms: boxes must be 16-byte aligned")
    boxes_b, squeeze = _batched(boxes, 2)
    scores_b, _ = _batched(scores, 1)
    t, k = scores_b.shape
    if k > NMS_MAX_K:
        raise ValueError(f"nms: at most {NMS_MAX_K} boxes a frame, got {k}")
    words = -(-k // 64)
    dev = boxes.device
    out_b = torch.empty((t, max_out, 4), dtype=torch.float32, device=dev)
    out_s = torch.empty((t, max_out), dtype=torch.float32, device=dev)
    out_v = torch.empty((t, max_out), dtype=torch.bool, device=dev)
    if out_s.numel():
        sorted_b = torch.empty((t, k, 4), dtype=torch.float32, device=dev)
        sorted_s = torch.empty((t, k), dtype=torch.float32, device=dev)
        mask = torch.empty((t, k, words), dtype=torch.int64, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            rc = _nms_lib().st_nms(
                boxes_b.data_ptr(), scores_b.data_ptr(), t, k,
                float(iou_thresh), float(score_thresh),
                int(mode == "min"), max_out, sorted_b.data_ptr(),
                sorted_s.data_ptr(), mask.data_ptr(), out_b.data_ptr(),
                out_s.data_ptr(), out_v.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"nms: CUDA launch failed with error {rc}")
        nms.launches += 1
    if squeeze:
        return out_b[0], out_s[0], out_v[0]
    return out_b, out_s, out_v


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
                      size: int) -> torch.Tensor:
    """[B] box sides -> [B, n_out] sample positions, clamped to the crop
    window and then to the frame, in the JAX package's written order."""
    d = hi - lo
    p = torch.arange(n_out, dtype=torch.float32, device=lo.device) + 0.5
    v = div(d[:, None] * p, n_out) - 0.5
    s = lo[:, None] + torch.minimum(torch.clamp_min(v, 0.0),
                                    torch.clamp_min(d - 1.0, 0.0)[:, None])
    return torch.clamp(s, 0.0, size - 1.0)


def _taps(lo: torch.Tensor, hi: torch.Tensor, n_out: int, size: int):
    """-> the two nonzero hat taps of each sample position: (i0, i1 [B,
    n_out] int64, w0, w1 [B, n_out] float32)."""
    s = _sample_positions(lo, hi, n_out, size)
    f0 = torch.floor(s)
    w0 = torch.clamp_min(1.0 - torch.abs(s - f0), 0.0)
    w1 = torch.clamp_min(1.0 - torch.abs(s - (f0 + 1.0)), 0.0)
    i0 = f0.to(torch.int64)
    return i0, torch.clamp(i0 + 1, max=size - 1), w0, w1


def crop_and_resize_plain(images: torch.Tensor, boxes: torch.Tensor,
                          out_hw, frame_idx=None) -> torch.Tensor:
    """The two-tap gather in plain torch; see ``crop_and_resize``."""
    images, frame_idx = _crop_inputs(images, boxes, frame_idx)
    _check_crop(images, boxes, frame_idx, out_hw, "crop_and_resize_plain")
    oh, ow = out_hw
    _, h, w, _ = images.shape
    y0, y1, wy0, wy1 = _taps(boxes[:, 1], boxes[:, 3], oh, h)
    x0, x1, wx0, wx1 = _taps(boxes[:, 0], boxes[:, 2], ow, w)
    f = frame_idx[:, None, None]

    def at(rows, cols):  # [B, oh, ow, C]
        return images[f, rows[:, :, None], cols[:, None, :]]

    wy0, wy1 = wy0[:, :, None, None], wy1[:, :, None, None]
    t0 = wy0 * at(y0, x0) + wy1 * at(y1, x0)  # y-pass at column x0
    t1 = wy0 * at(y0, x1) + wy1 * at(y1, x1)  # and at x1
    return wx0[:, None, :, None] * t0 + wx1[:, None, :, None] * t1


@functools.cache
def _crop_lib() -> ctypes.CDLL:
    lib = _build.load("crop_resize")
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, \
        ctypes.c_float
    lib.st_crop_resize.restype = i
    lib.st_crop_resize.argtypes = [p, i, i, i, i, p, p, i64, i, i, f, f, p,
                                   p]
    return lib


def crop_and_resize(images: torch.Tensor, boxes: torch.Tensor, out_hw,
                    frame_idx=None) -> torch.Tensor:
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

    For CUDA tensors one launch of the crop kernel serves every box; CPU
    tensors take ``crop_and_resize_plain``."""
    images, frame_idx = _crop_inputs(images, boxes, frame_idx)
    _check_crop(images, boxes, frame_idx, out_hw, "crop_and_resize")
    if images.device.type == "cpu":
        return crop_and_resize_plain(images, boxes, out_hw, frame_idx)
    if images.device.type != "cuda":
        raise ValueError(f"crop_and_resize: unsupported device "
                         f"{images.device}")
    if boxes.data_ptr() % 16:
        raise ValueError("crop_and_resize: boxes must be 16-byte aligned")
    oh, ow = (int(v) for v in out_hw)
    t, h, w, c = images.shape
    b = boxes.shape[0]
    out = torch.empty((b, oh, ow, c), dtype=torch.float32,
                      device=images.device)
    if out.numel() == 0:
        return out  # nothing to compute: no launch
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _crop_lib().st_crop_resize(
            images.data_ptr(), t, h, w, c, boxes.data_ptr(),
            frame_idx.data_ptr(), b, oh, ow, recip(oh), recip(ow),
            out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"crop_and_resize: CUDA launch failed with error "
                           f"{rc}")
    crop_and_resize.launches += 1
    return out


crop_and_resize.launches = 0


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
