"""Plain PyTorch building blocks of the references, frozen here.

Nothing in this file imports the program under test. The arithmetic is the
one the port states it computes (the JAX package's, as jitted XLA computes
it): divisions by a constant are products with the float32 reciprocal,
resizes are ``jax.image.resize`` without antialiasing, top-k keeps equal
values in index order, NMS is greedy in stable score order, and a crop
samples two taps a side at half-pixel centres.

Every convolution and dense layer goes through ``conv2d``/``linear``, so
that one switch, ``precision("tf32")``, computes them with their operands
rounded to TF32's 10-bit mantissa (the control: the precision a change
that turned TF32 on would compute in), and ``count_flops()`` counts their
multiply-adds from the shapes alone (meta tensors do no arithmetic).
"""

from __future__ import annotations

import contextlib
import functools
import threading

import numpy as np
import torch
import torch.nn.functional as F

_STATE = threading.local()


def _mode() -> str:
    return getattr(_STATE, "precision", "float32")


@contextlib.contextmanager
def precision(name: str):
    """Compute the convolutions and dense layers inside the block in
    ``name``: "float32" (full float32, TF32 off) or "tf32" (each operand
    rounded to TF32 first, the accumulation in float32, as the tensor
    cores compute)."""
    if name not in ("float32", "tf32"):
        raise ValueError(f"precision: float32 or tf32, got {name!r}")
    old = _mode()
    _STATE.precision = name
    try:
        yield
    finally:
        _STATE.precision = old


@contextlib.contextmanager
def count_flops():
    """Count the floating-point operations (2 per multiply-add) of the
    convolutions and dense layers run inside the block -> a one-item list
    that holds the running total."""
    old = getattr(_STATE, "flops", None)
    total = [0]
    _STATE.flops = total
    try:
        yield total
    finally:
        _STATE.flops = old


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties away from
    zero), still stored as float32."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return torch.where(torch.isfinite(x), rounded.view(torch.float32), x)


def _operands(*ts):
    if _mode() == "tf32":
        return tuple(None if t is None else round_tf32(t) for t in ts)
    return ts


def _full_f32():
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=False,
                       deterministic=cudnn.deterministic, allow_tf32=False)


def conv2d(x, w, b=None, stride=1, padding=0):
    """NCHW convolution, OIHW weights."""
    out_flops = getattr(_STATE, "flops", None)
    x, w, b = _operands(x, w, b)
    with _full_f32():
        y = F.conv2d(x, w, b, stride, padding)
    if out_flops is not None:
        out_flops[0] += 2 * y.numel() * w.shape[1] * w.shape[2] * w.shape[3]
    return y


def linear(x, w, b=None):
    """x @ w.T + b, torch layout [out, in]."""
    out_flops = getattr(_STATE, "flops", None)
    x, w, b = _operands(x, w, b)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        y = F.linear(x, w, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    if out_flops is not None:
        out_flops[0] += 2 * y.numel() * w.shape[1]
    return y


# ---------------------------------------------------------------- numerics

def recip(d: float) -> float:
    return float(np.float32(1) / np.float32(d))


def div(x: torch.Tensor, d: float) -> torch.Tensor:
    return x * recip(d)


def mean(x: torch.Tensor, dims, keepdim: bool = False) -> torch.Tensor:
    n = 1
    for d in dims:
        n *= x.shape[d]
    return div(x.sum(dim=dims, keepdim=keepdim), float(n))


def f32(x: float) -> float:
    return float(np.float32(x))


def same_pad(x: torch.Tensor, k: int, stride: int, value: float = 0.0):
    """flax "SAME" padding of NCHW for a k x k window (the extra pixel
    after)."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value) if any(pads) else x


def max_pool_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    return F.max_pool2d(same_pad(x, k, s, float("-inf")), k, s)


def batch_norm(x, mean_, var, scale, bias, eps: float) -> torch.Tensor:
    """Eval BatchNorm over dim 1, in flax's order: (x - mean) *
    (rsqrt(var + eps) * scale) + bias."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mul = torch.rsqrt(var + eps) * scale
    return (x - mean_.view(shape)) * mul.view(shape) + bias.view(shape)


# ---------------------------------------------------------------- resizing

def _triangle(x):
    return np.maximum(np.float32(0), np.float32(1) - np.abs(x))


def _keys_cubic(x):
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.)
    out = np.where(x >= 1., ((np.float32(-0.5) * x + np.float32(2.5)) * x
                             - np.float32(4.)) * x + np.float32(2.), out)
    return np.where(x >= 2., np.float32(0.), out).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _resize_taps(n_in: int, n_out: int, method: str, device: str):
    kernel = {"linear": _triangle, "cubic": _keys_cubic}[method]
    inv_scale = np.float32(1. / (n_out / n_in))
    sample = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
              * inv_scale - np.float32(0.5))
    w = kernel(np.abs(sample[None, :]
                      - np.arange(n_in, dtype=np.float32)[:, None]))
    total = np.zeros(n_out, np.float32)
    for i in range(n_in):
        total += w[i]
    w = np.where(np.abs(total) > 1000. * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, np.float32(1)),
                 np.float32(0)).astype(np.float32)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    w = np.where(inside[None, :], w, np.float32(0))
    k = max(1, int((w != 0).sum(axis=0).max()))
    index = np.zeros((k, n_out), np.int64)
    weight = np.zeros((k, n_out), np.float32)
    for o in range(n_out):
        nz = np.flatnonzero(w[:, o])
        index[:len(nz), o] = nz
        weight[:len(nz), o] = w[nz, o]
    return (torch.from_numpy(index).to(device),
            torch.from_numpy(weight).to(device))


def _resize_axis(x, dim: int, n_out: int, method: str):
    index, weight = _resize_taps(x.shape[dim], n_out, method, str(x.device))
    shape = [1] * x.dim()
    shape[dim] = n_out
    out = None
    for k in range(index.shape[0]):
        term = x.index_select(dim, index[k]) * weight[k].view(shape)
        out = term if out is None else out + term
    return out


def resize_hw(x, h_dim: int, th: int, tw: int, method: str = "linear"):
    """jax.image.resize(..., antialias=False) of axes h_dim, h_dim + 1; the
    cheaper axis first, as the einsum path takes it."""
    w_dim = h_dim + 1
    h, w = x.shape[h_dim], x.shape[w_dim]
    axes = [(d, n) for d, n in ((h_dim, th), (w_dim, tw)) if x.shape[d] != n]
    if len(axes) == 2 and tw * h * (w + th) < th * w * (h + tw):
        axes.reverse()
    for d, n in axes:
        x = _resize_axis(x, d, n, method)
    return x


# ------------------------------------------------------------ top-k and NMS

def topk_stable(x, k: int):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def topk_boxes(boxes, scores, k: int):
    n = scores.shape[-1]
    if n < k:
        boxes = torch.cat([boxes, boxes.new_zeros(
            (*boxes.shape[:-2], k - n, 4))], dim=-2)
        scores = torch.cat([scores, scores.new_full(
            (*scores.shape[:-1], k - n), float("-inf"))], dim=-1)
    s, idx = topk_stable(scores, k)
    return boxes.gather(-2, idx[..., None].expand(*idx.shape, 4)), s


def _area(b):
    return (torch.clamp_min(b[..., 2] - b[..., 0], 0.0)
            * torch.clamp_min(b[..., 3] - b[..., 1], 0.0))


def _inter(a, b):
    x1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    y1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    x2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    y2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    return torch.clamp_min(x2 - x1, 0.0) * torch.clamp_min(y2 - y1, 0.0)


def _overlap(b, mode: str):
    inter = _inter(b, b)
    area = _area(b)
    if mode == "union":
        union = area[..., :, None] + area[..., None, :] - inter
        return torch.where(union > 0, inter / union, 0.0)
    mn = torch.minimum(area[..., :, None], area[..., None, :])
    return torch.where(mn > 0, inter / mn, 0.0)


def nms(boxes, scores, iou_thresh: float, max_out: int,
        mode: str = "union"):
    """Greedy NMS of [T, K, 4] boxes and [T, K] scores in stable descending
    score order, rows of score <= 0 invalid -> (boxes, scores, valid) [T,
    max_out]: the kept rows first in score order, zeros after."""
    t, k = scores.shape
    s, order = torch.sort(scores, dim=1, descending=True, stable=True)
    b = boxes.gather(1, order[..., None].expand(t, k, 4))
    valid = s > 0.0
    idx = torch.arange(k, device=boxes.device)
    sup = ((_overlap(b, mode) > iou_thresh) & (idx[:, None] < idx[None, :])
           & valid[..., :, None])
    keep = valid
    while True:
        nxt = valid & ~(keep[..., :, None] & sup).any(dim=1)
        if torch.equal(nxt, keep):
            break
        keep = nxt
    n = max(max_out, k)
    dest = torch.where(keep, torch.cumsum(keep, dim=1) - 1, n)
    ob = b.new_zeros((t, n + 1, 4)).scatter_(
        1, dest[..., None].expand(t, k, 4), b)[:, :max_out]
    os_ = s.new_zeros((t, n + 1)).scatter_(1, dest, s)[:, :max_out]
    ov = keep.new_zeros((t, n + 1)).scatter_(1, dest, keep)[:, :max_out]
    return ob, os_, ov


# ------------------------------------------------------------------ crops

def _taps(lo, hi, n_out: int, size: int):
    """The two hat taps of each of n_out sample positions over [lo, hi)
    (half-pixel centres, clamped to the box and then the frame)."""
    d = hi - lo
    p = torch.arange(n_out, dtype=torch.float32, device=lo.device) + 0.5
    v = div(d[:, None] * p, n_out) - 0.5
    s = lo[:, None] + torch.minimum(torch.clamp_min(v, 0.0),
                                    torch.clamp_min(d - 1.0, 0.0)[:, None])
    s = torch.clamp(s, 0.0, size - 1.0)
    f0 = torch.floor(s)
    w0 = torch.clamp_min(1.0 - torch.abs(s - f0), 0.0)
    w1 = torch.clamp_min(1.0 - torch.abs(s - (f0 + 1.0)), 0.0)
    i0 = f0.to(torch.int64)
    return i0, torch.clamp(i0 + 1, max=size - 1), w0, w1


def crop_and_resize(images, boxes, out_hw, frame_idx):
    """images [T, H, W, C] float32, pixel boxes [B, 4] (x1, y1, x2, y2)
    from frames ``frame_idx`` [B] -> [B, oh, ow, C] bilinear crops."""
    oh, ow = out_hw
    _, h, w, _ = images.shape
    y0, y1, wy0, wy1 = _taps(boxes[:, 1], boxes[:, 3], oh, h)
    x0, x1, wx0, wx1 = _taps(boxes[:, 0], boxes[:, 2], ow, w)
    f = frame_idx[:, None, None]

    def at(rows, cols):
        return images[f, rows[:, :, None], cols[:, None, :]]

    wy0_, wy1_ = wy0[:, :, None, None], wy1[:, :, None, None]
    t0 = wy0_ * at(y0, x0) + wy1_ * at(y1, x0)
    t1 = wy0_ * at(y0, x1) + wy1_ * at(y1, x1)
    return wx0[:, None, :, None] * t0 + wx1[:, None, :, None] * t1


def touched_pixels(h: int, w: int, boxes, frame_idx, t: int, oh: int,
                   ow: int) -> int:
    """The pixels of T frames of h x w that the taps of crops of ``boxes``
    from frames ``frame_idx`` read, each counted once."""
    touched = torch.zeros((t, h, w), dtype=torch.bool, device=boxes.device)
    for i in range(0, boxes.shape[0], 64):
        b = boxes[i:i + 64]
        y0, y1, _, _ = _taps(b[:, 1], b[:, 3], oh, h)
        x0, x1, _, _ = _taps(b[:, 0], b[:, 2], ow, w)
        rows, cols = torch.cat([y0, y1], 1), torch.cat([x0, x1], 1)
        touched[frame_idx[i:i + 64, None, None], rows[:, :, None],
                cols[:, None, :]] = True
    return int(touched.sum())
