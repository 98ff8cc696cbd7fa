"""Image-processing ops: Resize, Blur, ConvertColor, FrameDifference,
Montage, Brightness/Contrast/Sharpness, FlowHistogram, vis ops.

Reference parity:
  Resize          resize_kernel.cpp:22-106 (width/height/min/preserve_aspect,
                  INTER_LINEAR default)
  Blur            blur_kernel_cpu.cpp:51-80 (naive box filter, integer mean,
                  interior-only; the reference leaves borders uninitialized —
                  we copy the input there instead)
  ConvertColor    convert_color_kernel.cpp:10-210 (cv::cvtColor string map;
                  the common conversions are implemented on device with
                  cv2-exact fixed-point; exotic codes fall back to host cv2)
  FrameDifference frame_difference_kernel_cpu.cpp:232-287 (dead code in the
                  reference build — registered here fixed, as |cur - prev|)
  Montage         montage_kernel_cpu.cpp:9-115 (stateful accumulator grid)
  Brightness/Contrast/Sharpness/ConvertToHSV/SharpnessBBox
                  old/imgproc.py:11-54 (YUV mean / Y-channel RMS contrast /
                  Laplacian variance)
  FlowHistogram   old/cpp_ops/flow_histogram_kernel_cpu.cpp:12-67
                  (64-bin magnitude [0,64) + angle [0,360) histograms)
  DrawFlow/DrawBboxes  vis.py:8-24

Device ops take FrameChunk/NHWC tensors, compute in float32 with torch on
the tensors' device, in the order the JAX package (scannertools_tpu's
ops/imgproc.py) writes each formula, and emit u8 frames. Host ops are the
JAX package's, unchanged.

Where torch's own routine would round or border differently from the
reference, this module does not call it: padding gathers along an index
map that ``np.pad`` computes, so "reflect" (REFLECT_101) and "edge" pad
exactly as ``jnp.pad`` does at any size (``F.pad(mode="reflect")``
refuses a pad as wide as the dimension, ``np.pad`` reflects again).
Resizing, divisions by constants and means are ``utils.numerics``'s, which
reproduce what the JAX package computes under ``jax.jit``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..registry import register_op
from ..utils.framechunk import FrameChunk
from ..utils.numerics import div as _div, mean as _mean, resize_hw


def _as_u8_hwc(frames):
    if isinstance(frames, FrameChunk):
        return frames.hwc_f32()  # converts i420 in the flat layout
    x = torch.as_tensor(frames)
    return x.to(torch.float32) if x.dtype == torch.uint8 else x


# ------------------------------------------------------------------ padding


@functools.lru_cache(maxsize=512)
def _pad_index(n: int, lo: int, hi: int, mode: str,
               device: torch.device) -> torch.Tensor:
    """The source position of each padded position, as ``np.pad`` pads
    ``arange(n)``; made once per shape and device."""
    src = np.pad(np.arange(n), (lo, hi), mode=mode)
    return torch.from_numpy(src).to(device)


def _pad(x: torch.Tensor, dim: int, lo: int, hi: int,
         mode: str) -> torch.Tensor:
    """``jnp.pad`` of one dimension, mode "reflect" or "edge", as a gather
    along the index map ``np.pad`` computes."""
    return x.index_select(dim, _pad_index(x.shape[dim], lo, hi, mode,
                                          x.device))


# --------------------------------------------------------------------- Resize

def resize_shape(h: int, w: int, width: int = 0, height: int = 0,
                 preserve_aspect: bool = False, min: bool = False):
    """Target (th, tw) per the reference arg semantics
    (resize_kernel.cpp:44-61)."""
    tw, th = int(width), int(height)
    if preserve_aspect:
        if tw == 0:
            tw = w * th // h
        else:
            th = h * tw // w
    if min and w <= tw and h <= th:
        tw, th = w, h
    return th, tw


@register_op("Resize", kind="device", outputs=("frame",), row_local=True)
def resize(ctx, frame, width: int = 0, height: int = 0,
           preserve_aspect: bool = False, min: bool = False,
           interpolation: str = "INTER_LINEAR"):
    x = _as_u8_hwc(frame)
    t, h, w, c = x.shape
    th, tw = resize_shape(h, w, width, height, preserve_aspect, min)
    method = {"INTER_LINEAR": "linear", "INTER_NEAREST": "nearest",
              "INTER_CUBIC": "cubic", "INTER_AREA": "linear"}.get(
                  interpolation, "linear")
    out = resize_hw(x, 1, th, tw, method)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


# ----------------------------------------------------------------------- Blur

def _box1d(a, axis, lo, hi):
    """Windowed sums via padded cumulative sums: output[i] = sum over
    a[i .. i+lo+hi] (length n-(lo+hi)). Sums of u8 pixels stay exact in
    f32 while any cumsum value < 2^24 (h, k*w < ~65k), so the order in
    which torch.cumsum adds does not matter."""
    n = a.shape[axis]
    cs = torch.cumsum(a, dim=axis)
    cs = torch.cat([torch.zeros_like(cs.narrow(axis, 0, 1)), cs], dim=axis)
    upper = cs.narrow(axis, lo + hi + 1, n - lo - hi)
    lower = cs.narrow(axis, 0, n - lo - hi)
    return upper - lower


def _box1d_same(a, axis, lo, hi):
    """SAME-padded window sums: output[i] = sum a[i-lo .. i+hi], zeros
    outside — row-count preserving (the spatially-sharded formulation)."""
    pad = [0, 0] * (a.dim() - 1 - axis) + [lo, hi]
    return _box1d(torch.nn.functional.pad(a, pad), axis, lo, hi)


def _blur_sp_halo(params: dict):
    k = int(params.get("kernel_size", 3))
    return max(k // 2, k - k // 2 - 1)


@register_op("Blur", kind="device", outputs=("frame",),
             sp_halo=_blur_sp_halo, row_local=True)
def blur(ctx, frame, kernel_size: int = 3, sigma: float = 0.0):
    """Box blur, integer mean over a kernel_size² window, interior pixels
    only (blur_kernel_cpu.cpp:62-79: value / k² in integer arithmetic).
    Implemented as a separable prefix-sum filter: O(1) per pixel.

    Under ``PerfParams(spatial_shards=N)`` the frame's row axis is sharded
    over the reserved 'sp' mesh devices with a one-hop halo exchange
    (parallel/spatial.spatial_apply_traced), and the result is
    bit-identical to the unsharded path (all window sums are exact u8
    integer sums in f32)."""
    x = _as_u8_hwc(frame)  # f32
    k = int(kernel_size)
    left = k // 2
    right = k - k // 2 - 1
    t, h, w, c = x.shape

    halo = max(left, right)
    mesh = ctx.sp_mesh(h, halo) if ctx is not None else None
    if mesh is not None and halo > 0:
        from ..parallel.spatial import spatial_apply_traced

        def body(padded, gidx):
            # padded [t, local+2*halo, w, c]; gidx = global row index of
            # each padded row (<0 / >=h outside the image)
            inside = ((gidx >= 0) & (gidx < h)).to(padded.dtype)
            xm = padded * inside[None, :, None, None]
            sums = _box1d_same(_box1d_same(xm, 1, left, right),
                               2, left, right)
            mean = torch.floor(_div(sums, float(k * k)))
            col = torch.arange(w, device=padded.device)
            in_col = (col >= left) & (col < w - right)
            in_row = (gidx >= left) & (gidx < h - right)
            m = in_row[None, :, None, None] & in_col[None, None, :, None]
            # interior pixels get the mean; borders keep original pixels
            return torch.where(m, mean, xm).to(torch.uint8)

        return spatial_apply_traced(body, x, halo, mesh)

    sums = _box1d(_box1d(x, 1, left, right), 2, left, right)
    mean = torch.floor(_div(sums, float(k * k)))  # integer division
    # paste the interior over a copy of the input (the reference leaves
    # borders uninitialized; we keep them as the original pixels)
    out = x.to(torch.uint8)
    out[:, left:left + mean.shape[1], left:left + mean.shape[2]] = \
        mean.to(torch.uint8)
    return out


# --------------------------------------------------------------- ConvertColor

def _rgb2gray_u8(x):
    """cv2 fixed-point BT.601: (R*4899 + G*9617 + B*1868 + 8192) >> 14."""
    xi = x.to(torch.int32)
    y = (xi[..., 0] * 4899 + xi[..., 1] * 9617 + xi[..., 2] * 1868
         + 8192) >> 14
    return y.to(torch.uint8)[..., None]


def _rgb2yuv_u8(x):
    """cv2 RGB2YUV u8 (fixed-point, ITU-R BT.601 with delta 128)."""
    xi = x.to(torch.float32)
    r, g, b = xi[..., 0], xi[..., 1], xi[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = 0.492 * (b - y) + 128.0
    v = 0.877 * (r - y) + 128.0
    out = torch.stack([y, u, v], dim=-1)
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def _rgb2hsv_u8(x):
    """cv2 RGB2HSV for u8: H in [0,180), S,V in [0,255]."""
    xf = x.to(torch.float32)
    r, g, b = xf[..., 0], xf[..., 1], xf[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = v - mn
    s = torch.where(v > 0, 255.0 * diff / torch.clamp(v, min=1e-9), 0.0)
    safe = torch.clamp(diff, min=1e-9)
    h = torch.where(
        v == r, 60.0 * (g - b) / safe,
        torch.where(v == g, 120.0 + 60.0 * (b - r) / safe,
                    240.0 + 60.0 * (r - g) / safe),
    )
    h = torch.where(diff == 0, 0.0, h)
    h = torch.where(h < 0, h + 360.0, h) / 2.0  # [0,180)
    out = torch.clamp(torch.round(torch.stack([h, s, v], dim=-1)), 0, 255)
    # u8 hue wraps at 180 (cv2 stores H/2 in [0,180))
    out[..., 0] = torch.remainder(out[..., 0], 180)
    return out.to(torch.uint8)


_DEVICE_CONVERSIONS = {
    "COLOR_RGB2GRAY": _rgb2gray_u8,
    "COLOR_BGR2GRAY": lambda x: _rgb2gray_u8(x.flip(-1)),
    "COLOR_RGB2BGR": lambda x: x.flip(-1).to(torch.uint8),
    "COLOR_BGR2RGB": lambda x: x.flip(-1).to(torch.uint8),
    "COLOR_RGB2HSV": _rgb2hsv_u8,
    "COLOR_BGR2HSV": lambda x: _rgb2hsv_u8(x.flip(-1)),
    "COLOR_RGB2YUV": _rgb2yuv_u8,
    "COLOR_GRAY2RGB": lambda x: x.to(torch.uint8).repeat_interleave(3,
                                                                    dim=-1),
}


def _pointwise(ctx, fn, x):
    """``fn(x)``, row-sharded over the 'sp' mesh under
    ``PerfParams(spatial_shards=N)`` (halo 0, bit-identical —
    parallel/spatial.spatial_apply_pointwise)."""
    # ctx is None when an op is called directly, outside an executor
    mesh = ctx.sp_mesh(x.shape[1]) if ctx is not None else None
    if mesh is not None:
        from ..parallel.spatial import spatial_apply_pointwise

        return spatial_apply_pointwise(fn, x, mesh)
    return fn(x)


@register_op("ConvertColor", kind="device", outputs=("frame",),
             sp_halo=lambda p: 0, row_local=True)
def convert_color(ctx, frame, conversion: str = "COLOR_RGB2GRAY"):
    """Per-pixel, so row-pointwise under spatial_shards."""
    x = _as_u8_hwc(frame)
    if conversion not in _DEVICE_CONVERSIONS:
        raise ValueError(
            f"ConvertColor: {conversion} has no device implementation; "
            "use ConvertColorHost for exotic cv2 codes"
        )
    return _pointwise(ctx, _DEVICE_CONVERSIONS[conversion], x)


@register_op("ConvertColorHost", kind="host", outputs=("frame",))
def convert_color_host(ctx, frames, conversion: str = "COLOR_RGB2GRAY"):
    """Full ~200-code coverage via host cv2 (convert_color_kernel.cpp map)."""
    import cv2

    code = getattr(cv2, conversion.replace("COLOR_", "COLOR_", 1))
    out = []
    n = len(frames) if isinstance(frames, list) else frames.shape[0]
    for i in range(n):
        r = cv2.cvtColor(np.asarray(frames[i]), code)
        out.append(r if r.ndim == 3 else r[..., None])
    return out


@register_op("ConvertToHSV", kind="device", outputs=("frame",),
             sp_halo=lambda p: 0, row_local=True)
def convert_to_hsv(ctx, frame):
    """old/imgproc.py:40 — cv2.cvtColor(frame, COLOR_RGB2HSV)."""
    return _pointwise(ctx, _rgb2hsv_u8, _as_u8_hwc(frame))


# ------------------------------------------------------------ FrameDifference

@register_op("FrameDifference", kind="device", stencil=(-1, 0),
             outputs=("frame",), sp_halo=lambda p: 0, row_local=True)
def frame_difference(ctx, frames):
    """|frame[i] - frame[i-1]| per pixel (fixed version of the reference's
    dead frame_difference_kernel_cpu.cpp). First frame diffs against itself
    (stream-edge clamp) -> zeros. The temporal stencil is row-pointwise in
    H, so rows shard over the 'sp' mesh under spatial_shards (halo 0)."""
    x = _as_u8_hwc(frames)  # [T+1, H, W, C] with 1-frame leading halo
    return _pointwise(ctx, lambda a: torch.abs(a[1:] - a[:-1]).to(
        torch.uint8), x)


# ------------------------------------------------- Brightness/Contrast/Sharp

# Brightness, Contrast and Sharpness are ``batch_local``, not
# ``row_local``: a frame's value reads its own pixels alone, but each is a
# float32 sum over the frame (of integers up to 255 a pixel: past 2**24 at
# 1080p, where a float32 sum is no longer exact), and torch's reductions
# choose how to split an output's sum from the number of outputs, the
# batch, on the CPU and on CUDA.
@register_op("Brightness", kind="device", outputs=("array_f32",),
             batch_local=True)
def brightness(ctx, frame):
    """Mean Y of RGB2YUV (old/imgproc.py:11-16)."""
    x = _as_u8_hwc(frame)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    y = torch.clamp(torch.round(y), 0, 255).to(torch.uint8).to(torch.float32)
    return _mean(y, (1, 2))[:, None]


@register_op("Contrast", kind="device", outputs=("array_f32",),
             batch_local=True)
def contrast(ctx, frame):
    """RMS deviation of the Y channel (old/imgproc.py:19-30)."""
    x = _as_u8_hwc(frame)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = torch.clamp(torch.round(0.299 * r + 0.587 * g + 0.114 * b), 0, 255)
    mean = _mean(y, (1, 2), keepdim=True)
    rms = torch.sqrt(_mean((y - mean) ** 2, (1, 2)))
    return rms[:, None]


def _laplacian_var(x):
    """cv2.Laplacian(ksize=1) variance with REFLECT_101 borders, per frame
    over all channels (old/imgproc.py:33-36)."""
    # kernel [[0,1,0],[1,-4,1],[0,1,0]]: lap = up+down+left+right-4x
    pad = _pad(_pad(x, 1, 1, 1, "reflect"), 2, 1, 1, "reflect")
    lap = (pad[:, :-2, 1:-1] + pad[:, 2:, 1:-1] + pad[:, 1:-1, :-2]
           + pad[:, 1:-1, 2:] - 4.0 * x)
    mean = _mean(lap, (1, 2, 3), keepdim=True)
    return _mean((lap - mean) ** 2, (1, 2, 3))


@register_op("Sharpness", kind="device", outputs=("array_f32",),
             batch_local=True)
def sharpness(ctx, frame):
    return _laplacian_var(_as_u8_hwc(frame))[:, None]


@register_op("SharpnessBBox", kind="host", outputs=("object",))
def sharpness_bbox(ctx, frames, bboxes):
    """Laplacian variance per 200x200-resized bbox crop
    (old/imgproc.py:44-54). bboxes are absolute-pixel BoundingBoxes here."""
    import cv2

    out = []
    for i in range(len(bboxes)):
        frame = np.asarray(frames[i])
        results = []
        for bbox in bboxes[i]:
            img = frame[int(bbox.y1):int(bbox.y2), int(bbox.x1):int(bbox.x2)]
            if img.size == 0:
                results.append(0.0)
                continue
            img = cv2.resize(img, (200, 200))
            results.append(float(cv2.Laplacian(img, cv2.CV_64F).var()))
        out.append(results)
    return out


# ------------------------------------------------------------- FlowHistogram

@register_op("FlowHistogram", kind="device", outputs=("array_i32",),
             row_local=True)
def flow_histogram(ctx, flow, bins: int = 64):
    """[T,H,W,2] flow -> [T,2,64] int32: magnitude histogram over [0,64) and
    angle (degrees) over [0,360); out-of-range values are excluded, matching
    cv::calcHist (flow_histogram_kernel_cpu.cpp:30-55). Counts come from one
    bincount over (frame, bin) codes; values outside a histogram's range go
    to a dead bin past the last, which is dropped."""
    f = torch.as_tensor(flow)
    fx, fy = f[..., 0], f[..., 1]
    mag = torch.sqrt(fx * fx + fy * fy)
    # jnp.degrees: a product with float32(180 / pi). torch.atan2 and
    # jnp.arctan2 may differ by an ulp, which can move a value on a bin
    # edge to the next bin; magnitudes (IEEE sqrt) are exact.
    ang = torch.atan2(fy, fx) * float(np.float32(180.0 / np.pi))
    ang = torch.where(ang < 0, ang + 360.0, ang)
    t = f.shape[0]

    def hist(vals, lo, hi):
        idx = torch.floor((vals - lo) * (bins / (hi - lo)))
        idx = torch.where((vals >= lo) & (vals < hi), idx,
                          bins).to(torch.int64)
        frame = torch.arange(t, device=f.device).view(-1, 1, 1)
        counts = torch.bincount((frame * (bins + 1) + idx).reshape(-1),
                                minlength=t * (bins + 1))
        return counts.view(t, bins + 1)[:, :bins]

    return torch.stack([hist(mag, 0.0, 64.0), hist(ang, 0.0, 360.0)],
                       dim=1).to(torch.int32)


# -------------------------------------------------------------------- Montage

def _montage_init(ctx):
    return {"seen": 0, "buffer": None}


@register_op("Montage", kind="stateful", outputs=("frame",),
             init_state=_montage_init)
def montage(ctx, state, frames, num_frames: int = 0, target_width: int = 100,
            frames_per_row: int = 8):
    """Tile num_frames into a grid; emit the montage on the final frame and
    1x1 dummies otherwise (montage_kernel_cpu.cpp:60-88: real frame only when
    frames_seen == num_frames)."""
    import cv2

    frames = np.asarray(frames)
    t, h, w, _ = frames.shape
    target_height = h * target_width // w
    rows = -(-num_frames // frames_per_row)
    if state["buffer"] is None:
        state["buffer"] = np.zeros(
            (rows * target_height, frames_per_row * target_width, 3), np.uint8
        )
    out = []
    for i in range(t):
        img = cv2.resize(frames[i], (target_width, target_height))
        x = state["seen"] % frames_per_row
        y = state["seen"] // frames_per_row
        state["buffer"][y * target_height:(y + 1) * target_height,
                        x * target_width:(x + 1) * target_width] = img
        state["seen"] += 1
        if state["seen"] == num_frames:
            out.append(state["buffer"].copy())
        else:
            out.append(np.zeros((1, 1, 3), np.uint8))
    return state, out


# ------------------------------------------------------------------- Vis ops

@register_op("DrawFlow", kind="host", outputs=("frame",))
def draw_flow(ctx, frame, flow):
    """Mean-|flow| grayscale panel hstacked with the frame (vis.py:8-12)."""
    out = []
    for i in range(len(frame)):
        f = np.asarray(frame[i])
        fl = np.asarray(flow[i])
        flow_vis = np.repeat(
            np.expand_dims(np.average(fl, axis=2), 2), 3, axis=2
        )
        mx = np.max(flow_vis)
        if mx <= 0:
            panel = np.zeros_like(f)
        else:
            panel = (np.clip(flow_vis / mx, None, 1.0) * 255).astype(np.uint8)
        out.append(np.hstack((f, panel)))
    return out


@register_op("DrawBboxes", kind="host", outputs=("frame",))
def draw_bboxes(ctx, frame, bboxes):
    """Rectangles scaled by frame dims (vis.py:15-24; bboxes normalized)."""
    import cv2

    out = []
    for i in range(len(bboxes)):
        f = np.ascontiguousarray(np.asarray(frame[i]))
        h, w = f.shape[:2]
        for bbox in bboxes[i]:
            cv2.rectangle(
                f,
                (int(bbox.x1 * w), int(bbox.y1 * h)),
                (int(bbox.x2 * w), int(bbox.y2 * h)),
                (255, 0, 0),
            )
        out.append(f)
    return out
