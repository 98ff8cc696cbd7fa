"""Dense optical flow — Farnebäck polynomial-expansion flow.

Reference parity: the ``OpticalFlow`` op wraps
``cv::FarnebackOpticalFlow::create(3, 0.5, false, 15, 3, 5, 1.2, 0)`` on
grayscale frame pairs with stencil {0,1}, emitting H×W×2 float32
(optical_flow_kernel_cpu.cpp:16,27-43; GPU variant
optical_flow_kernel_gpu.cpp).

The algorithm and every function name are those of the JAX package's
``ops/optical_flow.py`` (Farnebäck, "Two-frame motion estimation based on
polynomial expansion", SCIA 2003), with its layouts: gray ``[T, H, W]``,
coefficients ``[T, H, W, 5]``, flow ``[T, H, W, 2]``:

  * coarse-to-fine image pyramid (``levels`` extra octaves, scale
    ``pyr_scale``): each level Gaussian-smooths the full-res image with
    sigma = (1/scale - 1)/2 and resizes bilinearly;
  * per level: quadratic polynomial expansion per pixel (separable
    Gaussian-weighted least squares, window 2·poly_n+1, sigma poly_sigma)
    giving linear terms (bx, by) and quadratic terms (axx, ayy, axy);
  * ``iters`` fixed-point iterations: warp frame-1 coefficients by the
    current flow, form the 2×2 normal equations (G, h) per pixel, box-blur
    them over win_size², solve for the flow increment.

The warp and the normal equations (``_update_matrices``) are one
hand-written CUDA kernel, ``flow_update`` (kernels/csrc/flow.cu), launched
(levels + 1) · iters times per chunk; ``flow_update_plain`` beside it is its
plain torch version, which CPU tensors take. The other stages are plain
torch on the tensors' device, written as the JAX package writes them:

  * ``_sepconv`` and ``_poly_exp`` are running sums of shifted slices, not
    ``F.conv2d``: a float32 convolution on the card goes through cuDNN in
    TF32 by default (``torch.backends.cudnn.allow_tf32``), about three
    decimal digits;
  * padding and resizing are imgproc's ``_pad`` and ``utils.numerics``'s
    ``resize_hw``, which border and weight as ``jnp.pad`` and
    ``jax.image.resize`` do
    (REFLECT_101 at any size; half-pixel centres with renormalised edge
    weights, at odd pyramid sizes too);
  * ``_box_blur`` takes differences of float32 cumulative sums. Those sums
    are not exact, and ``torch.cumsum`` adds in another order than XLA (on
    the CPU it accumulates in double, on the card it scans in parallel), so
    the port is held to the JAX package within a stated tolerance there,
    not bit for bit (tests/test_torch_optical_flow.py).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..kernels import build as _build
from ..registry import register_op
from ..utils.framechunk import FrameChunk
from ..utils.numerics import div as _div, recip as _recip, resize_hw
from .imgproc import _pad, _rgb2gray_u8


# ------------------------------------------------------------ small helpers

def _gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _wsum(a: torch.Tensor, dim: int, n: int, k) -> torch.Tensor:
    """sum_i a[i : i + n along dim] * k[i], added in the order i = 0, 1, ...
    (the Python ``sum`` the JAX package writes)."""
    out = None
    for i, ki in enumerate(k):
        term = a.narrow(dim, i, n) * float(ki)
        out = term if out is None else out + term
    return out


def _sepconv(img: torch.Tensor, kx: np.ndarray, ky: np.ndarray,
             mode: str = "reflect") -> torch.Tensor:
    """Separable 2D correlation on [T, H, W] with border handling.

    mode='reflect' == cv2 BORDER_REFLECT_101 (GaussianBlur default);
    mode='edge'    == cv2 BORDER_REPLICATE (polynomial expansion).
    Shifted slices, not ``F.conv2d``: cuDNN would take float32 in TF32.
    """
    ry, rx = len(ky) // 2, len(kx) // 2
    x = _pad(_pad(img, 1, ry, ry, mode), 2, rx, rx, mode)
    # horizontal then vertical, as running weighted sums
    h = _wsum(x, 2, img.shape[2], kx)
    return _wsum(h, 1, img.shape[1], ky)


def _resize_bilinear(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``jax.image.resize(img, [..., h, w], "linear", antialias=False)``."""
    return resize_hw(img, img.dim() - 2, h, w, "linear")


def _bilinear_sample(img: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor
                     ) -> torch.Tensor:
    """img: [T, H, W, C]; fy/fx: [T, H, W] float coords -> [T, H, W, C].
    Coordinates clamped to the valid range (border replicate); the four
    corners gathered, with the bottom/right ones edge-clamped."""
    t, h, w, c = img.shape
    fy = torch.clamp(fy, 0.0, h - 1.0)
    fx = torch.clamp(fx, 0.0, w - 1.0)
    y0 = torch.floor(fy)
    x0 = torch.floor(fx)
    wy = (fy - y0)[..., None]
    wx = (fx - x0)[..., None]
    y0, x0 = y0.to(torch.int64), x0.to(torch.int64)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    flat = img.reshape(t, h * w, c)

    def at(yi, xi):
        idx = (yi * w + xi).reshape(t, h * w, 1).expand(t, h * w, c)
        return flat.gather(1, idx).view(t, h, w, c)

    top = at(y0, x0) * (1 - wx) + at(y0, x1) * wx
    bot = at(y1, x0) * (1 - wx) + at(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def _shift_warp(img: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor,
                warp_px: int) -> torch.Tensor:
    """The JAX package's bounded-displacement warp (``_shift_warp``, its
    select-over-shifts pass for the TPU), with its semantics and not those
    of the exact bilinear warp:

      * the sample offset is clamped per axis to [-R, R-1] pixels below
        the target, R = ``warp_px`` capped at the size less one;
      * the y-lerp at (y, x') uses the flow at (y, x'); the x-lerp then
        reads that value at the two columns x+dx and x+dx+1 of row y.

    In the JAX loop every shift but two has weight 0 and adds an exact
    zero, so the two nonzero terms, in that order, are the whole sum: this
    gathers them."""
    t, h, w, c = img.shape
    ry = min(warp_px, h - 1)
    rx = min(warp_px, w - 1)
    fy = torch.clamp(fy, 0.0, h - 1.0)
    fx = torch.clamp(fx, 0.0, w - 1.0)
    y0 = torch.floor(fy)
    x0 = torch.floor(fx)
    wy = (fy - y0)[..., None]
    wx = (fx - x0)[..., None]
    yy = torch.arange(h, device=img.device)[None, :, None]
    xx = torch.arange(w, device=img.device)[None, None, :]
    ys = yy + torch.clamp(y0 - yy, -ry, ry - 1).to(torch.int64)
    xs = xx + torch.clamp(x0 - xx, -rx, rx - 1).to(torch.int64)

    def rows(a, r):
        r = torch.clamp(r, 0, h - 1)[..., None].expand(t, h, w, c)
        return a.gather(1, r)

    def cols(a, q):
        q = torch.clamp(q, 0, w - 1)[..., None].expand(t, h, w, c)
        return a.gather(2, q)

    a = (1 - wy) * rows(img, ys) + wy * rows(img, ys + 1)
    return (1 - wx) * cols(a, xs) + wx * cols(a, xs + 1)


# ------------------------------------------------- polynomial expansion

@functools.lru_cache(maxsize=8)
def _poly_setup(poly_n: int, poly_sigma: float):
    """Basis kernels g, x·g, x²·g and the folded inverse-Gram coefficients
    (the ig11/ig03/ig33/ig55 constants of Farnebäck's scheme), computed
    numerically from the 6×6 Gram matrix of {1, x, y, x², y², xy} under the
    separable Gaussian weight."""
    n = poly_n
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x * x) / (2.0 * poly_sigma * poly_sigma))
    g /= g.sum()
    xg = x * g
    xxg = x * x * g
    m2 = float((x * x * g).sum())
    m4 = float((x ** 4 * g).sum())
    # Gram matrix for basis [1, x, y, x², y², xy], separable weight w(x)w(y)
    G = np.zeros((6, 6))
    G[0, 0] = 1.0
    G[1, 1] = G[2, 2] = m2
    G[3, 3] = G[4, 4] = m4
    G[5, 5] = m2 * m2
    G[0, 3] = G[0, 4] = G[3, 0] = G[4, 0] = m2
    G[3, 4] = G[4, 3] = m2 * m2
    invG = np.linalg.inv(G)
    ig11 = invG[1, 1]
    ig03 = invG[0, 3]
    ig33 = invG[3, 3]
    ig55 = invG[5, 5]
    return (g.astype(np.float32), xg.astype(np.float32),
            xxg.astype(np.float32), float(ig11), float(ig03), float(ig33),
            float(ig55))


def _poly_exp(img: torch.Tensor, poly_n: int,
              poly_sigma: float) -> torch.Tensor:
    """img: [T, H, W] f32 -> R: [T, H, W, 5] = (bx, by, axx, ayy, axy')."""
    g, xg, xxg, ig11, ig03, ig33, ig55 = _poly_setup(poly_n, poly_sigma)
    r = poly_n
    x = _pad(_pad(img, 1, r, r, "edge"), 2, r, r, "edge")
    H, W = img.shape[1], img.shape[2]

    # horizontal pass over x (rows stay padded in y)
    row0 = _wsum(x, 2, W, g)      # g·I
    row1 = _wsum(x, 2, W, xg)     # xg·I
    row2 = _wsum(x, 2, W, xxg)    # x²g·I
    # vertical pass
    b1 = _wsum(row0, 1, H, g)     # g⊗g
    b2 = _wsum(row0, 1, H, xg)    # y-linear
    b3 = _wsum(row1, 1, H, g)     # x-linear
    b4 = _wsum(row2, 1, H, g)     # x-quadratic
    b5 = _wsum(row0, 1, H, xxg)   # y-quadratic
    b6 = _wsum(row1, 1, H, xg)    # cross

    bx = b3 * ig11
    by = b2 * ig11
    axx = b1 * ig03 + b4 * ig33
    ayy = b1 * ig03 + b5 * ig33
    axy = b6 * ig55
    return torch.stack([bx, by, axx, ayy, axy], dim=-1)


# --------------------------------------------------- flow update machinery

BORDER = 5.0  # px of the damped band (BORDER in csrc/flow.cu)


@functools.lru_cache(maxsize=64)
def _border_factors(h: int, w: int, device: torch.device) -> torch.Tensor:
    """[h, w, 1] float32 sy·sx: the per-pixel weight that damps the normal
    equations in a 5-px border band. Polynomial expansions there see
    replicated pixels and are unreliable; without damping they dominate the
    box-blurred normal equations at coarse pyramid levels and the flow
    diverges (Farnebäck's estimator applies the same border
    down-weighting). Computed once per size, in numpy float32, dividing by
    BORDER as jitted XLA does (a product with its reciprocal), as the
    kernel does."""
    def ramp(n):
        a = np.arange(n, dtype=np.float32)
        v = (np.minimum(a, np.float32(n - 1) - a) + np.float32(0.5)) \
            * np.float32(_recip(BORDER))
        return np.clip(v, np.float32(0), np.float32(1))

    s = ramp(h)[:, None] * ramp(w)[None, :]
    return torch.from_numpy(s[..., None]).to(device)


def flow_update_plain(r0: torch.Tensor, r1: torch.Tensor, flow: torch.Tensor,
                      warp_px: int = 16) -> torch.Tensor:
    """Per-pixel normal equations M = [G00, G01, G11, h0, h1] from the two
    polynomial expansions and the current flow estimate, damped in the
    border band: the JAX package's ``_update_matrices`` in torch, each
    operation rounded on its own in the written order. ``warp_px`` > 0
    warps r1 by ``_shift_warp``, 0 by the exact ``_bilinear_sample``."""
    _check_update(r0, r1, flow, warp_px, "flow_update_plain")
    t, h, w, _ = r0.shape
    yy = torch.arange(h, dtype=torch.float32, device=r0.device)[None, :, None]
    xx = torch.arange(w, dtype=torch.float32, device=r0.device)[None, None, :]
    fy = yy + flow[..., 1]
    fx = xx + flow[..., 0]
    if warp_px > 0:
        r1w = _shift_warp(r1, fy, fx, warp_px)
    else:
        r1w = _bilinear_sample(r1, fy, fx)

    a11 = (r0[..., 2] + r1w[..., 2]) * 0.5
    a22 = (r0[..., 3] + r1w[..., 3]) * 0.5
    a12 = (r0[..., 4] + r1w[..., 4]) * 0.25
    dbx = -(r1w[..., 0] - r0[..., 0]) * 0.5 + a11 * flow[..., 0] \
        + a12 * flow[..., 1]
    dby = -(r1w[..., 1] - r0[..., 1]) * 0.5 + a12 * flow[..., 0] \
        + a22 * flow[..., 1]

    g00 = a11 * a11 + a12 * a12
    g01 = a12 * (a11 + a22)
    g11 = a22 * a22 + a12 * a12
    h0 = a11 * dbx + a12 * dby
    h1 = a12 * dbx + a22 * dby
    m = torch.stack([g00, g01, g11, h0, h1], dim=-1)
    return m * _border_factors(h, w, r0.device)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("flow")
    p, i64, i = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.st_flow_update.restype = i
    lib.st_flow_update.argtypes = [p, p, p, p, i64, i, i, i, p]
    return lib


def _check_update(r0, r1, flow, warp_px: int, name: str) -> None:
    """Raises on what ``flow_update`` (and its plain version) do not take."""
    if r0.dim() != 4 or r0.shape[-1] != 5:
        raise ValueError(f"{name}: r0 must be [T, H, W, 5], got "
                         f"{tuple(r0.shape)}")
    t, h, w, _ = r0.shape
    if tuple(r1.shape) != (t, h, w, 5) or tuple(flow.shape) != (t, h, w, 2):
        raise ValueError(f"{name}: r1 {tuple(r1.shape)} and flow "
                         f"{tuple(flow.shape)} do not match r0 "
                         f"{tuple(r0.shape)}")
    for label, x in (("r0", r0), ("r1", r1), ("flow", flow)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: {label} must be float32, got "
                            f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
        if x.device != r0.device:
            raise ValueError(f"{name}: {label} is on {x.device}, r0 on "
                             f"{r0.device}")
    if warp_px < 0:
        raise ValueError(f"{name}: warp_px must be >= 0, got {warp_px}")


def flow_update(r0: torch.Tensor, r1: torch.Tensor, flow: torch.Tensor,
                warp_px: int = 16) -> torch.Tensor:
    """[T,H,W,5] r0, r1 and [T,H,W,2] flow (float32, contiguous, one
    device) -> [T,H,W,5] damped normal equations (see flow_update_plain).
    Launches the CUDA kernel for CUDA tensors; CPU tensors take the plain
    version."""
    _check_update(r0, r1, flow, warp_px, "flow_update")
    if r0.device.type == "cpu":
        return flow_update_plain(r0, r1, flow, warp_px)
    if r0.device.type != "cuda":
        raise ValueError(f"flow_update: unsupported device {r0.device}")
    t, h, w, _ = r0.shape
    out = torch.empty_like(r0)
    if out.numel() == 0:
        return out  # nothing to compute: no launch
    with torch.cuda.device(r0.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().st_flow_update(r0.data_ptr(), r1.data_ptr(),
                                   flow.data_ptr(), out.data_ptr(), t, h, w,
                                   int(warp_px), stream)
    if rc != 0:
        raise RuntimeError(f"flow_update: CUDA launch failed with error {rc}")
    flow_update.launches += 1
    return out


flow_update.launches = 0

# The JAX package's name for this step.
_update_matrices = flow_update


def _box_blur(m: torch.Tensor, win: int) -> torch.Tensor:
    """[T, H, W, C] mean filter over win×win, border replicate, as
    differences of float32 cumulative sums. The sums are not exact and
    ``torch.cumsum`` adds in another order than XLA, so this stage is held
    to the JAX package within a tolerance, not bit for bit."""
    r_lo = win // 2
    r_hi = win - r_lo - 1
    x = _pad(_pad(m, 1, r_lo, r_hi, "edge"), 2, r_lo, r_hi, "edge")

    def box1(a, dim, size, out_len):
        cs = torch.cumsum(a, dim=dim)
        cs = torch.cat([torch.zeros_like(cs.narrow(dim, 0, 1)), cs], dim=dim)
        return cs.narrow(dim, size, out_len) - cs.narrow(dim, 0, out_len)

    s = box1(box1(x, 1, win, m.shape[1]), 2, win, m.shape[2])
    return _div(s, float(win * win))


def _solve_flow(m: torch.Tensor) -> torch.Tensor:
    g00, g01, g11, h0, h1 = m.unbind(-1)
    det = g00 * g11 - g01 * g01
    idet = torch.where(torch.abs(det) > 1e-9, 1.0 / det, 0.0)
    fx = (g11 * h0 - g01 * h1) * idet
    fy = (g00 * h1 - g01 * h0) * idet
    return torch.stack([fx, fy], dim=-1)


# --------------------------------------------------------------- main entry

def farneback_pairs(
    gray0: torch.Tensor,
    gray1: torch.Tensor,
    levels: int = 3,
    pyr_scale: float = 0.5,
    win_size: int = 15,
    iters: int = 3,
    poly_n: int = 5,
    poly_sigma: float = 1.2,
    warp_px: int = 16,
) -> torch.Tensor:
    """gray0/gray1: [T, H, W] float32 in [0,255] -> flow [T, H, W, 2], on
    their device. ``warp_px``: displacement bound of the shift-warp (0 =
    exact bilinear warp; see _shift_warp)."""
    t, H, W = gray0.shape
    # pyramid sizes, coarsest first (k = levels .. 0)
    sizes = []
    for k in range(levels, -1, -1):
        scale = pyr_scale ** k
        sizes.append((max(2, int(round(H * scale))),
                      max(2, int(round(W * scale))), scale))

    flow = None
    for (h, w, scale) in sizes:
        if scale < 1.0:
            sigma = (1.0 / scale - 1.0) * 0.5
            ksize = max(3, int(round(sigma * 5)) | 1)
            gk = _gaussian_kernel1d(sigma, ksize // 2)
            i0 = _resize_bilinear(_sepconv(gray0, gk, gk), h, w)
            i1 = _resize_bilinear(_sepconv(gray1, gk, gk), h, w)
        else:
            i0, i1 = gray0, gray1

        if flow is None:
            flow = torch.zeros((t, h, w, 2), dtype=torch.float32,
                               device=gray0.device)
        else:
            # the JAX package resizes [T, 2, h, w]; the values do not
            # depend on the layout
            flow = resize_hw(flow, 1, h, w, "linear") * (1.0 / pyr_scale)

        r0 = _poly_exp(i0, poly_n, poly_sigma)
        r1 = _poly_exp(i1, poly_n, poly_sigma)
        for _ in range(iters):
            m = _update_matrices(r0, r1, flow, warp_px)
            m = _box_blur(m, win_size)
            flow = _solve_flow(m)
    return flow


@register_op("OpticalFlow", kind="device", stencil=(0, 1), outputs=("flow",),
             compact_sink="out_dtype")
def optical_flow(ctx, frames, levels: int = 3, pyr_scale: float = 0.5,
                 win_size: int = 15, iters: int = 3, poly_n: int = 5,
                 poly_sigma: float = 1.2, warp_px: int = 16,
                 out_dtype: str = "float32"):
    """frames: FrameChunk/[T+1, H, W, 3] u8 (1-frame forward halo) ->
    [T, H, W, 2] flow between consecutive frames. ``warp_px`` bounds
    the shift-warp's displacement (0 = exact bilinear warp).

    ``out_dtype="float16"`` emits half-precision flow: 4× fewer device→host
    readback bytes for store-the-flow-field pipelines. Flow magnitudes are
    O(frame size) pixels, so f16's ~3 significant digits cost <0.1 px — the
    ``flow`` serde upcasts to f32 on load, keeping the reference's H×W×2
    float32 load contract (types.py 'flow')."""
    if isinstance(frames, FrameChunk):
        # i420: converted in the written order, so bit-equal to the JAX
        # package's numpy path; jitted JAX may floor a value differently
        # (ROADMAP queue 3)
        x = frames.hwc_u8()
    else:
        x = torch.as_tensor(frames)
    gray = _rgb2gray_u8(x)[..., 0].to(torch.float32)  # [T+1, H, W]
    flow = farneback_pairs(
        gray[:-1], gray[1:], levels=levels, pyr_scale=pyr_scale,
        win_size=win_size, iters=iters, poly_n=poly_n, poly_sigma=poly_sigma,
        warp_px=warp_px,
    )
    if out_dtype == "float16":
        flow = flow.to(torch.float16)
    elif out_dtype != "float32":
        raise ValueError(f"out_dtype must be float32|float16, got {out_dtype}")
    return flow
