// Farnebäck flow update: warp, normal equations and border damping in one
// pass over the pixels.
//
// Replaces the JAX package's _update_matrices
// (scannertools_tpu/ops/optical_flow.py:244-285) together with the warp it
// calls: _shift_warp (:113-169) for warp_px > 0 and _bilinear_sample
// (:75-110) for warp_px == 0. st_flow_update is launched (levels + 1) *
// iters times per chunk, 12 at the defaults.
//
// Inputs, float32, contiguous: r0, r1 [T, h, w, 5] (bx, by, axx, ayy, axy
// of the two frames' polynomial expansions) and flow [T, h, w, 2] (x, y).
// Output [T, h, w, 5]: G00, G01, G11, h0, h1 per pixel, times the border
// factor sy * sx.
//
// On the TPU a gather index costs about ten cycles, so the JAX package
// warps by 2 * (2R + 1) select-weighted passes over shifted copies of the
// whole coefficient field (R = warp_px = 16: 66 passes per warp). On this
// card a gather is a cached load: one thread per output pixel reads r0 and
// the flow at its pixel, computes the few r1 values it needs, forms the
// equations and writes them. Each input is read about once, so bytes bound
// the kernel: r0 20 B + r1 20 B + flow 8 B + out 20 B = 68 B per pixel,
// 0.67 GB for a 32-pair 640x480 level (0.20 ms at 3.35 TB/s), against
// about 110 float32 operations per pixel (0.02 ms at 67 TFLOP/s). The
// neighbouring threads of a warp read neighbouring 20-byte rows, so the
// loads coalesce and the r1 rows a thread takes from the rows around its
// own mostly hit in L1 and L2.
//
// Shift-warp semantics (warp_px > 0), exactly as _shift_warp computes them
// and not the exact bilinear warp: with ry = min(warp_px, h - 1),
// fy = clip(y + flow_y, 0, h - 1), y0 = floor(fy), wy = fy - y0 and
// dy = clamp(y0 - y, -ry, ry - 1), the y-pass value at (y, x') is
// (1 - wy) * r1[clamp(y + dy), x'] + wy * r1[clamp(y + dy + 1), x'], with
// dy and wy those of (y, x'). The x-pass lerps that value at columns
// clamp(x + dx) and clamp(x + dx + 1) of the same row y, with dx and wx
// those of (y, x). A thread recomputes the y-pass value at its two columns
// from the flow there, so no intermediate array is written. Every other
// shift of the JAX loop has weight 0 and adds an exact zero.
//
// Numerics. Every expression is evaluated in the order the JAX package
// writes it, each product and sum rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn: nvcc would otherwise contract a product and a sum
// into one FMA), so the kernel equals flow_update_plain, built from
// PyTorch's elementwise operations, bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace stflow {

constexpr int kThreads = 256;
constexpr int kC = 5;          // coefficients per pixel
// 1 / BORDER (ops/optical_flow.py): jitted XLA divides by a constant as a
// product with its float32 reciprocal, and so does the plain version.
constexpr float kInvBorder = 1.f / 5.f;

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}
// jnp.clip(v, 0, hi)
__device__ __forceinline__ float clip0(float v, float hi) {
  return fminf(fmaxf(v, 0.f), hi);
}

// clip((min(i, n - 1 - i) + 0.5) / BORDER, 0, 1)
__device__ __forceinline__ float border(int i, int n) {
  const float d = fminf(static_cast<float>(i), static_cast<float>(n - 1 - i));
  return clip0(mul(add(d, 0.5f), kInvBorder), 1.f);
}

// The shift-warp's y-pass value at (y, c): five coefficients into a.
__device__ __forceinline__ void y_pass(const float* __restrict__ r1f,
                                       const float* __restrict__ ff, int y,
                                       int c, int h, int w, int ry,
                                       float* a) {
  const float fy = clip0(add(static_cast<float>(y),
                             __ldg(ff + (static_cast<int64_t>(y) * w + c) * 2
                                   + 1)),
                         static_cast<float>(h - 1));
  const float y0 = floorf(fy);
  const float wy = sub(fy, y0);
  const float uy = sub(1.f, wy);
  const int dy = clampi(static_cast<int>(sub(y0, static_cast<float>(y))),
                        -ry, ry - 1);
  const float* ra = r1f + (static_cast<int64_t>(clampi(y + dy, 0, h - 1))
                           * w + c) * kC;
  const float* rb = r1f + (static_cast<int64_t>(clampi(y + dy + 1, 0, h - 1))
                           * w + c) * kC;
#pragma unroll
  for (int k = 0; k < kC; ++k) {
    a[k] = add(mul(uy, __ldg(ra + k)), mul(wy, __ldg(rb + k)));
  }
}

__global__ void __launch_bounds__(kThreads) flow_update_kernel(
    const float* __restrict__ r0, const float* __restrict__ r1,
    const float* __restrict__ flow, float* __restrict__ out, int64_t n,
    int h, int w, int warp_px) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= n) return;
  const int x = static_cast<int>(p % w);
  const int64_t row = p / w;  // frame * h + y
  const int y = static_cast<int>(row % h);
  const int64_t first = (row - y) * w;  // first pixel of this frame
  const float* r1f = r1 + first * kC;
  const float* ff = flow + first * 2;
  const float f0 = __ldg(flow + p * 2);
  const float f1 = __ldg(flow + p * 2 + 1);
  const float wm1 = static_cast<float>(w - 1);

  float r1w[kC];
  if (warp_px > 0) {
    const int ry = min(warp_px, h - 1);
    const int rx = min(warp_px, w - 1);
    const float fx = clip0(add(static_cast<float>(x), f0), wm1);
    const float x0 = floorf(fx);
    const float wx = sub(fx, x0);
    const float ux = sub(1.f, wx);
    const int dx = clampi(static_cast<int>(sub(x0, static_cast<float>(x))),
                          -rx, rx - 1);
    float a0[kC], a1[kC];
    y_pass(r1f, ff, y, clampi(x + dx, 0, w - 1), h, w, ry, a0);
    y_pass(r1f, ff, y, clampi(x + dx + 1, 0, w - 1), h, w, ry, a1);
#pragma unroll
    for (int k = 0; k < kC; ++k) r1w[k] = add(mul(ux, a0[k]), mul(wx, a1[k]));
  } else {
    const float fy = clip0(add(static_cast<float>(y), f1),
                           static_cast<float>(h - 1));
    const float fx = clip0(add(static_cast<float>(x), f0), wm1);
    const float y0f = floorf(fy);
    const float x0f = floorf(fx);
    const float wy = sub(fy, y0f);
    const float wx = sub(fx, x0f);
    const float uy = sub(1.f, wy);
    const float ux = sub(1.f, wx);
    const int y0 = static_cast<int>(y0f);
    const int x0 = static_cast<int>(x0f);
    const int y1 = min(y0 + 1, h - 1);
    const int x1 = min(x0 + 1, w - 1);
    const float* v00 = r1f + (static_cast<int64_t>(y0) * w + x0) * kC;
    const float* v01 = r1f + (static_cast<int64_t>(y0) * w + x1) * kC;
    const float* v10 = r1f + (static_cast<int64_t>(y1) * w + x0) * kC;
    const float* v11 = r1f + (static_cast<int64_t>(y1) * w + x1) * kC;
#pragma unroll
    for (int k = 0; k < kC; ++k) {
      const float top = add(mul(__ldg(v00 + k), ux), mul(__ldg(v01 + k), wx));
      const float bot = add(mul(__ldg(v10 + k), ux), mul(__ldg(v11 + k), wx));
      r1w[k] = add(mul(top, uy), mul(bot, wy));
    }
  }

  const float* q = r0 + p * kC;
  const float a11 = mul(add(__ldg(q + 2), r1w[2]), 0.5f);
  const float a22 = mul(add(__ldg(q + 3), r1w[3]), 0.5f);
  const float a12 = mul(add(__ldg(q + 4), r1w[4]), 0.25f);
  const float dbx = add(add(mul(-sub(r1w[0], __ldg(q)), 0.5f), mul(a11, f0)),
                        mul(a12, f1));
  const float dby = add(add(mul(-sub(r1w[1], __ldg(q + 1)), 0.5f),
                            mul(a12, f0)),
                        mul(a22, f1));
  const float s = mul(border(y, h), border(x, w));
  float* o = out + p * kC;
  o[0] = mul(add(mul(a11, a11), mul(a12, a12)), s);  // G00
  o[1] = mul(mul(a12, add(a11, a22)), s);            // G01
  o[2] = mul(add(mul(a22, a22), mul(a12, a12)), s);  // G11
  o[3] = mul(add(mul(a11, dbx), mul(a12, dby)), s);  // h0
  o[4] = mul(add(mul(a12, dbx), mul(a22, dby)), s);  // h1
}

}  // namespace stflow

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int st_flow_update(const float* r0, const float* r1,
                              const float* flow, float* out, int64_t t,
                              int h, int w, int warp_px, void* stream) {
  const int64_t n = t * h * w;
  if (n <= 0) return 0;
  const int64_t blocks = (n + stflow::kThreads - 1) / stflow::kThreads;
  stflow::flow_update_kernel<<<static_cast<unsigned>(blocks),
                               stflow::kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      r0, r1, flow, out, n, h, w, warp_px);
  return static_cast<int>(cudaGetLastError());
}
