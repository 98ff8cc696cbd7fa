// Per-frame, per-channel 16-bin histograms of decoded frame chunks.
//
// Replaces the JAX package's histogram kernels:
//   st_hist_rgb  <- scannertools_tpu/ops/histogram.py _hist_kernel (the
//                   Pallas kernel launched by _pallas_hist_fn), and the
//                   _histogram_jnp_flat formulations beside it;
//   st_hist_i420 <- the XLA fusion of utils/framechunk.py yuv420_to_rgb
//                   with _histogram_jnp (ops/histogram.py, i420 branch).
//
// Both are bound by device memory: each reads every input byte once and
// does a few integer operations per byte. The least time is the bytes
// read over 3.35 TB/s (H100 SXM data sheet): a 64-frame 1080p chunk is
// 398.1 MB as RGB24 (~0.119 ms) and 199.1 MB as I420 (~0.059 ms).
//
// Design. A block owns a slab of one frame (grid = (slabs, T)). Every
// thread keeps a private histogram in shared memory, laid out code-major
// (counter[code * NT + tid]): a thread increments only its own column, so
// the increments need no atomics, and the 32 lanes of a warp always touch
// 32 different banks whatever the pixel values — flat-colour frames, which
// would send a whole warp to one counter, cost the same as noise. The
// Pallas kernel's packed byte-field counters and 224-row tiles exist only
// because Mosaic has no scatter; they are not carried over. At the end a
// warp reduces each code's column with shuffles, and one global atomicAdd
// per (channel, bin) per block adds it into the output, which the caller
// zeroes. Integer atomics make the sum exact in any order.
//
// The I420 kernel computes the YUV->RGB conversion of yuv420_to_rgb with
// one thread per 2x2 luma block (the four samples share one U and one V),
// in float32 with every product and sum rounded separately, in the order
// written there (__fmul_rn/__fadd_rn/__fsub_rn are never contracted into
// FMAs), so its bins equal numpy's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 16;
constexpr int kThreads = 128;
// RGB: bytes per block; a multiple of kThreads * 16.
constexpr int64_t kRgbSlab = int64_t(kThreads) * 16 * 64;
// I420: chroma samples (2x2 luma blocks) per block.
constexpr int kI420Slab = kThreads * 32;
// Codes (channel * 16 + bin) a block can hold: channels <= 6 keeps the
// private histograms within the 48 KB of shared memory a block gets
// without opting in (6 * 16 * 128 * 4 bytes).
constexpr int kMaxChannels = 6;

__device__ __forceinline__ void zero_counts(uint32_t* cnt, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) cnt[i] = 0;
}

// One warp per code: sum the code's column, one atomicAdd into out.
__device__ __forceinline__ void flush_counts(const uint32_t* cnt, int codes,
                                             int32_t* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int code = warp; code < codes; code += kThreads / 32) {
    uint32_t s = 0;
    for (int i = lane; i < kThreads; i += 32) s += cnt[code * kThreads + i];
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0 && s) atomicAdd(out + code, static_cast<int32_t>(s));
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
hist_rgb_kernel(const uint8_t* __restrict__ x, int64_t stride, int64_t npix,
                int c, int32_t* __restrict__ out) {
  extern __shared__ uint32_t cnt[];
  const int codes = c * kBins;
  const int tid = threadIdx.x;
  zero_counts(cnt, codes * kThreads);
  __syncthreads();

  const uint8_t* f = x + int64_t(blockIdx.y) * stride;
  const int64_t lo = int64_t(blockIdx.x) * kRgbSlab;
  const int64_t hi = lo + kRgbSlab < npix ? lo + kRgbSlab : npix;
  uint32_t* mine = cnt + tid;
  for (int64_t i = lo + int64_t(tid) * 16; i < hi; i += kThreads * 16) {
    uint32_t word[4];
    if (kVec) {
      const uint4 v = *reinterpret_cast<const uint4*>(f + i);
      word[0] = v.x; word[1] = v.y; word[2] = v.z; word[3] = v.w;
    } else {
      // unaligned rows: byte loads, none past the end of the frame
      for (int k = 0; k < 4; ++k) {
        uint32_t w = 0;
        for (int b = 0; b < 4; ++b) {
          const int64_t j = i + 4 * k + b;
          if (j < npix) w |= uint32_t(f[j]) << (8 * b);
        }
        word[k] = w;
      }
    }
    int ch = static_cast<int>(i % c);
    const int valid = hi - i < 16 ? static_cast<int>(hi - i) : 16;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (k < valid) {
        const uint32_t bin = (word[k >> 2] >> (8 * (k & 3) + 4)) & 0xF;
        mine[(ch * kBins + bin) * kThreads] += 1;
      }
      ch = (ch + 1 == c) ? 0 : ch + 1;
    }
  }
  __syncthreads();
  flush_counts(cnt, codes, out + int64_t(blockIdx.y) * codes);
}

struct YuvCoefs {
  float ys, yo, rv, gu, gv, bu;
};

__device__ __forceinline__ uint32_t bin_of(float v) {
  v = fminf(fmaxf(floorf(v), 0.0f), 255.0f);
  return static_cast<uint32_t>(v) >> 4;
}

__device__ __forceinline__ void count_luma(uint32_t* mine, uint8_t yb,
                                           const YuvCoefs& k, float rve,
                                           float gud, float gve, float bud) {
  const float yy = __fmul_rn(__fsub_rn(float(yb), k.yo), k.ys);
  const float r = __fadd_rn(yy, rve);
  const float g = __fsub_rn(__fsub_rn(yy, gud), gve);
  const float b = __fadd_rn(yy, bud);
  mine[(0 * kBins + bin_of(r)) * kThreads] += 1;
  mine[(1 * kBins + bin_of(g)) * kThreads] += 1;
  mine[(2 * kBins + bin_of(b)) * kThreads] += 1;
}

__global__ void __launch_bounds__(kThreads)
hist_i420_kernel(const uint8_t* __restrict__ x, int64_t stride, int h, int w,
                 YuvCoefs k, int32_t* __restrict__ out) {
  __shared__ uint32_t cnt[3 * kBins * kThreads];
  const int tid = threadIdx.x;
  zero_counts(cnt, 3 * kBins * kThreads);
  __syncthreads();

  const int cw = w / 2;
  const int n = (h / 2) * cw;
  const uint8_t* yp = x + int64_t(blockIdx.y) * stride;
  const uint8_t* up = yp + int64_t(h) * w;
  const uint8_t* vp = up + n;
  const int lo = blockIdx.x * kI420Slab;
  const int hi = lo + kI420Slab < n ? lo + kI420Slab : n;
  uint32_t* mine = cnt + tid;
  for (int s = lo + tid; s < hi; s += kThreads) {
    const int by = s / cw;
    const int bx = s - by * cw;
    const float d = __fsub_rn(float(up[s]), 128.0f);
    const float e = __fsub_rn(float(vp[s]), 128.0f);
    const float rve = __fmul_rn(k.rv, e);
    const float gud = __fmul_rn(k.gu, d);
    const float gve = __fmul_rn(k.gv, e);
    const float bud = __fmul_rn(k.bu, d);
    // w is even and a frame starts 128-byte aligned: 2-byte loads align
    const uint8_t* row0 = yp + int64_t(2 * by) * w + 2 * bx;
    const uchar2 a = *reinterpret_cast<const uchar2*>(row0);
    const uchar2 b = *reinterpret_cast<const uchar2*>(row0 + w);
    count_luma(mine, a.x, k, rve, gud, gve, bud);
    count_luma(mine, a.y, k, rve, gud, gve, bud);
    count_luma(mine, b.x, k, rve, gud, gve, bud);
    count_luma(mine, b.y, k, rve, gud, gve, bud);
  }
  __syncthreads();
  flush_counts(cnt, 3 * kBins, out + int64_t(blockIdx.y) * 3 * kBins);
}

}  // namespace

extern "C" {

// x: [t, stride] u8 on the device; out: [t, c, 16] int32, zeroed by the
// caller. vec != 0 promises x and stride are 16-byte aligned. Returns the
// cudaError_t of the launch.
int st_hist_rgb(const uint8_t* x, int64_t t, int64_t stride, int64_t npix,
                int c, int vec, int32_t* out, cudaStream_t stream) {
  if (t <= 0 || npix <= 0) return cudaSuccess;
  if (c < 1 || c > kMaxChannels || t > 65535 || npix > stride)
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>((npix + kRgbSlab - 1) / kRgbSlab),
                  static_cast<unsigned>(t));
  const size_t smem = size_t(c) * kBins * kThreads * sizeof(uint32_t);
  if (vec)
    hist_rgb_kernel<true><<<grid, kThreads, smem, stream>>>(x, stride, npix,
                                                            c, out);
  else
    hist_rgb_kernel<false><<<grid, kThreads, smem, stream>>>(x, stride, npix,
                                                             c, out);
  return cudaGetLastError();
}

// x: [t, stride] u8 on the device, each row Y (h*w) then U then V
// ((h/2)*(w/2) each); out: [t, 3, 16] int32, zeroed by the caller;
// coefs: host pointer to (ys, yo, rv, gu, gv, bu).
int st_hist_i420(const uint8_t* x, int64_t t, int64_t stride, int h, int w,
                 const float* coefs, int32_t* out, cudaStream_t stream) {
  if (t <= 0 || h <= 0 || w <= 0) return cudaSuccess;
  if ((h & 1) || (w & 1) || t > 65535 ||
      int64_t(h) * w * 3 / 2 > stride)
    return cudaErrorInvalidValue;
  const YuvCoefs k{coefs[0], coefs[1], coefs[2], coefs[3], coefs[4],
                   coefs[5]};
  const int n = (h / 2) * (w / 2);
  const dim3 grid(static_cast<unsigned>((n + kI420Slab - 1) / kI420Slab),
                  static_cast<unsigned>(t));
  hist_i420_kernel<<<grid, kThreads, 0, stream>>>(x, stride, h, w, k, out);
  return cudaGetLastError();
}

}  // extern "C"
