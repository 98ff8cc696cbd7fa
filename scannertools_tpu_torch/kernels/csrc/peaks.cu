// Peak finding in OpenPose's body heat maps: the 3x3 local maxima above a
// threshold, and the top MAX_PEAKS of each part's map.
//
// Replaces the JAX package's find_peaks
// (scannertools_tpu/models/pose.py:363-382), which XLA computes per frame
// as a padded stencil (eight >= tests against neighbours, -1 outside the
// map), a where, and lax.top_k over each part's flattened map: the whole
// [18, H * W] score array is written, then sorted in part.
//
// Inputs: heat [T, C, H, W] float32 (NCHW, C >= 18: the parts are the
// first 18 channels; a part's H * W pixels are contiguous, in the order
// JAX's transpose(2, 0, 1) flattens them). Outputs: peaks [T, 18, 24, 3]
// float32 (x, y, score) and valid [T, 18, 24] bool (score > 0).
//
// The function, exactly: a pixel is a peak when it is >= each of its 8
// neighbours (-1.0 outside the map) and > 0.1f; its score is its value,
// any other pixel's -1.0. The 24 slots are top_k's: scores descending,
// equal scores by flat index y * W + x ascending. With fewer than 24
// peaks, the rest are the lowest flat indices that are not peaks, each
// with score -1.0 (all non-peaks tie at -1.0).
//
// What bounds it: it reads the 18 part maps once (177 MB for an 8-frame
// 480x640 chunk) and writes 3.5 KB a frame; a pixel costs a compare
// unless it clears the threshold, and then eight neighbour loads from L1.
// Bytes bound it. The design is the first right one:
//
//  * one block of 512 threads per (frame, part); each thread walks the
//    map's pixels in a stride of the block, four loads in flight, in
//    increasing index order;
//  * each thread keeps its own best 24 peaks in registers, as 64-bit keys
//    (the value's float bits above the complement of the index: values
//    above the threshold are positive, so the larger key is the larger
//    value, then the lower index), sorted, inserted by an unrolled bubble
//    (no dynamic register index, so no local memory). Any of the block's
//    top 24 is among its thread's top 24;
//  * the block then takes the largest head 24 times (a warp shuffle and a
//    pass over the warps' maxima), and the winning thread pops its head.
//    A round that finds no key ends the merge: n peaks, n < 24, and they
//    are then all of the map's peaks, so one thread fills slots n..23
//    with the lowest indices that are not among them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace stpeaks {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr int kParts = 18;
constexpr int kMaxPeaks = 24;
constexpr float kThre = 0.1f;  // THRE_PEAK, as float32

using Key = unsigned long long;  // 0: no peak

__device__ __forceinline__ Key key_of(float v, int idx) {
  return (static_cast<Key>(__float_as_uint(v)) << 32) |
         static_cast<uint32_t>(~idx);
}

__device__ __forceinline__ Key kmax(Key a, Key b) { return a > b ? a : b; }

// Whether pixel i = (y, x) of `map` with value v is a peak.
__device__ __forceinline__ bool is_peak(const float* map, int h, int w,
                                        int i, float v) {
  if (!(v > kThre)) return false;
  const int y = i / w;
  const int x = i - y * w;
  bool peak = true;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      if (dy == 0 && dx == 0) continue;
      const int yy = y + dy, xx = x + dx;
      const float nb = (yy >= 0 && yy < h && xx >= 0 && xx < w)
                           ? __ldg(map + yy * w + xx)
                           : -1.f;
      peak &= v >= nb;
    }
  return peak;
}

__global__ void __launch_bounds__(kThreads) pose_peaks(
    const float* __restrict__ heat, int c, int h, int w,
    float* __restrict__ peaks, bool* __restrict__ valid) {
  __shared__ Key warp_best[kWarps];
  __shared__ int sidx[kMaxPeaks];
  __shared__ float sval[kMaxPeaks];
  const int part = blockIdx.x % kParts;
  const int frame = blockIdx.x / kParts;
  const float* map = heat + (static_cast<int64_t>(frame) * c + part) *
                                static_cast<int64_t>(h) * w;
  const int n = h * w;

  Key top[kMaxPeaks];
#pragma unroll
  for (int k = 0; k < kMaxPeaks; ++k) top[k] = 0;
  for (int base = threadIdx.x; base < n; base += kThreads * kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads;
      v[u] = i < n ? __ldg(map + i) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = base + u * kThreads;
      if (i >= n || !is_peak(map, h, w, i, v[u])) continue;
      Key key = key_of(v[u], i);
      if (key <= top[kMaxPeaks - 1]) continue;
#pragma unroll
      for (int k = 0; k < kMaxPeaks; ++k)
        if (key > top[k]) {
          const Key t = top[k];
          top[k] = key;
          key = t;
        }
    }
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int found = 0;
  for (; found < kMaxPeaks; ++found) {
    Key best = top[0];
#pragma unroll
    for (int off = 16; off; off >>= 1)
      best = kmax(best, __shfl_xor_sync(0xffffffffu, best, off));
    if (lane == 0) warp_best[warp] = best;
    __syncthreads();
    best = warp_best[0];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) best = kmax(best, warp_best[q]);
    __syncthreads();
    if (best == 0) break;  // the same in every thread
    if (threadIdx.x == 0) {
      sidx[found] = static_cast<int>(~static_cast<uint32_t>(best));
      sval[found] = __uint_as_float(static_cast<uint32_t>(best >> 32));
    }
    if (top[0] == best) {  // keys are unique: one thread pops
#pragma unroll
      for (int k = 0; k + 1 < kMaxPeaks; ++k) top[k] = top[k + 1];
      top[kMaxPeaks - 1] = 0;
    }
  }
  if (threadIdx.x == 0) {
    int idx = 0;
    for (int r = found; r < kMaxPeaks; ++r) {
      for (;;) {
        bool taken = false;
        for (int q = 0; q < found; ++q) taken |= sidx[q] == idx;
        if (!taken) break;
        ++idx;
      }
      sidx[r] = idx++;
      sval[r] = -1.f;
    }
  }
  __syncthreads();
  if (threadIdx.x < kMaxPeaks) {
    const int r = threadIdx.x;
    const int64_t slot = static_cast<int64_t>(blockIdx.x) * kMaxPeaks + r;
    const int i = sidx[r];
    const int y = i / w;
    peaks[slot * 3 + 0] = static_cast<float>(i - y * w);
    peaks[slot * 3 + 1] = static_cast<float>(y);
    peaks[slot * 3 + 2] = sval[r];
    valid[slot] = sval[r] > 0.f;
  }
}

}  // namespace stpeaks

// heat [t, c, h, w] float32 (c >= 18, 24 <= h * w < 2^31), peaks
// [t, 18, 24, 3] float32, valid [t, 18, 24] bool. One block a (frame,
// part). Launches on `stream`; returns a cudaError_t (0 = ok).
extern "C" int st_pose_peaks(const float* heat, int t, int c, int h, int w,
                             float* peaks, bool* valid, void* stream) {
  using namespace stpeaks;
  if (t <= 0) return 0;
  const int64_t n = static_cast<int64_t>(h) * w;
  if (c < kParts || h < 1 || w < 1 || n < kMaxPeaks || n > 0x7fffffff ||
      static_cast<int64_t>(t) * kParts > 0x7fffffff)
    return cudaErrorInvalidValue;
  pose_peaks<<<static_cast<unsigned>(t * kParts), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(heat, c, h, w, peaks,
                                                     valid);
  return static_cast<int>(cudaGetLastError());
}
