// Bilinear crop-and-resize of boxes from a batch of frames.
//
// Replaces the JAX package's crop_and_resize
// (scannertools_tpu/models/common.py:105-143). On the TPU a gather index
// costs about ten cycles, so the JAX package builds, for each crop, dense
// hat matrices Ry [oh, H] and Rx [ow, W] with R[i, y] = max(0, 1 - |s_i -
// y|) and contracts them with the whole frame in two float32 einsums:
// (oh * H + ow * W) weights per crop, all but two per row zero. On this
// card a gather is a cached load: one thread per output pixel of one crop
// computes its sample position, reads the only two nonzero taps of each
// hat row, floor(s) and floor(s) + 1, and writes all C channels.
//
// Inputs: images [T, H, W, C] float32, boxes [B, 4] pixel (x1, y1, x2, y2)
// float32, frame_idx [B] int64 (the frame each box is cut from, in [0, T):
// one launch serves MTCNN's per-frame crops and a chunk-wide compaction;
// an index outside it stops the kernel with a trap, which the next
// synchronisation reports as a CUDA error, before anything is read).
// Output [B, oh, ow, C] float32.
//
// Sample positions, as the JAX package writes them: ys = y1 + clip((y2 -
// y1) * (i + 0.5) / oh - 0.5, 0, max(y2 - y1 - 1, 0)), then clip(ys, 0, H -
// 1); the same for x. The first clip holds the taps inside the crop
// window (the host path's cv2.resize of the cropped pixels replicates the
// crop's border), the second inside the frame. A degenerate box (x2 <= x1)
// samples its x1 column, as the JAX hat matrices do. The division by the
// constant oh is a product with its float32 reciprocal, as under jax.jit
// (XLA rewrites x / c so; imgproc._div).
//
// What bounds it: each output value is written once (4 B) and reads four
// taps, mostly from L1/L2 (neighbouring threads read neighbouring columns),
// and the taps of a crop lie in its box: the bytes are about the output's,
// at 8 float32 operations per value. Bytes bound it.
//
// Numerics: the y-pass first, t = wy0 * img[y0] + wy1 * img[y1] at the two
// columns, then the x-pass, wx0 * t0 + wx1 * t1, as the two einsums
// contract (their other terms are exact zeros). Each product and sum is
// rounded on its own (__fmul_rn, __fadd_rn: no FMA), so the kernel equals
// crop_and_resize_plain bit for bit. XLA's einsum may contract a product
// and the sum into an FMA, so the JAX package is held within a tolerance.

#include <cuda_runtime.h>
#include <stdint.h>

namespace stcrop {

constexpr int kThreads = 256;

struct Taps {
  int i0, i1;    // the two source rows (or columns), i1 clamped to the edge
  float w0, w1;  // their hat weights; w1 is 0 where i1 was clamped
};

// The two nonzero taps of output position `o` of `n_out` along an axis of
// `size` source pixels, for the box side [lo, hi).
__device__ __forceinline__ Taps taps(float lo, float hi, int o, float inv_n,
                                     int size) {
  const float d = __fsub_rn(hi, lo);
  const float p = __fadd_rn(static_cast<float>(o), 0.5f);
  const float v = __fsub_rn(__fmul_rn(__fmul_rn(d, p), inv_n), 0.5f);
  const float top = fmaxf(__fsub_rn(d, 1.f), 0.f);
  float s = __fadd_rn(lo, fminf(fmaxf(v, 0.f), top));
  s = fminf(fmaxf(s, 0.f), static_cast<float>(size - 1));
  const float f0 = floorf(s);
  const float f1 = __fadd_rn(f0, 1.f);
  Taps t;
  t.i0 = static_cast<int>(f0);
  t.i1 = min(t.i0 + 1, size - 1);
  t.w0 = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(s, f0))));
  t.w1 = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(s, f1))));
  return t;
}

__global__ void __launch_bounds__(kThreads) crop_resize_kernel(
    const float* __restrict__ images, int t, int h, int w, int c,
    const float* __restrict__ boxes, const int64_t* __restrict__ frame_idx,
    int64_t n, int oh, int ow, float inv_oh, float inv_ow,
    float* __restrict__ out) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (p >= n) return;
  const int x = static_cast<int>(p % ow);
  const int64_t r = p / ow;
  const int y = static_cast<int>(r % oh);
  const int64_t b = r / oh;
  const int64_t f = frame_idx[b];
  if (f < 0 || f >= t) __trap();
  const float4 box = reinterpret_cast<const float4*>(boxes)[b];
  const Taps ty = taps(box.y, box.w, y, inv_oh, h);
  const Taps tx = taps(box.x, box.z, x, inv_ow, w);
  const float* img = images + f * h * w * c;
  const float* r0 = img + static_cast<int64_t>(ty.i0) * w * c;
  const float* r1 = img + static_cast<int64_t>(ty.i1) * w * c;
  const int64_t c0 = static_cast<int64_t>(tx.i0) * c;
  const int64_t c1 = static_cast<int64_t>(tx.i1) * c;
  float* o = out + p * c;
  for (int ch = 0; ch < c; ++ch) {
    const float t0 = __fadd_rn(__fmul_rn(ty.w0, __ldg(r0 + c0 + ch)),
                               __fmul_rn(ty.w1, __ldg(r1 + c0 + ch)));
    const float t1 = __fadd_rn(__fmul_rn(ty.w0, __ldg(r0 + c1 + ch)),
                               __fmul_rn(ty.w1, __ldg(r1 + c1 + ch)));
    o[ch] = __fadd_rn(__fmul_rn(tx.w0, t0), __fmul_rn(tx.w1, t1));
  }
}

}  // namespace stcrop

// images [t, h, w, c], boxes [b, 4] (16-byte aligned), frame_idx [b] int64,
// out [b, oh, ow, c]. inv_oh and inv_ow are the float32 reciprocals of oh
// and ow. Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int st_crop_resize(const float* images, int t, int h, int w,
                              int c, const float* boxes,
                              const int64_t* frame_idx, int64_t b, int oh,
                              int ow, float inv_oh, float inv_ow, float* out,
                              void* stream) {
  const int64_t n = b * oh * ow;
  if (n <= 0) return 0;
  const int64_t blocks = (n + stcrop::kThreads - 1) / stcrop::kThreads;
  stcrop::crop_resize_kernel<<<static_cast<unsigned>(blocks),
                               stcrop::kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      images, t, h, w, c, boxes, frame_idx, n, oh, ow, inv_oh, inv_ow, out);
  return static_cast<int>(cudaGetLastError());
}
