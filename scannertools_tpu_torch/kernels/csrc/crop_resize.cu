// Bilinear crop-and-resize of boxes from a batch of frames.
//
// Replaces the JAX package's crop_and_resize
// (scannertools_tpu/models/common.py:105-143). On the TPU a gather index
// costs about ten cycles, so the JAX package builds, for each crop, dense
// hat matrices Ry [oh, H] and Rx [ow, W] with R[i, y] = max(0, 1 - |s_i -
// y|) and contracts them with the whole frame in two float32 einsums:
// (oh * H + ow * W) weights per crop, all but two per row zero. On this
// card a gather is a cached load: each output value reads the only two
// nonzero taps of each hat row, floor(s) and floor(s) + 1.
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
// taps, mostly from L1 (neighbouring lanes read neighbouring columns), and
// the taps of a crop lie in its box: the bytes are about the output's, at 8
// float32 operations per value. Bytes bound it, the writes above all. The
// first design (one thread an output pixel) spent its time elsewhere: four
// 64-bit divisions a pixel, the box and both axes' taps (about 25
// operations and a floor) recomputed by every pixel, and C serial values a
// thread, stored as 12-byte strided scalars for C = 3. This one:
//
//  * one block of 256 threads per (box, band of output rows); one thread
//    loads the box and the frame index (and traps on a bad index), and the
//    block computes the ow column taps and the band's row taps once into
//    shared memory, with the tap offsets premultiplied by their strides.
//    Index arithmetic inside a crop is 32-bit (the wrapper checks that
//    H * W * C and oh * ow * C fit).
//  * crop_rows, for C of 1-4 (the face path) and any C that is not a
//    multiple of 4: a warp takes an output row, whose ow * C values are
//    contiguous, and its lanes run over them four at a time: 16-byte
//    streaming stores from the first 16-byte boundary of the row, scalar
//    stores at its ragged ends (227 * 3 values a row leave most rows of the
//    gender crops unaligned).
//  * crop_pixels, for C a multiple of 4 above 4 (the FPN maps of the
//    detection models, C = 256): lanes run over the channels as float4, a
//    warp's lanes split into groups of min(32, C / 4) rounded up to a power
//    of two, one output pixel a group, so the reads of the four source
//    taps and the stores are coalesced 16-byte accesses.
//
// Numerics: the y-pass first, t = wy0 * img[y0] + wy1 * img[y1] at the two
// columns, then the x-pass, wx0 * t0 + wx1 * t1, as the two einsums
// contract (their other terms are exact zeros). Each product and sum is
// rounded on its own (__fmul_rn, __fadd_rn: no FMA), so the kernel equals
// crop_and_resize_plain bit for bit. XLA's einsum may contract a product
// and the sum into an FMA, so the JAX package is held within a tolerance.
//
// A box may also carry its own map (st_crop_resize_levels): Mask R-CNN's
// RoIAlign crops each RoI from the FPN level P2..P5 that the canonical
// heuristic assigns it. The JAX package (roi_align_multilevel,
// scannertools_tpu/models/maskrcnn.py:223-238) crops every RoI from all four
// levels and keeps one through a one-hot sum, four times the taps; here the
// box's thread loads its level with its frame index (and traps on a level
// outside [0, levels) as on a bad frame), takes that level's map, height
// and width, and scales the box by the level's 1 / stride, a power of two,
// so the product is exact (the JAX package's boxes / stride). The rest of
// the block is the one-map crop's. Its values equal the one-hot sum (0 * x
// + y == y for finite x), though the sign of a zero may differ.

#include <cuda_runtime.h>
#include <stdint.h>

namespace stcrop {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBandRows = 16;
constexpr int kMaxOw = 2048;
constexpr int kMaxLevels = 4;
// 1 / 255 in float32: the gray mode's division, as under jax.jit
constexpr float kInv255 = 1.f / 255.f;

// The maps of a launch: one for st_crop_resize, one per FPN level for
// st_crop_resize_levels, each [t, h, w, c] with the reciprocal of its
// stride (1 for the one-map crop).
struct Maps {
  const float* img[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float inv_stride[kMaxLevels];
  int levels;
};

struct Taps {
  int i0, i1;    // the two source offsets (rows or columns times their
                 // stride), i1 clamped to the edge
  float w0, w1;  // their hat weights; w1 is 0 where i1 was clamped
};

// The two nonzero taps of output position `o` of `n_out` along an axis of
// `size` source pixels, for the box side [lo, hi); offsets times `stride`.
// kGray: the position is not clamped to [0, size - 1]; a tap outside the
// axis gets weight 0 and its offset clamped to the edge.
template <bool kGray>
__device__ __forceinline__ Taps taps(float lo, float hi, int o, float inv_n,
                                     int size, int stride) {
  const float d = __fsub_rn(hi, lo);
  const float p = __fadd_rn(static_cast<float>(o), 0.5f);
  const float v = __fsub_rn(__fmul_rn(__fmul_rn(d, p), inv_n), 0.5f);
  const float top = fmaxf(__fsub_rn(d, 1.f), 0.f);
  float s = __fadd_rn(lo, fminf(fmaxf(v, 0.f), top));
  const float last = static_cast<float>(size - 1);
  if constexpr (!kGray) s = fminf(fmaxf(s, 0.f), last);
  const float f0 = floorf(s);
  const float f1 = __fadd_rn(f0, 1.f);
  Taps t;
  t.w0 = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(s, f0))));
  t.w1 = fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(s, f1))));
  if constexpr (kGray) {
    if (!(f0 >= 0.f && f0 <= last)) t.w0 = 0.f;
    if (!(f1 >= 0.f && f1 <= last)) t.w1 = 0.f;
    t.i0 = static_cast<int>(fminf(fmaxf(f0, 0.f), last)) * stride;
    t.i1 = static_cast<int>(fminf(fmaxf(f1, 0.f), last)) * stride;
  } else {
    const int i0 = static_cast<int>(f0);
    t.i0 = i0 * stride;
    t.i1 = min(i0 + 1, size - 1) * stride;
  }
  return t;
}

// The gray mode's border and scale of one value (else the value).
template <bool kGray>
__device__ __forceinline__ float finish(float v, const Taps& ty,
                                        const Taps& tx) {
  if constexpr (!kGray) return v;
  const float cov = __fmul_rn(__fadd_rn(ty.w0, ty.w1),
                              __fadd_rn(tx.w0, tx.w1));
  v = __fadd_rn(v, __fmul_rn(__fsub_rn(1.f, cov), 128.f));
  return __fsub_rn(__fmul_rn(v, kInv255), 0.5f);
}

// One output value: the y-pass at the two columns, then the x-pass.
__device__ __forceinline__ float lerp(const float* r0, const float* r1,
                                      const Taps& ty, const Taps& tx,
                                      int ch) {
  const float t0 = __fadd_rn(__fmul_rn(ty.w0, __ldg(r0 + tx.i0 + ch)),
                             __fmul_rn(ty.w1, __ldg(r1 + tx.i0 + ch)));
  const float t1 = __fadd_rn(__fmul_rn(ty.w0, __ldg(r0 + tx.i1 + ch)),
                             __fmul_rn(ty.w1, __ldg(r1 + tx.i1 + ch)));
  return __fadd_rn(__fmul_rn(tx.w0, t0), __fmul_rn(tx.w1, t1));
}

__device__ __forceinline__ float4 lerp4(const float4& a00, const float4& a10,
                                        const float4& a01, const float4& a11,
                                        const Taps& ty, const Taps& tx) {
  float4 o;
#define ST_CROP_LANE(f)                                               \
  o.f = __fadd_rn(                                                    \
      __fmul_rn(tx.w0, __fadd_rn(__fmul_rn(ty.w0, a00.f),             \
                                 __fmul_rn(ty.w1, a10.f))),           \
      __fmul_rn(tx.w1, __fadd_rn(__fmul_rn(ty.w0, a01.f),             \
                                 __fmul_rn(ty.w1, a11.f))));
  ST_CROP_LANE(x)
  ST_CROP_LANE(y)
  ST_CROP_LANE(z)
  ST_CROP_LANE(w)
#undef ST_CROP_LANE
  return o;
}

// What a block works on: its box's frame, and rows [y0, y0 + rows) of its
// crop, with the column taps xt[ow] and the band's row taps yt[rows] in
// shared memory.
struct Band {
  const float* img;
  int box, y0, rows;
  const Taps* xt;
  const Taps* yt;
};

// kLevels: each box names its map in `level` (else map 0, unscaled).
template <bool kLevels, bool kGray>
__device__ __forceinline__ Band begin_band(
    const Maps& maps, int t, int c, const float* boxes,
    const int64_t* frame_idx, const int64_t* level, int oh, int ow,
    int band_rows, int bands, float inv_oh, float inv_ow, Taps* smem) {
  __shared__ const float* simg;
  __shared__ int sh, sw;
  __shared__ float4 sbox;
  Band bd;
  bd.box = blockIdx.x / bands;
  bd.y0 = (blockIdx.x - bd.box * bands) * band_rows;
  bd.rows = min(band_rows, oh - bd.y0);
  if (threadIdx.x == 0) {
    const int64_t f = frame_idx[bd.box];
    if (f < 0 || f >= t) __trap();
    float4 b = reinterpret_cast<const float4*>(boxes)[bd.box];
    const float* img = maps.img[0];
    int h = maps.h[0], w = maps.w[0];
    if constexpr (kLevels) {
      const int64_t l = level[bd.box];
      if (l < 0 || l >= maps.levels) __trap();
      float s = maps.inv_stride[0];
#pragma unroll
      for (int i = 1; i < kMaxLevels; ++i)  // no dynamic index: no stack
        if (l == i) {
          img = maps.img[i];
          h = maps.h[i];
          w = maps.w[i];
          s = maps.inv_stride[i];
        }
      b = make_float4(__fmul_rn(b.x, s), __fmul_rn(b.y, s),
                      __fmul_rn(b.z, s), __fmul_rn(b.w, s));
    }
    simg = img + f * h * w * c;
    sh = h;
    sw = w;
    sbox = b;
  }
  __syncthreads();
  const float4 b = sbox;
  // the one-map crop reads its sides from the launch's parameters
  const int h = kLevels ? sh : maps.h[0];
  const int w = kLevels ? sw : maps.w[0];
  Taps* xt = smem;
  Taps* yt = smem + ow;
  for (int x = threadIdx.x; x < ow; x += kThreads)
    xt[x] = taps<kGray>(b.x, b.z, x, inv_ow, w, c);
  for (int r = threadIdx.x; r < bd.rows; r += kThreads)
    yt[r] = taps<kGray>(b.y, b.w, bd.y0 + r, inv_oh, h, w * c);
  __syncthreads();
  bd.img = simg;
  bd.xt = xt;
  bd.yt = yt;
  return bd;
}

// kC: the channel count when it is 1-4, else 0 (read from c).
template <int kC, bool kLevels, bool kGray>
__global__ void __launch_bounds__(kThreads) crop_rows(
    const Maps maps, int t, int c, const float* __restrict__ boxes,
    const int64_t* __restrict__ frame_idx, const int64_t* __restrict__ level,
    int oh, int ow, int band_rows, int bands, float inv_oh, float inv_ow,
    float* __restrict__ out) {
  extern __shared__ Taps smem_taps[];
  const int cc = kC ? kC : c;
  const Band bd = begin_band<kLevels, kGray>(
      maps, t, cc, boxes, frame_idx, level, oh, ow, band_rows, bands, inv_oh,
      inv_ow, smem_taps);
  const int lane = threadIdx.x & 31;
  const int row_len = ow * cc;
  for (int r = threadIdx.x >> 5; r < bd.rows; r += kWarps) {
    const Taps ty = bd.yt[r];
    const float* r0 = bd.img + ty.i0;
    const float* r1 = bd.img + ty.i1;
    float* orow = out + (static_cast<int64_t>(bd.box) * oh + bd.y0 + r) *
                            row_len;
    // values before the row's first 16-byte boundary, and after its last
    const int head = min(row_len, static_cast<int>(
        (0u - static_cast<unsigned>(reinterpret_cast<uintptr_t>(orow) >> 2))
        & 3u));
    const int body = (row_len - head) & ~3;
    const int tail = row_len - head - body;
    if (lane < head + tail) {
      const int e = lane < head ? lane : head + body + (lane - head);
      const int x = e / cc;
      const Taps tx = bd.xt[x];
      __stcs(orow + e, finish<kGray>(lerp(r0, r1, ty, tx, e - x * cc), ty,
                                     tx));
    }
    for (int e = head + 4 * lane; e < head + body; e += 4 * 32) {
      int x = e / cc;
      int ch = e - x * cc;
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const Taps tx = bd.xt[x];
        v[q] = finish<kGray>(lerp(r0, r1, ty, tx, ch), ty, tx);
        if (++ch == cc) {
          ch = 0;
          ++x;
        }
      }
      __stcs(reinterpret_cast<float4*>(orow + e),
             make_float4(v[0], v[1], v[2], v[3]));
    }
  }
}

template <bool kLevels, bool kGray>
__global__ void __launch_bounds__(kThreads) crop_pixels(
    const Maps maps, int t, int c, const float* __restrict__ boxes,
    const int64_t* __restrict__ frame_idx, const int64_t* __restrict__ level,
    int oh, int ow, int band_rows, int bands, float inv_oh, float inv_ow,
    float* __restrict__ out) {
  extern __shared__ Taps smem_taps[];
  const Band bd = begin_band<kLevels, kGray>(
      maps, t, c, boxes, frame_idx, level, oh, ow, band_rows, bands, inv_oh,
      inv_ow, smem_taps);
  const int c4 = c >> 2;
  int group = 1;  // lanes a pixel: min(32, c4) rounded up to a power of 2
  while (group < c4 && group < 32) group <<= 1;
  const int lane = threadIdx.x & 31;
  const int sub = lane / group;
  const int g0 = lane - sub * group;
  const int per_warp = 32 / group;
  const int pixels = bd.rows * ow;
  for (int p = (threadIdx.x >> 5) * per_warp + sub; p < pixels;
       p += kWarps * per_warp) {
    const int r = p / ow;
    const int x = p - r * ow;
    const Taps ty = bd.yt[r];
    const Taps tx = bd.xt[x];
    const float4* a00 = reinterpret_cast<const float4*>(bd.img + ty.i0 + tx.i0);
    const float4* a10 = reinterpret_cast<const float4*>(bd.img + ty.i1 + tx.i0);
    const float4* a01 = reinterpret_cast<const float4*>(bd.img + ty.i0 + tx.i1);
    const float4* a11 = reinterpret_cast<const float4*>(bd.img + ty.i1 + tx.i1);
    float4* o = reinterpret_cast<float4*>(
        out + ((static_cast<int64_t>(bd.box) * oh + bd.y0 + r) * ow + x) * c);
    for (int g = g0; g < c4; g += group) {
      float4 r = lerp4(__ldg(a00 + g), __ldg(a10 + g), __ldg(a01 + g),
                       __ldg(a11 + g), ty, tx);
      if constexpr (kGray) {
        r.x = finish<kGray>(r.x, ty, tx);
        r.y = finish<kGray>(r.y, ty, tx);
        r.z = finish<kGray>(r.z, ty, tx);
        r.w = finish<kGray>(r.w, ty, tx);
      }
      __stcs(o + g, r);
    }
  }
}

template <bool kLevels, bool kGray>
int launch(const Maps& maps, int t, int c, const float* boxes,
           const int64_t* frame_idx, const int64_t* level, int b, int oh,
           int ow, float inv_oh, float inv_ow, int band_rows, int bands,
           int pixels, float* out, void* stream) {
  if (b <= 0) return 0;
  if (oh < 1 || ow < 1 || ow > kMaxOw || c < 1 || band_rows < 1 ||
      band_rows > kMaxBandRows || bands != (oh + band_rows - 1) / band_rows ||
      static_cast<int64_t>(b) * bands > 0x7fffffff ||
      (pixels && (c % 4 || c <= 4)) || maps.levels < 1 ||
      maps.levels > kMaxLevels)
    return cudaErrorInvalidValue;
  for (int l = 0; l < maps.levels; ++l)
    if (maps.h[l] < 1 || maps.w[l] < 1) return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>(b * bands);
  const size_t smem = sizeof(Taps) * (ow + band_rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ST_CROP_ARGS \
  maps, t, c, boxes, frame_idx, level, oh, ow, band_rows, bands, inv_oh, \
      inv_ow, out
  if (pixels)
    crop_pixels<kLevels, kGray><<<blocks, kThreads, smem, st>>>(ST_CROP_ARGS);
  else if (c == 1)
    crop_rows<1, kLevels, kGray><<<blocks, kThreads, smem, st>>>(
        ST_CROP_ARGS);
  else if (c == 2)
    crop_rows<2, kLevels, kGray><<<blocks, kThreads, smem, st>>>(
        ST_CROP_ARGS);
  else if (c == 3)
    crop_rows<3, kLevels, kGray><<<blocks, kThreads, smem, st>>>(
        ST_CROP_ARGS);
  else if (c == 4)
    crop_rows<4, kLevels, kGray><<<blocks, kThreads, smem, st>>>(
        ST_CROP_ARGS);
  else
    crop_rows<0, kLevels, kGray><<<blocks, kThreads, smem, st>>>(
        ST_CROP_ARGS);
#undef ST_CROP_ARGS
  return static_cast<int>(cudaGetLastError());
}

}  // namespace stcrop

// images [t, h, w, c], boxes [b, 4] (16-byte aligned), frame_idx [b] int64,
// out [b, oh, ow, c] (16-byte aligned). inv_oh and inv_ow are the float32
// reciprocals of oh and ow. The launch geometry comes from
// models/common.py's crop_geometry: `bands` blocks a box of `band_rows`
// output rows each (the last may have fewer), crop_pixels where `pixels` is
// set (c a multiple of 4 above 4, images 16-byte aligned), else crop_rows.
// `gray` selects the gray mode (the pose crop; the header). Launches on
// `stream`; returns a cudaError_t (0 = ok).
extern "C" int st_crop_resize(const float* images, int t, int h, int w,
                              int c, const float* boxes,
                              const int64_t* frame_idx, int b, int oh,
                              int ow, float inv_oh, float inv_ow,
                              int band_rows, int bands, int pixels, int gray,
                              float* out, void* stream) {
  stcrop::Maps maps = {};
  maps.img[0] = images;
  maps.h[0] = h;
  maps.w[0] = w;
  maps.inv_stride[0] = 1.f;
  maps.levels = 1;
  if (gray)
    return stcrop::launch<false, true>(maps, t, c, boxes, frame_idx, nullptr,
                                       b, oh, ow, inv_oh, inv_ow, band_rows,
                                       bands, pixels, out, stream);
  return stcrop::launch<false, false>(maps, t, c, boxes, frame_idx, nullptr,
                                      b, oh, ow, inv_oh, inv_ow, band_rows,
                                      bands, pixels, out, stream);
}

// The crop with a map a box: `levels` maps (host arrays: images[l] on the
// device, [t, hw[2l], hw[2l + 1], c], each 16-byte aligned where `pixels`
// is set; inv_stride[l] the reciprocal of its stride, a power of two),
// level [b] int64, the rest as st_crop_resize. A box's coordinates are in
// canvas pixels; the kernel scales them by its level's inv_stride.
extern "C" int st_crop_resize_levels(const float* const* images,
                                     const int* hw, const float* inv_stride,
                                     int levels, int t, int c,
                                     const float* boxes,
                                     const int64_t* frame_idx,
                                     const int64_t* level, int b, int oh,
                                     int ow, float inv_oh, float inv_ow,
                                     int band_rows, int bands, int pixels,
                                     float* out, void* stream) {
  using stcrop::kMaxLevels;
  if (levels < 1 || levels > kMaxLevels) return cudaErrorInvalidValue;
  stcrop::Maps maps = {};
  for (int l = 0; l < levels; ++l) {
    maps.img[l] = images[l];
    maps.h[l] = hw[2 * l];
    maps.w[l] = hw[2 * l + 1];
    maps.inv_stride[l] = inv_stride[l];
  }
  maps.levels = levels;
  return stcrop::launch<true, false>(maps, t, c, boxes, frame_idx, level, b,
                                     oh, ow, inv_oh, inv_ow, band_rows, bands,
                                     pixels, out, stream);
}
