// Per-frame, per-channel 16-bin histograms of decoded frame chunks.
//
// Replaces the JAX package's histogram kernels:
//   st_hist_rgb  <- scannertools_tpu/ops/histogram.py _hist_kernel (the
//                   Pallas kernel launched by _pallas_hist_fn), and the
//                   _histogram_jnp_flat formulations beside it;
//   st_hist_i420 <- the XLA fusion of utils/framechunk.py yuv420_to_rgb
//                   with _histogram_jnp (ops/histogram.py, i420 branch).
//
// The least time is the bytes read over 3.35 TB/s (H100 SXM data sheet):
// a 64-frame 1080p chunk is 398.1 MB as RGB24 (0.119 ms) and 199.1 MB as
// I420 (0.059 ms). Both kernels count the same 398.1 M values per chunk
// (one per RGB byte; three per I420 luma sample), so what they spend per
// counted value decides how close they come to it.
//
// Counting. Every thread keeps a private histogram in shared memory,
// code-major (counter[code * kThreads + tid]): a thread touches only its
// own column, and the 32 lanes of a warp always hit 32 different banks,
// whatever the pixels, so flat-colour frames cost what noise costs. A
// count is one shared atomic add whose result is unused (so it starts no
// dependent load-add-store chain) at an address made by one integer
// multiply-add from the value; the channel of every byte is a
// compile-time constant (below), so nothing else is computed per count.
// Packed 8-bit counters in registers, as the Pallas kernel keeps in VMEM,
// would need a register chosen by the value: a select chain of several
// instructions per count where the shared add is one.
//
// What chose this (ceiling variants timed by tools/hist_probe.py, 64 x
// 1080p, random frames, median of 20 device times, an H100 80GB HBM3 at
// 700 W): the first design spent 0.316 ms on hist_rgb and 0.313 ms on
// hist_i420, its count-only variants 0.307 and 0.279 ms (reads alone:
// 0.136 and 0.090 ms), so counting bound it. Of the candidates timed in
// the same call, shared atomics beat a load, add and store per count
// (hist_rgb 0.149 against 0.164 ms, hist_i420 0.132 against 0.181 ms), and
// warp-striped RGB units beat 48 contiguous bytes a thread (0.149 against
// 0.150 ms full, 0.139 against 0.141 ms read-only); the losers were
// dropped. hist_rgb's count-only variant takes 0.071 ms and its read-only
// one 0.139 ms (a PyTorch int64 sum over the same bytes: 0.138 ms), so
// reads bind it and counting fewer times could not help; hist_i420's
// count-only variant takes 0.119 ms, most of it the conversion's
// arithmetic (the same number of shared adds costs hist_rgb 0.071 ms).
//
// Work split. The grid is persistent: about as many blocks as fit on the
// card at once (ops/histogram.py sizes it from the occupancy query), each
// walking a contiguous run of work items (frame, slab) in frame order. A
// block adds its counters into the output with global integer atomics
// (exact in any order) and clears them only when its next item lies in
// another frame, or when it is done.
//
// hist_rgb. The channel of byte i of a frame is i % c. A thread takes a
// chunk of 16c bytes (c 16-byte loads), whose channel pattern starts at 0,
// so the kernel is a template on c (1..6) and byte n of a chunk counts for
// channel n % c, a constant after unrolling: no division or per-byte
// predicate in the loop. The ragged last chunk of a frame takes a guarded
// byte path; so do frames that are not 16-byte aligned.
//
// hist_i420. A thread takes a cell of 16 luma columns of two rows (two
// 16-byte loads) and the 8 U and 8 V bytes under them (two 8-byte loads),
// i.e. eight 2x2 blocks. Cells are walked by (row, column) with a carry,
// not by dividing a flat index. Widths that are not a multiple of 16, and
// unaligned frames, take a guarded byte path. The conversion is that of
// yuv420_to_rgb in float32, every product and sum rounded separately in
// the written order (mul/add/sub with .rn, never contracted into FMAs), so
// its bins equal numpy's bit for bit. Binning avoids float->int
// conversions: every term is scaled by 1/256 (exact, and rounding commutes
// with it), so the sums come out already divided by 256; `add.rn.sat`
// clamps them to [0, 1]; adding 786432 (1.5 * 2^19, whose ulp is 1/16)
// rounding down leaves floor(16 s) = the bin in the low bits of the float,
// with 16 for values >= 256, counted in a 17th counter and folded into bin
// 15 when the block flushes. A byte becomes a float by placing it under
// the exponent of 2^23 (one byte permute); subtracting 2^23 + yo then gives
// Y - yo exactly, since yo is an integer.
//
// kMode selects the ceiling variants that tools/hist_probe.cu times: the
// entry points below launch kFull only.

#include <cuda_runtime.h>
#include <stdint.h>

namespace sthist {

enum Mode { kFull = 0, kReadOnly = 1, kCountOnly = 2 };

constexpr int kBins = 16;
constexpr int kThreads = 128;
constexpr int kMaxChannels = 6;
// I420 counters per channel: 16 bins and one for values >= 256.
constexpr int kI420Slots = kBins + 1;
// Float bits of 786432 + k/16: 0x49400000 + k.
constexpr uint32_t kBinMagicBits = 0x49400000u;
constexpr float kBinMagic = 786432.0f;
constexpr float kTwo23 = 8388608.0f;

// --------------------------------------------------------------- helpers

// The probe's count-only variant: a word made from the position, or one
// constant for a flat frame.
__device__ __forceinline__ uint32_t gen_word(uint64_t pos, int k, int flat) {
  if (flat) return 0xC8282828u;
  uint32_t g = uint32_t(pos) * 0x9E3779B1u + uint32_t(k) * 0x85EBCA77u;
  return g ^ (g >> 13);
}

// The probe's read-only variant: XOR the warp's words into one word.
__device__ __forceinline__ void fold_out(uint32_t acc, uint32_t* fold) {
  for (int off = 16; off > 0; off >>= 1)
    acc ^= __shfl_xor_sync(0xffffffffu, acc, off);
  if ((threadIdx.x & 31) == 0) atomicXor(fold, acc);
}

// One count: a shared atomic add whose result is unused, at byte offset off.
__device__ __forceinline__ void count_at(char* cnt, uint32_t off) {
  atomicAdd(reinterpret_cast<uint32_t*>(cnt + off), 1u);
}

__device__ __forceinline__ void zero_counts(uint32_t* cnt, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) cnt[i] = 0;
}

// Add every (channel, bin) column into out[kCh][16] with one global atomic
// per code, clearing the columns as they are read; kSlots counters per
// channel, the 17th (if any) folded into bin 15. The caller syncs before
// (the columns are complete) and after (they are clear).
template <int kCh, int kSlots>
__device__ __forceinline__ void flush_counts(uint32_t* cnt, int32_t* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int code = warp; code < kCh * kBins; code += kThreads / 32) {
    const int ch = code / kBins, bin = code % kBins;
    uint32_t* col = cnt + (ch * kSlots + bin) * kThreads;
    const int ncols = (kSlots > kBins && bin == kBins - 1) ? 2 : 1;
    uint32_t s = 0;
    for (int i = lane; i < ncols * kThreads; i += 32) {
      s += col[i];
      col[i] = 0;
    }
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0 && s) atomicAdd(out + code, static_cast<int32_t>(s));
  }
}

// The contiguous run of work items [lo, hi) of this block.
__device__ __forceinline__ void block_items(int64_t items, int64_t* lo,
                                            int64_t* hi) {
  *lo = items * blockIdx.x / gridDim.x;
  *hi = items * (blockIdx.x + 1) / gridDim.x;
}

// --------------------------------------------------------------- RGB

// Unit q of a frame: C pieces of 16 bytes, striped so that the warp's 32
// units tile 512*C bytes and piece i of all 32 lanes is one coalesced
// 512-byte row: piece i of lane l = q % 32 starts at
// 16*C*(q - l) + 16*l + 512*i.
template <int C>
__device__ __forceinline__ int64_t piece_at(int64_t q, int lane, int i) {
  return 16 * C * (q - lane) + 16 * lane + 512 * i;
}

// Count the 16*C bytes of one unit. ch_col[j] is this thread's column of
// channel (rot + j) % C, rot the channel of the unit's first byte, so that
// byte n of piece i counts in ch_col[(512*i + n) % C]: a compile-time
// index after unrolling.
template <int C>
__device__ __forceinline__ void count_unit(char* cnt,
                                           const uint32_t (&wd)[4 * C],
                                           const uint32_t (&ch_col)[C]) {
#pragma unroll
  for (int i = 0; i < C; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t m = wd[4 * i + k] & 0xF0F0F0F0u;  // bin * 16 a byte
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = (512 * i + 4 * k + b) % C;
        const uint32_t v = __byte_perm(m, 0u, 0x4440u | b);
        // bin * kThreads * 4 bytes = v * 32
        count_at(cnt, ch_col[j] + v * 32u);
      }
    }
  }
}

template <int kMode, int C, bool kVec>
__global__ void __launch_bounds__(kThreads)
hist_rgb_kernel(const uint8_t* __restrict__ x, int64_t stride, int64_t npix,
                int64_t item_units, int64_t items_per_frame, int64_t items,
                int flat, int32_t* __restrict__ out, uint32_t* fold) {
  extern __shared__ uint32_t cnt[];
  constexpr int kCodes = C * kBins;
  constexpr uint32_t kChCol = kBins * kThreads * 4;  // bytes a channel
  int64_t lo, hi;
  block_items(items, &lo, &hi);
  if (lo >= hi) return;
  // units a frame: whole warps' worth (ops/histogram.py rgb_geometry);
  // those below nfull have every byte inside the frame
  const int64_t nunits = 32 * ((npix + 512 * C - 1) / (512 * C));
  const int64_t nfull = 32 * (npix / (512 * C));
  const int lane = threadIdx.x & 31;
  const int rot = (16 * lane) % C;
  uint32_t ch_col[C];
#pragma unroll
  for (int j = 0; j < C; ++j)
    ch_col[j] = threadIdx.x * 4u + ((rot + j) % C) * kChCol;
  int64_t frame = lo / items_per_frame;
  int64_t slab = lo - frame * items_per_frame;
  char* const cb = reinterpret_cast<char*>(cnt);
  if (kMode != kReadOnly) zero_counts(cnt, kCodes * kThreads);
  __syncthreads();
  uint32_t acc = 0;

  for (int64_t item = lo; item < hi; ++item) {
    const uint8_t* f = x + frame * stride;
    const int64_t q0 = slab * item_units;
    const int64_t q1 = q0 + item_units < nunits ? q0 + item_units : nunits;
    for (int64_t q = q0 + threadIdx.x; q < q1; q += kThreads) {
      uint32_t wd[4 * C];
      if (q < nfull) {
        if (kMode == kCountOnly) {
#pragma unroll
          for (int i = 0; i < 4 * C; ++i)
            wd[i] = gen_word(uint64_t(frame * nunits + q), i, flat);
        } else {
#pragma unroll
          for (int i = 0; i < C; ++i) {
            const uint8_t* p = f + piece_at<C>(q, lane, i);
            if (kVec) {
              const uint4 v = *reinterpret_cast<const uint4*>(p);
              wd[4 * i] = v.x;
              wd[4 * i + 1] = v.y;
              wd[4 * i + 2] = v.z;
              wd[4 * i + 3] = v.w;
            } else {
#pragma unroll
              for (int k = 0; k < 4; ++k)
                wd[4 * i + k] = uint32_t(p[4 * k]) |
                                uint32_t(p[4 * k + 1]) << 8 |
                                uint32_t(p[4 * k + 2]) << 16 |
                                uint32_t(p[4 * k + 3]) << 24;
            }
          }
        }
        if (kMode == kReadOnly) {
#pragma unroll
          for (int i = 0; i < 4 * C; ++i) acc ^= wd[i];
        } else {
          count_unit<C>(cb, wd, ch_col);
        }
      } else if (kMode != kCountOnly) {
        // the frame's ragged last units: bytes below npix only
        for (int i = 0; i < C; ++i) {
          const int64_t o = piece_at<C>(q, lane, i);
          for (int n = 0; n < 16 && o + n < npix; ++n) {
            const uint32_t v = f[o + n] & 0xF0u;
            if (kMode == kReadOnly)
              acc ^= v;
            else
              count_at(cb, threadIdx.x * 4u +
                               uint32_t((o + n) % C) * kChCol + v * 32u);
          }
        }
      }
    }
    if (++slab == items_per_frame || item + 1 == hi) {
      if (kMode != kReadOnly) {
        __syncthreads();
        flush_counts<C, kBins>(cnt, out + frame * kCodes);
        __syncthreads();
      }
      slab = 0;
      ++frame;
    }
  }
  if (kMode == kReadOnly) fold_out(acc, fold);
}

// --------------------------------------------------------------- I420

struct YuvCoefs {
  float ys, yo, rv, gu, gv, bu;
};

// Coefficients as the kernel uses them: products scaled by 1/256, and the
// 2^23 bias of a byte made float folded into the offsets.
struct YuvTerms {
  float ys, ybias, rv, gu, gv, bu;
};

__device__ __forceinline__ float add_sat(float a, float b) {
  float r;
  asm("add.rn.sat.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float sub_sat(float a, float b) {
  float r;
  asm("sub.rn.sat.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// s in [0, 1] -> float bits kBinMagicBits + floor(16 s).
__device__ __forceinline__ uint32_t bin_bits(float s) {
  return __float_as_uint(__fadd_rd(s, kBinMagic));
}

// Byte k of w as a float 2^23 + byte.
__device__ __forceinline__ float byte_f(uint32_t w, int k) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u | k));
}

// Count the R, G, B bins of one luma sample; col already holds this
// thread's column and the -kBinMagicBits offset of the bin bits.
__device__ __forceinline__ void count_luma(char* cnt, uint32_t col, float fy,
                                           const YuvTerms& k, float rve,
                                           float gud, float gve, float bud) {
  constexpr uint32_t kStep = kThreads * 4;  // bytes from one bin to the next
  constexpr uint32_t kCh = kI420Slots * kStep;
  const float yy = __fmul_rn(__fsub_rn(fy, k.ybias), k.ys);
  count_at(cnt, col + bin_bits(add_sat(yy, rve)) * kStep);
  count_at(cnt,
           col + kCh + bin_bits(sub_sat(__fsub_rn(yy, gud), gve)) * kStep);
  count_at(cnt, col + 2 * kCh + bin_bits(add_sat(yy, bud)) * kStep);
}

// One cell: luma words a (upper row) and b (lower row), 16 samples each;
// U and V words, 8 samples each; the first `pairs` 2x2 blocks count.
template <bool kGuard>
__device__ __forceinline__ void count_cell(char* cnt, uint32_t col,
                                           const YuvTerms& k,
                                           const uint32_t (&a)[4],
                                           const uint32_t (&b)[4],
                                           const uint32_t (&u)[2],
                                           const uint32_t (&v)[2],
                                           int pairs) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (kGuard && j >= pairs) break;
    const float d = __fsub_rn(byte_f(u[j >> 2], j & 3), kTwo23 + 128.0f);
    const float e = __fsub_rn(byte_f(v[j >> 2], j & 3), kTwo23 + 128.0f);
    const float rve = __fmul_rn(k.rv, e);
    const float gud = __fmul_rn(k.gu, d);
    const float gve = __fmul_rn(k.gv, e);
    const float bud = __fmul_rn(k.bu, d);
    const int wi = j >> 1, bi = 2 * (j & 1);
    count_luma(cnt, col, byte_f(a[wi], bi), k, rve, gud, gve, bud);
    count_luma(cnt, col, byte_f(a[wi], bi + 1), k, rve, gud, gve, bud);
    count_luma(cnt, col, byte_f(b[wi], bi), k, rve, gud, gve, bud);
    count_luma(cnt, col, byte_f(b[wi], bi + 1), k, rve, gud, gve, bud);
  }
}

__device__ __forceinline__ uint32_t load_bytes(const uint8_t* p, int n) {
  uint32_t w = 0;
  for (int i = 0; i < 4 && i < n; ++i) w |= uint32_t(p[i]) << (8 * i);
  return w;
}

template <int kMode, bool kVec>
__global__ void __launch_bounds__(kThreads)
hist_i420_kernel(const uint8_t* __restrict__ x, int64_t stride, int h, int w,
                 YuvTerms k, int64_t item_cells, int64_t items_per_frame,
                 int64_t items, int flat, int32_t* __restrict__ out,
                 uint32_t* fold) {
  __shared__ uint32_t cnt[3 * kI420Slots * kThreads];
  int64_t lo, hi;
  block_items(items, &lo, &hi);
  if (lo >= hi) return;
  const int cw = w / 2;
  const int crows = h / 2;
  const int gpr = (w + 15) / 16;  // cells per chroma row
  const int64_t ncells = int64_t(crows) * gpr;
  // A thread's cells in an item are item_start + tid + kThreads * i; its
  // (row, column) moves by (dr, dg) per step and by (ir, ig) per item.
  const int dr = kThreads / gpr, dg = kThreads % gpr;
  const int64_t ir64 = item_cells / gpr;
  const int ir = static_cast<int>(ir64);
  const int ig = static_cast<int>(item_cells - ir64 * gpr);
  const int r0 = threadIdx.x / gpr, g0 = threadIdx.x % gpr;
  int64_t frame = lo / items_per_frame;
  int64_t slab = lo - frame * items_per_frame;
  const int64_t first = slab * item_cells + threadIdx.x;
  int r = static_cast<int>(first / gpr);
  int g = static_cast<int>(first - int64_t(r) * gpr);
  char* const cb = reinterpret_cast<char*>(cnt);
  const uint32_t col = threadIdx.x * 4u - kBinMagicBits * (kThreads * 4u);
  if (kMode != kReadOnly) zero_counts(cnt, 3 * kI420Slots * kThreads);
  __syncthreads();
  uint32_t acc = 0;

  for (int64_t item = lo; item < hi; ++item) {
    const uint8_t* yp = x + frame * stride;
    const uint8_t* up = yp + int64_t(h) * w;
    const uint8_t* vp = up + int64_t(crows) * cw;
    const int64_t c1 = (slab + 1) * item_cells < ncells
                           ? (slab + 1) * item_cells : ncells;
    int rr = r, gg = g;
    for (int64_t c = slab * item_cells + threadIdx.x; c < c1;
         c += kThreads) {
      const uint8_t* y0 = yp + int64_t(2 * rr) * w + 16 * gg;
      const uint8_t* u0 = up + int64_t(rr) * cw + 8 * gg;
      const uint8_t* v0 = vp + int64_t(rr) * cw + 8 * gg;
      uint32_t a[4], b[4], u[2], v[2];
      int cols = 16;  // luma columns of this cell inside the frame
      if (kMode == kCountOnly) {
        const uint64_t pos = uint64_t(frame * ncells + c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = gen_word(pos, i, flat);
          b[i] = gen_word(pos, 4 + i, flat);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          u[i] = gen_word(pos, 8 + i, flat);
          v[i] = gen_word(pos, 10 + i, flat);
        }
      } else if (kVec) {
        const uint4 la = *reinterpret_cast<const uint4*>(y0);
        const uint4 lb = *reinterpret_cast<const uint4*>(y0 + w);
        const uint2 lu = *reinterpret_cast<const uint2*>(u0);
        const uint2 lv = *reinterpret_cast<const uint2*>(v0);
        a[0] = la.x; a[1] = la.y; a[2] = la.z; a[3] = la.w;
        b[0] = lb.x; b[1] = lb.y; b[2] = lb.z; b[3] = lb.w;
        u[0] = lu.x; u[1] = lu.y;
        v[0] = lv.x; v[1] = lv.y;
      } else {
        cols = w - 16 * gg < 16 ? w - 16 * gg : 16;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = load_bytes(y0 + 4 * i, cols - 4 * i);
          b[i] = load_bytes(y0 + w + 4 * i, cols - 4 * i);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          u[i] = load_bytes(u0 + 4 * i, cols / 2 - 4 * i);
          v[i] = load_bytes(v0 + 4 * i, cols / 2 - 4 * i);
        }
      }
      if (kMode == kReadOnly) {
        acc ^= a[0] ^ a[1] ^ a[2] ^ a[3] ^ b[0] ^ b[1] ^ b[2] ^ b[3] ^
               u[0] ^ u[1] ^ v[0] ^ v[1];
      } else if (kVec || kMode == kCountOnly) {
        count_cell<false>(cb, col, k, a, b, u, v, 8);
      } else {
        count_cell<true>(cb, col, k, a, b, u, v, cols / 2);
      }
      gg += dg;
      rr += dr;
      if (gg >= gpr) {
        gg -= gpr;
        ++rr;
      }
    }
    if (++slab == items_per_frame) {
      slab = 0;
      r = r0;
      g = g0;
    } else {
      g += ig;
      r += ir;
      if (g >= gpr) {
        g -= gpr;
        ++r;
      }
    }
    if (slab == 0 || item + 1 == hi) {
      if (kMode != kReadOnly) {
        __syncthreads();
        flush_counts<3, kI420Slots>(cnt, out + frame * 3 * kBins);
        __syncthreads();
      }
      if (slab == 0) ++frame;
    }
  }
  if (kMode == kReadOnly) fold_out(acc, fold);
}

// --------------------------------------------------------------- launch

template <typename F>
int set_max_carveout(F* fn) {
  return cudaFuncSetAttribute(fn,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// Resident blocks per SM of fn, with the largest shared-memory carveout.
template <typename F>
int blocks_per_sm(F* fn, size_t smem, int* blocks) {
  const int rc = set_max_carveout(fn);
  if (rc != cudaSuccess) return rc;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads,
                                                       smem);
}

constexpr size_t rgb_smem(int c) {
  return size_t(c) * kBins * kThreads * sizeof(uint32_t);
}

template <int kMode, int C, bool kVec>
int launch_rgb(const uint8_t* x, int64_t stride, int64_t npix, int64_t grid,
               int64_t item_units, int64_t items_per_frame, int64_t items,
               int flat, int32_t* out, uint32_t* fold, cudaStream_t stream) {
  hist_rgb_kernel<kMode, C, kVec>
      <<<static_cast<unsigned>(grid), kThreads, rgb_smem(C), stream>>>(
          x, stride, npix, item_units, items_per_frame, items, flat, out,
          fold);
  return cudaGetLastError();
}

template <int kMode, bool kVec>
int launch_i420(const uint8_t* x, int64_t stride, int h, int w,
                const YuvTerms& k, int64_t grid, int64_t item_cells,
                int64_t items_per_frame, int64_t items, int flat,
                int32_t* out, uint32_t* fold, cudaStream_t stream) {
  hist_i420_kernel<kMode, kVec>
      <<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
          x, stride, h, w, k, item_cells, items_per_frame, items, flat, out,
          fold);
  return cudaGetLastError();
}

// The launch geometry must cover every chunk (cell) of every frame once:
// items_per_frame items of item_units (a multiple of kThreads) per frame.
inline bool geometry_ok(int64_t t, int64_t units, int64_t grid,
                        int64_t item_units, int64_t items_per_frame) {
  return grid >= 1 && grid <= t * items_per_frame && grid < (1ll << 31) &&
         item_units >= kThreads && item_units % kThreads == 0 &&
         items_per_frame * item_units >= units &&
         (items_per_frame - 1) * item_units < units;
}

inline YuvTerms yuv_terms(const float* c) {
  const float s = 1.0f / 256.0f;  // exact: a power of two
  return YuvTerms{c[0] * s, kTwo23 + c[1], c[2] * s, c[3] * s, c[4] * s,
                  c[5] * s};
}

inline bool yuv_ok(const float* c) {
  // Y - yo is exact only for an integer offset within a byte
  return c[1] >= 0.0f && c[1] <= 255.0f && c[1] == float(int(c[1]));
}

}  // namespace sthist

extern "C" {

// x: [t, stride] u8 on the device; out: [t, c, 16] int32, zeroed by the
// caller. vec != 0 promises x and stride are 16-byte aligned. grid,
// item_units, items_per_frame: the launch geometry of ops/histogram.py
// rgb_geometry (32 * ceil(npix / (512 c)) units a frame). Returns the
// cudaError_t of the launch.
int st_hist_rgb(const uint8_t* x, int64_t t, int64_t stride, int64_t npix,
                int c, int vec, int64_t grid, int64_t item_units,
                int64_t items_per_frame, int32_t* out, cudaStream_t stream) {
  using namespace sthist;
  if (t <= 0 || npix <= 0) return cudaSuccess;
  if (c < 1 || c > kMaxChannels || npix > stride ||
      !geometry_ok(t, 32 * ((npix + 512 * c - 1) / (512 * c)), grid,
                   item_units, items_per_frame))
    return cudaErrorInvalidValue;
  const int64_t items = t * items_per_frame;
#define ST_RGB(C)                                                          \
  return vec ? launch_rgb<kFull, C, true>(x, stride, npix, grid,           \
                                          item_units, items_per_frame,     \
                                          items, 0, out, nullptr, stream)  \
             : launch_rgb<kFull, C, false>(x, stride, npix, grid,          \
                                           item_units, items_per_frame,    \
                                           items, 0, out, nullptr, stream)
  switch (c) {
    case 1: ST_RGB(1);
    case 2: ST_RGB(2);
    case 3: ST_RGB(3);
    case 4: ST_RGB(4);
    case 5: ST_RGB(5);
    default: ST_RGB(6);
  }
#undef ST_RGB
}

// Resident blocks per SM of the kernel st_hist_rgb launches for c, vec,
// after asking for the largest shared-memory carveout for it.
int st_hist_rgb_occupancy(int c, int vec, int* blocks) {
  using namespace sthist;
  if (c < 1 || c > kMaxChannels) return cudaErrorInvalidValue;
#define ST_RGB_OCC(C, V) \
  blocks_per_sm(hist_rgb_kernel<kFull, C, V>, rgb_smem(C), blocks)
#define ST_RGB_OCC2(C) \
  return vec ? ST_RGB_OCC(C, true) : ST_RGB_OCC(C, false)
  switch (c) {
    case 1: ST_RGB_OCC2(1);
    case 2: ST_RGB_OCC2(2);
    case 3: ST_RGB_OCC2(3);
    case 4: ST_RGB_OCC2(4);
    case 5: ST_RGB_OCC2(5);
    default: ST_RGB_OCC2(6);
  }
#undef ST_RGB_OCC2
#undef ST_RGB_OCC
}

// x: [t, stride] u8 on the device, each row Y (h*w) then U then V
// ((h/2)*(w/2) each); out: [t, 3, 16] int32, zeroed by the caller;
// coefs: host pointer to (ys, yo, rv, gu, gv, bu). vec != 0 promises x
// and stride are 16-byte aligned and w is a multiple of 16. grid,
// item_cells, items_per_frame: the launch geometry of ops/histogram.py
// i420_geometry (cells of 16 luma columns of two rows).
int st_hist_i420(const uint8_t* x, int64_t t, int64_t stride, int h, int w,
                 const float* coefs, int vec, int64_t grid,
                 int64_t item_cells, int64_t items_per_frame, int32_t* out,
                 cudaStream_t stream) {
  using namespace sthist;
  if (t <= 0 || h <= 0 || w <= 0) return cudaSuccess;
  if ((h & 1) || (w & 1) || (vec && w % 16) || !yuv_ok(coefs) ||
      int64_t(h) * w * 3 / 2 > stride ||
      !geometry_ok(t, int64_t(h / 2) * ((w + 15) / 16), grid, item_cells,
                   items_per_frame))
    return cudaErrorInvalidValue;
  const YuvTerms k = yuv_terms(coefs);
  const int64_t items = t * items_per_frame;
  return vec ? launch_i420<kFull, true>(x, stride, h, w, k, grid,
                                        item_cells, items_per_frame, items,
                                        0, out, nullptr, stream)
             : launch_i420<kFull, false>(x, stride, h, w, k, grid,
                                         item_cells, items_per_frame, items,
                                         0, out, nullptr, stream);
}

// Resident blocks per SM of the kernel st_hist_i420 launches for vec,
// after asking for the largest shared-memory carveout for it.
int st_hist_i420_occupancy(int vec, int* blocks) {
  using namespace sthist;
  return vec ? blocks_per_sm(hist_i420_kernel<kFull, true>, 0, blocks)
             : blocks_per_sm(hist_i420_kernel<kFull, false>, 0, blocks);
}

}  // extern "C"
