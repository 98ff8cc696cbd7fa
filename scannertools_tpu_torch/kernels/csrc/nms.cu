// Greedy non-maximum suppression over a batch of frames, as a bitmask.
//
// Replaces the JAX package's nms (scannertools_tpu/models/common.py:33-102)
// with iou_matrix (:20-30). There the keep set is the fixed point of the
// triangular suppression recurrence, iterated by a while_loop of [K]x[K,K]
// float32 matvecs on the TPU's matrix unit, and the kept rows are then
// compacted by a scatter. On this card it is the classic bitmask NMS.
//
// What bounds it. For the face cascade's calls (K = 128 per pyramid scale,
// 256, 96, 64; T = 16 frames, or 80 for the five scales batched) the inputs
// and outputs are a few hundred kilobytes and the K^2 / 2 overlaps about 15
// float32 operations each: both bounds are microseconds. What sets the time
// is latency: the launches, the dependent steps of the greedy walk, and the
// overlaps of a frame, where one SM computes them. The first design (three
// launches, a mask in device memory, one warp stepping through all K rows
// with a dependent global read each) took about 0.55 us a row. This one:
//
//  * one launch, one block of 1024 threads per frame, everything in shared
//    memory (nms_shared), for K up to the largest whose layout (Layout
//    below: the sorted boxes and source rows, and a region that holds the
//    sort keys and then the mask, K * ceil(K / 64) * 8 bytes) fits the
//    227 KB a block may have: K <= kSharedMaxK = 1280 (a static_assert
//    holds the two together). The wrapper allocates only the outputs.
//  * sort: a bitonic sort in shared memory of 64-bit keys (the score
//    mapped to an order-preserving integer, descending, then the row
//    index), which is the stable descending order of jnp.argsort(-scores)
//    (ties keep the input order; -0.0 and 0.0 tie). The scores must not be
//    NaN. Sorting puts the V valid rows (score > score_thresh) first.
//  * mask: the suppression words of the valid rows only (rows and columns
//    < V, words on and right of a row's own tile), a warp a word: each lane
//    takes two columns and __ballot_sync gathers the bits, so all 32 warps
//    share a frame's overlaps; a pair that does not intersect skips the
//    division.
//  * walk (walk() below): the rows 64 at a time, stopping at V. A tile's
//    candidates are its rows less those removed by kept rows of earlier
//    tiles. The greedy inside the tile runs on the tile's diagonal words,
//    held in warp 0's registers (two a lane): take the lowest candidate,
//    keep it, clear the candidates it suppresses, repeat. A candidate that
//    suppresses no other candidate (found by one ballot) is kept or not
//    without changing the rest, so only the others take a step: the steps
//    are at most the rows kept, and none where nothing overlaps. Then each
//    warp ORs the kept rows' words of one later tile (two 32-bit
//    reductions across the lanes) into the removed set. A row is
//    suppressed only by kept rows before it: the sequential greedy rule,
//    and so the JAX fixed point.
//  * write-out: each kept row's output slot is the kept count before its
//    tile plus the kept bits before it in the tile; slots past the kept
//    count are zeros. The sort keys carry each row's source index in their
//    low 32 bits; the sorted rows keep it in place of the sorted scores
//    (the kept scores are read back from the input through it), so the
//    kept boxes' source rows come out too where the caller asks for them
//    (-1 in rows not kept), at no cost in shared memory: K <= 1280 still
//    fits. The device-memory path below does the same through its scratch.
//
// Above K = 1280, and for K above 512 at fewer than 32 frames (where one SM
// a frame leaves the card idle: models/common.py's nms_geometry, from
// timings), the mask lives in device memory, L2-resident at these sizes,
// in two launches: nms_sort_global (one block per frame: the same sort, the
// sorted rows and V written out) and nms_mask_walk_global (one block per
// frame and 64-row tile builds that tile's words; the last block of a frame
// to finish, counted by an atomic ticket, walks the frame as above, its
// diagonal words read straight into registers, so a step still costs a
// kept row and not a dependent read of device memory per row).
//
// Numerics. The overlap is evaluated in the written order of iou_matrix
// (area = max(x2 - x1, 0) * max(y2 - y1, 0); inter likewise; union =
// a_j + a_i - inter; inter / union where union > 0, else 0; for "min",
// inter / min(a_j, a_i) where that is > 0), each operation rounded on its
// own (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn: nvcc would otherwise
// contract a product and a sum into one FMA), so the kernel equals
// nms_plain, built from PyTorch's elementwise operations, bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace stnms {

using u64 = unsigned long long;  // a mask word (the type __ldcg takes)

constexpr int kTile = 64;             // rows a tile; bits a mask word
constexpr int kSmemLimit = 232448;    // shared memory a block may have, sm_90
constexpr int kSharedThreads = 1024;  // nms_shared
constexpr int kSortThreads = 1024;    // nms_sort_global
constexpr int kMaskThreads = 256;     // nms_mask_walk_global
constexpr int kMaxWords = 256;        // ceil(NMS_MAX_K / 64)
// the largest K of nms_shared (models/common.py's NMS_SHARED_MAX_K)
constexpr int kSharedMaxK = 1280;

__host__ __device__ constexpr int ceil_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Byte offsets of nms_shared's dynamic shared memory for K rows a frame.
struct Layout {
  int words;    // ceil(K / 64)
  int keys;     // sort keys: the next power of two >= max(K, 1)
  int boxes;    // float4 [K], sorted
  int region;   // uint64: keys [keys] while sorting, then mask [K][words]
  int index;    // int [K]: the sorted rows' source rows
  int kept;     // uint64 [words]
  int removed;  // uint64 [words]
  int prefix;   // int [words]
  int misc;     // int [4]: valid rows, kept rows
  int bytes;
};

__host__ __device__ constexpr Layout layout(int k) {
  Layout l{};
  l.words = (k + kTile - 1) / kTile;
  l.keys = ceil_pow2(k > 1 ? k : 1);
  l.boxes = 0;
  l.region = 16 * k;
  const int region = 8 * (k * l.words > l.keys ? k * l.words : l.keys);
  l.index = l.region + region;
  l.kept = (l.index + 4 * k + 7) & ~7;
  l.removed = l.kept + 8 * l.words;
  l.prefix = l.removed + 8 * l.words;
  l.misc = l.prefix + 4 * l.words;
  l.bytes = l.misc + 16;
  return l;
}

static_assert(layout(kSharedMaxK).bytes <= kSmemLimit &&
                  layout(kSharedMaxK + 1).bytes > kSmemLimit,
              "kSharedMaxK is the largest K whose layout fits a block");

__device__ __forceinline__ float area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f),
                   fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

// Ascending order of the key = stable descending order of the scores.
__device__ __forceinline__ u64 sort_key(float s, int i) {
  uint32_t u = __float_as_uint(__fadd_rn(s, 0.f));  // -0.0 -> 0.0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);   // floats, ascending
  return (static_cast<u64>(~u) << 32) | static_cast<uint32_t>(i);
}

// Keys of the frame's rows into keys[0, n) (n a power of two >= k, pads
// last), sorted ascending by the whole block; -> the count of rows with
// score > score_thresh. `count` is one int of shared scratch.
__device__ int sort_rows(const float* __restrict__ s, int k, int n,
                         float score_thresh, u64* keys, int* count) {
  if (threadIdx.x == 0) *count = 0;
  __syncthreads();
  int valid = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    u64 key = ~0ull;
    if (i < k) {
      const float si = s[i];
      key = sort_key(si, i);
      valid += si > score_thresh;
    }
    keys[i] = key;
  }
  valid = __reduce_add_sync(0xffffffffu, valid);
  if ((threadIdx.x & 31) == 0) atomicAdd(count, valid);
  __syncthreads();
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < n / 2; p += blockDim.x) {
        const int i = 2 * p - (p & (stride - 1));  // lower row of the pair
        const int j = i + stride;
        const u64 a = keys[i], b = keys[j];
        if ((a > b) == ((i & size) == 0)) {
          keys[i] = b;
          keys[j] = a;
        }
      }
      __syncthreads();
    }
  }
  return *count;
}

// Whether row j (box bj, area aj) suppresses the box bi after it: their
// overlap, in iou_matrix's written order, is above iou_thresh. Where the
// intersection is 0 the overlap is 0 without the division (0 / x is 0).
__device__ __forceinline__ bool suppresses(float4 bj, float aj, float4 bi,
                                           float iou_thresh, int mode_min) {
  const float xx1 = fmaxf(bj.x, bi.x);
  const float yy1 = fmaxf(bj.y, bi.y);
  const float xx2 = fminf(bj.z, bi.z);
  const float yy2 = fminf(bj.w, bi.w);
  const float inter = __fmul_rn(fmaxf(__fsub_rn(xx2, xx1), 0.f),
                                fmaxf(__fsub_rn(yy2, yy1), 0.f));
  float overlap = 0.f;
  if (inter != 0.f) {
    const float ai = area(bi);
    if (mode_min) {
      const float mn = fminf(aj, ai);
      if (mn > 0.f) overlap = __fdiv_rn(inter, mn);
    } else {
      const float uni = __fsub_rn(__fadd_rn(aj, ai), inter);
      if (uni > 0.f) overlap = __fdiv_rn(inter, uni);
    }
  }
  return overlap > iou_thresh;
}

// Word w of row j of the mask, by one warp (lane l: columns 64 w + l and
// 64 w + 32 + l): bit q set where column i = 64 w + q comes after j, is
// valid (i < v) and is suppressed by j. Boxes in score order.
__device__ __forceinline__ u64 mask_word(const float4* sb, int j, int w,
                                         int v, float iou_thresh,
                                         int mode_min) {
  const int lane = threadIdx.x & 31;
  const float4 bj = sb[j];
  const float aj = area(bj);
  const int i0 = w * kTile + lane;
  const int i1 = i0 + 32;
  const bool p0 = i0 > j && i0 < v &&
                  suppresses(bj, aj, sb[i0], iou_thresh, mode_min);
  const bool p1 = i1 > j && i1 < v &&
                  suppresses(bj, aj, sb[i1], iou_thresh, mode_min);
  return (static_cast<u64>(__ballot_sync(0xffffffffu, p1)) << 32) |
         __ballot_sync(0xffffffffu, p0);
}

template <bool kGlobal>
__device__ __forceinline__ u64 load_word(const u64* p) {
  if constexpr (kGlobal)
    return __ldcg(p);  // written by other blocks of this launch
  else
    return *p;
}

// The greedy walk of the v valid rows over the mask (row r's word w at
// mask[r * stride + w]), by the whole block. Leaves each tile's kept bits
// in kept[], the kept count before each tile in prefix[], and returns the
// kept count. kGlobal: the mask is in device memory.
template <bool kGlobal>
__device__ int walk(const u64* mask, int stride, int v, u64* kept,
                    u64* removed, int* prefix, int* total) {
  const int tiles = (v + kTile - 1) / kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int w = threadIdx.x; w < tiles; w += blockDim.x) removed[w] = 0;
  if (threadIdx.x == 0) *total = 0;
  __syncthreads();
  for (int tile = 0; tile < tiles; ++tile) {
    const int base = tile * kTile;
    const int n = min(kTile, v - base);
    if (warp == 0) {
      // the tile's diagonal words in registers: rows base + lane and
      // base + 32 + lane
      const u64 d0 = lane < n ? load_word<kGlobal>(
          mask + static_cast<int64_t>(base + lane) * stride + tile) : 0;
      const u64 d1 = lane + 32 < n ? load_word<kGlobal>(
          mask + static_cast<int64_t>(base + 32 + lane) * stride + tile) : 0;
      u64 cand = (n == kTile ? ~0ull : (1ull << n) - 1) & ~removed[tile];
      // the candidates that suppress a candidate; the greedy keeps every
      // other candidate it reaches without changing the rest, so only
      // these take a step
      u64 steps = ((static_cast<u64>(__ballot_sync(
                        0xffffffffu, (d1 & cand) != 0)) << 32) |
                   __ballot_sync(0xffffffffu, (d0 & cand) != 0)) & cand;
      while (steps) {
        const int q = __ffsll(static_cast<long long>(steps)) - 1;  // kept
        const u64 dq = q < 32 ? __shfl_sync(0xffffffffu, d0, q)
                              : __shfl_sync(0xffffffffu, d1, q - 32);
        cand &= ~dq;
        steps &= ~dq;
        steps &= steps - 1;
      }
      if (lane == 0) {
        kept[tile] = cand;
        prefix[tile] = *total;
        *total += __popcll(cand);
      }
    }
    __syncthreads();
    if (tile + 1 == tiles) break;
    const u64 keep = kept[tile];
    for (int w = tile + 1 + warp; w < tiles; w += warps) {
      u64 acc = 0;
      for (int q = lane; q < n; q += 32)
        if ((keep >> q) & 1)
          acc |= load_word<kGlobal>(mask + static_cast<int64_t>(base + q) *
                                               stride + w);
      const unsigned lo = __reduce_or_sync(0xffffffffu,
                                           static_cast<unsigned>(acc));
      const unsigned hi = __reduce_or_sync(0xffffffffu,
                                           static_cast<unsigned>(acc >> 32));
      if (lane == 0) removed[w] |= (static_cast<u64>(hi) << 32) | lo;
    }
    __syncthreads();
  }
  return *total;
}

// The kept rows (boxes sb in score order) to the front of the frame's
// outputs; the rest of the max_out rows zeros (index -1). src holds the
// sorted rows' source rows: the kept scores are read from the frame's input
// scores s through them, and the rows go to oi unless it is null.
__device__ void write_out(const float4* sb, const int* src, const float* s,
                          int v, const u64* kept, const int* prefix,
                          int total, int max_out, float4* ob, float* os,
                          uint8_t* ov, int64_t* oi) {
  for (int r = threadIdx.x; r < v; r += blockDim.x) {
    const u64 bits = kept[r / kTile];
    const int q = r % kTile;
    if (!((bits >> q) & 1)) continue;
    const int p = prefix[r / kTile] + __popcll(bits & ((1ull << q) - 1));
    if (p < max_out) {
      const int i = src[r];
      ob[p] = sb[r];
      os[p] = s[i];
      ov[p] = 1;
      if (oi) oi[p] = i;
    }
  }
  for (int p = min(total, max_out) + threadIdx.x; p < max_out;
       p += blockDim.x) {
    ob[p] = make_float4(0.f, 0.f, 0.f, 0.f);
    os[p] = 0.f;
    ov[p] = 0;
    if (oi) oi[p] = -1;
  }
}

__global__ void __launch_bounds__(kSharedThreads) nms_shared(
    const float* __restrict__ boxes, const float* __restrict__ scores, int k,
    float iou_thresh, float score_thresh, int mode_min, int max_out,
    float* __restrict__ out_boxes, float* __restrict__ out_scores,
    uint8_t* __restrict__ out_valid, int64_t* __restrict__ out_index) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(k);
  float4* sb = reinterpret_cast<float4*>(smem + L.boxes);
  u64* region = reinterpret_cast<u64*>(smem + L.region);
  int* si = reinterpret_cast<int*>(smem + L.index);
  u64* kept = reinterpret_cast<u64*>(smem + L.kept);
  u64* removed = reinterpret_cast<u64*>(smem + L.removed);
  int* prefix = reinterpret_cast<int*>(smem + L.prefix);
  int* misc = reinterpret_cast<int*>(smem + L.misc);
  const int64_t frame = blockIdx.x;
  const float* s = scores + frame * k;
  const float4* b = reinterpret_cast<const float4*>(boxes) + frame * k;

  const int v = sort_rows(s, k, L.keys, score_thresh, region, misc);
  for (int r = threadIdx.x; r < k; r += blockDim.x) {
    const int i = static_cast<int>(region[r] & 0xffffffffu);
    sb[r] = b[i];
    si[r] = i;
  }
  __syncthreads();  // the keys are read: the region becomes the mask
  const int tiles = (v + kTile - 1) / kTile;
  const int lane = threadIdx.x & 31;
  for (int w = 0; w < tiles; ++w) {  // a warp a word: rows on or left of w
    const int rows = min(v, (w + 1) * kTile);
    for (int j = threadIdx.x >> 5; j < rows; j += blockDim.x >> 5) {
      const u64 bits = mask_word(sb, j, w, v, iou_thresh, mode_min);
      if (lane == 0) region[j * tiles + w] = bits;
    }
  }
  __syncthreads();
  const int total = walk<false>(region, tiles, v, kept, removed, prefix,
                                misc + 1);
  write_out(sb, si, s, v, kept, prefix, total, max_out,
            reinterpret_cast<float4*>(out_boxes) + frame * max_out,
            out_scores + frame * max_out, out_valid + frame * max_out,
            out_index ? out_index + frame * max_out : nullptr);
}

// counts [t][2]: the frame's valid rows, and the ticket of its mask blocks.
// sorted_src [t][k]: the sorted rows' source rows.
__global__ void __launch_bounds__(kSortThreads) nms_sort_global(
    const float* __restrict__ boxes, const float* __restrict__ scores, int k,
    float score_thresh, float* __restrict__ sorted_boxes,
    int* __restrict__ sorted_src, int* __restrict__ counts) {
  extern __shared__ u64 keys[];
  __shared__ int count;
  const int64_t frame = blockIdx.x;
  const float* s = scores + frame * k;
  const float4* b = reinterpret_cast<const float4*>(boxes) + frame * k;
  const int v = sort_rows(s, k, ceil_pow2(k > 1 ? k : 1), score_thresh, keys,
                          &count);
  float4* sb = reinterpret_cast<float4*>(sorted_boxes) + frame * k;
  for (int r = threadIdx.x; r < k; r += blockDim.x) {
    const int i = static_cast<int>(keys[r] & 0xffffffffu);
    sb[r] = b[i];
    sorted_src[frame * k + r] = i;
  }
  if (threadIdx.x == 0) {
    counts[2 * frame] = v;
    counts[2 * frame + 1] = 0;
  }
}

__global__ void __launch_bounds__(kMaskThreads) nms_mask_walk_global(
    const float* __restrict__ scores, const float* __restrict__ sorted_boxes,
    const int* __restrict__ sorted_src, int k, int words, float iou_thresh,
    int mode_min, int max_out, u64* __restrict__ mask,
    int* __restrict__ counts, float* __restrict__ out_boxes,
    float* __restrict__ out_scores, uint8_t* __restrict__ out_valid,
    int64_t* __restrict__ out_index) {
  __shared__ u64 kept[kMaxWords], removed[kMaxWords];
  __shared__ int prefix[kMaxWords];
  __shared__ int total, last;
  const int64_t frame = blockIdx.y;
  const int v = counts[2 * frame];
  const int tiles = (v + kTile - 1) / kTile;
  const int row_tile = blockIdx.x;
  // tile 0 always reports, so a frame with no valid row is written too
  if (row_tile >= max(tiles, 1)) return;
  const float4* sb =
      reinterpret_cast<const float4*>(sorted_boxes) + frame * k;
  u64* m = mask + frame * k * static_cast<int64_t>(words);
  const int rows = max(0, min(kTile, v - row_tile * kTile));
  const int items = rows * (tiles - row_tile);
  for (int it = threadIdx.x >> 5; it < items; it += blockDim.x >> 5) {
    const int w = row_tile + it / rows;  // a warp a word
    const int j = row_tile * kTile + it % rows;
    const u64 bits = mask_word(sb, j, w, v, iou_thresh, mode_min);
    if ((threadIdx.x & 31) == 0)
      m[static_cast<int64_t>(j) * words + w] = bits;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(counts + 2 * frame + 1, 1) == max(tiles, 1) - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int n_kept = walk<true>(m, words, v, kept, removed, prefix, &total);
  write_out(sb, sorted_src + frame * k, scores + frame * k, v, kept, prefix,
            n_kept, max_out,
            reinterpret_cast<float4*>(out_boxes) + frame * max_out,
            out_scores + frame * max_out, out_valid + frame * max_out,
            out_index ? out_index + frame * max_out : nullptr);
}

// Lets `fn` take up to `bytes` of dynamic shared memory (once a device and
// kernel).
cudaError_t allow_smem(const void* fn, int slot, int bytes) {
  static int done[2][64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[slot][dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 64) done[slot][dev] = 1;
  return err;
}

}  // namespace stnms

// boxes [t, k, 4] and scores [t, k] float32 (boxes 16-byte aligned);
// outputs: boxes [t, max_out, 4], scores [t, max_out] float32, valid
// [t, max_out] uint8 and, unless out_index is null, the kept rows' source
// rows [t, max_out] int64 (-1 where none is kept). With sorted_boxes null,
// one launch of nms_shared (k at most kSharedMaxK); otherwise the two
// launches of the device-memory path, with scratch sorted_boxes [t, k, 4]
// float32, sorted_src [t, k] int32 (source rows), mask [t, k, ceil(k / 64)]
// uint64 and counts [t, 2] int32. Launches on `stream`;
// returns a cudaError_t (0 = ok).
extern "C" int st_nms(const float* boxes, const float* scores, int t, int k,
                      float iou_thresh, float score_thresh, int mode_min,
                      int max_out, float* sorted_boxes, int* sorted_src,
                      unsigned long long* mask, int* counts, float* out_boxes,
                      float* out_scores, uint8_t* out_valid,
                      long long* out_index, void* stream) {
  using namespace stnms;
  if (t <= 0 || max_out <= 0) return 0;
  if (k < 0 || k > kMaxWords * kTile) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (sorted_boxes == nullptr) {
    if (k > kSharedMaxK) return cudaErrorInvalidValue;
    if ((err = allow_smem(reinterpret_cast<const void*>(nms_shared), 0,
                          kSmemLimit)))
      return err;
    nms_shared<<<t, kSharedThreads, layout(k).bytes, st>>>(
        boxes, scores, k, iou_thresh, score_thresh, mode_min, max_out,
        out_boxes, out_scores, out_valid,
        reinterpret_cast<int64_t*>(out_index));
    return static_cast<int>(cudaGetLastError());
  }
  if (t > 65535) return cudaErrorInvalidValue;
  if ((err = allow_smem(reinterpret_cast<const void*>(nms_sort_global), 1,
                        8 * kMaxWords * kTile)))
    return err;
  nms_sort_global<<<t, kSortThreads, 8 * ceil_pow2(k > 1 ? k : 1), st>>>(
      boxes, scores, k, score_thresh, sorted_boxes, sorted_src, counts);
  const int words = (k + kTile - 1) / kTile;
  nms_mask_walk_global<<<dim3(words > 0 ? words : 1, t), kMaskThreads, 0,
                         st>>>(
      scores, sorted_boxes, sorted_src, k, words, iou_thresh, mode_min,
      max_out, mask, counts, out_boxes, out_scores, out_valid,
      reinterpret_cast<int64_t*>(out_index));
  return static_cast<int>(cudaGetLastError());
}
