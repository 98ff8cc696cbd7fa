// Greedy non-maximum suppression over a batch of frames, as a bitmask.
//
// Replaces the JAX package's nms (scannertools_tpu/models/common.py:33-102)
// with iou_matrix (:20-30). There the keep set is the fixed point of the
// triangular suppression recurrence, iterated by a while_loop of [K]x[K,K]
// float32 matvecs on the TPU's matrix unit, and the kept rows are then
// compacted by a scatter. On this card the natural form is the classic
// bitmask NMS, in three launches on one stream, for all T frames at once:
//
//  1. nms_sort: each thread finds the rank of its score in its frame,
//     rank_i = #{j : s_j > s_i} + #{j < i : s_j == s_i}, and writes its
//     box and score to that row of the sorted scratch. That is the stable
//     descending order of jnp.argsort(-scores) (ties keep the input order;
//     -0.0 and 0.0 tie). The scores must not be NaN.
//  2. nms_mask: one block of 64 threads per (frame, 64-row tile, 64-column
//     tile) on or above the diagonal: thread j sets bit q of word
//     mask[j][tile] when box i = 64 * tile + q comes after j (i > j), row j
//     is valid (s_j > score_thresh) and overlap(j, i) > iou_thresh.
//  3. nms_walk: one warp per frame walks the rows in score order, keeping
//     row i when it is valid and no kept row before it set bit i, ORs the
//     kept row's mask words into the removed set (in shared memory), and
//     writes kept rows to the front of the outputs; the rest of the max_out
//     rows are zeros. A row is suppressed only by kept rows, which is the
//     sequential greedy rule and so the JAX fixed point.
//
// What bounds it: for the cascade's K (128 per pyramid scale, 256, 96, 64)
// and T = 16 frames, the inputs and outputs are a few hundred kilobytes and
// the K^2 / 2 overlaps about 15 float32 operations each: both bounds are
// microseconds. The walk is K sequential steps of one warp per frame, so
// for these sizes launch latency and the walk's dependent steps, not bytes
// or operations, set the time. The mask costs K * ceil(K / 64) * 8 bytes a
// frame of scratch (200 KB at K = 1280).
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

constexpr int kSortThreads = 256;
constexpr int kTile = 64;  // rows and columns per mask block; bits a word

__device__ __forceinline__ float area(float x1, float y1, float x2,
                                      float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.f),
                   fmaxf(__fsub_rn(y2, y1), 0.f));
}

__global__ void __launch_bounds__(kSortThreads) nms_sort(
    const float* __restrict__ boxes, const float* __restrict__ scores,
    int k, float* __restrict__ sorted_boxes,
    float* __restrict__ sorted_scores) {
  __shared__ float tile[kSortThreads];
  const int64_t frame = blockIdx.y;
  const int i = blockIdx.x * kSortThreads + threadIdx.x;
  const float* s = scores + frame * k;
  const float si = i < k ? s[i] : 0.f;
  int rank = 0;
  for (int base = 0; base < k; base += kSortThreads) {
    const int j = base + threadIdx.x;
    tile[threadIdx.x] = j < k ? s[j] : 0.f;
    __syncthreads();
    const int n = min(kSortThreads, k - base);
    if (i < k) {
      for (int q = 0; q < n; ++q) {
        const float sj = tile[q];
        rank += (sj > si) || (sj == si && base + q < i);
      }
    }
    __syncthreads();
  }
  if (i >= k) return;
  sorted_scores[frame * k + rank] = si;
  const float4 b = reinterpret_cast<const float4*>(boxes)[frame * k + i];
  reinterpret_cast<float4*>(sorted_boxes)[frame * k + rank] = b;
}

__global__ void __launch_bounds__(kTile) nms_mask(
    const float* __restrict__ sorted_boxes,
    const float* __restrict__ sorted_scores, int k, int words,
    float iou_thresh, float score_thresh, int mode_min,
    uint64_t* __restrict__ mask) {
  const int col_tile = blockIdx.x;
  const int row_tile = blockIdx.y;
  // columns before the row tile are never read by the walk
  if (col_tile < row_tile) return;
  const int64_t frame = blockIdx.z;
  const float4* b = reinterpret_cast<const float4*>(sorted_boxes) + frame * k;

  __shared__ float4 cols[kTile];
  __shared__ float col_area[kTile];
  const int c = col_tile * kTile + threadIdx.x;
  if (c < k) {
    const float4 bc = b[c];
    cols[threadIdx.x] = bc;
    col_area[threadIdx.x] = area(bc.x, bc.y, bc.z, bc.w);
  }
  __syncthreads();

  const int j = row_tile * kTile + threadIdx.x;
  if (j >= k) return;
  const float4 bj = b[j];
  const float aj = area(bj.x, bj.y, bj.z, bj.w);
  const bool valid = sorted_scores[frame * k + j] > score_thresh;
  const int n = min(kTile, k - col_tile * kTile);
  uint64_t bits = 0;
  if (valid) {
    for (int q = 0; q < n; ++q) {
      const int i = col_tile * kTile + q;
      if (i <= j) continue;
      const float4 bi = cols[q];
      const float ai = col_area[q];
      const float xx1 = fmaxf(bj.x, bi.x);
      const float yy1 = fmaxf(bj.y, bi.y);
      const float xx2 = fminf(bj.z, bi.z);
      const float yy2 = fminf(bj.w, bi.w);
      const float inter = __fmul_rn(fmaxf(__fsub_rn(xx2, xx1), 0.f),
                                    fmaxf(__fsub_rn(yy2, yy1), 0.f));
      float overlap;
      if (mode_min) {
        const float mn = fminf(aj, ai);
        overlap = mn > 0.f ? __fdiv_rn(inter, mn) : 0.f;
      } else {
        const float uni = __fsub_rn(__fadd_rn(aj, ai), inter);
        overlap = uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
      }
      if (overlap > iou_thresh) bits |= 1ull << q;
    }
  }
  mask[(frame * k + j) * words + col_tile] = bits;
}

__global__ void __launch_bounds__(32) nms_walk(
    const float* __restrict__ sorted_boxes,
    const float* __restrict__ sorted_scores,
    const uint64_t* __restrict__ mask, int k, int words, float score_thresh,
    int max_out, float* __restrict__ out_boxes,
    float* __restrict__ out_scores, uint8_t* __restrict__ out_valid) {
  extern __shared__ uint64_t removed[];  // `words` words
  const int64_t frame = blockIdx.x;
  const int lane = threadIdx.x;
  const float* s = sorted_scores + frame * k;
  const float4* b = reinterpret_cast<const float4*>(sorted_boxes) + frame * k;
  float4* ob = reinterpret_cast<float4*>(out_boxes) + frame * max_out;
  float* os = out_scores + frame * max_out;
  uint8_t* ov = out_valid + frame * max_out;
  for (int w = lane; w < words; w += 32) removed[w] = 0;
  __syncwarp();
  int kept = 0;
  for (int i = 0; i < k; ++i) {
    // the same branch in every lane: the warp stays converged
    const float si = s[i];
    if (!(si > score_thresh)) continue;
    if ((removed[i >> 6] >> (i & 63)) & 1ull) continue;
    if (lane == 0 && kept < max_out) {
      ob[kept] = b[i];
      os[kept] = si;
      ov[kept] = 1;
    }
    ++kept;
    const uint64_t* row = mask + (frame * k + i) * words;
    for (int w = (i >> 6) + lane; w < words; w += 32) removed[w] |= row[w];
    __syncwarp();
  }
  for (int p = min(kept, max_out) + lane; p < max_out; p += 32) {
    ob[p] = make_float4(0.f, 0.f, 0.f, 0.f);
    os[p] = 0.f;
    ov[p] = 0;
  }
}

}  // namespace stnms

// boxes [t, k, 4] and scores [t, k] float32 (boxes 16-byte aligned);
// scratch: sorted_boxes [t, k, 4], sorted_scores [t, k] float32 and mask
// [t, k, ceil(k / 64)] uint64; outputs: boxes [t, max_out, 4], scores
// [t, max_out] float32, valid [t, max_out] uint8. Launches on `stream`;
// returns the cudaError_t of the launches (0 = ok).
extern "C" int st_nms(const float* boxes, const float* scores, int t, int k,
                      float iou_thresh, float score_thresh, int mode_min,
                      int max_out, float* sorted_boxes, float* sorted_scores,
                      uint64_t* mask, float* out_boxes, float* out_scores,
                      uint8_t* out_valid, void* stream) {
  if (t <= 0 || max_out <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int words = (k + stnms::kTile - 1) / stnms::kTile;
  if (k > 0) {
    const dim3 sort_grid((k + stnms::kSortThreads - 1) / stnms::kSortThreads,
                         t);
    stnms::nms_sort<<<sort_grid, stnms::kSortThreads, 0, st>>>(
        boxes, scores, k, sorted_boxes, sorted_scores);
    const dim3 mask_grid(words, words, t);
    stnms::nms_mask<<<mask_grid, stnms::kTile, 0, st>>>(
        sorted_boxes, sorted_scores, k, words, iou_thresh, score_thresh,
        mode_min, mask);
  }
  stnms::nms_walk<<<t, 32, words * sizeof(uint64_t), st>>>(
      sorted_boxes, sorted_scores, mask, k, words, score_thresh, max_out,
      out_boxes, out_scores, out_valid);
  return static_cast<int>(cudaGetLastError());
}
