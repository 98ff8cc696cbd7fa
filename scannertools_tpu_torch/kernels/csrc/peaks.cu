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
// 480x640 chunk: 0.0528 ms at 3.35 TB/s) and writes 3.5 KB a frame; the
// card's own read of those bytes (a torch sum) takes about 0.067 ms.
// Pixels above the threshold are a few percent on trained maps and a
// quarter on the seeded net's; only their chunks run the stencil. The
// design streams the maps and keeps the rest off that stream:
//
//  * a thread block cluster of kCluster blocks per (frame, part) map,
//    each block a band of ceil(H / kCluster) rows (empty bands where
//    H < kCluster): an 8-frame chunk is 1,152 blocks of 256 threads,
//    3 resident an SM at <= 80 registers (45 clusters on an H100);
//  * a strip is 32 lanes x V pixels: V = 4, one 16-byte load a lane and
//    row, where W % 4 == 0 and the tensor is 16-byte aligned (then every
//    map and row is); V = 1 otherwise. The band's strips x rows are split
//    evenly over the block's warps, strip-major; a warp walks its rows of
//    a strip kRows at a time, the chunk's loads issued together, and keeps
//    the last two rows as the next chunk's upper halo. Lanes 0 and 31 also
//    load the column beside the strip. So a pixel is read once, besides
//    two columns a strip and two rows where a warp's range starts;
//  * a chunk costs its loads, a max and a vote unless a pixel it tests is
//    above the threshold and not below the value of the warp's cut-off.
//    Then the 3x3 test takes its rows from registers and its columns from
//    the neighbouring lanes by shuffle, as one >= against the window's
//    max.NaN (a NaN neighbour fails it, as it fails the plain version's
//    eight tests);
//  * each peak becomes a 64-bit key: the value's float bits (positive
//    above the threshold, so they order as the values) over the
//    complement of the flat index, so one unsigned compare orders value
//    down, then index up. A warp appends the keys above its cut-off to a
//    kWarpCap-key buffer in shared memory; when a batch would not fit, it
//    sorts the buffer (a bitonic sort through shuffles), keeps its top 24
//    and raises its cut-off to the 24th, which it also offers the cluster
//    (atomicMax in block rank 0's shared memory: any 24 peaks bound the
//    map's 24th). A warp that finds peaks first learns the cluster's
//    cut-off, and keys below it are dropped. A map where every pixel is a
//    peak (a constant plateau) keeps at most 24 + 32 keys a warp;
//  * the merge: each warp sorts its <= 24 keys, and each key finds its
//    rank among the block's by binary search in the other warps' lists;
//    the block's top 24, in order, go into rank 0's shared memory through
//    the cluster's distributed shared memory, and rank 0 merges the eight
//    lists the same way. With n < 24 keys no cut-off was ever set, so they
//    are all of the map's peaks, and the fill slots are the first 24 - n
//    indices of [0, 48) that are not peaks: two OR-reductions and two
//    ballots of one warp.
//
// The rest of the time: the chunks that run the stencil, and each
// cluster's slots held until its slowest band and rank 0's merge end.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace stpeaks {

constexpr int kCluster = 8;  // blocks a map (the portable cluster size)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 3;    // resident an SM: <= 80 registers
constexpr int kRowsVec = 4;      // rows a chunk, 16-byte loads
constexpr int kRowsScalar = 8;   // rows a chunk, 4-byte loads
constexpr int kWarpCap = 64;     // keys a warp's buffer holds
constexpr int kParts = 18;
constexpr int kMaxPeaks = 24;
constexpr int kFill = 2 * kMaxPeaks;  // the fill indices lie in [0, 48)
constexpr float kThre = 0.1f;  // THRE_PEAK, as float32

static_assert(kWarpCap == 64, "a warp sorts its buffer two keys a lane");
static_assert(kCluster * kMaxPeaks <= kThreads,
              "rank 0 ranks the cluster's keys a thread each");
static_assert(kMaxPeaks <= 32, "a warp sorts its list a key a lane");
static_assert(kFill <= 64, "the fill takes two ballots");
static_assert(kRowsVec * 4 < 32 && kRowsScalar < 32,
              "a chunk's pixels, and the shift past them, fit a 32-bit mask");

using Key = unsigned long long;  // 0: no peak

__device__ __forceinline__ Key key_of(float v, int idx) {
  return (static_cast<Key>(__float_as_uint(v)) << 32) |
         static_cast<uint32_t>(~idx);
}
__device__ __forceinline__ int index_of(Key k) {
  return static_cast<int>(~static_cast<uint32_t>(k));
}
__device__ __forceinline__ float value_of(Key k) {
  return __uint_as_float(static_cast<uint32_t>(k >> 32));
}

// The larger of a and b, NaN if either is (then no >= test passes, as in
// the eight tests of the plain version).
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ void cluster_arrive() {  // release
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {  // acquire
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Two keys a lane: element lane and element lane + 32 of a warp's 64.
struct Pair {
  Key a, b;
};

// A warp's 64 keys -> the same keys in descending order (a bitonic sort
// through shuffles).
__device__ __forceinline__ Pair sort64_desc(Pair p, int lane) {
  Key a = p.a, b = p.b;
#pragma unroll
  for (int k = 2; k <= 64; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j == 32) {  // k == 64: a is the lower of each pair
        if (a < b) {
          const Key q = a;
          a = b;
          b = q;
        }
        continue;
      }
      const Key pa = __shfl_xor_sync(0xffffffffu, a, j);
      const Key pb = __shfl_xor_sync(0xffffffffu, b, j);
      // an element keeps the larger when it is the lower of its pair in a
      // descending run, or the upper in an ascending one
      const bool lower = (lane & j) == 0;
      a = lower == ((lane & k) == 0) ? (a > pa ? a : pa) : (a < pa ? a : pa);
      b = lower == (((lane + 32) & k) == 0) ? (b > pb ? b : pb)
                                            : (b < pb ? b : pb);
    }
  return {a, b};
}

// A warp's buffer of n > 24 keys -> its top 24, in order, at buf[0..24);
// returns the cut-off raised to the 24th, which it also offers the
// cluster's.
__device__ __forceinline__ Key compact(Key* buf, int n, Key cut,
                                       Key* cluster_cut, int lane) {
  __syncwarp();
  const Pair p = sort64_desc({lane < n ? buf[lane] : 0,
                              lane + 32 < n ? buf[lane + 32] : 0},
                             lane);
  if (lane < kMaxPeaks) buf[lane] = p.a;
  __syncwarp();
  const Key k24 = __shfl_sync(0xffffffffu, p.a, kMaxPeaks - 1);
  if (k24 > cut) {
    cut = k24;
    if (lane == 0) atomicMax(cluster_cut, k24);
  }
  return cut;
}

// The cluster's cut-off as this warp last knew it, raised to the shared
// one (a load from block rank 0's shared memory).
__device__ __forceinline__ Key shared_cut(const Key* cluster_cut, Key cut,
                                          int lane) {
  Key c = 0;
  if (lane == 0) c = *static_cast<const volatile Key*>(cluster_cut);
  c = __shfl_sync(0xffffffffu, c, 0);
  return c > cut ? c : cut;
}

// One chunk of a warp's walk: G rows from a of one strip, whose rows
// [ys, ye) are this warp's to test.
struct Chunk {
  int strip, a, ys, ye;
};

// A warp's share of a band: row-strips [lo, hi) of the band's strips x
// rows, strip-major; its walk is the chunks of each (strip, row range).
struct Walk {
  int y0, rows, hi;
  // The first chunk of the range that starts at row-strip q0 (a = ys - 1:
  // its first row is the upper halo); end: the row-strip it ends at.
  __device__ Chunk start(int q0, int& end) const {
    const int s = q0 / rows;
    end = min(hi, (s + 1) * rows);
    const int ys = y0 + q0 - s * rows;
    return {s, ys - 1, ys, y0 + end - s * rows};
  }
};

// The chunk after c (which tests rows a - 1 .. a + G - 2), false at the
// end of the walk.
template <int G>
__device__ __forceinline__ bool next_chunk(const Walk& walk, int& end,
                                           Chunk& c) {
  c.a += G;
  if (c.a - 1 < c.ye) return true;
  if (end >= walk.hi) return false;
  c = walk.start(end, end);
  return true;
}

// Chunk c's G rows at the lane's V columns into rows[2..] and, in lanes
// 0 and 31, the column beside the strip (strip_x - 1, strip_x + 32 V) into
// edges[2..]: loads issued together, -1 outside the map; rows past ye,
// which no tested row touches, are not loaded.
template <int V, int G>
__device__ __forceinline__ void fetch(const float* map, int h, int w,
                                      const Chunk& c, float (&rows)[G + 2][V],
                                      float (&edges)[G + 2], int lane) {
  const int strip_x = c.strip * 32 * V;
  const int x = strip_x + lane * V;
  const int ex = lane == 0 ? strip_x - 1 : strip_x + 32 * V;
  const bool edge_lane = (lane == 0 || lane == 31) && ex >= 0 && ex < w;
  const int first = max(0, -c.a);                  // rows in the map:
  const int last = min(h - 1, c.ye) - c.a;         // [first, last]
  const float* row = map + static_cast<int64_t>(c.a) * w;
#pragma unroll
  for (int i = 0; i < G; ++i, row += w) {
    const bool in = i >= first && i <= last;
    float* out = rows[i + 2];
    if (in && x < w) {
      if constexpr (V == 4) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(row + x));
        out[0] = q.x;
        out[1] = q.y;
        out[2] = q.z;
        out[3] = q.w;
      } else {
        out[0] = __ldg(row + x);
      }
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) out[k] = -1.f;
    }
    edges[i + 2] = in && edge_lane ? __ldg(row + ex) : -1.f;
  }
}

// The stencil and the keys of one chunk whose warp holds a pixel that
// passes the gate. r[i] is row a - 2 + i at the lane's V columns from x,
// edge[i] its column beside the strip (lanes 0 and 31); bit i * V + k of
// tested: pixel (a - 1 + i, x + k) is this warp's to test.
template <int V, int G>
__device__ __forceinline__ void chunk_peaks(
    int w, int a, int x, float gate, uint32_t tested,
    const float (&r)[G + 2][V], const float (&edge)[G + 2], Key* buf,
    int& n, Key& cut, Key* cluster_cut, int lane) {
  // e[i] = row a - 2 + i from column x - 1 to x + V
  float e[G + 2][V + 2];
#pragma unroll
  for (int i = 0; i < G + 2; ++i) {
    const float up = __shfl_up_sync(0xffffffffu, r[i][V - 1], 1);
    const float down = __shfl_down_sync(0xffffffffu, r[i][0], 1);
    e[i][0] = lane == 0 ? edge[i] : up;
#pragma unroll
    for (int k = 0; k < V; ++k) e[i][k + 1] = r[i][k];
    e[i][V + 1] = lane == 31 ? edge[i] : down;
  }
  // bit i * V + k: pixel (a - 1 + i, x + k) passes the gate and is >= the
  // largest of its 3x3 window, which holds the pixel itself: it is >=
  // every neighbour.
  uint32_t mask = 0;
#pragma unroll
  for (int i = 0; i < G; ++i) {
    float m[V + 2];  // the largest of rows a - 2 + i .. a + i, by column
#pragma unroll
    for (int c = 0; c < V + 2; ++c)
      m[c] = max_nan(max_nan(e[i][c], e[i + 1][c]), e[i + 2][c]);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float v = e[i + 1][k + 1];
      const float top = max_nan(max_nan(m[k], m[k + 1]), m[k + 2]);
      mask |= (v >= gate && v >= top ? 1u : 0u) << (i * V + k);
    }
  }
  mask &= tested;
  if (!__any_sync(0xffffffffu, mask)) return;
  // peaks: learn the cluster's cut-off, and keep those above it
  cut = shared_cut(cluster_cut, cut, lane);
  if (cut) {
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (key_of(e[i + 1][k + 1], (a - 1 + i) * w + x + k) <= cut)
          mask &= ~(1u << (i * V + k));
  }

  uint32_t any = __reduce_or_sync(0xffffffffu, mask);
  const uint32_t below = (1u << lane) - 1;
  while (any) {  // the same in every lane
    const int bit = __ffs(any) - 1;
    any &= any - 1;
    float v = 0.f;
#pragma unroll
    for (int b = 0; b < G * V; ++b)
      if (b == bit) v = e[b / V + 1][b % V + 1];
    const int i = bit / V;
    const Key key = key_of(v, (a - 1 + i) * w + x + bit - i * V);
    bool want = ((mask >> bit) & 1) && key > cut;
    uint32_t ballot = __ballot_sync(0xffffffffu, want);
    if (n + __popc(ballot) > kWarpCap) {
      cut = compact(buf, n, cut, cluster_cut, lane);
      n = kMaxPeaks;
      want = want && key > cut;
      ballot = __ballot_sync(0xffffffffu, want);
    }
    if (want) buf[n + __popc(ballot & below)] = key;
    n += __popc(ballot);
  }
  __syncwarp();
}

// Rows [y0, y1) of one map: this warp's share of the band's row-strips,
// walked in chunks of G rows -> its keys in buf[0..n), n <= 24, each at
// least the cut-off.
template <int V, int G>
__device__ void scan_band(const float* map, int h, int w, int y0, int y1,
                          Key* buf, int& n, Key& cut, Key* cluster_cut,
                          int warp, int lane) {
  // the smallest float above the threshold: v >= it is v > kThre
  const float above_thre = __uint_as_float(__float_as_uint(kThre) + 1u);
  const int strips = (w + 32 * V - 1) / (32 * V);
  const int rows = y1 - y0;
  const int total = strips * rows;
  const int lo = warp * total / kWarps;
  Walk walk{y0, rows, (warp + 1) * total / kWarps};
  if (lo >= walk.hi) return;
  int end;
  Chunk c = walk.start(lo, end);
  float r[G + 2][V];  // rows a - 2 .. a + G - 1 of chunk c
  float edge[G + 2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int k = 0; k < V; ++k) r[G + i][k] = -1.f;
    edge[G + i] = -1.f;
  }
  for (;;) {
    // rows a - 2 and a - 1 are the last chunk's (unused at a range's start)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int k = 0; k < V; ++k) r[i][k] = r[G + i][k];
      edge[i] = edge[G + i];
    }
    fetch<V, G>(map, h, w, c, r, edge, lane);
    // the chunk tests rows a - 1 + i for i in [i0, i1)
    const int i0 = max(0, c.ys - c.a + 1);
    const int i1 = min(G, c.ye - c.a + 1);
    // a pixel passes when it is above the threshold and not below the
    // value of the warp's cut-off (its key decides at equal values);
    // fmaxf drops NaN, which passes no test
    const float gate = cut ? fmaxf(value_of(cut), above_thre) : above_thre;
    float best = -1.f;
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (i >= i0 && i < i1) best = fmaxf(best, r[i + 1][k]);
    if (__any_sync(0xffffffffu, best >= gate)) {
      const uint32_t tested = ((1u << (i1 * V)) - 1) & ~((1u << (i0 * V)) - 1);
      chunk_peaks<V, G>(w, c.a, c.strip * 32 * V + lane * V, gate, tested,
                        r, edge, buf, n, cut, cluster_cut, lane);
    }
    if (!next_chunk<G>(walk, end, c)) break;
  }
  if (n > kMaxPeaks) {
    cut = compact(buf, n, cut, cluster_cut, lane);
    n = kMaxPeaks;
  }
  // keys below any cut-off have 24 larger ones: drop them
  cut = shared_cut(cluster_cut, cut, lane);
  const Key mine = lane < n ? buf[lane] : 0;
  const bool keep = mine && mine >= cut;
  const uint32_t kept = __ballot_sync(0xffffffffu, keep);
  __syncwarp();
  if (keep) buf[__popc(kept & ((1u << lane) - 1))] = mine;
  n = __popc(kept);
  __syncwarp();
}

// A warp's 32 keys, one a lane -> descending (a bitonic sort through
// shuffles).
__device__ __forceinline__ Key sort32_desc(Key a, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const Key pa = __shfl_xor_sync(0xffffffffu, a, j);
      const bool lower = (lane & j) == 0;
      a = lower == ((lane & k) == 0) ? (a > pa ? a : pa) : (a < pa ? a : pa);
    }
  return a;
}

// How many of the n keys of a descending list exceed k.
__device__ __forceinline__ int count_above(const Key* list, int n, Key k) {
  int lo = 0;
#pragma unroll
  for (int step = 32; step; step >>= 1)  // lists hold at most 24 keys
    if (lo + step <= n && list[lo + step - 1] > k) lo += step;
  return lo;
}

// Lists q < kLists of counts[q] <= 24 keys each, descending, at
// lists + q * stride; this thread holds key i of list q (i < counts[q])
// -> its rank among all of them (keys are unique).
template <int kLists>
__device__ __forceinline__ int merged_rank(const Key* lists, int stride,
                                           const int* counts, int q, int i,
                                           Key k) {
  int rank = i;
#pragma unroll
  for (int o = 0; o < kLists; ++o)
    if (o != q) rank += count_above(lists + o * stride, counts[o], k);
  return rank;
}

template <int V, int G>
__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kThreads, kMinBlocks)
        pose_peaks(const float* __restrict__ heat, int c, int h, int w,
                   float* __restrict__ peaks, bool* __restrict__ valid) {
  __shared__ Key s_buf[kWarps][kWarpCap];
  __shared__ Key s_top[kMaxPeaks];  // the block's best, in order
  __shared__ Key s_cluster[kCluster][kMaxPeaks];  // rank 0's: the blocks'
  __shared__ int s_lens[kCluster];                // rank 0's: their counts
  __shared__ Key s_cut;  // rank 0's: the cluster's cut-off
  __shared__ int s_count[kWarps];
  cg::cluster_group cluster = cg::this_cluster();
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int rank = static_cast<int>(cluster.block_rank());
  if (t == 0) s_cut = 0;
  cluster_arrive();  // rank 0's cut-off is set
  const int map_id = blockIdx.x / kCluster;
  const int frame = map_id / kParts;
  const int part = map_id - frame * kParts;
  const float* map = heat + (static_cast<int64_t>(frame) * c + part) *
                                static_cast<int64_t>(h) * w;
  const int band = (h + kCluster - 1) / kCluster;
  const int y0 = min(h, rank * band);
  const int y1 = min(h, y0 + band);
  Key* cluster_cut = cluster.map_shared_rank(&s_cut, 0);
  cluster_wait();

  Key* buf = s_buf[warp];
  int n = 0;
  Key cut = 0;
  scan_band<V, G>(map, h, w, y0, y1, buf, n, cut, cluster_cut, warp, lane);

  // The block's best 24, in order: each warp sorts its list, and each
  // key finds its rank among the block's by binary search in the others.
  {
    const Key k = sort32_desc(lane < n ? buf[lane] : 0, lane);
    if (lane < n) buf[lane] = k;
    if (lane == 0) s_count[warp] = n;
  }
  __syncthreads();
  if (lane < n) {
    const Key k = buf[lane];
    const int r = merged_rank<kWarps>(&s_buf[0][0], kWarpCap, s_count, warp,
                                      lane, k);
    if (r < kMaxPeaks) s_top[r] = k;
  }
  __syncthreads();
  int kept = 0;
#pragma unroll
  for (int q = 0; q < kWarps; ++q) kept += s_count[q];
  kept = min(kept, kMaxPeaks);
  // ... into rank 0's lists, through distributed shared memory
  if (t < kept) cluster.map_shared_rank(&s_cluster[rank][0], 0)[t] = s_top[t];
  if (t == 0) *cluster.map_shared_rank(&s_lens[rank], 0) = kept;
  cluster_arrive();
  cluster_wait();
  if (rank != 0) return;

  // Rank 0: the cluster's best 24, in order, merged the same way.
  if (t < kCluster * kMaxPeaks) {
    const int q = t / kMaxPeaks;
    const int i = t - q * kMaxPeaks;
    if (i < s_lens[q]) {
      const Key k = s_cluster[q][i];
      const int r = merged_rank<kCluster>(&s_cluster[0][0], kMaxPeaks,
                                          s_lens, q, i, k);
      if (r < kMaxPeaks) s_top[r] = k;
    }
  }
  __syncthreads();
  if (warp != 0) return;
  int found = 0;
#pragma unroll
  for (int q = 0; q < kCluster; ++q) found += s_lens[q];
  found = min(found, kMaxPeaks);
  const Key key = lane < found ? s_top[lane] : 0;
  // the fill: the first 24 - found indices of [0, 48) that are no peak's
  const int own = lane < found ? index_of(key) : -1;
  const uint32_t taken0 = __reduce_or_sync(
      0xffffffffu, own >= 0 && own < 32 ? 1u << own : 0u);
  const uint32_t taken1 = __reduce_or_sync(
      0xffffffffu, own >= 32 && own < 64 ? 1u << (own - 32) : 0u);
  const int lim = h * w < kFill ? h * w : kFill;
  const bool free0 = lane < lim && !((taken0 >> lane) & 1);
  const bool free1 = lane + 32 < lim && !((taken1 >> lane) & 1);
  const uint32_t b0 = __ballot_sync(0xffffffffu, free0);
  const uint32_t b1 = __ballot_sync(0xffffffffu, free1);
  const uint32_t below = (1u << lane) - 1;
  const int64_t first = static_cast<int64_t>(map_id) * kMaxPeaks;
  auto write = [&](int slot, int i, float score) {
    const int64_t o = first + slot;
    const int y = i / w;
    peaks[o * 3 + 0] = static_cast<float>(i - y * w);
    peaks[o * 3 + 1] = static_cast<float>(y);
    peaks[o * 3 + 2] = score;
    valid[o] = score > 0.f;
  };
  if (lane < found) write(lane, index_of(key), value_of(key));
  if (free0) {
    const int slot = found + __popc(b0 & below);
    if (slot < kMaxPeaks) write(slot, lane, -1.f);
  }
  if (free1) {
    const int slot = found + __popc(b0) + __popc(b1 & below);
    if (slot < kMaxPeaks) write(slot, lane + 32, -1.f);
  }
}

using KernelFn = void (*)(const float*, int, int, int, float*, bool*);

KernelFn kernel_for(bool vec) {
  return vec ? pose_peaks<4, kRowsVec> : pose_peaks<1, kRowsScalar>;
}

}  // namespace stpeaks

// heat [t, c, h, w] float32 (c >= 18, 24 <= h * w < 2^31), peaks
// [t, 18, 24, 3] float32, valid [t, 18, 24] bool. A cluster of 8 blocks a
// (frame, part); 16-byte loads where w % 4 == 0 and heat is 16-byte
// aligned. Launches on `stream`; returns a cudaError_t (0 = ok).
extern "C" int st_pose_peaks(const float* heat, int t, int c, int h, int w,
                             float* peaks, bool* valid, void* stream) {
  using namespace stpeaks;
  if (t <= 0) return 0;
  const int64_t n = static_cast<int64_t>(h) * w;
  if (c < kParts || h < 1 || w < 1 || n < kMaxPeaks || n > 0x7fffffff ||
      static_cast<int64_t>(t) * kParts * kCluster > 0x7fffffff)
    return cudaErrorInvalidValue;
  const unsigned blocks = static_cast<unsigned>(t * kParts * kCluster);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w % 4 == 0 && reinterpret_cast<uintptr_t>(heat) % 16 == 0)
    pose_peaks<4, kRowsVec><<<blocks, kThreads, 0, s>>>(heat, c, h, w,
                                                        peaks, valid);
  else
    pose_peaks<1, kRowsScalar><<<blocks, kThreads, 0, s>>>(heat, c, h, w,
                                                           peaks, valid);
  return static_cast<int>(cudaGetLastError());
}

// The launch's resources, for the 16-byte (vec != 0) or the 4-byte form:
// out = {registers a thread, static shared bytes a block, local bytes a
// thread (spills), blocks resident an SM, clusters resident on the card}.
// Returns a cudaError_t (0 = ok).
extern "C" int st_pose_peaks_info(int vec, int* out) {
  using namespace stpeaks;
  const KernelFn fn = kernel_for(vec != 0);
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = static_cast<int>(a.localSizeBytes);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], fn, kThreads,
                                                      0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(&out[4], fn, &cfg));
}
