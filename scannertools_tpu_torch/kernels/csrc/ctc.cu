// CTC Viterbi over a batch of windows: the lattice DP and its backtrace.
//
// Replaces the JAX package's _viterbi_fn (scannertools_tpu/ops/ctc_align.py:
// 79-113): a lax.scan over time of the max over three moves (stay s->s,
// advance s-1->s, skip s-2->s where allowed) plus the frame's emission, and
// a reverse scan over the stored argmax pointers. XLA fuses each into one
// program a window shape; plain torch pays about six launches a frame.
//
// Inputs: log_probs [B, Tmax, V] f32, t_len [B] i32, labels_ext [B, Smax]
// i32, allow_skip [B, Smax] u8 (bool), s_len [B] i32. Outputs: states
// [B, Tmax] i32 (-1 past a window's T) and score [B] f32. Every window of
// a call goes in one launch, on one of two paths that ops/ctc_align.py's
// viterbi_geometry picks from (B, Tmax, Smax, V):
//
// The warp path (Smax <= kWarpMaxStates = 256, and a window's shared
// bytes within kSharedMax): one warp a window, up to kMaxWindows windows
// a block. Lane l owns K = ceil(Smax / 32) contiguous states s = l * K + k
// (K a template parameter, 1..8) and keeps their alpha, labels and skip
// flags in registers. A step takes the values of s - 1 and s - 2 from the
// lane's own registers, and at its first two states from lane l - 1 by
// __shfl_up_sync (lane l - 2 when K = 1): no shared memory and no barrier
// sit on the step's chain. Frame 0's emissions come from device memory;
// frames 1 .. T - 1 arrive ahead of the scan in a ring of kStages stages
// of `rows` rows (4 or 8, whole groups of kGroupSteps = 4 steps) in shared
// memory, a stage one cp.async.bulk copy completed on the stage's
// mbarrier. A bulk copy needs 16-byte alignment, which a row of V floats
// has only when V % 4 == 0 and the emissions start on a 16-byte boundary;
// otherwise the lanes fill the same ring with 4-byte cp.async copies that
// arrive on the same mbarrier. A group's emissions are read together,
// before its 4 steps, so that their latency is off the steps' chain: for
// V <= 32 one shared load a lane a row and a __shfl_sync of each state's
// label, else a shared load a state. The moves go to shared memory at
// kMoveBits = 2 bits a state: a lane packs its K moves into 16 bits a step
// and a group into one 64-bit store, 64 bytes a step, 22.5 KB for a window
// of 350 frames. After the last step one lane walks the packed words back
// from the final state, a group at a time, from two lanes' words a group
// (walk_back), into a byte a frame in shared memory; the warp writes the
// path out in coalesced stores. No device-memory scratch.
//
// The block path (Smax above 256, up to kMaxStates = 4096, or a Tmax
// whose back-pointers overflow a block's shared memory): one block a
// window. Each thread owns up to kPerThread states (s = tid + k *
// blockDim); alpha is double-buffered in shared memory, one barrier a
// step; the back-pointers go to device-memory scratch bps [B, Tmax - 1,
// Smax] i8, and one thread walks them back.
//
// What bounds it: not bytes (the function reads log_probs once and writes
// the path once: about 24 MB for 600 windows of T 250-350 and S 81-161,
// 0.0072 ms at 3.35 TB/s) but the scan: T - 1 dependent steps, then T - 1
// dependent rows of the backtrace. Windows run side by side, so a call
// takes about as long as its longest window. On the warp path a step of
// one warp issues about 12 K + 10 instructions, most of them compares,
// selects and the moves' packing on the integer and logic pipe, and that
// issue, not the shuffles' latency, sets its pace (tools/ctc_probe.py;
// PERF.md). st_ctc_step_probe measures the step's chain alone (the
// shuffles, the max, the add), st_ctc_block_step_probe the block path's
// (a shared round trip and a barrier).
//
// Numerics: each cell is a max of three values and one f32 add, with no
// reduction across threads, so the result equals the jitted JAX program
// and viterbi_plain bit for bit on both paths. Ties go to the first move
// in the order stay, advance, skip (strict > in that order, jnp.argmax's
// first maximum); the final state is S - 1 if alpha[S - 1] >= alpha[S - 2],
// else S - 2. No state below 0 is read, even where allow_skip is set on
// states 0 and 1. NEG + emission stays NEG in f32 for any log-prob above
// -1e22.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace stctc {

constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// the warp path; ops/ctc_align.py mirrors each of these
constexpr int kLanes = 32;
constexpr int kMaxK = 8;                         // states a lane, at most
constexpr int kWarpMaxStates = kLanes * kMaxK;   // WARP_MAX_STATES
constexpr int kMoveBits = 2;                     // 0 stay, 1 advance, 2 skip
constexpr int kGroupSteps = 4;                   // steps a lane's 64-bit word
constexpr int kStages = 4;                       // stages of the ring
constexpr int kMaxRows = 8;                      // emission rows a stage
constexpr int kRingFloats = 1024;                // the ring, for its rows
constexpr int kBarrierBytes = 64;                // a window's mbarriers
constexpr int kMaxWindows = 8;                   // windows (warps) a block
constexpr int kSharedMax = 232448;               // a block's shared bytes
constexpr uint32_t kWaitTries = 1u << 24;        // then the copy is lost
static_assert(kMoveBits * kMaxK <= 16, "a lane's moves in one uint16");
static_assert(kGroupSteps * 16 == 64, "a group's steps in one uint64");
static_assert(kStages * 8 <= kBarrierBytes, "the stages' mbarriers");
static_assert(kWarpMaxStates <= 256, "a state in one byte of the path");

// the block path
constexpr int kPerThread = 4;        // states a thread, at most
constexpr int kMaxThreads = 1024;
constexpr int kMaxStates = kPerThread * kMaxThreads;  // MAX_STATES

// Emission rows a stage of the ring: kRingFloats over the stages, in whole
// groups of kGroupSteps rows, 4 or kMaxRows = 8 rows of V floats.
inline int ring_rows(int v) {
  const int groups = kRingFloats / (kStages * kGroupSteps * v);
  return kGroupSteps * std::max(1, std::min(kMaxRows / kGroupSteps, groups));
}

// Groups of kGroupSteps steps in the Tmax - 1 steps of a window.
__host__ __device__ inline int move_groups(int tmax) {
  return (tmax - 1 + kGroupSteps - 1) / kGroupSteps;
}

// A window's shared bytes on the warp path: its mbarriers, the ring, the
// packed moves of Tmax - 1 steps (a 64-bit word a lane a group of 4) and
// the path's byte a frame (and a group past the last, which the walk
// writes), in 128-byte units so that every window's region keeps the ring
// 16-byte aligned.
inline int64_t window_bytes(int tmax, int v, int rows) {
  const int64_t ring = int64_t{kStages} * rows * v * 4;
  const int64_t moves = int64_t{move_groups(tmax)} * kLanes * 8;
  const int64_t path = (int64_t{tmax} + kGroupSteps + 15) / 16 * 16;
  return (kBarrierBytes + ring + moves + path + 127) / 128 * 128;
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   shared_addr(bar)),
               "r"(count)
               : "memory");
}

// Waits for the completion of the barrier's phase of this parity. A copy
// that has not landed after kWaitTries polls is lost: trap, so that the
// launch fails rather than hangs.
__device__ __forceinline__ void barrier_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = shared_addr(bar);
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == kWaitTries) __trap();
  }
}

// Stage `chunk` of a window's emissions: rows [chunk * rows, + rows) of
// the T rows at `lp`, into `dst`, completing on `bar`. Bulk: lane 0 issues
// one copy of whole rows. Otherwise every lane copies 4-byte elements with
// cp.async and arrives on the barrier (counted 32) when its copies have
// landed.
template <bool kBulk>
__device__ __forceinline__ void stage_rows(float* dst, const float* lp,
                                           int chunk, int rows, int T, int v,
                                           uint64_t* bar, int lane) {
  const int r0 = chunk * rows;
  const int n = min(rows, T - r0) * v;
  const float* src = lp + static_cast<int64_t>(r0) * v;
  if (kBulk) {
    if (lane == 0) {
      const uint32_t bytes = static_cast<uint32_t>(n) * 4;
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
              shared_addr(bar)),
          "r"(bytes)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n" ::"r"(shared_addr(dst)),
          "l"(src), "r"(bytes), "r"(shared_addr(bar))
          : "memory");
    }
  } else {
    for (int i = lane; i < n; i += kLanes)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       shared_addr(dst + i)),
                   "l"(src + i)
                   : "memory");
    asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(
                     shared_addr(bar))
                 : "memory");
  }
}

// a where the mask is ~0u, b where it is 0, bit for bit: one LOP3 and no
// predicate (a step of K states is short of the warp's 7 predicates).
__device__ __forceinline__ float pick(uint32_t m, float a, float b) {
  return __uint_as_float((__float_as_uint(a) & m) | (__float_as_uint(b) & ~m));
}

// One step of a lane's K states: alpha `a` of step t - 1 plus the frame's
// emissions `e` becomes step t's, the K moves packed 2 bits a state into
// the returned word. up1 and up2 are the values of states l * K - 1 and
// l * K - 2 (kNeg where below 0); skip[k] is ~0u where the skip into state
// l * K + k is allowed, else 0.
template <int K>
__device__ __forceinline__ uint32_t lane_step(float (&a)[K],
                                              const float (&e)[K],
                                              const uint32_t (&skip)[K],
                                              float up1, float up2) {
  float next[K];
  uint32_t word = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float best = a[k];
    uint32_t move = 0;
    const float adv = k >= 1 ? a[k - 1] : up1;
    if (adv > best) {
      best = adv;
      move = 1;
    }
    const float below = k >= 2 ? a[k - 2] : (k == 1 ? up1 : up2);
    const float skp = pick(skip[k], below, kNeg);
    if (skp > best) {
      best = skp;
      move = 2;
    }
    next[k] = __fadd_rn(best, e[k]);
    word |= move << (kMoveBits * k);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) a[k] = next[k];
  return word;
}

// The values of states l * K - 1 and l * K - 2, from lane l - 1 (from lane
// l - 2 for the second when K = 1); kNeg for lane 0's state -1. A value
// below state 0 is never used: the skip is allowed only from s >= 2.
template <int K>
__device__ __forceinline__ void from_below(const float (&a)[K], int lane,
                                           float& up1, float& up2) {
  up1 = __shfl_up_sync(kFull, a[K - 1], 1);
  up2 = K >= 2 ? __shfl_up_sync(kFull, a[K >= 2 ? K - 2 : 0], 1)
               : __shfl_up_sync(kFull, a[0], 2);
  if (lane == 0) up1 = kNeg;
}

// alpha of state s (uniform across the warp), from the lane that owns it
template <int K>
__device__ __forceinline__ float alpha_of(const float (&a)[K], int s) {
  const int kk = s % K;
  float mine = a[0];
#pragma unroll
  for (int k = 1; k < K; ++k)
    if (k == kk) mine = a[k];
  return __shfl_sync(kFull, mine, s / K);
}

// Logical shift right with PTX's clamp: a shift of 32 or more (a negative
// one read as unsigned) gives 0.
__device__ __forceinline__ uint32_t shr_clamped(uint32_t x, int n) {
  uint32_t r;
  asm("shr.b32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(n));
  return r;
}

// The moves of group g (rows 4 g .. 4 g + 3) for the path that enters it
// at state owner * K + k, one row at a time, reading a lane's word again
// wherever the path leaves the lane's states. Writes path[4 g .. 4 g + 3]
// and leaves (owner, k) at the path's state at frame 4 g.
template <int K>
__device__ __forceinline__ void walk_group(const uint64_t* moves,
                                           uint8_t* path, int g, int& owner,
                                           int& k) {
  uint64_t word = moves[g * kLanes + owner];
#pragma unroll
  for (int i = kGroupSteps - 1; i >= 0; --i) {
    k -= static_cast<int>(word >> (16 * i + kMoveBits * k)) & 3;
    if (k < 0) {  // into the states of a lane below (two when K = 1)
      do {
        k += K;
        --owner;
      } while (k < 0);
      word = moves[g * kLanes + owner];
    }
    path[g * kGroupSteps + i] = static_cast<uint8_t>(owner * K + k);
  }
}

// The path of a window from its final state back to frame 0, by one lane.
// `moves` holds, for each group of kGroupSteps steps, a 64-bit word a lane:
// row r's 16 bits at 16 * (r % 4), and in them state l * K + k's move at
// 2 k (row r: the step into frame r + 1; rows past the window's last are
// 0, stay). The walk takes the groups from the window's last. For a group
// it reads the words of two lanes, the path's (`owner`) and the one below,
// and joins a row's 2 K moves of the two into one 32-bit field, so that a
// row costs a shift, a mask and a subtract on the state q counted from the
// lower lane's first: no read and no branch on the chain. Where the path
// drops below the two lanes within a group (four skips), the group is
// walked again a row at a time (walk_group). path[t] is the state at frame
// t; path[T .. T + 2] are written and not read.
template <int K>
__device__ __forceinline__ void walk_back(const uint64_t* moves,
                                          uint8_t* path, int state, int T) {
  path[T - 1] = static_cast<uint8_t>(state);
  int owner = state / K;
  int q = state - owner * K + K;
  for (int g = (T - 2) / kGroupSteps; T >= 2 && g >= 0; --g) {
    const uint64_t hi = moves[g * kLanes + owner];
    const uint64_t lo = owner > 0 ? moves[g * kLanes + owner - 1] : 0;
    const int entry = q;
#pragma unroll
    for (int i = kGroupSteps - 1; i >= 0; --i) {
      const uint32_t field =
          (static_cast<uint32_t>(lo >> (16 * i)) & 0xffffu) |
          (static_cast<uint32_t>(hi >> (16 * i)) & 0xffffu) << (kMoveBits * K);
      q -= static_cast<int>(shr_clamped(field, kMoveBits * q)) & 3;
      path[g * kGroupSteps + i] = static_cast<uint8_t>((owner - 1) * K + q);
    }
    if (q < 0) {  // below both lanes: the group again, a row at a time
      int k = entry - K;
      walk_group<K>(moves, path, g, owner, k);
      q = k + K;
    } else if (q < K) {  // the next group's two lanes, one lower
      --owner;
      q += K;
    }
  }
}

template <int K, bool kBulk, bool kSmallV>
__global__ void __launch_bounds__(kLanes * kMaxWindows)
warp_viterbi_kernel(const float* __restrict__ log_probs,
                    const int* __restrict__ t_len,
                    const int* __restrict__ labels,
                    const uint8_t* __restrict__ allow_skip,
                    const int* __restrict__ s_len, int batch, int tmax,
                    int v, int smax, int rows, int stride,
                    int* __restrict__ states, float* __restrict__ score) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x % kLanes;
  const int warp = threadIdx.x / kLanes;
  const int b = blockIdx.x * (blockDim.x / kLanes) + warp;
  if (b >= batch) return;
  unsigned char* base = smem + static_cast<int64_t>(warp) * stride;
  uint64_t* bar = reinterpret_cast<uint64_t*>(base);
  float* ring = reinterpret_cast<float*>(base + kBarrierBytes);
  const int stage = rows * v;  // floats a stage
  uint2* moves = reinterpret_cast<uint2*>(ring + kStages * stage);
  uint8_t* path =
      reinterpret_cast<uint8_t*>(moves + move_groups(tmax) * kLanes);

  // clamp to the arrays: the wrapper's callers keep the lengths in range
  const int T = min(max(t_len[b], 1), tmax);
  const int S = min(max(s_len[b], 2), smax);
  const float* lp = log_probs + static_cast<int64_t>(b) * tmax * v;
  // the ring holds frames 1 .. T - 1, chunk c frames 1 + c * rows onwards
  const int steps = T - 1;
  const int chunks = (steps + rows - 1) / rows;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i)
      barrier_init(&bar[i], kBulk ? 1 : kLanes);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  for (int c = 0; c < min(chunks, kStages); ++c)
    stage_rows<kBulk>(ring + c * stage, lp + v, c, rows, steps, v, &bar[c],
                      lane);

  int lab[K];
  uint32_t skip[K];  // ~0u where the skip into state lane * K + k is allowed
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = lane * K + k;
    const int64_t at = static_cast<int64_t>(b) * smax + s;
    lab[k] = s < S ? min(max(labels[at], 0), v - 1) : 0;
    skip[k] = s < S && s >= 2 && allow_skip[at] != 0 ? ~0u : 0u;
  }
  // a row's emissions of the lane's states: for V <= 32 one load a lane
  // and a shuffle a state, else a load a state
  auto emissions = [&](const float* row, float (&e)[K]) {
    if (kSmallV) {
      const float mine = lane < v ? row[lane] : 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) e[k] = __shfl_sync(kFull, mine, lab[k]);
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) e[k] = row[lab[k]];
    }
  };
  auto step = [&](float (&a)[K], const float (&e)[K]) {
    float up1, up2;
    from_below(a, lane, up1, up2);
    return lane_step(a, e, skip, up1, up2);
  };

  float a[K];
#pragma unroll
  for (int k = 0; k < K; ++k)  // frame 0: only states 0 and 1 start
    a[k] = lane * K + k <= 1 ? __ldg(lp + lab[k]) : kNeg;
  for (int c = 0; c < chunks; ++c) {
    const int slot = c % kStages;
    barrier_wait(&bar[slot], (c / kStages) & 1);
    const float* rowp = ring + slot * stage;
    const int n = min(rows, steps - c * rows);
    uint2* out = moves + (c * rows / kGroupSteps) * kLanes + lane;
    int i = 0;
    // whole groups: a group's emissions loaded together, ahead of its
    // steps; its moves in one 64-bit store
    for (; i + kGroupSteps <= n; i += kGroupSteps, out += kLanes) {
      float e[kGroupSteps][K];
#pragma unroll
      for (int j = 0; j < kGroupSteps; ++j)
        emissions(rowp + (i + j) * v, e[j]);
      uint32_t half[2] = {0u, 0u};
#pragma unroll
      for (int j = 0; j < kGroupSteps; ++j)
        half[j / 2] |= step(a, e[j]) << (16 * (j % 2));
      *out = make_uint2(half[0], half[1]);
    }
    if (i < n) {  // the window's last group, short
      uint64_t word = 0;
      for (int j = 0; i + j < n; ++j) {
        float e[K];
        emissions(rowp + (i + j) * v, e);
        word |= static_cast<uint64_t>(step(a, e)) << (16 * j);
      }
      *out = make_uint2(static_cast<uint32_t>(word),
                        static_cast<uint32_t>(word >> 32));
    }
    __syncwarp();  // every lane is done with the slot before it refills
    if (c + kStages < chunks)
      stage_rows<kBulk>(ring + slot * stage, lp + v, c + kStages, rows,
                        steps, v, &bar[slot], lane);
  }

  // final state: the last token or the trailing blank, ties to the token
  const float last = alpha_of(a, S - 1);
  const float blank = alpha_of(a, S - 2);
  if (lane == 0) {
    score[b] = last >= blank ? last : blank;
    walk_back<K>(reinterpret_cast<const uint64_t*>(moves), path,
                 last >= blank ? S - 1 : S - 2, T);
  }
  __syncwarp();
  int* out = states + static_cast<int64_t>(b) * tmax;
  for (int t = lane; t < tmax; t += kLanes) out[t] = t < T ? path[t] : -1;
}

// The floor of the warp path's forward scan: `steps` dependent steps over
// one window of smax <= 256 states in one warp, each what a step of
// warp_viterbi_kernel cannot do without (the two shuffles from the lane
// below, the max of three values, the add) and nothing else: no emission
// load, no move stored. Alpha goes to `out` at the end, so the chain is
// not dead code. Timed at two step counts, its slope is one step's time.
template <int K>
__global__ void __launch_bounds__(kLanes)
warp_step_probe_kernel(int steps, int smax, float* __restrict__ out) {
  const int lane = threadIdx.x;
  float a[K], e[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = lane * K + k;
    e[k] = (s & 1) ? -0.5f : -0.25f;
    a[k] = s <= 1 ? 0.f : kNeg;
  }
  for (int t = 1; t <= steps; ++t) {
    float up1, up2;
    from_below(a, lane, up1, up2);
    if (lane < (K == 1 ? 2 : 1)) up2 = kNeg;  // every state may skip here
    float next[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float adv = k >= 1 ? a[k - 1] : up1;
      const float skp = k >= 2 ? a[k - 2] : (k == 1 ? up1 : up2);
      next[k] = __fadd_rn(fmaxf(a[k], fmaxf(adv, skp)), e[k]);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) a[k] = next[k];
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (lane * K + k < smax) out[lane * K + k] = a[k];
}

__global__ void __launch_bounds__(kMaxThreads)
block_viterbi_kernel(const float* __restrict__ log_probs,
                     const int* __restrict__ t_len,
                     const int* __restrict__ labels,
                     const uint8_t* __restrict__ allow_skip,
                     const int* __restrict__ s_len, int tmax, int v, int smax,
                     int8_t* __restrict__ bps, int* __restrict__ states,
                     float* __restrict__ score) {
  extern __shared__ float alpha[];  // [2][smax]
  const int b = blockIdx.x;
  // clamp to the arrays: the wrapper's callers keep the lengths in range
  const int T = min(max(t_len[b], 1), tmax);
  const int S = min(max(s_len[b], 2), smax);
  const float* lp = log_probs + static_cast<int64_t>(b) * tmax * v;
  int8_t* bp = bps + static_cast<int64_t>(b) * (tmax - 1) * smax;

  int lab[kPerThread];
  bool skip[kPerThread];
  float emit[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int s = threadIdx.x + k * blockDim.x;
    const bool on = s < S;
    const int64_t at = static_cast<int64_t>(b) * smax + s;
    lab[k] = on ? min(max(labels[at], 0), v - 1) : 0;
    skip[k] = on && s >= 2 && allow_skip[at] != 0;  // no state below 0
    if (on) alpha[s] = s <= 1 ? lp[lab[k]] : kNeg;
    emit[k] = (on && T > 1) ? lp[v + lab[k]] : 0.f;
  }
  __syncthreads();

  for (int t = 1; t < T; ++t) {
    const float* prev = alpha + ((t - 1) & 1) * smax;
    float* next = alpha + (t & 1) * smax;
    int8_t* bp_t = bp + static_cast<int64_t>(t - 1) * smax;
    float emit_next[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int s = threadIdx.x + k * blockDim.x;
      emit_next[k] = (s < S && t + 1 < T)
                         ? lp[static_cast<int64_t>(t + 1) * v + lab[k]]
                         : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int s = threadIdx.x + k * blockDim.x;
      if (s < S) {
        float best = prev[s];
        int8_t move = 0;
        const float adv = s >= 1 ? prev[s - 1] : kNeg;
        if (adv > best) {
          best = adv;
          move = 1;
        }
        const float skp = skip[k] ? prev[s - 2] : kNeg;
        if (skp > best) {
          best = skp;
          move = 2;
        }
        next[s] = __fadd_rn(best, emit[k]);
        bp_t[s] = move;
      }
      emit[k] = emit_next[k];
    }
    __syncthreads();
  }

  int* path = states + static_cast<int64_t>(b) * tmax;
  for (int t = T + threadIdx.x; t < tmax; t += blockDim.x) path[t] = -1;
  if (threadIdx.x == 0) {
    const float* last = alpha + ((T - 1) & 1) * smax;
    int state = last[S - 1] >= last[S - 2] ? S - 1 : S - 2;
    score[b] = last[state];
    path[T - 1] = state;
    for (int t = T - 2; t >= 0; --t) {
      state -= bp[static_cast<int64_t>(t) * smax + state];
      path[t] = state;
    }
  }
}

// The floor of the block path's forward scan: the steps of
// block_viterbi_kernel (three neighbours of the previous alpha read from
// shared memory, their maximum, the add, the next alpha written, one
// barrier) with no emission load and no back-pointer store.
__global__ void __launch_bounds__(kMaxThreads)
block_step_probe_kernel(int steps, int smax, float* __restrict__ out) {
  extern __shared__ float alpha[];  // [2][smax]
  float emit[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int s = threadIdx.x + k * blockDim.x;
    emit[k] = (s & 1) ? -0.5f : -0.25f;
    if (s < smax) alpha[s] = s <= 1 ? 0.f : kNeg;
  }
  __syncthreads();
  for (int t = 1; t <= steps; ++t) {
    const float* prev = alpha + ((t - 1) & 1) * smax;
    float* next = alpha + (t & 1) * smax;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int s = threadIdx.x + k * blockDim.x;
      if (s < smax) {
        const float adv = s >= 1 ? prev[s - 1] : kNeg;
        const float skp = s >= 2 ? prev[s - 2] : kNeg;
        next[s] = __fadd_rn(fmaxf(prev[s], fmaxf(adv, skp)), emit[k]);
      }
    }
    __syncthreads();
  }
  for (int s = threadIdx.x; s < smax; s += blockDim.x)
    out[s] = alpha[(steps & 1) * smax + s];
}

// Threads a block for windows of at most smax states on the block path:
// the fewest states a thread that fit kMaxThreads, rounded up to whole
// warps.
static int threads_for(int smax) {
  const int per = (smax + kMaxThreads - 1) / kMaxThreads;
  const int threads = (smax + per - 1) / per;
  return (threads + 31) / 32 * 32;
}

using WarpKernel = void (*)(const float*, const int*, const int*,
                            const uint8_t*, const int*, int, int, int, int,
                            int, int, int*, float*);

template <bool kBulk, bool kSmallV>
static WarpKernel warp_kernel(int k) {
  static const WarpKernel table[kMaxK] = {
      warp_viterbi_kernel<1, kBulk, kSmallV>,
      warp_viterbi_kernel<2, kBulk, kSmallV>,
      warp_viterbi_kernel<3, kBulk, kSmallV>,
      warp_viterbi_kernel<4, kBulk, kSmallV>,
      warp_viterbi_kernel<5, kBulk, kSmallV>,
      warp_viterbi_kernel<6, kBulk, kSmallV>,
      warp_viterbi_kernel<7, kBulk, kSmallV>,
      warp_viterbi_kernel<8, kBulk, kSmallV>};
  return table[k - 1];
}

using ProbeKernel = void (*)(int, int, float*);

static ProbeKernel warp_probe(int k) {
  static const ProbeKernel table[kMaxK] = {
      warp_step_probe_kernel<1>, warp_step_probe_kernel<2>,
      warp_step_probe_kernel<3>, warp_step_probe_kernel<4>,
      warp_step_probe_kernel<5>, warp_step_probe_kernel<6>,
      warp_step_probe_kernel<7>, warp_step_probe_kernel<8>};
  return table[k - 1];
}

}  // namespace stctc

// The warp path: `windows` windows (warps) a block, bulk copies when
// `bulk` (V % 4 == 0 and log_probs on a 16-byte boundary), else 4-byte
// cp.async. K = ceil(smax / 32).
extern "C" int st_ctc_viterbi_warp(const float* log_probs, const int* t_len,
                                   const int* labels,
                                   const uint8_t* allow_skip,
                                   const int* s_len, int b, int tmax, int v,
                                   int smax, int windows, int bulk,
                                   int* states, float* score, void* stream) {
  using namespace stctc;
  if (b <= 0) return 0;
  if (smax < 2 || smax > kWarpMaxStates || tmax < 1 || v < 1 ||
      windows < 1 || windows > kMaxWindows)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bulk && (v % 4 != 0 || reinterpret_cast<uintptr_t>(log_probs) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = ring_rows(v);
  const int64_t one = window_bytes(tmax, v, rows);
  if (one * windows > kSharedMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const int k = (smax + kLanes - 1) / kLanes;
  const bool small = v <= kLanes;
  const WarpKernel fn =
      bulk ? (small ? warp_kernel<true, true>(k) : warp_kernel<true, false>(k))
           : (small ? warp_kernel<false, true>(k)
                    : warp_kernel<false, false>(k));
  const int shared = static_cast<int>(one * windows);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<(b + windows - 1) / windows, windows * kLanes, shared,
       static_cast<cudaStream_t>(stream)>>>(
      log_probs, t_len, labels, allow_skip, s_len, b, tmax, v, smax, rows,
      static_cast<int>(one), states, score);
  return static_cast<int>(cudaGetLastError());
}

// The block path, for smax up to 4096; bps [b, tmax - 1, smax] i8 scratch.
extern "C" int st_ctc_viterbi_block(const float* log_probs, const int* t_len,
                                    const int* labels,
                                    const uint8_t* allow_skip,
                                    const int* s_len, int b, int tmax, int v,
                                    int smax, int8_t* bps, int* states,
                                    float* score, void* stream) {
  using namespace stctc;
  if (b <= 0) return 0;
  if (smax < 2 || smax > kMaxStates || tmax < 1 || v < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = threads_for(smax);
  const size_t shared = 2 * sizeof(float) * static_cast<size_t>(smax);
  block_viterbi_kernel<<<b, threads, shared,
                         static_cast<cudaStream_t>(stream)>>>(
      log_probs, t_len, labels, allow_skip, s_len, tmax, v, smax, bps,
      states, score);
  return static_cast<int>(cudaGetLastError());
}

// One warp, `steps` dependent steps of the warp path's forward scan over
// smax <= 256 states and nothing else; out [smax] f32.
extern "C" int st_ctc_step_probe(int steps, int smax, float* out,
                                 void* stream) {
  using namespace stctc;
  if (steps < 0 || smax < 2 || smax > kWarpMaxStates)
    return static_cast<int>(cudaErrorInvalidValue);
  const ProbeKernel fn = warp_probe((smax + kLanes - 1) / kLanes);
  fn<<<1, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(steps, smax, out);
  return static_cast<int>(cudaGetLastError());
}

// One block of the threads block_viterbi_kernel gives smax states, `steps`
// dependent steps of the block path's forward scan; out [smax] f32.
extern "C" int st_ctc_block_step_probe(int steps, int smax, float* out,
                                       void* stream) {
  using namespace stctc;
  if (steps < 0 || smax < 2 || smax > kMaxStates)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared = 2 * sizeof(float) * static_cast<size_t>(smax);
  block_step_probe_kernel<<<1, threads_for(smax), shared,
                            static_cast<cudaStream_t>(stream)>>>(steps, smax,
                                                                 out);
  return static_cast<int>(cudaGetLastError());
}
