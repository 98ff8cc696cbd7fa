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
// [B, Tmax] i32 (-1 past a window's T), score [B] f32, and the back-pointer
// scratch bps [B, Tmax - 1, Smax] i8 (0 stay, 1 advance, 2 skip).
//
// One block a window; every window of the call in one launch. Each thread
// owns up to kPerThread states (s = tid + k * blockDim), keeping their
// labels and skip flags in registers. Alpha is double-buffered in shared
// memory: step t reads buffer (t - 1) & 1 and writes t & 1, so one barrier
// a step orders each step's reads before the next step's writes. The next
// frame's emissions are loaded before the current frame's arithmetic, so
// the global load is off the step's critical path. The back-pointers of a
// step go to global memory in one coalesced row; after the last step one
// thread walks them back from the final state.
//
// What bounds it: not bytes (the function reads log_probs once and writes
// the path once: about 24 MB for 600 windows of T 250-350 and S 81-161,
// 0.0071 ms at 3.35 TB/s; the int8 pointers are this kernel's own scratch,
// about 22 MB more written and read) but the scan: T - 1 dependent steps,
// each a shared-memory round trip and a barrier, then T - 1 dependent
// loads of the backtrace. Blocks of different windows run side by side,
// so the call takes about as long as its longest window. st_ctc_step_probe
// measures the forward chain alone: the same steps with no global memory.
//
// Numerics: each cell is a max of three values and one f32 add, with no
// reduction across threads, so the result equals the jitted JAX program
// and viterbi_plain bit for bit. Ties go to the first move in the order
// stay, advance, skip (strict > in that order, jnp.argmax's first maximum);
// the final state is S - 1 if alpha[S - 1] >= alpha[S - 2], else S - 2.
// NEG + emission stays NEG in f32 for any log-prob above -1e22.

#include <cuda_runtime.h>
#include <stdint.h>

namespace stctc {

constexpr int kPerThread = 4;        // states a thread, at most
constexpr int kMaxThreads = 1024;
constexpr int kMaxStates = kPerThread * kMaxThreads;  // MAX_STATES in ctc_align.py
constexpr float kNeg = -1e30f;

__global__ void __launch_bounds__(kMaxThreads)
viterbi_kernel(const float* __restrict__ log_probs,
               const int* __restrict__ t_len, const int* __restrict__ labels,
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

// The floor of the forward scan: `steps` dependent steps over one window of
// smax states, each what a step of viterbi_kernel cannot do without (read
// the three neighbours of the previous alpha from shared memory, take
// their maximum, add, write the next alpha, one barrier) and nothing else:
// no emission load, no back-pointer store. Alpha goes to `out` at the end,
// so the chain is not dead code. Timed at two step counts, its slope is the
// latency of one step.
__global__ void __launch_bounds__(kMaxThreads)
step_probe_kernel(int steps, int smax, float* __restrict__ out) {
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

// Threads a block for windows of at most smax states: the fewest states a
// thread that fit kMaxThreads, rounded up to whole warps.
static int threads_for(int smax) {
  const int per = (smax + kMaxThreads - 1) / kMaxThreads;
  const int threads = (smax + per - 1) / per;
  return (threads + 31) / 32 * 32;
}

}  // namespace stctc

extern "C" int st_ctc_viterbi(const float* log_probs, const int* t_len,
                              const int* labels, const uint8_t* allow_skip,
                              const int* s_len, int b, int tmax, int v,
                              int smax, int8_t* bps, int* states,
                              float* score, void* stream) {
  if (b <= 0) return 0;
  if (smax < 2 || smax > stctc::kMaxStates || tmax < 1 || v < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = stctc::threads_for(smax);
  const size_t shared = 2 * sizeof(float) * static_cast<size_t>(smax);
  stctc::viterbi_kernel<<<b, threads, shared,
                          static_cast<cudaStream_t>(stream)>>>(
      log_probs, t_len, labels, allow_skip, s_len, tmax, v, smax, bps,
      states, score);
  return static_cast<int>(cudaGetLastError());
}

// One block of the threads viterbi_kernel gives smax states, `steps`
// dependent steps of the forward scan and nothing else; out [smax] f32.
extern "C" int st_ctc_step_probe(int steps, int smax, float* out,
                                 void* stream) {
  if (steps < 0 || smax < 2 || smax > stctc::kMaxStates)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = stctc::threads_for(smax);
  const size_t shared = 2 * sizeof(float) * static_cast<size_t>(smax);
  stctc::step_probe_kernel<<<1, threads, shared,
                             static_cast<cudaStream_t>(stream)>>>(steps, smax,
                                                                  out);
  return static_cast<int>(cudaGetLastError());
}
