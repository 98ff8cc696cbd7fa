// The backtrace of the ctc_viterbi kernel's warp path alone, for
// tools/ctc_probe.py.
//
// One warp writes a window's packed moves into shared memory in the
// kernel's layout (a 64-bit word a lane a group of 4 steps), the move of
// every state above 0 being an advance on odd rows and a stay on even ones
// (and on the rows past the window's last), so that the path drops one
// state every two frames and leaves a lane's states every 2 K frames,
// about as a caption window's path does.
// Then one lane runs walk_back of csrc/ctc.cu, included below, from
// `state` over `t` frames, and the warp writes the path out. Timed at two
// frame counts, the slope is a frame of the backtrace.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ctc.cu"

namespace {

using namespace stctc;

template <int K>
__global__ void __launch_bounds__(kLanes)
walk_probe_kernel(int t, int state, int* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* moves = reinterpret_cast<uint64_t*>(smem);
  uint8_t* path =
      reinterpret_cast<uint8_t*>(moves + move_groups(t) * kLanes);
  const int lane = threadIdx.x;
  for (int g = 0; g < move_groups(t); ++g) {
    uint64_t word = 0;
    for (int i = 0; i < kGroupSteps; ++i) {
      const int r = g * kGroupSteps + i;
      for (int k = 0; k < K; ++k) {
        const uint64_t move = (r & 1) && r < t - 1 && lane * K + k > 0;
        word |= move << (16 * i + kMoveBits * k);
      }
    }
    moves[g * kLanes + lane] = word;
  }
  __syncwarp();
  if (lane == 0) walk_back<K>(moves, path, state, t);
  __syncwarp();
  for (int i = lane; i < t; i += kLanes) out[i] = path[i];
}

using WalkKernel = void (*)(int, int, int*);

WalkKernel walk_probe(int k) {
  static const WalkKernel table[kMaxK] = {
      walk_probe_kernel<1>, walk_probe_kernel<2>, walk_probe_kernel<3>,
      walk_probe_kernel<4>, walk_probe_kernel<5>, walk_probe_kernel<6>,
      walk_probe_kernel<7>, walk_probe_kernel<8>};
  return table[k - 1];
}

}  // namespace

// One warp, K = ceil(smax / 32), a path of t frames from `state`;
// out [t] i32.
extern "C" int st_ctc_walk_probe(int smax, int t, int state, int* out,
                                 void* stream) {
  if (smax < 2 || smax > kWarpMaxStates || t < 1 || state < 0 ||
      state >= smax)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t shared = int64_t{move_groups(t)} * kLanes * 8 +
                         (int64_t{t} + kGroupSteps + 15) / 16 * 16;
  if (shared > kSharedMax) return static_cast<int>(cudaErrorInvalidValue);
  const WalkKernel fn = walk_probe((smax + kLanes - 1) / kLanes);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(shared));
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<1, kLanes, shared, static_cast<cudaStream_t>(stream)>>>(t, state,
                                                               out);
  return static_cast<int>(cudaGetLastError());
}
