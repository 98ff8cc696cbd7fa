// Ceiling variants of the histogram kernels, for tools/hist_probe.py.
//
// Each variant keeps one part of a kernel and drops the rest, so that
// timing it bounds what that part alone costs:
//   full        the kernel as it ships;
//   read-only   the same loads and launch, with the bytes XOR-folded into
//               one word per warp instead of counted: the read ceiling;
//   count-only  the same counting and launch, on bytes generated in
//               registers from the position (a multiply-xorshift hash, or
//               one constant for a flat frame), with no global loads: the
//               counting ceiling.
//
// The kernels are those of csrc/histogram.cu, included below: they take
// the mode as a template argument, and its entry points launch the full
// one only.

#include <cuda_runtime.h>
#include <stdint.h>

#include "histogram.cu"

namespace {

using namespace sthist;

// Resident blocks per SM of a kernel with its dynamic shared memory, after
// optionally asking for the largest shared-memory carveout.
template <typename F>
int occupancy(F* fn, size_t smem, int carveout, int* blocks) {
  if (carveout) {
    const int rc = set_max_carveout(fn);
    if (rc != cudaSuccess) return rc;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads,
                                                       smem);
}

template <int kMode>
int rgb(const uint8_t* x, int64_t stride, int64_t npix, int carveout,
        int64_t grid, int64_t item_units, int64_t items_per_frame,
        int64_t items, int flat, int32_t* out, uint32_t* fold,
        cudaStream_t s) {
  if (carveout) {
    const int rc = set_max_carveout(hist_rgb_kernel<kMode, 3, true>);
    if (rc != cudaSuccess) return rc;
  }
  return launch_rgb<kMode, 3, true>(x, stride, npix, grid, item_units,
                                    items_per_frame, items, flat, out, fold,
                                    s);
}

template <int kMode>
int i420(const uint8_t* x, int64_t stride, int h, int w, const float* coefs,
         int carveout, int64_t grid, int64_t item_cells,
         int64_t items_per_frame, int64_t items, int flat, int32_t* out,
         uint32_t* fold, cudaStream_t s) {
  if (carveout) {
    const int rc = set_max_carveout(hist_i420_kernel<kMode, true>);
    if (rc != cudaSuccess) return rc;
  }
  return launch_i420<kMode, true>(x, stride, h, w, yuv_terms(coefs), grid,
                                  item_cells, items_per_frame, items, flat,
                                  out, fold, s);
}

}  // namespace

extern "C" {

// The kernels of csrc/histogram.cu (c = 3, 16-byte aligned frames; I420
// widths a multiple of 16) in a mode (0 full, 1 read-only, 2 count-only),
// at the launch geometry given (ops/histogram.py), with or without asking
// for the largest shared-memory carveout first. fold: one device word that
// read-only XORs into; flat: count-only makes one constant word.
int probe_rgb(int mode, const uint8_t* x, int64_t t, int64_t stride,
              int64_t npix, int carveout, int64_t grid, int64_t item_units,
              int64_t items_per_frame, int flat, int32_t* out, uint32_t* fold,
              cudaStream_t s) {
  const int64_t items = t * items_per_frame;
  switch (mode) {
    case kFull:
      return rgb<kFull>(x, stride, npix, carveout, grid, item_units,
                        items_per_frame, items, flat, out, fold, s);
    case kReadOnly:
      return rgb<kReadOnly>(x, stride, npix, carveout, grid, item_units,
                            items_per_frame, items, flat, out, fold, s);
    case kCountOnly:
      return rgb<kCountOnly>(x, stride, npix, carveout, grid, item_units,
                             items_per_frame, items, flat, out, fold, s);
  }
  return cudaErrorInvalidValue;
}

int probe_i420(int mode, const uint8_t* x, int64_t t, int64_t stride, int h,
               int w, const float* coefs, int carveout, int64_t grid,
               int64_t item_cells, int64_t items_per_frame, int flat,
               int32_t* out, uint32_t* fold, cudaStream_t s) {
  const int64_t items = t * items_per_frame;
  switch (mode) {
    case kFull:
      return i420<kFull>(x, stride, h, w, coefs, carveout, grid, item_cells,
                         items_per_frame, items, flat, out, fold, s);
    case kReadOnly:
      return i420<kReadOnly>(x, stride, h, w, coefs, carveout, grid,
                             item_cells, items_per_frame, items, flat, out,
                             fold, s);
    case kCountOnly:
      return i420<kCountOnly>(x, stride, h, w, coefs, carveout, grid,
                              item_cells, items_per_frame, items, flat, out,
                              fold, s);
  }
  return cudaErrorInvalidValue;
}

// Resident blocks per SM of the full kernels (c = 3, aligned), with or
// without the largest carveout. kernel: 0 rgb, 1 i420.
int probe_occupancy(int kernel, int carveout, int* blocks) {
  if (kernel == 0)
    return occupancy(hist_rgb_kernel<kFull, 3, true>, rgb_smem(3), carveout,
                     blocks);
  if (kernel == 1)
    return occupancy(hist_i420_kernel<kFull, true>, 0, carveout, blocks);
  return cudaErrorInvalidValue;
}

}  // extern "C"
