// Device code shared by the kernels that take peaks (K1, K3, K6) and by the
// launches of the row passes (K3, K4, K5):
//
//   fmax_nan     the NaN-propagating max of the peaks;
//   peaks_pass   one warp per row: deterministic max of per-(row, segment)
//                partial peaks, tp = max(tp, sp) (K1, K3, K6);
//   blocks_for   the grid of a pass of THREADS-thread blocks.
//
// Sample offsets are int64 throughout. Everything here has internal
// linkage: each translation unit that includes it gets its own copy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

// max that returns NaN when either operand is NaN (torch.max does)
__device__ __forceinline__ float fmax_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// one warp per row; max is exact, so the order of the lanes' partial
// maxima does not change the result (a NaN partial gives a NaN peak)
__global__ void __launch_bounds__(THREADS)
peaks_pass(int64_t rows, int64_t nsteps, const float* __restrict__ tp_part,
           const float* __restrict__ sp_part, float* __restrict__ tp,
           float* __restrict__ sp) {
  const int64_t row = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float a = 0.f, b = 0.f;
  for (int64_t j = lane; j < nsteps; j += 32) {
    a = fmax_nan(a, tp_part[row * nsteps + j]);
    b = fmax_nan(b, sp_part[row * nsteps + j]);
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2) {
    a = fmax_nan(a, __shfl_xor_sync(0xffffffffu, a, o));
    b = fmax_nan(b, __shfl_xor_sync(0xffffffffu, b, o));
  }
  if (lane == 0) {
    tp[row] = fmax_nan(a, b);
    sp[row] = b;
  }
}

inline unsigned blocks_for(int64_t threads) {
  return (unsigned)((threads + THREADS - 1) / THREADS);
}

}  // namespace
