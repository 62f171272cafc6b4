// K1: fused K-weighting energy + true peak over the frames view.
//
// Replaces soundscope_tpu/ops/pallas_iir_chunked.py:kweight_energy_tp_chunked
// (kernel body _chunked_kernel_factory). The TPU kernel walks its grid in
// order and carries the filter state, the previous chunk and the running
// maxima in VMEM from one grid step to the next. CUDA blocks run in no
// order, so this file splits time into steps of L samples (L = 128 * 2^k,
// L <= h, so at most one 100 ms boundary per step) and runs four passes:
//
//   1. zero_state_pass  one thread per (row, step): filter the step from a
//                       zero state, write its final 4-state;
//   2. prefix_pass      one thread per row: s_entry[j+1] = A^L s_entry[j] +
//                       s_final0[j] (A^L built on the host in float64);
//   3. k1_correct       one thread per (row, step): refilter from s_entry[j];
//                       z = w_ch * y^2 masked at n_valid, summed in float64
//                       in sample order into (step total, energy before the
//                       step's boundary); the polyphase FIR over the same
//                       samples with a halo of KP-1 raw samples before the
//                       span; partial true and sample peaks per (row, step);
//   4. peaks_pass       one warp per row: deterministic max of the partial
//                       peaks, tp = max(tp, sp).
//
// Passes 1, 2 and 4, the filter and the FIR are shared with K3-K6
// (iir_common.cuh). The filter runs sample by sample in the modal
// realisation (block-diagonal A, ops/biquad.py:modal_form), which stays
// exact in float32; the direct form would drift.
//
// Bound on the H100: device-memory reads of the input in passes 1 and 3.
// Each thread streams its own contiguous span with 16-byte loads; the
// lines it touches are reused from L1 by its next loads. Everything else
// it writes is a few floats per (row, step). Sample offsets are int64.

#include "iir_common.cuh"

namespace {

// F phases of KP taps each (F = 1: no oversampling, sample peak only)
template <int F, int KP>
__global__ void __launch_bounds__(THREADS)
k1_correct(const float* __restrict__ x, const int64_t* __restrict__ n_valid,
           const float* __restrict__ coef, const float* __restrict__ weights,
           const float* __restrict__ taps, int64_t rows, int ch, int64_t n,
           int64_t nsteps, int64_t L, int64_t h,
           const float* __restrict__ s_entry, float* __restrict__ step_sums,
           float* __restrict__ tp_part, float* __restrict__ sp_part) {
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= rows * nsteps) return;
  const int64_t row = t / nsteps;
  const int64_t j = t - row * nsteps;
  const int64_t nv = __ldg(n_valid + row / ch);
  const float w = __ldg(weights + row % ch);
  Filter f;
  load_filter(coef, f);
  Fir<(F > 1 ? F : 1), KP> fir;
  if (F > 1) fir.load(taps);

  float s[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = s_entry[t * NS + i];

  const int64_t start = j * L;
  // the first 100 ms boundary at or after the step start, if inside it
  int64_t bound = ((start + h - 1) / h) * h;
  if (bound > start + L) bound = start + L;
  const float* xr = x + row * n;

  if (F > 1) fir.reset(xr, start, nv);

  double tot = 0.0, left = 0.0;
  float sp = 0.f;
  stream_samples(xr, start, L, [&](int64_t g, float xv) {
    const float y = output(f, s, xv);
    advance(f, s, xv);
    const bool valid = g < nv;
    const float z = valid ? (y * y) * w : 0.f;
    tot += (double)z;
    if (g < bound) left += (double)z;
    const float xm = valid ? xv : 0.f;
    sp = fmaxf(sp, fabsf(xm));
    if (F > 1) fir.push(xm, valid);
  });
  step_sums[t * 2] = (float)tot;
  step_sums[t * 2 + 1] = (float)left;
  tp_part[t] = F > 1 ? fir.tp : 0.f;
  sp_part[t] = sp;
}

}  // namespace

// Returns the first CUDA error of the four launches, 0 on success.
extern "C" int ss_kweight_energy_tp(
    const float* x, const int64_t* n_valid, const float* coef,
    const float* weights, const float* taps, int factor, int64_t rows, int ch,
    int64_t n, int64_t L, int64_t h, float* s_final, float* s_entry,
    float* step_sums, float* tp_part, float* sp_part, float* tp, float* sp,
    void* stream) {
  if (factor != 1 && factor != 2 && factor != 4) return (int)cudaErrorInvalidValue;
  if (L <= 0 || L % 128 != 0 || n % L != 0 || h < L || ch <= 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int64_t nsteps = n / L;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;

  zero_state_pass<<<blocks_for(rows * nsteps), THREADS, 0, st>>>(
      x, coef, rows, n, nsteps, L, s_final);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  prefix_pass<<<blocks_for(rows), THREADS, 0, st>>>(coef, rows, nsteps, s_final,
                                                  s_entry, nullptr);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  const unsigned g = blocks_for(rows * nsteps);
  if (factor == 4) {
    k1_correct<4, 13><<<g, THREADS, 0, st>>>(x, n_valid, coef, weights, taps,
        rows, ch, n, nsteps, L, h, s_entry, step_sums, tp_part, sp_part);
  } else if (factor == 2) {
    k1_correct<2, 25><<<g, THREADS, 0, st>>>(x, n_valid, coef, weights, taps,
        rows, ch, n, nsteps, L, h, s_entry, step_sums, tp_part, sp_part);
  } else {
    k1_correct<1, 1><<<g, THREADS, 0, st>>>(x, n_valid, coef, weights, taps,
        rows, ch, n, nsteps, L, h, s_entry, step_sums, tp_part, sp_part);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  peaks_pass<<<blocks_for(rows * 32), THREADS, 0, st>>>(rows, nsteps, tp_part,
                                                        sp_part, tp, sp);
  return (int)cudaGetLastError();
}
