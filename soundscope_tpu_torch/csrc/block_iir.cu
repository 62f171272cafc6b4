// K7: the K-weighting filter with carried state, y and s_final from x and
// s0, for any length N >= 1 (the streaming meter's filter, one launch per
// push).
//
// Replaces soundscope_tpu/ops/pallas_iir.py:block_iir_pallas (pallas_call
// in _run, :67; kernel _iir_kernel :32-54). The TPU kernel walks the blocks
// in grid order and carries the 4-state in VMEM from zero:
//   y_j = x_j Tt + s Ot,  s = s A_B^T + x_j Wt.
// CUDA blocks run in no order, so K7 splits time into steps of L samples
// and runs the split-time passes of iir_common.cuh, with the semantics of
// ops/biquad.block_iir (s0 in, s_final out):
//
//   stream_zero_state  one thread per (row, full step before the last):
//                      the step's final state from zero, in matrix form
//                      (sum_i A^(L-1-i) B x_i, the table built on the host
//                      in float64);
//   prefix_pass        one thread per row, from the caller's s0 (A^L built
//                      on the host in float64);
//   stream_correct     one thread per (row, step): refilters its step from
//                      its entry state in the modal realisation, writes y,
//                      and the thread of the last step writes s_final in
//                      matrix form, A^r s_entry + sum_i A^(r-1-i) B x_i.
//
// The last step may be partial (N % L != 0: 800 frames per 60 Hz tick,
// 44,100 per 1 s slab); its length r takes A^r from the host. The state
// is in the modal basis of ops/biquad.py:modal_form, the basis of the JAX
// package's BlockFilter.
//
// Why the matrix form: the carried state of the sample-by-sample float32
// recurrence drifts. Its slow high-pass mode (|lambda| = 0.995 at 44.1
// kHz) amplifies each sample's rounding about 200-fold, and its state
// component is unobserved in y (C ~ 1e-17), so the error shows in s_final
// only: up to 3e-5 per unit RMS of x against a float64 evaluation at
// (2, 44100), over the 2e-5 pin; the matrix form stays near 2e-6.

// x is read through strides (row stride rs, sample stride cs) so that the
// meter's channel view of interleaved audio (stride = channels) needs no
// copy; y (rows, N) and s_final (rows, 4) are contiguous. The sample loops
// are plain strided loads, since stream_samples needs contiguous rows of a
// multiple of 32 samples.
//
// Bound on the H100: at the meter's shapes ((2, 800) per tick, (2, 44100)
// per slab) it moves 13 KB or 0.7 MB, well under a microsecond at
// 3.35 TB/s, so its time is the launch latency of its three passes.

#include "iir_common.cuh"

namespace {

// the step's final state from zero in matrix form, sum_i W[i] x_i with
// W[i] = A^(L-1-i) B from float64: no rounding carried from sample to sample
__global__ void __launch_bounds__(THREADS)
stream_zero_state(const float* __restrict__ x, int64_t rs, int64_t cs,
                  const float* __restrict__ wtab, int64_t rows, int64_t nsteps,
                  int64_t L, float* __restrict__ s_final) {
  const int64_t nfull = nsteps - 1;
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= rows * nfull) return;
  const int64_t row = t / nfull;
  const int64_t j = t - row * nfull;
  float s[NS] = {0.f, 0.f, 0.f, 0.f};
  const float* xr = x + row * rs + j * L * cs;
#pragma unroll 4
  for (int64_t i = 0; i < L; ++i) {
    const float xv = __ldg(xr + i * cs);
#pragma unroll
    for (int k = 0; k < NS; ++k) s[k] = fmaf(__ldg(wtab + NS * i + k), xv, s[k]);
  }
  // s_final rows have nsteps entries, as prefix_pass reads them; the last
  // one is never written and the state it would give is never read
#pragma unroll
  for (int i = 0; i < NS; ++i) s_final[(row * nsteps + j) * NS + i] = s[i];
}

// y over the step by the recurrence from s_entry; the last step's thread
// also writes s_final = A^len s_entry + sum_i W[L-len+i] x_i (matrix form,
// A^len = coef_r's A^steps)
__global__ void __launch_bounds__(THREADS)
stream_correct(const float* __restrict__ x, int64_t rs, int64_t cs,
               const float* __restrict__ coef, const float* __restrict__ coef_r,
               const float* __restrict__ wtab, int64_t rows, int64_t n,
               int64_t nsteps, int64_t L, const float* __restrict__ s_entry,
               float* __restrict__ y, float* __restrict__ s_out) {
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= rows * nsteps) return;
  const int64_t row = t / nsteps;
  const int64_t j = t - row * nsteps;
  const int64_t start = j * L;
  const int64_t len = (n - start < L) ? n - start : L;
  Filter f;
  load_filter(coef, f);
  float s[NS], se[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = se[i] = s_entry[t * NS + i];
  const float* xr = x + row * rs + start * cs;
  float* yr = y + row * n + start;
#pragma unroll 4
  for (int64_t i = 0; i < len; ++i) {
    const float xv = __ldg(xr + i * cs);
    yr[i] = output(f, s, xv);
    advance(f, s, xv);
  }
  if (j == nsteps - 1) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < NS; ++k) acc = fmaf(__ldg(coef_r + CO_AL + i * NS + k), se[k], acc);
      s[i] = acc;
    }
    const float* w = wtab + NS * (L - len);
    for (int64_t i = 0; i < len; ++i) {
      const float xv = __ldg(xr + i * cs);
#pragma unroll
      for (int k = 0; k < NS; ++k) s[k] = fmaf(__ldg(w + NS * i + k), xv, s[k]);
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) s_out[row * NS + i] = s[i];
  }
}

}  // namespace

// x (rows, n) at strides (rs, cs); s0 (rows, 4); coef as iir_common.cuh
// with A^L, coef_r with A^r for the last step's length r = n - (nsteps -
// 1) L; wtab (L, 4): A^(L-1-i) B. Scratch s_final0 and s_entry are (rows,
// ceil(n / L), 4); y (rows, n) and s_out (rows, 4) are written whole.
// Returns the first CUDA error of the launches, 0 on success.
extern "C" int ss_block_iir_stream(
    const float* x, int64_t rs, int64_t cs, const float* s0, const float* coef,
    const float* coef_r, const float* wtab, int64_t rows, int64_t n, int64_t L,
    float* s_final0, float* s_entry, float* y, float* s_out, void* stream) {
  if (rows < 0 || n <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int64_t nsteps = (n + L - 1) / L;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;

  if (nsteps > 1) {
    stream_zero_state<<<blocks_for(rows * (nsteps - 1)), THREADS, 0, st>>>(
        x, rs, cs, wtab, rows, nsteps, L, s_final0);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }

  prefix_pass<<<blocks_for(rows), THREADS, 0, st>>>(coef, rows, nsteps,
                                                    s_final0, s_entry, s0);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  stream_correct<<<blocks_for(rows * nsteps), THREADS, 0, st>>>(
      x, rs, cs, coef, coef_r, wtab, rows, n, nsteps, L, s_entry, y, s_out);
  return (int)cudaGetLastError();
}
