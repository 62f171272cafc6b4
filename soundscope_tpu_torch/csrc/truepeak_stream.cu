// K6: streaming BS.1770 true peak and sample peak over (rows, N).
//
// Replaces soundscope_tpu/ops/pallas_truepeak.py:true_peak_pallas
// (pallas_call :166, kernel _make_kernel). The TPU kernel walks each row
// tile's blocks in order, carrying the FIR context (the previous block) and
// running maxima in VMEM, with blocks of 128-512 samples and row tiles of
// up to 256 sized for VMEM. Here time is split into spans of L samples
// instead: one thread per (row, span) runs the polyphase FIR of K1 over its
// span with a halo of KP - 1 raw samples before it (12 at 4x, 24 at 2x),
// masked at the row's n_valid, and writes a partial true and sample peak;
// peaks_pass (iir_common.cuh) takes the per-row max, tp = max(tp, sp). No
// float atomics: the result is the same on every run, and the sample peak
// is exact. Maxima propagate NaN, as the plain version's torch max does.
// The reference's block and row-tile picks are VMEM policy and
// are not ported. Factor 1 (>= 192 kHz) launches nothing (the wrapper takes
// a masked max, as the reference does).
//
// Bound on the H100: bytes, one read of the input. The function needs 36
// FMAs per sample at 4x (24 at 2x): phase 0 is a unit impulse, whose
// outputs the sample peak covers, and the other phases' last tap is zero.
// This kernel runs all 52 (50 at 2x).

#include "iir_common.cuh"

namespace {

template <int F, int KP>
__global__ void __launch_bounds__(THREADS)
tp_spans(const float* __restrict__ x, const int64_t* __restrict__ n_valid,
         const float* __restrict__ taps, int64_t rows, int64_t n,
         int64_t nsteps, int64_t L, float* __restrict__ tp_part,
         float* __restrict__ sp_part) {
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= rows * nsteps) return;
  const int64_t row = t / nsteps;
  const int64_t j = t - row * nsteps;
  const int64_t nv = __ldg(n_valid + row);
  const int64_t start = j * L;
  const float* xr = x + row * n;
  Fir<F, KP> fir;
  fir.load(taps);
  fir.reset(xr, start, nv);
  float sp = 0.f;
  stream_samples(xr, start, L, [&](int64_t g, float xv) {
    const bool valid = g < nv;
    const float xm = valid ? xv : 0.f;
    sp = fmax_nan(sp, fabsf(xm));
    fir.push(xm, valid);
  });
  tp_part[t] = fir.tp;
  sp_part[t] = sp;
}

}  // namespace

// n_valid is per row (rows,). Returns the first CUDA error, 0 on success.
extern "C" int ss_true_peak_stream(
    const float* x, const int64_t* n_valid, const float* taps, int factor,
    int64_t rows, int64_t n, int64_t L, float* tp_part, float* sp_part,
    float* tp, float* sp, void* stream) {
  if (factor != 2 && factor != 4) return (int)cudaErrorInvalidValue;
  if (L <= 0 || L % 128 != 0 || n % L != 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int64_t nsteps = n / L;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;

  const unsigned g = blocks_for(rows * nsteps);
  if (factor == 4) {
    tp_spans<4, 13><<<g, THREADS, 0, st>>>(x, n_valid, taps, rows, n, nsteps, L,
                                           tp_part, sp_part);
  } else {
    tp_spans<2, 25><<<g, THREADS, 0, st>>>(x, n_valid, taps, rows, n, nsteps, L,
                                           tp_part, sp_part);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  peaks_pass<<<blocks_for(rows * 32), THREADS, 0, st>>>(rows, nsteps, tp_part,
                                                        sp_part, tp, sp);
  return (int)cudaGetLastError();
}
