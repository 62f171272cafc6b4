// K1: fused K-weighting energy + true peak over the frames view.
//
// Replaces soundscope_tpu/ops/pallas_iir_chunked.py:kweight_energy_tp_chunked
// (kernel body _chunked_kernel_factory). The TPU kernel walks its grid in
// order and carries the filter state, the previous chunk and the running
// maxima in VMEM from one grid step to the next. CUDA blocks run in no
// order, so this file splits time into steps of L samples (L = 128 * 2^k,
// L <= h, so at most one 100 ms boundary per step) and runs four passes:
//
//   1. k1_zero_state  one thread per (row, step): filter the step from a
//                     zero state, write its final 4-state;
//   2. k1_prefix      one thread per row: s_entry[j+1] = A^L s_entry[j] +
//                     s_final0[j] (A^L built on the host in float64);
//   3. k1_correct     one thread per (row, step): refilter from s_entry[j];
//                     z = w_ch * y^2 masked at n_valid, summed in float64
//                     in sample order into (step total, energy before the
//                     step's boundary); the polyphase FIR over the same
//                     samples with a halo of KP-1 raw samples before the
//                     span; partial true and sample peaks per (row, step);
//   4. k1_peaks       one thread per row: deterministic max of the partial
//                     peaks, tp = max(tp, sp).
//
// The filter runs sample by sample in the modal realisation (block-diagonal
// A, ops/biquad.py:modal_form), which stays exact in float32; the direct
// form would drift.
//
// Bound on the H100: device-memory reads of the input in passes 1 and 3.
// Each thread streams its own contiguous span with 16-byte loads; the
// lines it touches are reused from L1 by its next loads. Everything else
// it writes is a few floats per (row, step). Sample offsets are int64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NS = 4;          // states of the K-weighting cascade
constexpr int THREADS = 128;
// coef layout (float32): A[16] row-major, B[4], C[4], D, AL[16]
constexpr int CO_A = 0, CO_B = 16, CO_C = 20, CO_D = 24, CO_AL = 25;

struct Filter {
  float A[NS * NS];
  float B[NS];
  float C[NS];
  float D;
};

__device__ __forceinline__ void load_filter(const float* __restrict__ coef,
                                            Filter& f) {
#pragma unroll
  for (int i = 0; i < NS * NS; ++i) f.A[i] = __ldg(coef + CO_A + i);
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    f.B[i] = __ldg(coef + CO_B + i);
    f.C[i] = __ldg(coef + CO_C + i);
  }
  f.D = __ldg(coef + CO_D);
}

// s <- A s + B x
__device__ __forceinline__ void advance(const Filter& f, float s[NS], float x) {
  float t[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    float acc = f.B[i] * x;
#pragma unroll
    for (int j = 0; j < NS; ++j) acc = fmaf(f.A[i * NS + j], s[j], acc);
    t[i] = acc;
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = t[i];
}

__global__ void __launch_bounds__(THREADS)
k1_zero_state(const float* __restrict__ x, const float* __restrict__ coef,
              int64_t rows, int64_t n, int64_t nsteps, int64_t L,
              float* __restrict__ s_final) {
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= rows * nsteps) return;
  const int64_t row = t / nsteps;
  const int64_t j = t - row * nsteps;
  Filter f;
  load_filter(coef, f);
  const float4* p = reinterpret_cast<const float4*>(x + row * n + j * L);
  float s[NS] = {0.f, 0.f, 0.f, 0.f};
  for (int64_t i = 0; i < L / 4; ++i) {
    const float4 v = __ldg(p + i);
    advance(f, s, v.x);
    advance(f, s, v.y);
    advance(f, s, v.z);
    advance(f, s, v.w);
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) s_final[t * NS + i] = s[i];
}

__global__ void __launch_bounds__(THREADS)
k1_prefix(const float* __restrict__ coef, int64_t rows, int64_t nsteps,
          const float* __restrict__ s_final, float* __restrict__ s_entry) {
  const int64_t row = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (row >= rows) return;
  float AL[NS * NS];
#pragma unroll
  for (int i = 0; i < NS * NS; ++i) AL[i] = __ldg(coef + CO_AL + i);
  float s[NS] = {0.f, 0.f, 0.f, 0.f};
  for (int64_t j = 0; j < nsteps; ++j) {
    const int64_t o = (row * nsteps + j) * NS;
    float t[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      s_entry[o + i] = s[i];
      float acc = s_final[o + i];
#pragma unroll
      for (int k = 0; k < NS; ++k) acc = fmaf(AL[i * NS + k], s[k], acc);
      t[i] = acc;
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = t[i];
  }
}

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
  float hk[F][KP];
#pragma unroll
  for (int p = 0; p < F; ++p)
#pragma unroll
    for (int k = 0; k < KP; ++k) hk[p][k] = (F > 1) ? __ldg(taps + p * KP + k) : 0.f;

  float s[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = s_entry[t * NS + i];

  const int64_t start = j * L;
  // the first 100 ms boundary at or after the step start, if inside it
  int64_t bound = ((start + h - 1) / h) * h;
  if (bound > start + L) bound = start + L;
  const float* xr = x + row * n;

  // hist[k] = masked x at (g - k) once sample g has been pushed; before
  // the first push, hist[k] holds x[start - 1 - k] (the FIR halo)
  float hist[KP];
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const int64_t g = start - 1 - k;
    hist[k] = (F > 1 && k < KP - 1 && g >= 0 && g < nv) ? xr[g] : 0.f;
  }

  double tot = 0.0, left = 0.0;
  float tp = 0.f, sp = 0.f;
  const float4* p4 = reinterpret_cast<const float4*>(xr + start);
  for (int64_t i4 = 0; i4 < L / 4; ++i4) {
    const float4 v = __ldg(p4 + i4);
    const float xs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int64_t g = start + i4 * 4 + q;
      const float xv = xs[q];
      float y = f.D * xv;
#pragma unroll
      for (int i = 0; i < NS; ++i) y = fmaf(f.C[i], s[i], y);
      advance(f, s, xv);
      const bool valid = g < nv;
      const float z = valid ? (y * y) * w : 0.f;
      tot += (double)z;
      if (g < bound) left += (double)z;
      const float xm = valid ? xv : 0.f;
      sp = fmaxf(sp, fabsf(xm));
      if (F > 1) {
#pragma unroll
        for (int k = KP - 1; k > 0; --k) hist[k] = hist[k - 1];
        hist[0] = xm;
        if (valid) {
#pragma unroll
          for (int p = 0; p < F; ++p) {
            float acc = 0.f;
#pragma unroll
            for (int k = KP - 1; k >= 0; --k) acc = fmaf(hk[p][k], hist[k], acc);
            tp = fmaxf(tp, fabsf(acc));
          }
        }
      }
    }
  }
  step_sums[t * 2] = (float)tot;
  step_sums[t * 2 + 1] = (float)left;
  tp_part[t] = tp;
  sp_part[t] = sp;
}

__global__ void __launch_bounds__(THREADS)
k1_peaks(int64_t rows, int64_t nsteps, const float* __restrict__ tp_part,
         const float* __restrict__ sp_part, float* __restrict__ tp,
         float* __restrict__ sp) {
  const int64_t row = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (row >= rows) return;
  float a = 0.f, b = 0.f;
  for (int64_t j = 0; j < nsteps; ++j) {
    a = fmaxf(a, tp_part[row * nsteps + j]);
    b = fmaxf(b, sp_part[row * nsteps + j]);
  }
  tp[row] = fmaxf(a, b);
  sp[row] = b;
}

inline unsigned blocks_for(int64_t threads) {
  return (unsigned)((threads + THREADS - 1) / THREADS);
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

  k1_zero_state<<<blocks_for(rows * nsteps), THREADS, 0, st>>>(
      x, coef, rows, n, nsteps, L, s_final);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  k1_prefix<<<blocks_for(rows), THREADS, 0, st>>>(coef, rows, nsteps, s_final,
                                                  s_entry);
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

  k1_peaks<<<blocks_for(rows), THREADS, 0, st>>>(rows, nsteps, tp_part, sp_part,
                                                 tp, sp);
  return (int)cudaGetLastError();
}
