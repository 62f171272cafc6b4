// Device code shared by the K-weighting energy and true-peak kernels
// (K1 iir_chunked.cu, K3/K4/K5 iir_rows.cu, K6 truepeak_stream.cu).
//
// All of them solve the 4-state K-weighting recurrence s <- A s + B x,
// y = C s + D x in the modal realisation (block-diagonal A,
// ops/biquad.py:modal_form), which stays exact in float32; the direct form
// would drift. Where time is split into steps of L samples, the passes are
//
//   zero_state_pass  one thread per (row, step): the step's final state
//                    from a zero state;
//   prefix_pass      one thread per row: s_entry[j+1] = A^L s_entry[j] +
//                    s_final0[j] (A^L built on the host in float64);
//   a correction pass of each kernel's own: refilter from s_entry[j];
//   peaks_pass       one warp per row: deterministic max of per-(row,
//                    step) partial peaks, tp = max(tp, sp).
//
// Sample offsets are int64 throughout. Everything here has internal
// linkage: each translation unit that includes it gets its own copy.

#pragma once

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

// y = C s + D x (the output before the state advances)
__device__ __forceinline__ float output(const Filter& f, const float s[NS],
                                        float x) {
  float y = f.D * x;
#pragma unroll
  for (int i = 0; i < NS; ++i) y = fmaf(f.C[i], s[i], y);
  return y;
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

// Calls fn(g, x[g]) for g = start .. start + len - 1 in order. len % 32 == 0
// and xr + start 16-byte aligned. The next 32 samples' loads are in flight
// while the current 32 are processed, so a thread with a long serial chain
// of work per sample still keeps the memory system busy.
template <class Fn>
__device__ __forceinline__ void stream_samples(const float* __restrict__ xr,
                                               int64_t start, int64_t len,
                                               Fn&& fn) {
  constexpr int V = 8;         // float4 per chunk: 32 samples, 128 bytes
  const float4* p = reinterpret_cast<const float4*>(xr + start);
  const int64_t nchunk = len / (4 * V);
  float4 cur[V], nxt[V];
#pragma unroll
  for (int k = 0; k < V; ++k) cur[k] = __ldg(p + k);
  for (int64_t c = 0; c < nchunk; ++c) {
    if (c + 1 < nchunk) {
#pragma unroll
      for (int k = 0; k < V; ++k) nxt[k] = __ldg(p + (c + 1) * V + k);
    }
    const int64_t g0 = start + c * 4 * V;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      fn(g0 + 4 * k, cur[k].x);
      fn(g0 + 4 * k + 1, cur[k].y);
      fn(g0 + 4 * k + 2, cur[k].z);
      fn(g0 + 4 * k + 3, cur[k].w);
    }
#pragma unroll
    for (int k = 0; k < V; ++k) cur[k] = nxt[k];
  }
}

// BS.1770 polyphase interpolator: F phases of KP taps over the masked
// signal. hist[k] = masked x at (g - k) once sample g has been pushed;
// before the first push it holds x[start - 1 - k], the KP - 1 samples of
// halo before a span.
template <int F, int KP>
struct Fir {
  float hk[F][KP];
  float hist[KP];
  float tp;

  __device__ __forceinline__ void load(const float* __restrict__ taps) {
#pragma unroll
    for (int p = 0; p < F; ++p)
#pragma unroll
      for (int k = 0; k < KP; ++k) hk[p][k] = __ldg(taps + p * KP + k);
  }

  __device__ __forceinline__ void reset(const float* __restrict__ xr,
                                        int64_t start, int64_t nv) {
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      const int64_t g = start - 1 - k;
      hist[k] = (k < KP - 1 && g >= 0 && g < nv) ? xr[g] : 0.f;
    }
    tp = 0.f;
  }

  // push the masked sample xm; its outputs count only where valid
  __device__ __forceinline__ void push(float xm, bool valid) {
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
};

__global__ void __launch_bounds__(THREADS)
zero_state_pass(const float* __restrict__ x, const float* __restrict__ coef,
                int64_t rows, int64_t n, int64_t nsteps, int64_t L,
                float* __restrict__ s_final) {
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= rows * nsteps) return;
  const int64_t row = t / nsteps;
  const int64_t j = t - row * nsteps;
  Filter f;
  load_filter(coef, f);
  float s[NS] = {0.f, 0.f, 0.f, 0.f};
  stream_samples(x + row * n, j * L, L,
                 [&](int64_t, float xv) { advance(f, s, xv); });
#pragma unroll
  for (int i = 0; i < NS; ++i) s_final[t * NS + i] = s[i];
}

__global__ void __launch_bounds__(THREADS)
prefix_pass(const float* __restrict__ coef, int64_t rows, int64_t nsteps,
            const float* __restrict__ s_final, float* __restrict__ s_entry) {
  const int64_t row = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (row >= rows) return;
  float AL[NS * NS];
#pragma unroll
  for (int i = 0; i < NS * NS; ++i) AL[i] = __ldg(coef + CO_AL + i);
  constexpr int U = 8;         // steps whose s_final loads are issued together
  float s[NS] = {0.f, 0.f, 0.f, 0.f};
  const float* sf = s_final + row * nsteps * NS;
  float* se = s_entry + row * nsteps * NS;
  for (int64_t j0 = 0; j0 < nsteps; j0 += U) {
    float in[U][NS];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < NS; ++i)
        in[u][i] = (j0 + u < nsteps) ? sf[(j0 + u) * NS + i] : 0.f;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (j0 + u >= nsteps) break;
      float t[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        se[(j0 + u) * NS + i] = s[i];
        float acc = in[u][i];
#pragma unroll
        for (int k = 0; k < NS; ++k) acc = fmaf(AL[i * NS + k], s[k], acc);
        t[i] = acc;
      }
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = t[i];
    }
  }
}

// one warp per row; max is exact, so the order of the lanes' partial
// maxima does not change the result
__global__ void __launch_bounds__(THREADS)
peaks_pass(int64_t rows, int64_t nsteps, const float* __restrict__ tp_part,
           const float* __restrict__ sp_part, float* __restrict__ tp,
           float* __restrict__ sp) {
  const int64_t row = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float a = 0.f, b = 0.f;
  for (int64_t j = lane; j < nsteps; j += 32) {
    a = fmaxf(a, tp_part[row * nsteps + j]);
    b = fmaxf(b, sp_part[row * nsteps + j]);
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2) {
    a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
    b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, o));
  }
  if (lane == 0) {
    tp[row] = fmaxf(a, b);
    sp[row] = b;
  }
}

inline unsigned blocks_for(int64_t threads) {
  return (unsigned)((threads + THREADS - 1) / THREADS);
}

}  // namespace
