// K2: pooled mid/side display spectrogram over the frames view.
//
// Replaces soundscope_tpu/ops/pallas_stft.py:stft_pooled_pallas_frames
// (kernel _make_kernel). The TPU kernel evaluates each 16384-point window
// as a four-step 128x128 DFT on its matrix unit (about 50 MFLOP a window).
// Here one CTA of 1024 threads owns one (track, window) and runs a radix-4
// decimation-in-time FFT (7 stages, about 1 MFLOP) on the 16384 complex
// float32 values held in 128 KB of dynamic shared memory:
//
//   load     window w = samples [2048 w, 2048 w + 16384) of both channels;
//            z = (l+r)/2 * hann + i (l-r)/2 * hann, stored at the base-4
//            digit-reversed index so the in-place DIT ends in natural order;
//   fft      7 radix-4 stages, twiddles exp(-2 pi i k / 16384) from a
//            float32 table built on the host in float64;
//   pool     for each bin k < 8192: |M|^2, |S|^2 by the conjugate split of
//            Z[k] and Z[-k], times the squared display gain; each thread
//            takes the max over 8 consecutive bins, then one thread per
//            band the max over its 16 partials (no atomics);
//   output   10 log10 with the -150 dB floor; bands 64-127 (at or above
//            Nyquist, gain 0) are the floor.
//
// Bound on the H100: shared-memory traffic (each stage reads and writes
// all 128 KB) with one CTA per SM. Device memory is read 8x per sample by
// overlapping windows, mostly from L2; the output is 1 KB per window.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WIN = 16384;          // 4^7
constexpr int HOP = 2048;
constexpr int STAGES = 7;
constexpr int BANDS = 128;
constexpr int HALF_BANDS = 64;      // bands below Nyquist
constexpr int PER = WIN / BANDS;    // bins per band
constexpr int THREADS = 1024;
constexpr int BINS_PER_THREAD = (WIN / 2) / THREADS;       // 8
constexpr int PARTS_PER_BAND = PER / BINS_PER_THREAD;      // 16
constexpr float FLOOR_DB = -150.0f;
constexpr int SMEM = WIN * (int)sizeof(float2);            // 128 KB

// base-4 digit reversal of a 14-bit index: bit-reverse, then swap the two
// bits inside every digit back
__device__ __forceinline__ int rev4(int i) {
  const unsigned r = __brev((unsigned)i) >> (32 - 14);
  return (int)(((r & 0x1555u) << 1) | ((r >> 1) & 0x1555u));
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__global__ void __launch_bounds__(THREADS)
k2_stft_pooled(const float* __restrict__ x, int64_t n, int64_t nw,
               const float* __restrict__ hann, const float* __restrict__ g2,
               const float2* __restrict__ tw, float* __restrict__ mid_db,
               float* __restrict__ side_db) {
  extern __shared__ float2 z[];                 // WIN complex values
  __shared__ float part[2][THREADS];            // per-thread band maxima
  const int tid = threadIdx.x;
  const int64_t w = blockIdx.x;
  const int64_t trk = blockIdx.y;
  const float* l = x + (trk * 2) * n + w * HOP;
  const float* r = l + n;

  for (int i = tid; i < WIN; i += THREADS) {
    const float lv = __ldg(l + i), rv = __ldg(r + i);
    const float hw = 0.5f * __ldg(hann + i);
    z[rev4(i)] = make_float2((lv + rv) * hw, (lv - rv) * hw);
  }

#pragma unroll 1
  for (int s = 0; s < STAGES; ++s) {
    __syncthreads();
    const int q = 2 * s;                 // span = 4^s = 1 << q
    const int span = 1 << q;
    const int tshift = 12 - q;           // WIN / (4 span) = 1 << (12 - 2s)
    for (int b = tid; b < WIN / 4; b += THREADS) {
      const int j = b & (span - 1);
      const int i0 = ((b >> q) << (q + 2)) + j;
      const int t1 = j << tshift;
      const float2 a0 = z[i0];
      const float2 a1 = cmul(z[i0 + span], __ldg(tw + t1));
      const float2 a2 = cmul(z[i0 + 2 * span], __ldg(tw + 2 * t1));
      const float2 a3 = cmul(z[i0 + 3 * span], __ldg(tw + 3 * t1));
      const float2 s02 = make_float2(a0.x + a2.x, a0.y + a2.y);
      const float2 d02 = make_float2(a0.x - a2.x, a0.y - a2.y);
      const float2 s13 = make_float2(a1.x + a3.x, a1.y + a3.y);
      const float2 d13 = make_float2(a1.x - a3.x, a1.y - a3.y);
      z[i0] = make_float2(s02.x + s13.x, s02.y + s13.y);
      z[i0 + span] = make_float2(d02.x + d13.y, d02.y - d13.x);      // d02 - i d13
      z[i0 + 2 * span] = make_float2(s02.x - s13.x, s02.y - s13.y);
      z[i0 + 3 * span] = make_float2(d02.x - d13.y, d02.y + d13.x);  // d02 + i d13
    }
  }
  __syncthreads();

  // bins [8 tid, 8 tid + 8) all lie in band tid / 16
  float pm = 0.f, ps = 0.f;
#pragma unroll
  for (int u = 0; u < BINS_PER_THREAD; ++u) {
    const int k = tid * BINS_PER_THREAD + u;
    const float2 a = z[k];
    const float2 c = z[(WIN - k) & (WIN - 1)];
    const float g = __ldg(g2 + k);
    const float mr = a.x + c.x, mi = a.y - c.y;   // 2 M[k]
    const float sr = a.x - c.x, si = a.y + c.y;   // 2 i S[k], rotated
    pm = fmaxf(pm, 0.25f * (mr * mr + mi * mi) * g);
    ps = fmaxf(ps, 0.25f * (sr * sr + si * si) * g);
  }
  part[0][tid] = pm;
  part[1][tid] = ps;
  __syncthreads();

  if (tid < 2 * BANDS) {
    const int which = tid / BANDS;
    const int band = tid % BANDS;
    float v = 0.f;
    if (band < HALF_BANDS) {
#pragma unroll
      for (int u = 0; u < PARTS_PER_BAND; ++u)
        v = fmaxf(v, part[which][band * PARTS_PER_BAND + u]);
    }
    const float db = v > 0.f ? 10.0f * log10f(fmaxf(v, 1e-38f)) : FLOOR_DB;
    float* out = which ? side_db : mid_db;
    out[(trk * nw + w) * BANDS + band] = db;
  }
}

}  // namespace

// frames: (tracks, 2, n) float32 planar stereo; writes mid/side (tracks,
// nw, 128). Returns a CUDA error code, 0 on success.
extern "C" int ss_stft_pooled(const float* x, int64_t tracks, int64_t n,
                              int64_t nw, const float* hann, const float* g2,
                              const float* tw, float* mid_db, float* side_db,
                              void* stream) {
  if (tracks == 0 || nw == 0) return 0;
  if (tracks > 65535 || nw > 0x7fffffff || (nw - 1) * HOP + WIN > n)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      k2_stft_pooled, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)nw, (unsigned)tracks);
  k2_stft_pooled<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      x, n, nw, hann, g2, reinterpret_cast<const float2*>(tw), mid_db, side_db);
  return (int)cudaGetLastError();
}
