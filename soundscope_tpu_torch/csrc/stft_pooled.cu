// K2: pooled mid/side display spectrogram over the frames view.
//
// Replaces soundscope_tpu/ops/pallas_stft.py:stft_pooled_pallas_frames
// (kernel _make_kernel). The TPU kernel evaluates each 16384-point window
// as a four-step 128x128 DFT on its matrix unit (about 50 MFLOP a window).
// Here one CTA of 512 threads owns one (track, window) and runs a
// register-resident FFT (about 1.2 MFLOP a window, float32 throughout):
// 16384 = 32 x 32 x 16, each thread holding 32 complex values, the data
// crossing shared memory only between passes.
//
//   load     thread t reads samples t + 512 m (m < 32) of both channels,
//            coalesced, into registers: z = (l+r)/2 hann + i (l-r)/2 hann;
//   pass 1   a 32-point DFT over m, then the twiddle W^(t k1) (W =
//            exp(-2 pi i / 16384)) as a product of table factors;
//   exch. 1  thread t writes its value k1 at s1(k1, t); thread (k1, u)
//            (t = 16 k1 + u) reads values t' = u + 16 m2 of row k1;
//   pass 2   a 32-point DFT over m2, then the twiddle W^(32 u k2);
//   exch. 2  thread (k1, u) writes value k2 at s2(k1, k2, u); thread
//            (k1, k2), k2 < 16, reads u = 0..15 of group (k1, k2) and of its
//            partner group (-k1 mod 32, 31 - k2) (see below);
//   pass 3   a 16-point DFT over u for each of its two groups:
//            Z[k1 + 32 k2 + 1024 k3] in register k3 of group (k1, k2);
//   pool     -k lies in the partner group at k3' = 15 - k3, so each thread
//            forms |M|^2 and |S|^2 (the conjugate split of Z[k] and Z[-k])
//            for its 16 bins below 8192 in registers, times the squared
//            display gain, and writes them in bin order; each warp then
//            takes the max of 4 bands (x mid, side) with warp shuffles
//            and writes each band once: 10 log10 with the -150 dB floor;
//            bands 64-127 (at or above Nyquist, gain 0) are the floor.
//            The max keeps a NaN, so a band holding a NaN bin reads the
//            floor and one of +Inf bins +Inf dB, as in the plain version.
//
// Thread (0, 0) is the exception to the pairing: it holds the two groups
// that are their own partners, (0, 0) (partner k3' = -k3 mod 16) and
// (0, 16) (k3' = 15 - k3).
//
// The exchanges use split real and imaginary planes with XOR swizzles,
//   s1(k1, t)     = 512 k1 + (t ^ (16 (k1 & 1)))
//   s2(k1, k2, u) = 512 k2 + 32 u + (k1 ^ 2u)
// so that every warp's reads and writes, the bin-order power writes and
// the pool's reads touch 32 distinct banks (tests/test_torch_stft.py
// emulates the passes in float64 and checks this). Inside a pass, the
// 16- and 32-point DFTs are radix-2 with constant twiddles folded by the
// compiler; the pass twiddles come from a 6 KB table in shared memory,
// built on the host in float64 and stored as float32.
//
// Bound on the H100: not memory. The kernel uses 128 registers x 512
// threads, the whole register file, and 134 KB of shared memory, with no
// spills, so one CTA runs per SM and a window's load, passes and pool run
// in turn between barriers; instruction issue and those barriers are the
// likely limit. Per window it moves
// about 640 KB through shared memory and does 1.2 MFLOP; device memory is
// read 8x per sample by overlapping windows, mostly from L2 (windows of one
// track run first), and the output is 1 KB. Measured at the bench shape
// (PERF.md): about 3.5 ms, 4.2x the float32 operation bound, 5.1x faster
// than the shared-memory radix-4 kernel before it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WIN = 16384;
constexpr int HOP = 2048;
constexpr int BANDS = 128;
constexpr int THREADS = 512;
constexpr int R = 32;                       // values per thread
constexpr float FLOOR_DB = -150.0f;
// twiddle table (float2): W^f, f < 128 | W^(128 c), c < 128 | W^(32 j), j < 512
constexpr int TW_FINE = 0;
constexpr int TW_COARSE = 128;
constexpr int TW_PASS2 = 256;
constexpr int TW_LEN = 768;
constexpr int SMEM = 2 * WIN * (int)sizeof(float) + TW_LEN * (int)sizeof(float2);

// max that returns NaN when either operand is NaN, as the plain version's
// amax does (fmaxf drops a NaN); the same as iir_common.cuh's, whose
// THREADS this file cannot share
__device__ __forceinline__ float fmax_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// cos(2 pi b / 32) for b = 0..8: float64 values rounded to float32
__device__ __forceinline__ float cos32_q(int b) {
  switch (b) {
    case 0: return 1.0f;
    case 1: return (float)0.9807852804032304;
    case 2: return (float)0.9238795325112867;
    case 3: return (float)0.8314696123025452;
    case 4: return (float)0.7071067811865476;
    case 5: return (float)0.5555702330196023;
    case 6: return (float)0.38268343236508984;
    case 7: return (float)0.19509032201612833;
    default: return 0.0f;
  }
}

// cos(2 pi j / 32) for any j (folded to a constant where j is one)
__device__ __forceinline__ float cos32(int j) {
  j &= 31;
  const int a = j <= 16 ? j : 32 - j;       // cos is even
  return a <= 8 ? cos32_q(a) : -cos32_q(16 - a);
}

// v * W_32^j, W_32 = exp(-2 pi i / 32), j a compile-time constant
__device__ __forceinline__ float2 rot32(float2 v, int j) {
  j &= 31;
  if (j == 0) return v;
  if (j == 8) return make_float2(v.y, -v.x);       // -i
  if (j == 16) return make_float2(-v.x, -v.y);
  if (j == 24) return make_float2(-v.y, v.x);      // +i
  return cmul(v, make_float2(cos32(j), -cos32(j - 8)));
}

// one radix-2 decimation-in-frequency stage of half-width S, then the rest
template <int N, int S>
__device__ __forceinline__ void dif_stages(float2 (&v)[N]) {
#pragma unroll
  for (int j = 0; j < N; j += 2 * S) {
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const float2 a = v[j + i], b = v[j + i + S];
      v[j + i] = cadd(a, b);
      v[j + i + S] = rot32(csub(a, b), 16 / S * i);   // W_N^(i N / 2S)
    }
  }
  if constexpr (S > 1) dif_stages<N, S / 2>(v);
}

__host__ __device__ constexpr int bitrev(int k, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((k >> b) & 1) << (bits - 1 - b);
  return r;
}

// in place: v[k] = sum_m v[m] W_N^(m k), N = 16 or 32, natural order in
// and out (the bit reversal is a renaming of registers)
template <int N>
__device__ __forceinline__ void dft(float2 (&v)[N]) {
  constexpr int BITS = N == 32 ? 5 : 4;
  dif_stages<N, N / 2>(v);
  float2 t[N];
#pragma unroll
  for (int k = 0; k < N; ++k) t[k] = v[bitrev(k, BITS)];
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = t[k];
}

__device__ __forceinline__ int s1(int k1, int t) {
  return 512 * k1 + (t ^ ((k1 & 1) << 4));
}
__device__ __forceinline__ int s2(int k1, int k2, int u) {
  return 512 * k2 + 32 * u + (k1 ^ (2 * u));
}

// |M|^2 g and |S|^2 g of bin k from a = Z[k], c = Z[-k]
__device__ __forceinline__ void split_power(float2 a, float2 c, float g,
                                            float& pm, float& ps) {
  const float mr = a.x + c.x, mi = a.y - c.y;   // 2 M[k]
  const float sr = a.x - c.x, si = a.y + c.y;   // 2 i S[k], rotated
  pm = 0.25f * (mr * mr + mi * mi) * g;
  ps = 0.25f * (sr * sr + si * si) * g;
}

__global__ void __launch_bounds__(THREADS, 1)
k2_stft_pooled(const float* __restrict__ x, int64_t n, int64_t nw,
               const float* __restrict__ hann, const float* __restrict__ g2,
               const float2* __restrict__ tw, float* __restrict__ mid_db,
               float* __restrict__ side_db) {
  extern __shared__ float smem[];
  float* re = smem;                             // WIN floats
  float* im = smem + WIN;                       // WIN floats
  float2* tab = reinterpret_cast<float2*>(smem + 2 * WIN);
  const int t = threadIdx.x;
  const int64_t w = blockIdx.x;
  const int64_t trk = blockIdx.y;
  const float* l = x + (trk * 2) * n + w * HOP;
  const float* r = l + n;

  float2 v[R];
#pragma unroll
  for (int m = 0; m < R; ++m) {
    const int i = t + THREADS * m;
    const float lv = __ldg(l + i), rv = __ldg(r + i);
    const float hw = 0.5f * __ldg(hann + i);
    v[m] = make_float2((lv + rv) * hw, (lv - rv) * hw);
  }
  for (int i = t; i < TW_LEN; i += THREADS) tab[i] = __ldg(tw + i);
  __syncthreads();

  // pass 1: DFT over m, then the twiddle W^(t k1) = W^(t a) W^(8 t b) for
  // k1 = a + 8 b, each factor W^e = W^(128 (e >> 7)) W^(e & 127) from the
  // coarse and fine tables (10 factors, not 31)
  dft<32>(v);
  {
    float2 wb[4];
#pragma unroll
    for (int b = 1; b < 4; ++b) {
      const int e = 8 * t * b;
      wb[b] = cmul(tab[TW_COARSE + (e >> 7)], tab[TW_FINE + (e & 127)]);
      v[8 * b] = cmul(v[8 * b], wb[b]);
    }
#pragma unroll
    for (int a = 1; a < 8; ++a) {
      const int e = t * a;
      const float2 wa = cmul(tab[TW_COARSE + (e >> 7)], tab[TW_FINE + (e & 127)]);
      v[a] = cmul(v[a], wa);
#pragma unroll
      for (int b = 1; b < 4; ++b) v[a + 8 * b] = cmul(v[a + 8 * b], cmul(wa, wb[b]));
    }
  }
#pragma unroll
  for (int k1 = 0; k1 < R; ++k1) {
    re[s1(k1, t)] = v[k1].x;
    im[s1(k1, t)] = v[k1].y;
  }
  __syncthreads();

  // pass 2: thread (k1, u) takes t' = u + 16 m2; DFT over m2; W^(32 u k2)
  {
    const int k1 = t >> 4, u = t & 15;
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const int a = s1(k1, u + 16 * m);
      v[m] = make_float2(re[a], im[a]);
    }
    dft<32>(v);
#pragma unroll
    for (int k2 = 1; k2 < R; ++k2) v[k2] = cmul(v[k2], tab[TW_PASS2 + u * k2]);
    __syncthreads();
#pragma unroll
    for (int k2 = 0; k2 < R; ++k2) {
      re[s2(k1, k2, u)] = v[k2].x;
      im[s2(k1, k2, u)] = v[k2].y;
    }
  }
  __syncthreads();

  // pass 3: thread (k1, k2 < 16) holds group A = (k1, k2) and its partner
  // group B = (-k1 mod 32, 31 - k2); thread (0, 0) holds (0, 0) and (0, 16)
  const int k1 = t & 31, k2 = t >> 5;
  const int b1 = (32 - k1) & 31;
  const int b2 = k1 ? 31 - k2 : (k2 ? 32 - k2 : 16);
  const bool self = t == 0;
  float2 va[16], vb[16];
#pragma unroll
  for (int u = 0; u < 16; ++u) {
    const int a = s2(k1, k2, u), b = s2(b1, b2, u);
    va[u] = make_float2(re[a], im[a]);
    vb[u] = make_float2(re[b], im[b]);
  }
  dft<16>(va);
  dft<16>(vb);
  __syncthreads();

  // powers of the 16 bins below 8192 in bin order: mid in re, side in im
#pragma unroll
  for (int k3 = 0; k3 < 8; ++k3) {
    float pm, ps;
    const int ka = k1 + 32 * k2 + 1024 * k3;
    const float2 ca = self ? va[(16 - k3) & 15] : vb[15 - k3];
    split_power(va[k3], ca, __ldg(g2 + ka), pm, ps);
    re[ka] = pm;
    im[ka] = ps;
    const int kb = b1 + 32 * b2 + 1024 * k3;
    const float2 cb = self ? vb[15 - k3] : va[15 - k3];
    split_power(vb[k3], cb, __ldg(g2 + kb), pm, ps);
    re[kb] = pm;
    im[kb] = ps;
  }
  __syncthreads();

  // pool: warp q takes bands 4q .. 4q + 3 of mid and of side
  const int lane = t & 31, q = t >> 5;
  float mine = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float* p = (j < 4 ? re : im) + (4 * q + (j & 3)) * 128 + lane;
    float m = fmax_nan(fmax_nan(p[0], p[32]), fmax_nan(p[64], p[96]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmax_nan(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == j) mine = m;
  }
  const int64_t row = (trk * nw + w) * BANDS;
  if (lane < 8) {
    const float db = mine > 0.f ? 10.0f * log10f(fmaxf(mine, 1e-38f)) : FLOOR_DB;
    (lane < 4 ? mid_db : side_db)[row + 4 * q + (lane & 3)] = db;
  }
  if (t < 2 * (BANDS / 2))                      // bands 64-127: the floor
    ((t >> 6) ? side_db : mid_db)[row + BANDS / 2 + (t & 63)] = FLOOR_DB;
}

}  // namespace

// frames: (tracks, 2, n) float32 planar stereo; writes mid/side (tracks,
// nw, 128). tw: the 768 float2 twiddles above. Returns a CUDA error code,
// 0 on success.
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

// The kernel's resources: out[0] registers per thread, out[1] static and
// out[2] dynamic shared memory bytes, out[3] local (spill) bytes per
// thread, out[4] threads per CTA, out[5] CTAs resident per SM. Returns a
// CUDA error code.
extern "C" int ss_stft_pooled_attrs(int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncSetAttribute(
      k2_stft_pooled, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, k2_stft_pooled);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k2_stft_pooled,
                                                      THREADS, SMEM);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = SMEM;
  out[3] = (int)a.localSizeBytes;
  out[4] = THREADS;
  out[5] = blocks;
  return 0;
}
