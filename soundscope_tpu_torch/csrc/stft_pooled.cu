// K2: pooled mid/side display spectrogram over the frames view.
//
// Replaces soundscope_tpu/ops/pallas_stft.py:stft_pooled_pallas_frames
// (kernel _make_kernel). The TPU kernel evaluates each 16384-point window
// as a four-step 128x128 DFT on its matrix unit (about 50 MFLOP a window).
// Here two CTAs of 256 threads own one (track, window): blockIdx.x = 2 w +
// c, c = 0 mid, 1 side, adjacent in launch order so that the second reads
// the window from L2. Each takes the real 16384-point FFT of its channel
// as a packed complex 8192-point one (float32 throughout):
//
//   load     thread t reads samples 2n, 2n + 1 of both channels, n = t +
//            256 m (m < 32), as float2, coalesced and past L1, and forms
//            z[n] = x[2n] + i x[2n+1] of its channel x = (l +- r) hann / 4
//            (the 1/4 is the split's 1/2 squared, folded in); the Hann
//            window comes from a table of 1 - cos and sin and constant
//            angles, exact to a few ulps down to its edges (see hann4);
//   pass 1   a 32-point DFT over m, then the lane part W^(2 l k1) of the
//            twiddle W8192^(t k1) = W^(2 l k1) W^(64 v k1), t = 32 v + l,
//            from a 32 x 32 table read at (k1, l);
//   exch. 1  thread t writes its value k1 at s1(t, k1); thread (k1, u0)
//            (t = 8 k1 + u0) reads values t' = u + 16 m2 of row k1 for its
//            two units u = u0, u0 + 8;
//   pass 2   the warp part W^(64 v k1), v = t' >> 5 = m2 >> 1 (7 table
//            reads), a 16-point DFT over m2 per unit, then W256^(u k2) from
//            a 16 x 16 table read at (k2, u);
//   exch. 2  thread (k1, u0) writes value k2 of unit u at s2(k1, k2, u);
//            thread (k1, k2), k2 < 8, reads u = 0..15 of group (k1, k2) and
//            of its partner group (-k1 mod 32, 15 - k2) (see below);
//   pass 3   a 16-point DFT over u for each of its two groups:
//            Z[k1 + 32 k2 + 512 k3] in register k3 of group (k1, k2);
//   split    8192 - k lies in the partner group at k3' = 15 - k3, so each
//            thread forms, for its 16 pairs (k, 8192 - k), E = Z[k] +
//            conj Z[8192 - k] and O = -i (Z[k] - conj Z[8192 - k]) and the
//            two bins |E +- W^k O|^2 (W = exp(-2 pi i / 16384)) in
//            registers, with W^k the table's W^(k1 + 32 k2) turned by a
//            constant W32^k3; it writes the 32 powers in bin order;
//   pool     lane l of warp v reads bins 4 l .. 4 l + 3 of bands 8 v ..
//            8 v + 7 with their squared display gains, as float4; a
//            butterfly of 9 shuffles, each step halving the bands a lane
//            holds, leaves each band's max in 4 lanes, one of which writes
//            it: 10 log10 with the -150 dB floor; bands 64-127 (at or
//            above Nyquist, gain 0) are the floor. The max keeps a NaN, so
//            a band holding a NaN bin reads the floor and one of +Inf bins
//            +Inf dB, as in the plain version.
//
// Thread 0 is the exception to the pairing: it holds the two groups that
// are their own partners, (0, 0) (k3' = -k3 mod 16) and (0, 8) (k3' =
// 15 - k3), and also forms bin 4096 alone.
//
// The exchanges move float2 values at XOR-swizzled places,
//   s1(t, k1)     = 256 k1 + (t ^ (8 (k1 & 3)))
//   s2(k1, k2, u) = 512 k2 + 32 u + (k1 ^ (2 (u & 7)))
// so that every warp's reads and writes, the bin-order power writes, the
// pool's reads and every twiddle read are free of bank conflicts
// (tests/test_torch_stft.py emulates the kernel in float64 and checks
// this). Inside a pass, the 16- and 32-point DFTs are radix-2 with
// constant twiddles folded by the compiler; the pass and split twiddles
// come from a 16 KB table, built on the host in float64 and stored as
// float32, that every CTA reads through L1.
//
// Bound on the H100: not memory (device memory is read about once, L2 16x
// per sample: 8 overlapping windows, 2 channels; the same kernel on one
// window that stays in L2 for every CTA is 2 % faster), but instruction
// issue (about 2,900 a thread, 70 % of them float32) and the latency of
// the phases between barriers. Each CTA holds 32 values a thread in at
// most 128 registers x 256 threads and 64 KB of shared memory, so two
// CTAs share each SM: while one waits on a barrier, an exchange or its
// load, the other's butterflies issue. The FFT is about 1.1 MFLOP a
// window over both CTAs, a CTA's exchanges 256 KB of shared-memory
// traffic, the output 1 KB. The 512-thread kernel before it (one CTA a
// window, mid and side in one complex FFT, the whole register file, its
// phases in series between barriers) took 28.06 ms at the frames cell's
// shape, 10.3x its 2.71 ms FFT bound; PERF.md gives this one's time and
// the ablations of both.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WIN = 16384;
constexpr int HALF = WIN / 2;              // points of the packed complex FFT
constexpr int HOP = 2048;
constexpr int BANDS = 128;
constexpr int THREADS = 256;
constexpr int R = 32;                       // values per thread
constexpr float FLOOR_DB = -150.0f;
// twiddle table (float2, in device memory), W = exp(-2 pi i / WIN):
constexpr int TW_P1 = 0;       // W^(2 l k1) at 32 k1 + l (l, k1 < 32): pass 1, lane part
constexpr int TW_WARP = 1024;  // W^(64 j), j < 256: pass 1, warp part
constexpr int TW_P2 = 1280;    // W^(64 u k2) at 16 k2 + u (u, k2 < 16): pass 2
constexpr int TW_SPLIT = 1536; // W^e, e <= 256: the split
constexpr int TW_HANN = 1793;  // (1 - cos, sin)(2 pi e / WIN), e <= 512: the Hann window
constexpr int SMEM = HALF * (int)sizeof(float2);   // the exchanges

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

__device__ __forceinline__ int s1(int t, int k1) {
  return 256 * k1 + (t ^ ((k1 & 3) << 3));
}
__device__ __forceinline__ int s2(int k1, int k2, int u) {
  return 512 * k2 + 32 * u + (k1 ^ ((u & 7) << 1));
}

// 1 - cos(2 pi m / 32) for m = 0..15: float64 values rounded to float32
__device__ __forceinline__ float vers32(int m) {
  switch (m) {
    case 0: return 0.0f;
    case 1: return (float)0.01921471959676957;
    case 2: return (float)0.07612046748871326;
    case 3: return (float)0.16853038769745476;
    case 4: return (float)0.2928932188134524;
    case 5: return (float)0.4444297669803977;
    case 6: return (float)0.6173165676349102;
    case 7: return (float)0.8049096779838717;
    case 8: return 1.0f;
    case 9: return (float)1.1950903220161282;
    case 10: return (float)1.3826834323650896;
    case 11: return (float)1.555570233019602;
    case 12: return (float)1.7071067811865475;
    case 13: return (float)1.8314696123025453;
    case 14: return (float)1.9238795325112867;
    default: return (float)1.9807852804032304;
  }
}

// Hann / 4 of sample e + 512 m, m < 16 a compile-time constant, from vs =
// (1 - cos a, sin a) at a = 2 pi e / WIN: (1 - cos(a + b)) / 8 with b =
// 2 pi m / 32 is (vers b + cos b (1 - cos a) + sin b sin a) / 8, a sum of
// terms >= 0 wherever it is small, so no term cancels (1 - cos(a + b) of
// a rounded cosine would lose all digits at the window's edges)
__device__ __forceinline__ float hann4(float2 vs, int m) {
  return fmaf(0.125f * cos32(m), vs.x, fmaf(0.125f * cos32(m - 8), vs.y, 0.125f * vers32(m)));
}

// a float2 load that leaves L1 to the gains and the twiddles
__device__ __forceinline__ float2 ld_stream(const float2* p) {
  float2 v;
  asm("ld.global.nc.L1::no_allocate.v2.f32 {%0, %1}, [%2];" : "=f"(v.x), "=f"(v.y) : "l"(p));
  return v;
}

// the split of one pair: a = Z[k], c = Z[8192 - k], w = W^k; pa, pb the
// powers of bins k and 8192 - k
__device__ __forceinline__ void split_power(float2 a, float2 c, float2 w, float& pa,
                                            float& pb) {
  const float er = a.x + c.x, ei = a.y - c.y;   // E = Z[k] + conj Z[-k]
  const float dr = a.x - c.x, di = a.y + c.y;   // O = -i (dr + i di)
  const float tr = fmaf(w.x, di, w.y * dr);     // W^k O
  const float ti = fmaf(w.y, di, -(w.x * dr));
  const float pr = er + tr, pi = ei + ti, nr = er - tr, ni = ei - ti;
  pa = fmaf(pr, pr, pi * pi);
  pb = fmaf(nr, nr, ni * ni);
}

__global__ void __launch_bounds__(THREADS, 2)
k2_stft_pooled(const float* __restrict__ x, int64_t n, int64_t nw,
               const float* __restrict__ g2, const float2* __restrict__ tw,
               float* __restrict__ mid_db, float* __restrict__ side_db) {
  extern __shared__ float4 smem4[];
  float2* buf = reinterpret_cast<float2*>(smem4);   // HALF values
  const int t = threadIdx.x, lane = t & 31, wp = t >> 5;
  const int64_t w = blockIdx.x >> 1;
  const bool side = blockIdx.x & 1;
  const int64_t trk = blockIdx.y;
  const float2* l = reinterpret_cast<const float2*>(x + (trk * 2) * n + w * HOP);
  const float2* r = reinterpret_cast<const float2*>(x + (trk * 2 + 1) * n + w * HOP);
  const float sg = side ? -1.0f : 1.0f;

  float2 v[R];
  {
    // samples 2t, 2t + 1 (+ 512 m); past the middle by hann(s) = hann(WIN -
    // s): samples 2 (256 - t), 2 (255 - t) + 1 (+ 512 (31 - m))
    const float2 he = __ldg(tw + TW_HANN + 2 * t), ho = __ldg(tw + TW_HANN + 2 * t + 1);
    const float2 me = __ldg(tw + TW_HANN + 512 - 2 * t), mo = __ldg(tw + TW_HANN + 511 - 2 * t);
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const float2 lv = ld_stream(l + t + 256 * m), rv = ld_stream(r + t + 256 * m);
      const float h0 = m < 16 ? hann4(he, m) : hann4(me, 31 - m);
      const float h1 = m < 16 ? hann4(ho, m) : hann4(mo, 31 - m);
      v[m] = make_float2(fmaf(sg, rv.x, lv.x) * h0, fmaf(sg, rv.y, lv.y) * h1);
    }
  }

  // pass 1: DFT over m, then the lane part W^(2 lane k1) of W8192^(t k1)
  dft<32>(v);
#pragma unroll
  for (int k1 = 1; k1 < R; ++k1) v[k1] = cmul(v[k1], __ldg(tw + TW_P1 + 32 * k1 + lane));
#pragma unroll
  for (int k1 = 0; k1 < R; ++k1) buf[s1(t, k1)] = v[k1];
  __syncthreads();

  // pass 2: thread (k1, u0) takes units u = u0, u0 + 8: t' = u + 16 m2,
  // times the warp part W^(64 (t' >> 5) k1) = W^(64 (m2 >> 1) k1) of pass
  // 1's twiddle; a DFT over m2; W256^(u k2)
  float2 va[16], vb[16];
  {
    const int k1 = t >> 3, u0 = t & 7;
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      va[m] = buf[s1(u0 + 16 * m, k1)];
      vb[m] = buf[s1(u0 + 8 + 16 * m, k1)];
    }
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      const float2 f = __ldg(tw + TW_WARP + j * k1);
      va[2 * j] = cmul(va[2 * j], f);
      va[2 * j + 1] = cmul(va[2 * j + 1], f);
      vb[2 * j] = cmul(vb[2 * j], f);
      vb[2 * j + 1] = cmul(vb[2 * j + 1], f);
    }
    dft<16>(va);
    dft<16>(vb);
#pragma unroll
    for (int k2 = 1; k2 < 16; ++k2) {
      va[k2] = cmul(va[k2], __ldg(tw + TW_P2 + 16 * k2 + u0));
      vb[k2] = cmul(vb[k2], __ldg(tw + TW_P2 + 16 * k2 + u0 + 8));
    }
    __syncthreads();
#pragma unroll
    for (int k2 = 0; k2 < 16; ++k2) {
      buf[s2(k1, k2, u0)] = va[k2];
      buf[s2(k1, k2, u0 + 8)] = vb[k2];
    }
  }
  __syncthreads();

  // pass 3: thread (k1, k2 < 8) holds group A = (k1, k2) and its partner
  // group B = (-k1 mod 32, 15 - k2); thread 0 holds (0, 0) and (0, 8)
  const int k1 = lane, k2 = wp;
  const int b1 = (32 - k1) & 31;
  const int b2 = k1 ? 15 - k2 : (k2 ? 16 - k2 : 8);
#pragma unroll
  for (int u = 0; u < 16; ++u) {
    va[u] = buf[s2(k1, k2, u)];
    vb[u] = buf[s2(b1, b2, u)];
  }
  dft<16>(va);
  dft<16>(vb);
  const bool self = t == 0;
  const float2 wa = __ldg(tw + TW_SPLIT + k1 + 32 * k2);   // W^(k1 + 32 k2)
  const float2 wb = __ldg(tw + TW_SPLIT + 256);            // W^256, thread 0's (0, 8)
  __syncthreads();

  // the split: pair j is (k, 8192 - k) for k = k1 + 32 k2 + 512 j, with
  // a = A[j], c = B[15 - j]; thread 0 takes (0, 0) for j < 8 and (0, 8)
  // for j >= 8, each with itself; powers in bin order into pw
  float* pw = reinterpret_cast<float*>(buf);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const bool hb = j >= 8 && self;
    const float2 a = hb ? vb[j & 7] : va[j];
    const float2 c = self ? (j < 8 ? va[(16 - j) & 15] : vb[(23 - j) & 15]) : vb[15 - j];
    // W^k = W^(k1 + 32 k2) W32^j; for j >= 8 the base carries W32^8 = -i
    const float2 base = j < 8 ? wa : (self ? wb : make_float2(wa.y, -wa.x));
    const int ka = hb ? 256 + 512 * (j - 8) : k1 + 32 * k2 + 512 * j;
    float pa, pb;
    split_power(a, c, rot32(base, j & 7), pa, pb);
    pw[ka] = pa;
    if (j != 0 || !self) pw[HALF - ka] = pb;        // thread 0, j = 0: 8192 - 0 is no bin
  }
  if (self) {                                       // bin 4096, its own pair
    float pa, pb;
    split_power(va[8], va[8], make_float2(0.0f, -1.0f), pa, pb);
    pw[HALF / 2] = pa;
  }
  __syncthreads();

  // pool: warp wp takes bands 8 wp .. 8 wp + 7, lane l bins 4 l .. 4 l + 3
  // of each, times their squared gains
  const float4* p4 = reinterpret_cast<const float4*>(pw);
  const float4* gw = reinterpret_cast<const float4*>(g2);
  float m[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int q = (8 * wp + j) * 32 + lane;
    const float4 p = p4[q], g = __ldg(gw + q);
    m[j] = fmax_nan(fmax_nan(p.x * g.x, p.y * g.y), fmax_nan(p.z * g.z, p.w * g.w));
  }
  // each step halves the bands a lane holds, lane bit o picking the half
#pragma unroll
  for (int o = 16, h = 4; o >= 4; o >>= 1, h >>= 1) {
    const bool up = lane & o;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float keep = up ? m[i + h] : m[i], send = up ? m[i] : m[i + h];
      m[i] = fmax_nan(keep, __shfl_xor_sync(0xffffffffu, send, o));
    }
  }
  float mine = fmax_nan(m[0], __shfl_xor_sync(0xffffffffu, m[0], 2));
  mine = fmax_nan(mine, __shfl_xor_sync(0xffffffffu, mine, 1));
  float* out = (side ? side_db : mid_db) + (trk * nw + w) * BANDS;
  if ((lane & 3) == 0)                              // band 8 wp + lane bits 2-4
    out[8 * wp + (lane >> 2)] = mine > 0.f ? 10.0f * log10f(fmaxf(mine, 1e-38f)) : FLOOR_DB;
  if (t < BANDS / 2) out[BANDS / 2 + t] = FLOOR_DB;   // bands 64-127: the floor
}

}  // namespace

// frames: (tracks, 2, n) float32 planar stereo, 8-byte aligned; writes
// mid/side (tracks, nw, 128). g2: the squared gains of the 8,192 bins
// below Nyquist, 16-byte aligned; tw: the 2,306 float2 twiddles above;
// hann: unused, the kernel forms the window from tw. One launch of 2 nw
// CTAs per track. Returns a CUDA error code, 0 on success.
extern "C" int ss_stft_pooled(const float* x, int64_t tracks, int64_t n,
                              int64_t nw, const float* hann, const float* g2,
                              const float* tw, float* mid_db, float* side_db,
                              void* stream) {
  (void)hann;
  if (tracks == 0 || nw == 0) return 0;
  if (tracks > 65535 || nw > 0x3fffffff || (nw - 1) * HOP + WIN > n || (n & 1) ||
      (reinterpret_cast<uintptr_t>(x) & 7) || (reinterpret_cast<uintptr_t>(g2) & 15) ||
      (reinterpret_cast<uintptr_t>(tw) & 7))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      k2_stft_pooled, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(2 * nw), (unsigned)tracks);
  k2_stft_pooled<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      x, n, nw, g2, reinterpret_cast<const float2*>(tw), mid_db, side_db);
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
