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
//            angles, exact to a few ulps down to its edges (see hann4),
//            whose four entries a thread loads before its samples;
//   pass 1   a 32-point DFT over m, then the lane part W^(2 l k1) of the
//            twiddle W8192^(t k1) = W^(2 l k1) W^(64 v k1), t = 32 v + l,
//            from a 32 x 32 table read at (k1, l);
//   exch. 1  thread t writes its value k1 at s1(t, k1); thread (k1, u0)
//            (t = 8 k1 + u0) reads values t' = u + 16 m2 of row k1 for its
//            two units u = u0, u0 + 8;
//   pass 2   the warp part W^(64 v k1), v = t' >> 5 = m2 >> 1 (7 table
//            reads at (k1, v)), a 16-point DFT over m2 per unit, then
//            W256^(u k2) from a 16 x 16 table read at (k2, u);
//   exch. 2  thread (k1, u0) writes value k2 of unit u at s2(k1, k2, u);
//            thread (k1, k2), k2 < 8, reads u = 0..15 of group (k1, k2) and
//            of its partner group (-k1 mod 32, 15 - k2) (see below);
//   pass 3   a 16-point DFT over u for each of its two groups:
//            Z[k1 + 32 k2 + 512 k3] in register k3 of group (k1, k2);
//   split    8192 - k lies in the partner group at k3' = 15 - k3, so each
//            thread forms, for its 16 pairs (k, 8192 - k), E = Z[k] +
//            conj Z[8192 - k] and O = -i (Z[k] - conj Z[8192 - k]) and the
//            two bins |E +- W^k O|^2 (W = exp(-2 pi i / 16384)) in
//            registers, and writes the 32 powers in bin order;
//   pool     lane l of warp v reads bins 4 l .. 4 l + 3 of bands 8 v ..
//            8 v + 7 with their squared display gains, as float4; a
//            butterfly of 9 shuffles, each step halving the bands a lane
//            holds, leaves each band's max in 4 lanes, one of which writes
//            it: 10 log10 with the -150 dB floor; bands 64-127 (at or
//            above Nyquist, gain 0) are the floor. The max keeps a NaN, so
//            a band holding a NaN bin reads the floor and one of +Inf bins
//            +Inf dB, as in the plain version.
//
// For k1 = 0 the partner of group (0, k2) is (0, 16 - k2), at the same k3'.
// Thread 0 holds the two groups that are their own partners, (0, 0) (k3' =
// -k3 mod 16) and (0, 8) (k3' = 15 - k3). It runs the others' split on
// them, which writes its (0, 0) bins wrongly, and leaves the operands of
// its 17 self pairs (8 in each group, and bin 0) in 272 bytes of static
// shared memory; threads 0-16 then form one self pair each, over the
// wrong bins. No thread selects between the two cases, and warp 0's own
// path is one pair long.
//
// Butterflies (bfly): the 32- and 16-point DFTs are radix-2 decimation in
// time, each twiddle W_32^e a compile-time constant. Where it is 1 or -i a
// butterfly is four additions; otherwise w b = f (p, q), with (p, q) two
// FMAs from b and the factor f folded into the four FMAs of a +- f (p, q):
// six instructions where a complex product and four additions took eight
// (Linzer and Feig, Math. Comp. 60, 1993; Goedecker, SIAM J. Sci. Comput.
// 18, 1997). For |tan| <= 1, w = cos (1 - i tan); else w = sin (cot - i),
// so that no FMA multiplies by more than 1. The split's E +- W^k O takes
// the same form: W^k comes from a table of (cos, tan) at angles up to pi /
// 4, read by its symmetries, its form fixed at compile time by k's pair
// index (k < 2048, 2048 <= k < 6144 or above).
//
// The exchanges move float2 values at XOR-swizzled places,
//   s1(t, k1)     = 256 k1 + (t ^ (8 (k1 & 1)))
//   s2(k1, k2, u) = 512 k2 + 32 u + (k1 ^ (2 (u & 7)))
// chosen so that every write of exchange 1 and 2 and every read of
// exchange 1 is one base a thread (two at most) plus an offset fixed at
// compile time, which the compiler folds into the shared-memory
// instruction; only pass 3's reads XOR with u, 8 bases a group. Every
// warp's reads and writes, the bin-order power writes (but the self pairs'
// two, to bins 256 apart), the pool's reads and every table read are free
// of bank conflicts (tests/test_torch_stft.py emulates the kernel in
// float64 and checks this). The tables, built on the host in float64
// and stored as float32 (32 KB), are read by every CTA through L1.
//
// Bound on the H100: not memory (device memory is read about once, L2 16x
// per sample: 8 overlapping windows, 2 channels), but instruction issue and
// the latency of the phases between barriers. Each CTA holds 32 values a
// thread in at most 128 registers x 256 threads and 64 KB of shared memory
// (and the self pairs' 272 bytes), so two CTAs share each SM: while one
// waits on a barrier, an exchange or its load, the other's butterflies
// issue. The FFT is about 1.1 MFLOP a window over both CTAs, a CTA's
// exchanges 256 KB of shared-memory traffic, the output 1 KB. The kernel
// is 2,464 SASS instructions (1,895 float32), 2,430 (1,879) on the path of
// warps 1-7, against 2,916 (2,153) for the radix-2 DIF kernel before it,
// whose thread 0 case was selects in every thread. Loaded before the
// window's table entries, the samples held every product until the last
// of them came in: loading the entries first took K2 from 20.4 to 19.2 ms
// at the frames cell's shape. PERF.md gives the measured times, the counts
// and the ablations of this design and the ones before it.

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
// tables (float2, in device memory), W = exp(-2 pi i / WIN):
constexpr int TW_P1 = 0;       // W^(2 l k1) at 32 k1 + l (l, k1 < 32): pass 1, lane part
constexpr int TW_WARP = 1024;  // W^(64 v k1) at 8 k1 + v (v < 8, k1 < 32): pass 2, warp part
constexpr int TW_P2 = 1280;    // W^(64 u k2) at 16 k2 + u (u, k2 < 16): pass 2
constexpr int TW_SPLIT = 1536; // (cos, tan)(2 pi e / WIN), e <= 2048: the split's W^k
constexpr int TW_HANN = 3585;  // (1 - cos, sin)(2 pi e / WIN), e <= 512: the Hann window
constexpr int TW_SELF = 4098;  // W^k of thread 0's 17 self pairs s (k_self(s)), as (cos, -sin)
constexpr int SELF = 17;
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

// tan(2 pi b / 32) for b = 0..4: float64 values rounded to float32
__device__ __forceinline__ float tan32_q(int b) {
  switch (b) {
    case 0: return 0.0f;
    case 1: return (float)0.198912367379658;
    case 2: return (float)0.41421356237309503;
    case 3: return (float)0.6681786379192989;
    default: return 1.0f;
  }
}

// cos(2 pi j / 32) for any j (folded to a constant where j is one)
__device__ __forceinline__ float cos32(int j) {
  j &= 31;
  const int a = j <= 16 ? j : 32 - j;       // cos is even
  return a <= 8 ? cos32_q(a) : -cos32_q(16 - a);
}

// a, b <- a + w b, a - w b with w = W_32^e = exp(-2 pi i e / 32), e < 16 a
// compile-time constant: four additions where w is 1 or -i; else w b = f
// (p, q), f (p, q) = cos (b.x + tan b.y, b.y - tan b.x) for |tan| <= 1 (e
// <= 4 or e >= 12), sin (cot b.x + b.y, cot b.y - b.x) otherwise
__device__ __forceinline__ void bfly(float2& a, float2& b, int e) {
  const float2 s = a;
  if (e == 0 || e == 8) {
    const float2 wb = e == 0 ? b : make_float2(b.y, -b.x);
    a = cadd(s, wb);
    b = csub(s, wb);
    return;
  }
  float f, p, q;
  if (e <= 4 || e >= 12) {
    f = e <= 4 ? cos32_q(e) : -cos32_q(16 - e);
    const float tn = e <= 4 ? tan32_q(e) : -tan32_q(16 - e);
    p = fmaf(tn, b.y, b.x);
    q = fmaf(-tn, b.x, b.y);
  } else {
    f = cos32_q(e < 8 ? 8 - e : e - 8);                   // sin
    const float ct = e < 8 ? tan32_q(8 - e) : -tan32_q(e - 8);
    p = fmaf(ct, b.x, b.y);
    q = fmaf(ct, b.y, -b.x);
  }
  a = make_float2(fmaf(f, p, s.x), fmaf(f, q, s.y));
  b = make_float2(fmaf(-f, p, s.x), fmaf(-f, q, s.y));
}

// the decimation-in-time stages of half-width H, 2 H, ... N / 2: the
// butterfly (j + i, j + i + H) takes W_2H^i = W_32^(16 i / H)
template <int N, int H>
__device__ __forceinline__ void dit_stages(float2 (&a)[N]) {
#pragma unroll
  for (int j = 0; j < N; j += 2 * H) {
#pragma unroll
    for (int i = 0; i < H; ++i) bfly(a[j + i], a[j + i + H], 16 * i / H);
  }
  if constexpr (2 * H < N) dit_stages<N, 2 * H>(a);
}

__host__ __device__ constexpr int bitrev(int k, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((k >> b) & 1) << (bits - 1 - b);
  return r;
}

// in place: v[k] = sum_m v[m] W_N^(m k), N = 16 or 32, natural order in
// and out (the bit reversal of the inputs is a renaming of registers)
template <int N>
__device__ __forceinline__ void dft(float2 (&v)[N]) {
  constexpr int BITS = N == 32 ? 5 : 4;
  float2 a[N];
#pragma unroll
  for (int k = 0; k < N; ++k) a[k] = v[bitrev(k, BITS)];
  dit_stages<N, 1>(a);
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = a[k];
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

// p, opaque to the compiler, so that constant offsets from it fold into
// the loads' immediates (it would rewrite p + 32 k as an OR of indices and
// form each address anew)
__device__ __forceinline__ const float2* opaque(const float2* p) {
  asm("" : "+l"(p));
  return p;
}

// a float2 load that leaves L1 to the gains and the tables
__device__ __forceinline__ float2 ld_stream(const float2* p) {
  float2 v;
  asm("ld.global.nc.L1::no_allocate.v2.f32 {%0, %1}, [%2];" : "=f"(v.x), "=f"(v.y) : "l"(p));
  return v;
}

// the split of pair j of a thread, k = base + 512 j: a = Z[k], c = Z[8192 -
// k]; the powers |E +- W^k O|^2 of bins k and 8192 - k go to pk[512 j] and
// pn[-512 j], pk = pw + base, pn = pw + 8192 - base. W^k = f.x
// (1 - i f.y) for k < 2048 (j < 4) and k >= 6144 (j >= 12), f.x (f.y - i)
// between, from the table's (cos, tan) at up[e] = (cos, tan)(base + e) or
// dn[e] = (cos, tan)(e - base): (cos, tan)(k), (sin, cot)(k) = (cos,
// tan)(4096 - k) or (cos, -tan)(k - 4096), (cos, tan)(k) = (-cos,
// -tan)(8192 - k)
__device__ __forceinline__ void split_pair(float2 a, float2 c, const float2* up, const float2* dn,
                                           int j, float* pk, float* pn) {
  float2 f;
  if (j < 4) {
    f = __ldg(up + 512 * j);
  } else if (j < 8) {
    f = __ldg(dn + 4096 - 512 * j);
  } else if (j < 12) {
    f = __ldg(up + 512 * j - 4096);
    f.y = -f.y;
  } else {
    f = __ldg(dn + 8192 - 512 * j);
    f = make_float2(-f.x, -f.y);
  }
  const bool cot = j >= 4 && j < 12;
  const float er = a.x + c.x, ei = a.y - c.y;   // E = Z[k] + conj Z[-k]
  const float dr = a.x - c.x, di = a.y + c.y;   // O = -i (dr + i di) = (di, -dr)
  const float ox = cot ? fmaf(f.y, di, -dr) : fmaf(-f.y, dr, di);   // W^k O = f.x (ox, oy)
  const float oy = cot ? fmaf(-f.y, dr, -di) : fmaf(-f.y, di, -dr);
  const float pr = fmaf(f.x, ox, er), pi = fmaf(f.x, oy, ei);
  const float nr = fmaf(-f.x, ox, er), ni = fmaf(-f.x, oy, ei);
  pk[512 * j] = fmaf(pr, pr, pi * pi);
  pn[-512 * j] = fmaf(nr, nr, ni * ni);
}

// the split of one pair with W^k = w as (cos, -sin): a = Z[k], c = Z[8192 -
// k]; pa, pb the powers of bins k and 8192 - k
__device__ __forceinline__ void split_power(float2 a, float2 c, float2 w, float& pa,
                                            float& pb) {
  const float er = a.x + c.x, ei = a.y - c.y;
  const float dr = a.x - c.x, di = a.y + c.y;
  const float tr = fmaf(w.x, di, w.y * dr);     // W^k O
  const float ti = fmaf(w.y, di, -(w.x * dr));
  const float pr = er + tr, pi = ei + ti, nr = er - tr, ni = ei - ti;
  pa = fmaf(pr, pr, pi * pi);
  pb = fmaf(nr, nr, ni * ni);
}

// thread 0's self pair s: the (0, 8) pair j = s (s < 8), bins 256 + 512 s
// and its partner; the (0, 0) pair j = s - 7 (8 <= s < 16), bins 512 j and
// 8192 - 512 j; bin 0 (s = 16), its partner 8192 no bin
__host__ __device__ constexpr int k_self(int s) {
  return s < 8 ? 256 + 512 * s : (s < 16 ? 512 * (s - 7) : 0);
}

__global__ void __launch_bounds__(THREADS, 2)
k2_stft_pooled(const float* __restrict__ x, int64_t n, int64_t nw,
               const float* __restrict__ g2, const float2* __restrict__ tw,
               float* __restrict__ mid_db, float* __restrict__ side_db) {
  extern __shared__ float4 smem4[];
  __shared__ float4 self[SELF];                     // thread 0's self pairs (a, c)
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
    // the window's samples are loaded once its table entries are in: an
    // L1 hit issued after them would come back after them, and every
    // product waits for it (the offset is 0: each entry is at most 2)
    const int late = he.x + ho.x + me.x + mo.x > 8.0f;
    const float2* const lt = l + t + late;
    const float2* const rt = r + t + late;
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const float2 lv = ld_stream(lt + 256 * m), rv = ld_stream(rt + 256 * m);
      const float h0 = m < 16 ? hann4(he, m) : hann4(me, 31 - m);
      const float h1 = m < 16 ? hann4(ho, m) : hann4(mo, 31 - m);
      v[m] = make_float2(fmaf(sg, rv.x, lv.x) * h0, fmaf(sg, rv.y, lv.y) * h1);
    }
  }

  // pass 1: DFT over m, then the lane part W^(2 lane k1) of W8192^(t k1);
  // s1(t, k1) is t's slot of row k1 for even k1, t ^ 8 for odd
  dft<32>(v);
  {
    const float2* const f1 = opaque(tw + TW_P1 + lane);
#pragma unroll
    for (int k1 = 1; k1 < R; ++k1) v[k1] = cmul(v[k1], __ldg(f1 + 32 * k1));
  }
  {
    float2* const even = buf + t;
    float2* const odd = buf + (t ^ 8);
#pragma unroll
    for (int k1 = 0; k1 < R; ++k1) (k1 & 1 ? odd : even)[256 * k1] = v[k1];
  }
  __syncthreads();

  // pass 2: thread (k1, u0) takes units u = u0, u0 + 8: t' = u + 16 m2 at
  // s1(t', k1) = 256 k1 + (u ^ 8 (k1 & 1)) + 16 m2, times the warp part
  // W^(64 (t' >> 5) k1) = W^(64 (m2 >> 1) k1) of pass 1's twiddle; a DFT
  // over m2; W256^(u k2); unit u's value k2 to s2(k1, k2, u) = 512 k2 + 32
  // u + (k1 ^ 2 u0)
  float2 va[16], vb[16];
  {
    const int k1 = t >> 3, u0 = t & 7;
    const int sw = (k1 & 1) << 3;
    const float2* const ra = buf + 256 * k1 + (u0 ^ sw);
    const float2* const rb = buf + 256 * k1 + ((u0 + 8) ^ sw);
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      va[m] = ra[16 * m];
      vb[m] = rb[16 * m];
    }
    const float2* const fw = tw + TW_WARP + 8 * k1;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      const float2 f = __ldg(fw + j);
      va[2 * j] = cmul(va[2 * j], f);
      va[2 * j + 1] = cmul(va[2 * j + 1], f);
      vb[2 * j] = cmul(vb[2 * j], f);
      vb[2 * j + 1] = cmul(vb[2 * j + 1], f);
    }
    dft<16>(va);
    dft<16>(vb);
    const float2* const fa = tw + TW_P2 + u0;
#pragma unroll
    for (int k2 = 1; k2 < 16; ++k2) {
      va[k2] = cmul(va[k2], __ldg(fa + 16 * k2));
      vb[k2] = cmul(vb[k2], __ldg(fa + 16 * k2 + 8));
    }
    float2* const wa = buf + 32 * u0 + (k1 ^ (u0 << 1));   // unit u0 + 8 at + 256
    __syncthreads();
#pragma unroll
    for (int k2 = 0; k2 < 16; ++k2) {
      wa[512 * k2] = va[k2];
      wa[512 * k2 + 256] = vb[k2];
    }
  }
  __syncthreads();

  // pass 3: thread (k1, k2) holds group A = (k1, k2) and its partner group
  // B = (-k1 mod 32, 15 - k2), (0, 16 - k2) for k1 = 0; thread 0 holds (0,
  // 0) and (0, 8). s2's XOR, on byte offsets, leaves the shared-memory
  // window's base and 256 u to the loads' address operands
  const int k1 = lane, k2 = wp;
  const int b1 = (32 - k1) & 31;
  const int b2 = t == 0 ? 8 : 15 - k2 + (k1 == 0);
  {
    const char* const sb = reinterpret_cast<const char*>(buf);
    const int oa = 8 * (512 * k2 + k1), ob = 8 * (512 * b2 + b1);
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int sw = (u & 7) << 4;
      va[u] = *reinterpret_cast<const float2*>(sb + (oa ^ sw) + 256 * u);
      vb[u] = *reinterpret_cast<const float2*>(sb + (ob ^ sw) + 256 * u);
    }
  }
  dft<16>(va);
  dft<16>(vb);
  if (t == 0) {
#pragma unroll
    for (int s = 0; s < SELF; ++s) {
      const int j = s < 8 ? s : (s < 16 ? s - 7 : 0);
      const float2 a = s < 8 ? vb[j] : va[j];
      const float2 c = s < 8 ? vb[15 - j] : va[(16 - j) & 15];
      self[s] = make_float4(a.x, a.y, c.x, c.y);
    }
  }
  __syncthreads();

  // the split: pair j is (k, 8192 - k) for k = k1 + 32 k2 + 512 j, with a =
  // A[j], c = B[15 - j]; powers in bin order. Thread 0's groups are their
  // own partners: Z[512 j] pairs with Z[512 (16 - j)], Z[256 + 512 j] with
  // Z[256 + 512 (15 - j)], bin 4096 with itself. Its generic pairs write
  // its (0, 0) bins wrongly (and float 8192, past the powers); threads
  // 0-16 then write its 17 self pairs, one each
  float* pw = reinterpret_cast<float*>(buf);
  {
    const float2* const split = tw + TW_SPLIT;
    const int base = k1 + 32 * k2;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      split_pair(va[j], vb[15 - j], split + base, split - base, j, pw + base, pw + HALF - base);
  }
  __syncwarp();
  if (t < SELF) {
    const float4 ac = self[t];
    const int k = k_self(t);
    float pa, pb;
    split_power(make_float2(ac.x, ac.y), make_float2(ac.z, ac.w), __ldg(tw + TW_SELF + t), pa,
                pb);
    pw[k] = pa;
    pw[HALF - k] = pb;      // k = 4096: bin 4096 again; k = 0: float 8192
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
// below Nyquist, 16-byte aligned; tw: the 4,115 float2 table entries above;
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
