// The tile-scan core of the K-weighting kernels: K1 (iir_chunked.cu), K3,
// K4, K5 (iir_rows.cu) and the streaming filter K7 (block_iir.cu). Four
// bodies on one core's tile_loop: K1 sums steps and runs the FIR, K4 and
// K5 write group sums (one kernel, k5_tile, at two look-back depths), K7
// writes y and the row's end state from a carried state s0 (tile_loop's
// S0 mode, below). K3, which writes group sums and runs the FIR, and K5
// with one or two weighted channels take the core's tile, matrices and
// carry records in kernels of their own (iir_rows.cu, k3_tile_tracks and
// k5_tile_tracks: tickets of one track's segment of its channels in one
// tile, or K3's of one row's segment). The true peak K6
// (truepeak_stream.cu) walks the same tiles with no scan (tile_walk).
//
// Each runs the 4-state recurrence s <- A s + B x, y = C s + D x in the
// modal realisation (ops/biquad.py:modal_form; A is two 2x2 blocks, the
// wrapper checks it) over rows of N samples and sums z = w * y^2 masked at
// n_valid into fixed spans. One launch, one read of the input:
//
//   * A CTA of P = 32 W threads works on segments of T = 32 P samples of
//     one row at a time. It takes tickets from a global counter (ticket t
//     is active row t mod R, segment t / R), so every earlier ticket has
//     been handed to a running CTA and the waits below cannot deadlock.
//     It copies the segment, and the 32 samples before it (the FIR's
//     halo), from device memory into shared memory once with cp.async,
//     coalesced. The CTAs are persistent (as many as fit on the card) and
//     double-buffered: the copy of a CTA's next segment is in flight while
//     it works on the current one.
//   * Each thread owns a sub-span of S = 32 samples. Its zero-state end
//     state is the matrix form f = sum_k W[k] x_k, W[k] = A^(S-1-k) B: four
//     independent FMAs per sample, no dependent chain. Matrix forms from
//     float64 keep the carried state exact to float32 rounding; the
//     sample-by-sample float32 recurrence amplifies its rounding by about
//     1 / (1 - |lambda|) = 200 in the slow high-pass mode.
//   * A Kogge-Stone scan over the warp's lanes (A^(32 * 2^r), five rounds)
//     and a serial pass over the CTA's warps (A^1024) give, before the
//     carry is known, every thread's zero-state entry offset and the
//     segment's aggregate G (its zero-state end state).
//   * The entry state of the segment comes from a fixed look-back of depth
//     D, a constant of the kernel's instance: TILE_LOOKBACK = 32 or 0.
//     The CTA publishes G(t) before it waits for
//     anything, then takes, with every term of a segment before 0 zero,
//
//       s_in(t) = A^(T D) incl(t - (D+1) R) + sum_(j=1..D) A^(T (j-1)) G(t - j R)
//       incl(t) = A^T s_in(t) + G(t),
//
//     and publishes incl(t) for the CTA that looks back to it. A row's
//     chain of waits on inclusive states then hops D + 1 segments at a
//     time: N / (T (D+1)) hops instead of N / T. Lane j - 1 of warp 0
//     reads G(t - j R) (D <= 32) and forms its term in float32 from the
//     float64 powers A^(T 2^b) picked by the bits of j - 1; a fixed tree
//     over the lanes sums the terms, so every launch gives the same
//     bits (a look-back that stops wherever a prefix happens to be ready
//     would not). The state carried D segments back enters through
//     A^(T D), about e^(-20 D) at T = 4096 in the slow mode: the sum is
//     well conditioned. D = 0 is the plain chain, s_in(t) = incl(t - R)
//     (K1 and K5, whose many rows keep the card busy along short chains).
//     With a look-back the CTA takes its next ticket once its records are
//     out (tile_loop).
//   * S0 mode (K7): a row enters from the caller's state s0, not from zero.
//     s0 stands as the records of a segment -1, G(-1) = incl(-1) = s0: the
//     look-back's term for segment -1 is A^(T (j-1)) s0 where t - j R would
//     be segment -1, and A^(T D) s0 where t - (D+1) R would be. The copy
//     puts s0 into the tile's halo row (K7 reads no halo), so no wait
//     involves it. The input is read through its strides, 4 bytes a sample
//     (the meter's channels are strided views of interleaved audio), and a
//     launch whose rows are one segment each writes no records and takes
//     its tickets in grid-stride order, so it needs no record buffer.
//   * Each thread's entry state is A^(32 lane) (A^(1024 w) s_in + E_w) +
//     F_(lane-1), the lane power applied as a product of the scan's
//     matrices picked by the bits of the lane. It then refilters its 32
//     samples from shared memory and forms w * y^2 (K7 writes y itself;
//     K1 and K3 also run the polyphase FIR over the same samples and the
//     halo).
//
// The carry records are two float4s per ticket (G, then incl), set to the
// bit pattern 0xFFFFFFFF by the wrapper; a record is complete when none of
// its four words holds that pattern. st_carry never writes it: a word that
// would hold it (a NaN whose payload the input forged) is written as the
// card's canonical NaN 0x7FFFFFFF instead, so no input can hang a wait.
// Word 0 of the same int32 buffer is the ticket counter, so tickets count
// from -1 + 1 = 0; records start at word 4.
//
// Constants: TileConsts, built on the host in float64 and rounded to
// float32 (ops/iir_tile.py), is passed by value: the kernel parameters
// live in the constant bank, whence FMAs read them without registers, and
// the wrappers upload nothing.
//
// Peaks (K1, K3, K6) are maxima that propagate NaN (max.NaN), as the plain
// versions' torch max does: a NaN in the valid samples of a row is a NaN
// peak, not a peak of the other samples.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "iir_common.cuh"

namespace {

constexpr int TS = 32;                 // samples per thread (S)
constexpr int TILE_MAX_WARPS = 16;     // P <= 512, T <= 16384
constexpr int KS_ROUNDS = 5;           // log2 of the warp
constexpr int TILE_MAX_CH = 16;
constexpr int TILE_MAX_TAPS = 52;      // 4 x 13 or 2 x 25
constexpr int TILE_LOOKBACK = 32;      // D with a look-back: the lanes of warp 0
constexpr int LB_BITS = 6;             // look-back powers A^(T 2^b): D < 2^LB_BITS
constexpr int REC = 8;                 // record words per ticket: G, incl

// float layout of the host array (ops/iir_tile.py:tile_constants)
struct TileConsts {
  float A[16];                         // row-major; only the 2x2 blocks are read
  float B[4];
  float C[4];
  float D;
  float W[TS][4];                      // A^(S-1-k) B
  float KS[KS_ROUNDS][16];             // A^(S * 2^r)
  float AW[TILE_MAX_WARPS][16];        // A^(32 S w)
  float AT[16];                        // A^T
  float LB[LB_BITS][8];                // A^(T 2^b) as its two 2x2 blocks
};

struct TileArgs {
  TileConsts k;
  float taps[TILE_MAX_TAPS];           // K1, K3, K6: F phases x KP taps
  float weights[TILE_MAX_CH];          // per channel
  int chans[TILE_MAX_CH];              // K4, K5: the active (nonzero-weight) channels
  const float* x;
  const int64_t* n_valid;              // per track (K7: none)
  int* sync;                           // [0] ticket counter, records from [4]
  int64_t n;                           // samples per row
  int64_t nseg;                        // segments per row
  int64_t R;                           // active rows
  int ch;                              // channels per track
  int na;                              // active channels per track (K4, K5)
  // K1
  int64_t L, h, nsteps;
  float* step_sums;
  // K1, K3, K6: partial peaks per (row, segment)
  float* tp_part;
  float* sp_part;
  // K3, K4, K5: group sums per row
  float* zr;
  int64_t group;                       // K3: samples per group, g | 32
  // K7: x read at x + row * rs + i * cs, rows entering from s0 (rows, 4);
  // y (rows, n) and the end states s_out (rows, 4); AR = A^m, m the
  // samples of the row's last sub-span, as its two 2x2 blocks
  const float* s0;
  int64_t rs, cs;
  float* y;
  float* s_out;
  float AR[8];
};

// TileArgs travels by value as the kernel's parameter. CUDA 12.1 and later
// (12.8 and 12.9 included) allow 32,764 bytes of parameters on Volta and
// later; TileArgs stays within the classic 4,096 that every CUDA release
// accepts.
static_assert(sizeof(TileArgs) <= 32764, "TileArgs outgrows the kernel parameter space");
static_assert(sizeof(TileArgs) <= 4096, "TileArgs outgrows the classic 4 KB of parameters");

struct V4 {
  float v[4];
};

__device__ __forceinline__ V4 matvec(const float* __restrict__ M, const V4& s) {
  V4 r;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float acc = M[4 * i] * s.v[0];
#pragma unroll
    for (int j = 1; j < 4; ++j) acc = fmaf(M[4 * i + j], s.v[j], acc);
    r.v[i] = acc;
  }
  return r;
}

// M s with M the two 2x2 diagonal blocks m[0..3], m[4..7] (row-major)
__device__ __forceinline__ V4 matvec2(const float* __restrict__ m, const V4& s) {
  V4 r;
  r.v[0] = fmaf(m[1], s.v[1], m[0] * s.v[0]);
  r.v[1] = fmaf(m[3], s.v[1], m[2] * s.v[0]);
  r.v[2] = fmaf(m[5], s.v[3], m[4] * s.v[2]);
  r.v[3] = fmaf(m[7], s.v[3], m[6] * s.v[2]);
  return r;
}

__device__ __forceinline__ V4 add(const V4& a, const V4& b) {
  V4 r;
#pragma unroll
  for (int i = 0; i < 4; ++i) r.v[i] = a.v[i] + b.v[i];
  return r;
}

__device__ __forceinline__ V4 shfl_up(const V4& a, int d) {
  V4 r;
#pragma unroll
  for (int i = 0; i < 4; ++i) r.v[i] = __shfl_up_sync(0xffffffffu, a.v[i], d);
  return r;
}

__device__ __forceinline__ V4 shfl_down(const V4& a, int d) {
  V4 r;
#pragma unroll
  for (int i = 0; i < 4; ++i) r.v[i] = __shfl_down_sync(0xffffffffu, a.v[i], d);
  return r;
}

// Shared-memory tile: row r holds samples start - 32 + 32 r .. + 31 as 8
// float4 chunks, chunk c stored at r * 8 + (c ^ (r & 7)). A quarter-warp
// reading chunk c of 8 consecutive rows then touches 32 distinct banks.
__device__ __forceinline__ int tile_slot(int r, int c) { return r * 8 + (c ^ (r & 7)); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}

// Starts the copy of rows first_row .. P of a segment's tile (row 0 is
// the halo before the segment) as one cp.async group; samples outside
// [0, n) read as 0.
__device__ __forceinline__ void issue_tile(float4* tile, const float* __restrict__ xr,
                                           int64_t start, int64_t n, int P, int first_row) {
  const int nchunk = 8 * (P + 1);
  for (int q = 8 * first_row + threadIdx.x; q < nchunk; q += blockDim.x) {
    const int r = q >> 3, c = q & 7;
    const int64_t g = start - TS + (int64_t)TS * r + 4 * c;
    const bool in = g >= 0 && g < n;       // n % 32 == 0: chunks are whole
    cp_async16(tile + tile_slot(r, c), in ? xr + g : xr, in ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// issue_tile for CTAs of a fixed P (K6): thread i copies chunk i mod 8 of
// rows i / 8 + k P / 8, so every swizzled slot and sample offset is a
// constant step from its first, and a tile wholly inside [0, n) is copied
// without bounds checks.
template <int P>
__device__ __forceinline__ void issue_tile_fixed(float4* tile, const float* __restrict__ xr,
                                                 int64_t start, int64_t n) {
  static_assert(P % 64 == 0, "rows i / 8 + k P / 8 keep their swizzle");
  const int c = threadIdx.x & 7, r0 = threadIdx.x >> 3;
  const bool whole = start >= TS && start + TS * P <= n;
#pragma unroll
  for (int k = 0; k <= 8; ++k) {
    if (k == 8 && threadIdx.x >= 8) break;         // row P: threads 0 .. 7
    const int r = r0 + k * (P / 8);
    const int64_t g = start - TS + (int64_t)TS * r + 4 * c;
    const bool in = whole || (g >= 0 && g < n);
    cp_async16(tile + tile_slot(r, c), in ? xr + g : xr, in ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// S0 mode (K7): starts the copy of rows 1 .. P of a segment through the
// input's strides, one sample a cp.async, samples past n read as 0 (lanes
// take consecutive samples), and, for a segment that looks back to the
// row's start, the row's s0 into chunk 0 of row 0.
__device__ __forceinline__ void issue_strided(float4* tile, const TileArgs& a, int64_t row,
                                              int64_t start, int P, bool with_s0) {
  float* t = reinterpret_cast<float*>(tile);
  const float* xr = a.x + row * a.rs;
  for (int q = threadIdx.x; q < TS * P; q += blockDim.x) {
    const int64_t g = start + q;
    const bool in = g < a.n;
    cp_async4(t + 4 * tile_slot((q >> 5) + 1, (q >> 2) & 7) + (q & 3), in ? xr + g * a.cs : xr,
              in ? 4 : 0);
  }
  if (with_s0 && threadIdx.x < 4)
    cp_async4(t + 4 * tile_slot(0, 0) + threadIdx.x, a.s0 + 4 * row + threadIdx.x, 4);
  asm volatile("cp.async.commit_group;\n" ::);
}

// The CTA's ticket after t (t = blockIdx.x - gridDim.x for its first): the
// counter's next, or in S0 mode without a record buffer (every row one
// segment) the grid-stride order.
template <bool S0>
__device__ __forceinline__ int64_t next_ticket(const TileArgs& a, int64_t t) {
  if (S0 && a.sync == nullptr) return t + gridDim.x;
  return (int64_t)atomicAdd(a.sync, 1) + 1;
}

__device__ __forceinline__ V4 ld_carry(const int* p) {
  V4 r;
  asm volatile("ld.volatile.global.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(r.v[0]), "=f"(r.v[1]), "=f"(r.v[2]), "=f"(r.v[3])
               : "l"(p));
  return r;
}

// the word, or the canonical NaN where the word is the record sentinel
__device__ __forceinline__ float no_sentinel(float v) {
  return __float_as_int(v) == -1 ? __int_as_float(0x7fffffff) : v;
}

__device__ __forceinline__ void st_carry(int* p, const V4& s) {
  asm volatile("st.volatile.global.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "f"(no_sentinel(s.v[0])), "f"(no_sentinel(s.v[1])),
               "f"(no_sentinel(s.v[2])), "f"(no_sentinel(s.v[3]))
               : "memory");
}

__device__ __forceinline__ bool carry_ready(const V4& s) {
  bool ok = true;
#pragma unroll
  for (int i = 0; i < 4; ++i) ok &= __float_as_int(s.v[i]) != -1;
  return ok;
}

__device__ __forceinline__ V4 wait_carry(const int* p, V4 s) {
  while (!carry_ready(s)) {
    __nanosleep(20);
    s = ld_carry(p);
  }
  return s;
}

// What the scan gives each thread of the CTA.
struct TileScan {
  int64_t ticket, row, seg, start;
  V4 entry;                            // the state before the thread's first sample
  bool skip;                           // the segment starts at or past n_valid
};

// S0 mode: the row's s0, in chunk 0 of the tile's row 0
__device__ __forceinline__ V4 tile_s0(const float4* tile) {
  const float4 q = tile[tile_slot(0, 0)];
  return V4{{q.x, q.y, q.z, q.w}};
}

// A^(T m) v for 0 <= m < 2^LB_BITS: the look-back powers picked by the
// bits of m, lowest first
__device__ __forceinline__ V4 lb_power(const TileConsts& k, int m, V4 v) {
#pragma unroll
  for (int b = 0; b < LB_BITS; ++b)
    if ((m >> b) & 1) v = matvec2(k.LB[b], v);
  return v;
}

// The scan and look-back of the module comment, up to each thread's entry
// state, over a tile already in shared memory. Every thread of the CTA
// calls it. D: the look-back depth, 0 or TILE_LOOKBACK. S0: the row enters
// from the s0 in the tile's row 0. next_sh (D > 0): where thread 0 puts
// the CTA's next ticket, taken once this one's records are out.
template <int D, bool S0 = false>
__device__ __forceinline__ V4 tile_scan(const TileArgs& a, const float4* tile,
                                        int64_t ticket, int64_t seg, int64_t* next_sh) {
  static_assert(D >= 0 && D <= TILE_LOOKBACK, "the look-back runs on the lanes of warp 0");
  __shared__ V4 warp_sh[TILE_MAX_WARPS];
  __shared__ V4 s_in_sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = blockDim.x;
  const TileConsts& k = a.k;
  int* const rec = a.sync + 4;

  // the records that enter, read early: they are usually complete. Lane
  // j - 1 of warp 0 takes G(t - j R), lane 0 also incl(t - (D+1) R).
  const bool has_incl = seg > D;
  const int* src = rec + REC * (ticket - (int64_t)(D + 1) * a.R) + 4;
  V4 incl = {{0.f, 0.f, 0.f, 0.f}};
  if (tid == 0 && has_incl) incl = ld_carry(src);
  const int j = lane + 1;
  const bool has_g = warp == 0 && j <= D && seg >= j;
  const int* gsrc = rec + REC * (ticket - (int64_t)j * a.R);
  V4 g = {{0.f, 0.f, 0.f, 0.f}};
  if (has_g) g = ld_carry(gsrc);

  // zero-state end state of the thread's sub-span, in matrix form
  const int r = tid + 1;
  V4 f = {{0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float4 x4 = tile[tile_slot(r, c)];
    const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int m = 0; m < 4; ++m) f.v[m] = fmaf(k.W[4 * c + i][m], xs[i], f.v[m]);
  }
  // inclusive Kogge-Stone over the warp: F_l = sum_(m <= l) A^(S (l - m)) f_m
#pragma unroll
  for (int q = 0; q < KS_ROUNDS; ++q) {
    const V4 o = shfl_up(f, 1 << q);
    if (lane >= (1 << q)) f = add(matvec(k.KS[q], o), f);
  }
  V4 fex = shfl_up(f, 1);
  if (lane == 0) fex = V4{{0.f, 0.f, 0.f, 0.f}};
  if (lane == 31) warp_sh[warp] = f;
  __syncthreads();

  if (warp == 0) {
    // exclusive prefix over the warps in order, then the segment aggregate
    // G, published before any wait
    V4 e = {{0.f, 0.f, 0.f, 0.f}};
    if (lane == 0) {
      for (int w = 0; w < P / 32; ++w) {
        const V4 t = warp_sh[w];
        warp_sh[w] = e;
        e = add(matvec(k.AW[1], e), t);
      }
      if (D > 0 && seg + 1 < a.nseg) st_carry(rec + REC * ticket, e);
    }
    // lane j - 1 forms A^(T (j-1)) G(t - j R); a fixed tree sums the lanes
    V4 s_in = {{0.f, 0.f, 0.f, 0.f}};
    if (D > 0) {
      if (has_g) s_in = lb_power(k, j - 1, wait_carry(gsrc, g));
      else if (S0 && j <= D && seg == j - 1) s_in = lb_power(k, j - 1, tile_s0(tile));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s_in = add(s_in, shfl_down(s_in, o));
    }
    if (lane == 0) {
      if (has_incl) {
        incl = wait_carry(src, incl);
        s_in = D > 0 ? add(lb_power(k, D, incl), s_in) : incl;
      } else if (S0 && seg == D) {
        s_in = D > 0 ? add(lb_power(k, D, tile_s0(tile)), s_in) : tile_s0(tile);
      }
      if (seg + D + 1 < a.nseg) st_carry(rec + REC * ticket + 4, add(matvec(k.AT, s_in), e));
      if (D > 0) *next_sh = next_ticket<S0>(a, ticket);
      s_in_sh = s_in;
    }
  }
  __syncthreads();

  V4 v = add(matvec(k.AW[warp], s_in_sh), warp_sh[warp]);
#pragma unroll
  for (int q = 0; q < KS_ROUNDS; ++q)
    if ((lane >> q) & 1) v = matvec(k.KS[q], v);
  return add(v, fex);
}

// A persistent CTA's walk over the segments. Each CTA works on one ticket
// while the copy of its next ticket's segment into the other tile buffer is
// in flight. On the plain chain (D = 0, many rows) it takes the next ticket
// as it starts on the current one, so the copy overlaps the whole segment's
// work. With a look-back (D > 0, a few long rows) it takes the next ticket
// once the current one's records are out, and the copy overlaps the
// refilter: a ticket then waits in a CTA's hands for a refilter, not a
// whole segment, and the segments a CTA looks back to have been started in
// ticket order, close together. With a look-back, a segment that starts at
// or past its track's n_valid (a padded bucket's tail) is neither copied
// nor scanned: nothing valid follows it in its row, so no record of it is
// read, and its body writes zeros (ts.skip). (In both, the smallest
// ticket whose records are not out is one a CTA is working on, and every
// record it reads belongs to a smaller ticket, so the waits cannot
// deadlock.) body(ts, tile) runs once per segment with the tile in shared
// memory; tiles holds two buffers of 8 * (P + 1) float4. row_of maps an
// active-row index to a row. S0 (K7, with D > 0): rows enter from a.s0,
// the input is read through its strides (issue_strided), every segment is
// filtered (no n_valid).
template <int D, bool S0 = false, class RowOf, class Body>
__device__ __forceinline__ void tile_loop(const TileArgs& a, float4* tiles, bool halo,
                                          RowOf row_of, Body body) {
  __shared__ int64_t ticket_sh[2];
  const int P = blockDim.x;
  const int64_t ntickets = a.R * a.nseg;
  const int64_t T = (int64_t)TS * P;
  constexpr bool late = D > 0;
  static_assert(!S0 || late, "S0 mode runs with a look-back");
  auto buf = [&](int b) { return tiles + b * 8 * (P + 1); };
  auto skipped = [&](int64_t t) {
    const int64_t seg = t / a.R;
    return !S0 && late && seg * T >= __ldg(a.n_valid + row_of(t - seg * a.R) / a.ch);
  };
  auto start_copy = [&](int64_t t, float4* dst) {
    const int64_t seg = t / a.R;
    const int64_t row = row_of(t - seg * a.R);
    if (S0) issue_strided(dst, a, row, seg * T, P, seg <= D);
    else if (!skipped(t)) issue_tile(dst, a.x + row * a.n, seg * T, a.n, P, halo ? 0 : 1);
    else asm volatile("cp.async.commit_group;\n" ::);
  };
  if (threadIdx.x == 0) ticket_sh[0] = next_ticket<S0>(a, (int64_t)blockIdx.x - gridDim.x);
  __syncthreads();
  int64_t t = ticket_sh[0];
  if (t >= ntickets) return;
  start_copy(t, buf(0));
  for (int b = 0;; b ^= 1) {
    int64_t next = ntickets;
    if (!late) {
      if (threadIdx.x == 0) ticket_sh[b ^ 1] = (int64_t)atomicAdd(a.sync, 1) + 1;
      __syncthreads();
      next = ticket_sh[b ^ 1];
      if (next < ntickets) {
        start_copy(next, buf(b ^ 1));
        asm volatile("cp.async.wait_group 1;\n" ::);
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::);
      }
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    TileScan ts;
    ts.ticket = t;
    ts.seg = t / a.R;
    ts.row = row_of(t - ts.seg * a.R);
    ts.start = ts.seg * T;
    ts.skip = skipped(t);
    if (!ts.skip) {
      ts.entry = tile_scan<D, S0>(a, buf(b), t, ts.seg, &ticket_sh[b ^ 1]);
    } else {
      if (threadIdx.x == 0) ticket_sh[b ^ 1] = (int64_t)atomicAdd(a.sync, 1) + 1;
      __syncthreads();
    }
    if (late) {
      next = ticket_sh[b ^ 1];
      if (next < ntickets) start_copy(next, buf(b ^ 1));
    }
    body(ts, buf(b));
    __syncthreads();                     // the buffer is refilled next turn
    if (next >= ntickets) return;
    t = next;
  }
}

// K6's walk over independent tickets: no scan, no records. Ticket t is row
// t / nseg, segment t mod nseg; CTA i takes the contiguous run of
// ceil(tickets / grid) tickets from i ceil(tickets / grid), so no counter
// is needed and each CTA streams consecutive segments of a few rows. The
// copy of the CTA's next segment, with its halo row, is in flight while it
// works on the current one. A segment that starts at or past its track's
// n_valid (track row / a.ch) is not copied. body(row, seg, skip, last,
// tile) runs once per ticket with the tile in shared memory; last: the
// CTA's next ticket is in another row, or it has none. tiles holds two
// buffers of 8 * (P + 1) float4. P: the CTA's threads.
template <int P, class Body>
__device__ __forceinline__ void tile_walk(const TileArgs& a, float4* tiles, Body body) {
  const int64_t ntickets = a.R * a.nseg;
  const int64_t T = (int64_t)TS * P;
  const int64_t per = (ntickets + gridDim.x - 1) / gridDim.x;
  const int64_t t0 = blockIdx.x * per;
  const int64_t tend = t0 + per < ntickets ? t0 + per : ntickets;
  auto buf = [&](int64_t k) { return tiles + (int)(k & 1) * 8 * (P + 1); };
  auto skipped = [&](int64_t row, int64_t seg) {
    return seg * T >= __ldg(a.n_valid + row / a.ch);
  };
  // one cp.async group per ticket, empty past the run's end
  auto start_copy = [&](int64_t t, float4* dst) {
    const int64_t row = t / a.nseg, seg = t - row * a.nseg;
    if (t < tend && !skipped(row, seg))
      issue_tile_fixed<P>(dst, a.x + row * a.n, seg * T, a.n);
    else
      asm volatile("cp.async.commit_group;\n" ::);
  };
  if (t0 >= tend) return;
  start_copy(t0, buf(0));
  for (int64_t k = 0;; ++k) {
    const int64_t t = t0 + k;
    start_copy(t + 1, buf(k + 1));
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    const int64_t row = t / a.nseg, seg = t - row * a.nseg;
    body(row, seg, skipped(row, seg), t + 1 >= tend || seg + 1 == a.nseg, buf(k));
    if (t + 1 >= tend) return;
    __syncthreads();                     // the buffer is refilled next turn
  }
}

inline size_t tile_smem_bytes(int P) { return 2 * sizeof(float4) * 8 * (P + 1); }

// As many CTAs as fit on the card at once, at most one per ticket. The
// first call for a (kernel, device, P, smem) on a host thread sets the
// kernel's dynamic shared memory and asks the occupancy calculator; later
// calls reuse the answer (those queries cost microseconds of host time,
// and K7 launches once per meter push).
template <class K>
cudaError_t persistent_grid(K kernel, int P, size_t smem, int64_t ntickets, int* grid) {
  struct Seen {
    const void* fn;
    int dev, P;
    size_t smem;
    int64_t most;
  };
  thread_local Seen seen[8];
  thread_local int nseen = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const void* fn = reinterpret_cast<const void*>(kernel);
  int64_t most = 0;
  for (int i = 0; i < nseen; ++i)
    if (seen[i].fn == fn && seen[i].dev == dev && seen[i].P == P && seen[i].smem == smem)
      most = seen[i].most;
  if (most == 0) {
    int sms = 0, per_sm = 0;
    if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
      return e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return e;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, P, smem)) !=
        cudaSuccess)
      return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    most = (int64_t)per_sm * sms;
    if (nseen < 8) seen[nseen++] = Seen{fn, dev, P, smem, most};
  }
  *grid = (int)(ntickets < most ? ntickets : most);
  return cudaSuccess;
}

// out[6]: registers, static smem, dynamic smem, local (spill) bytes per
// thread, threads, CTAs per SM, for P threads a CTA and `smem` bytes of
// dynamic shared memory (the core's two tiles unless given)
template <class K>
void kernel_attrs(K kernel, int P, int* out, size_t smem = 0) {
  cudaFuncAttributes fa;
  if (cudaFuncGetAttributes(&fa, kernel) != cudaSuccess) return;
  if (smem == 0) smem = tile_smem_bytes(P);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, P, smem);
  out[0] = fa.numRegs;
  out[1] = (int)fa.sharedSizeBytes;
  out[2] = (int)smem;
  out[3] = (int)fa.localSizeBytes;
  out[4] = P;
  out[5] = per_sm;
}

// y = C s + D x, then s <- A s + B x with A as its two 2x2 blocks
__device__ __forceinline__ float step_filter(const TileConsts& k, V4& s, float x) {
  float y = k.D * x;
#pragma unroll
  for (int i = 0; i < 4; ++i) y = fmaf(k.C[i], s.v[i], y);
  const float t0 = fmaf(k.A[0], s.v[0], fmaf(k.A[1], s.v[1], k.B[0] * x));
  const float t1 = fmaf(k.A[4], s.v[0], fmaf(k.A[5], s.v[1], k.B[1] * x));
  const float t2 = fmaf(k.A[10], s.v[2], fmaf(k.A[11], s.v[3], k.B[2] * x));
  const float t3 = fmaf(k.A[14], s.v[2], fmaf(k.A[15], s.v[3], k.B[3] * x));
  s.v[0] = t0;
  s.v[1] = t1;
  s.v[2] = t2;
  s.v[3] = t3;
  return y;
}

// The masked polyphase FIR of K1, K3 and K6 over a thread's 32 samples (tile
// row r), phases 1 .. F-1 over taps 0 .. KP-2. Phase 0 of the BS.1770
// interpolator is a unit impulse (its other taps are under 4e-17), so its
// outputs are input samples, which the sample peak already takes (tp =
// max(tp, sp), within 1e-16 of the full sum); the last tap of the other
// phases is zero. The wrappers check both on the taps they pass.
// hist[t] = x at (g - t) once sample g is in; before the first sample it
// holds x at (g0 - 1 - t), the last KH - 1 samples of row r - 1. The
// history holds raw samples: an output at a valid position reads only
// valid ones, and outputs at positions >= n_valid do not count.
template <int F, int KP>
struct TileFir {
  static constexpr int KH = KP > 1 ? KP - 1 : 1;   // taps read per phase
  float hist[KH];

  __device__ __forceinline__ void halo(const float4* tile, int r) {
    if (F == 1) return;
    constexpr int c0 = (TS - (KH - 1)) / 4;
#pragma unroll
    for (int c = c0; c < 8; ++c) {
      const float4 h4 = tile[tile_slot(r - 1, c)];
      const float hs[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (TS - 1 - (4 * c + i) < KH - 1) hist[TS - 1 - (4 * c + i)] = hs[i];
    }
  }

  // push sample x; its outputs raise tp where valid (taps: a.taps)
  __device__ __forceinline__ void push(const TileArgs& a, float x, bool valid, float& tp) {
    if (F == 1) return;
#pragma unroll
    for (int t = KH - 1; t > 0; --t) hist[t] = hist[t - 1];
    hist[0] = x;
#pragma unroll
    for (int p = 1; p < F; ++p) {
      float acc = 0.f;
#pragma unroll
      for (int t = KH - 1; t >= 0; --t) acc = fmaf(a.taps[p * KP + t], hist[t], acc);
      tp = fmax_nan(tp, valid ? fabsf(acc) : 0.f);
    }
  }
};

// The CTA's partial peaks (K1, K3, K6): each warp's maxima into pk (before a
// __syncthreads), then thread 0 writes the CTA's (after it).
__device__ __forceinline__ void warp_peaks(float tp, float sp, float (*pk)[2]) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) {
    tp = fmax_nan(tp, __shfl_xor_sync(0xffffffffu, tp, o));
    sp = fmax_nan(sp, __shfl_xor_sync(0xffffffffu, sp, o));
  }
  if ((threadIdx.x & 31) == 0) {
    pk[threadIdx.x >> 5][0] = tp;
    pk[threadIdx.x >> 5][1] = sp;
  }
}

__device__ __forceinline__ void cta_peaks(float (*pk)[2], float* tp_out,
                                          float* sp_out) {
  if (threadIdx.x != 0) return;
  float a0 = 0.f, a1 = 0.f;
  for (int v = 0; v < (int)blockDim.x / 32; ++v) {
    a0 = fmax_nan(a0, pk[v][0]);
    a1 = fmax_nan(a1, pk[v][1]);
  }
  *tp_out = a0;
  *sp_out = a1;
}

}  // namespace
