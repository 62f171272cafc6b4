// K6: BS.1770 true peak and sample peak over (rows, N), masked at each
// row's n_valid.
//
// Replaces soundscope_tpu/ops/pallas_truepeak.py:true_peak_pallas
// (pallas_call :166, kernel _make_kernel). The TPU kernel walks each row
// tile's blocks in order, carrying the FIR context (the previous block) and
// running maxima in VMEM, with blocks of 128-512 samples and row tiles of
// up to 256 sized for VMEM; those picks are VMEM policy and are not
// ported. Here every (row, segment of T = 8,192 samples) is an independent
// ticket of the tile-scan core's persistent, double-buffered copy
// (tile_walk, iir_tile.cuh), with no scan and no records:
//
//   k6_tile     a CTA of 256 threads takes a contiguous run of tickets, so
//               it streams consecutive segments of a few rows; it copies
//               each segment and the 32 samples before it (the FIR's halo)
//               into shared memory with cp.async, coalesced, while it works
//               on the previous one (issue_tile_fixed: constant offsets, no
//               bounds checks inside [0, n)); each thread runs the masked
//               polyphase FIR of K1 and K3 (TileFir) over its 32 samples
//               and takes their sample peak, masked at n_valid, carrying
//               both maxima over the run's segments of a row; the CTA
//               reduces them once per run into one partial peak (0 for the
//               run's other segments). A segment that starts past n_valid
//               (a padded bucket's tail) is not copied.
//   peaks_pass  one warp per row: deterministic max, tp = max(tp, sp)
//               (iir_common.cuh).
//
// No float atomics: every launch gives the same bits, and the sample peak
// is exact. Maxima propagate NaN, as the plain version's torch max does.
// Factor 1 (>= 192 kHz) launches nothing (the wrapper takes a masked max,
// as the reference does).
//
// Bound on the H100: bytes, one read of the input (1.72 ms at the library
// scan's 5.76 GB). The function needs 36 FMAs per sample at 4x (24 at 2x):
// phase 0 is a unit impulse, whose outputs the sample peak covers, and the
// other phases' last tap is zero (TileFir skips both; the wrapper checks
// the taps). With the peaks, the kernel issues about 41 instructions a
// sample at 4x, which at the card's issue rate take about as long as the
// reads: the two bounds are close, the FIR alone takes longer than the
// reads alone, and under both the card reaches its power limit. So the
// design spends nothing else per sample (16-byte conflict-free
// shared-memory reads, taps as kernel parameters, a mask-free path for
// spans wholly valid) and little per segment (the copy's fixed offsets,
// one reduction per run). The previous design ran one thread per (row,
// span of 3,200 samples), whose lanes read 12.8 KB apart, and all 52 taps.

#include <cstring>

#include "iir_common.cuh"
#include "iir_tile.cuh"

namespace {

constexpr int K6_THREADS = 256;        // T = 8192
constexpr int K6_MINB = 3;             // 3 x 65,792 bytes of tiles per SM

// The FIR and the sample peak over the thread's 32 samples (tile row r);
// MASK: some sample is at or past n_valid.
template <int F, int KP, bool MASK>
__device__ __forceinline__ void k6_span(const TileArgs& a, const float4* tile, int r,
                                        int64_t g0, int64_t nv, float& tp, float& sp) {
  TileFir<F, KP> fir;
  fir.halo(tile, r);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float4 x4 = tile[tile_slot(r, c)];
    const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool valid = !MASK || g0 + 4 * c + i < nv;
      sp = fmax_nan(sp, valid ? fabsf(xs[i]) : 0.f);
      fir.push(a, xs[i], valid, tp);
    }
  }
}

// Each thread carries its maxima over the CTA's consecutive segments of a
// row; the CTA reduces them once per run, into the partial of the run's
// last segment, and writes 0 for the run's other segments, so peaks_pass
// reads every (row, segment) once.
template <int F, int KP>
__global__ void __launch_bounds__(K6_THREADS, K6_MINB)
k6_tile(const __grid_constant__ TileArgs a) {
  extern __shared__ float4 tiles[];
  __shared__ float pk[TILE_MAX_WARPS][2];
  float tp = 0.f, sp = 0.f;
  tile_walk<K6_THREADS>(a, tiles, [&](int64_t row, int64_t seg, bool skip, bool last,
                                      const float4* tile) {
    if (!skip) {
      const int64_t g0 = (seg * K6_THREADS + threadIdx.x) * TS;
      int64_t nv = __ldg(a.n_valid + row / a.ch);
      if (nv > a.n) nv = a.n;
      if (g0 + TS <= nv) k6_span<F, KP, false>(a, tile, threadIdx.x + 1, g0, nv, tp, sp);
      else if (g0 < nv) k6_span<F, KP, true>(a, tile, threadIdx.x + 1, g0, nv, tp, sp);
    }
    float* tp_out = a.tp_part + row * a.nseg + seg;
    float* sp_out = a.sp_part + row * a.nseg + seg;
    if (!last) {
      if (threadIdx.x == 0) *tp_out = *sp_out = 0.f;
      return;
    }
    warp_peaks(tp, sp, pk);
    __syncthreads();
    cta_peaks(pk, tp_out, sp_out);
    tp = sp = 0.f;
  });
}

template <int F, int KP>
cudaError_t launch_k6(const TileArgs& a, cudaStream_t st) {
  const size_t smem = tile_smem_bytes(K6_THREADS);
  int grid = 0;
  cudaError_t e = persistent_grid(k6_tile<F, KP>, K6_THREADS, smem, a.R * a.nseg, &grid);
  if (e != cudaSuccess) return e;
  k6_tile<F, KP><<<grid, K6_THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x (rows, n) contiguous, 16-byte aligned, n % 32 == 0; n_valid: one
// length per `per` consecutive rows (a track's channels); taps F x KP
// (host memory). tp_part, sp_part (rows, nseg) scratch, nseg = ceil(n /
// 8192); tp, sp (rows) are written whole. Returns the first CUDA error, 0
// on success.
extern "C" int ss_true_peak_stream(const float* x, const int64_t* n_valid, int64_t per,
                                   const float* taps, int factor, int64_t rows, int64_t n,
                                   float* tp_part, float* sp_part, float* tp, float* sp,
                                   void* stream) {
  if (factor != 2 && factor != 4) return (int)cudaErrorInvalidValue;
  if (n <= 0 || n % TS != 0 || per <= 0 || rows % per != 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  TileArgs a;
  memset(&a, 0, sizeof(a));
  const int KP = factor == 4 ? 13 : 25;
  memcpy(a.taps, taps, sizeof(float) * factor * KP);
  a.x = x;
  a.n_valid = n_valid;
  a.ch = (int)per;
  a.n = n;
  a.nseg = (n + TS * K6_THREADS - 1) / (TS * K6_THREADS);   // the wrapper's TILE
  a.R = rows;
  a.tp_part = tp_part;
  a.sp_part = sp_part;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = factor == 4 ? launch_k6<4, 13>(a, st) : launch_k6<2, 25>(a, st);
  if (e != cudaSuccess) return (int)e;
  peaks_pass<<<blocks_for(rows * 32), THREADS, 0, st>>>(rows, a.nseg, tp_part, sp_part, tp,
                                                        sp);
  return (int)cudaGetLastError();
}

// out[6]: registers, static smem, dynamic smem, local (spill) bytes per
// thread, threads, CTAs per SM of k6_tile at this factor.
extern "C" int ss_true_peak_stream_attrs(int factor, int* out) {
  if (factor == 4) kernel_attrs(k6_tile<4, 13>, K6_THREADS, out);
  else kernel_attrs(k6_tile<2, 25>, K6_THREADS, out);
  return (int)cudaGetLastError();
}
