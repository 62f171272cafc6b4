// K1: fused K-weighting energy + true peak over the frames view.
//
// Replaces soundscope_tpu/ops/pallas_iir_chunked.py:kweight_energy_tp_chunked
// (kernel body _chunked_kernel_factory). The TPU kernel walks its grid in
// order and carries the filter state, the previous chunk and the running
// maxima in VMEM from one grid step to the next. CUDA blocks run in no
// order; K1 runs the tile-scan core of iir_tile.cuh instead, one launch
// that reads the input once:
//
//   k1_tile     a CTA per segment of T samples of a row (T = max(L, 8192),
//               a multiple of the step L = 128 * 2^k <= h, so at most one
//               100 ms boundary per step), its entry state chained from the
//               previous segment's CTA (look-back depth 0: its 64 rows at
//               the bench shape keep the card busy); each thread refilters its 32
//               samples from shared memory, sums z = w_ch * y^2 masked at
//               n_valid in float32 into (energy before the step's
//               boundary, energy from it on) and runs the polyphase FIR
//               over the same samples with the halo of KP-1 raw samples
//               before them; the steps' sums are added in a fixed order
//               in float64, the partial peaks per (row, segment) reduced by
//   peaks_pass  one warp per row: deterministic max, tp = max(tp, sp).
//
// Bound on the H100: operations. The function needs 104 float32
// operations per sample at 4x, an FMA counting two: the FIR's 36 FMAs (of
// its 52 taps, phase 0 is an impulse and the last tap of the others is
// zero: TileFir, iir_tile.cuh), the filter's 5 multiplies and 12 FMAs, and
// the energy.
// With the 4 FMAs of the matrix-form zero state and the peaks the kernel
// issues about 70 instructions per sample against one 4-byte read. The
// design spends nothing else per sample: the tile is read from
// shared memory in 16-byte chunks without bank conflicts, constants are
// kernel parameters (FMA operands from the constant bank, no registers),
// spans wholly valid and free of a boundary take a path without per-sample
// masks, and the chain's hop is one 4x4 product per segment. The previous
// design ran the filter sample by sample on one thread per (row, 4096
// samples), 352 CTAs of 128 threads at the bench shape, and read the
// input twice.

#include <cstring>

#include "iir_common.cuh"
#include "iir_tile.cuh"

namespace {

// Refilters the thread's 32 samples (tile row r) from s; sums z into left
// for samples before `cut` and into right for the others, each part a sum
// of its own samples (a part taken as the total less the other would lose a
// quiet part beside a loud one to cancellation); the FIR (F > 1, TileFir)
// over the samples with the halo from row r - 1. MASK: some sample is at or
// past n_valid, or the step's boundary cuts the span.
template <int F, int KP, bool MASK>
__device__ __forceinline__ void k1_span(const TileArgs& a, const float4* tile, int r,
                                        V4 s, int64_t g0, int64_t nv, float w, int cut,
                                        float& left, float& right, float& tp, float& sp) {
  const TileConsts& k = a.k;
  TileFir<F, KP> fir;
  fir.halo(tile, r);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float4 x4 = tile[tile_slot(r, c)];
    const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * c + i;
      const float x = xs[i];
      const float y = step_filter(k, s, x);
      const float z = w * (y * y);
      const bool valid = !MASK || g0 + j < nv;
      if (MASK) {
        left += (valid && j < cut) ? z : 0.f;
        right += (valid && j >= cut) ? z : 0.f;
        sp = fmax_nan(sp, valid ? fabsf(x) : 0.f);
      } else {
        right += z;
        sp = fmax_nan(sp, fabsf(x));
      }
      fir.push(a, x, valid, tp);
    }
  }
  // unmasked, the span lies wholly on one side of the boundary
  if (!MASK && cut >= TS) {
    left = right;
    right = 0.f;
  }
}

// CTAs of at most PMAX threads: 256 (T = 8192, the steps of 48 and 44.1
// kHz) with at least MINB of them resident per SM, or 512 (T = 16384)
constexpr int K1_MINB = 2;

template <int F, int KP, int PMAX>
__global__ void __launch_bounds__(PMAX, PMAX == 256 ? K1_MINB : 1)
k1_tile(const __grid_constant__ TileArgs a) {
  extern __shared__ float4 tiles[];
  __shared__ double red[TILE_MAX_WARPS][2];
  __shared__ float pk[TILE_MAX_WARPS][2];
  tile_loop<0>(a, tiles, F > 1, [](int64_t ar) { return ar; },
            [&](const TileScan& ts, const float4* tile) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, P = blockDim.x;
    const int64_t g0 = ts.start + (int64_t)TS * tid;
    const int64_t nv = __ldg(a.n_valid + ts.row / a.ch);
    const float w = a.weights[ts.row % a.ch];

    float left = 0.f, right = 0.f, tp = 0.f, sp = 0.f;
    if (g0 < a.n && g0 < nv) {
      const int64_t s0 = (g0 / a.L) * a.L;
      int64_t bound = ((s0 + a.h - 1) / a.h) * a.h;
      if (bound > s0 + a.L) bound = s0 + a.L;
      const int64_t c = bound - g0;
      const int cut = c <= 0 ? 0 : (c >= TS ? TS : (int)c);
      if (g0 + TS <= nv && (cut == 0 || cut == TS))
        k1_span<F, KP, false>(a, tile, tid + 1, ts.entry, g0, nv, w, cut, left, right, tp,
                              sp);
      else
        k1_span<F, KP, true>(a, tile, tid + 1, ts.entry, g0, nv, w, cut, left, right, tp, sp);
    }

    // step sums: float32 per thread, then float64 over the step's threads
    // in a fixed order (an xor butterfly within the warp, then warps in
    // order)
    const int per_step = (int)(a.L / TS);          // threads per step, >= 4
    const int gs = per_step < 32 ? per_step : 32;
    double dl = left, dr = right;
    for (int o = 1; o < gs; o *= 2) {
      dl += __shfl_xor_sync(0xffffffffu, dl, o);
      dr += __shfl_xor_sync(0xffffffffu, dr, o);
    }
    const int64_t step0 = ts.start / a.L;
    float* out = a.step_sums + ts.row * a.nsteps * 2;
    if (per_step <= 32) {
      const int64_t step = step0 + tid / per_step;
      if (lane % gs == 0 && step < a.nsteps) {
        out[2 * step] = (float)dl;
        out[2 * step + 1] = (float)dr;
      }
    } else if (lane == 0) {
      red[warp][0] = dl;
      red[warp][1] = dr;
    }
    warp_peaks(tp, sp, pk);
    __syncthreads();
    const int wps = per_step / 32;                 // warps per step, if > 0
    if (per_step > 32 && tid < P / per_step && step0 + tid < a.nsteps) {
      double sl = 0.0, sr = 0.0;
      for (int v = tid * wps; v < (tid + 1) * wps; ++v) {
        sl += red[v][0];
        sr += red[v][1];
      }
      out[2 * (step0 + tid)] = (float)sl;
      out[2 * (step0 + tid) + 1] = (float)sr;
    }
    cta_peaks(pk, a.tp_part + ts.row * a.nseg + ts.seg,
              a.sp_part + ts.row * a.nseg + ts.seg);
  });
}

template <int F, int KP, int PMAX>
cudaError_t launch_k1(const TileArgs& a, int P, int64_t ntickets, cudaStream_t st) {
  const size_t smem = tile_smem_bytes(P);
  int grid = 0;
  cudaError_t e = persistent_grid(k1_tile<F, KP, PMAX>, P, smem, ntickets, &grid);
  if (e != cudaSuccess) return e;
  k1_tile<F, KP, PMAX><<<grid, P, smem, st>>>(a);
  return cudaGetLastError();
}

template <int F, int KP>
cudaError_t launch_k1(const TileArgs& a, int P, int64_t ntickets, cudaStream_t st) {
  return P <= 256 ? launch_k1<F, KP, 256>(a, P, ntickets, st)
                  : launch_k1<F, KP, 512>(a, P, ntickets, st);
}

template <int F, int KP>
void attrs(int P, int* out) {
  if (P <= 256) kernel_attrs(k1_tile<F, KP, 256>, P, out);
  else kernel_attrs(k1_tile<F, KP, 512>, P, out);
}

}  // namespace

// consts: TileConsts as floats (host memory); taps F x KP (host); weights
// ch (host). sync: int32 (4 + 8 * rows * nseg), all bits set; tp_part,
// sp_part (rows, nseg). Returns the first CUDA error, 0 on success.
extern "C" int ss_kweight_energy_tp(
    const float* x, const int64_t* n_valid, const float* consts, const float* taps,
    const float* weights, int factor, int64_t rows, int ch, int64_t n, int64_t L,
    int64_t h, int64_t T, int* sync, float* step_sums, float* tp_part, float* sp_part,
    float* tp, float* sp, void* stream) {
  if (factor != 1 && factor != 2 && factor != 4) return (int)cudaErrorInvalidValue;
  if (L <= 0 || L % 128 != 0 || n % L != 0 || h < L || ch <= 0 || ch > TILE_MAX_CH ||
      T % L != 0 || T % 1024 != 0 || T > 32 * 32 * TILE_MAX_WARPS)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  TileArgs a;
  memcpy(&a.k, consts, sizeof(TileConsts));
  memset(a.taps, 0, sizeof(a.taps));
  const int KP = factor == 4 ? 13 : (factor == 2 ? 25 : 0);
  if (factor > 1) memcpy(a.taps, taps, sizeof(float) * factor * KP);
  for (int c = 0; c < ch; ++c) a.weights[c] = weights[c];
  a.x = x;
  a.n_valid = n_valid;
  a.sync = sync;
  a.n = n;
  a.nseg = (n + T - 1) / T;
  a.R = rows;
  a.ch = ch;
  a.na = ch;
  a.L = L;
  a.h = h;
  a.nsteps = n / L;
  a.step_sums = step_sums;
  a.tp_part = tp_part;
  a.sp_part = sp_part;
  a.zr = nullptr;
  a.group = 0;
  const int P = (int)(T / TS);
  const int64_t ntickets = rows * a.nseg;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (factor == 4) e = launch_k1<4, 13>(a, P, ntickets, st);
  else if (factor == 2) e = launch_k1<2, 25>(a, P, ntickets, st);
  else e = launch_k1<1, 1>(a, P, ntickets, st);
  if (e != cudaSuccess) return (int)e;
  peaks_pass<<<blocks_for(rows * 32), THREADS, 0, st>>>(rows, a.nseg, tp_part, sp_part,
                                                        tp, sp);
  return (int)cudaGetLastError();
}

// out[6]: registers, static smem, dynamic smem, local (spill) bytes per
// thread, threads, CTAs per SM of k1_tile at this factor and tile.
extern "C" int ss_kweight_energy_tp_attrs(int factor, int64_t T, int* out) {
  const int P = (int)(T / TS);
  if (factor == 4) attrs<4, 13>(P, out);
  else if (factor == 2) attrs<2, 25>(P, out);
  else attrs<1, 1>(P, out);
  return (int)cudaGetLastError();
}
