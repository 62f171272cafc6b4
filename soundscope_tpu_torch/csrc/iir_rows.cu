// K3, K4, K5: K-weighted, masked, channel-weighted energy over the rows
// layout (b*ch, N) (channel-minor; a 3D (b, ch, N) tensor is the same
// memory), pre-summed over groups of g samples into z (b, N/g); K3 adds the
// BS.1770 true peak and sample peak per row.
//
// Replaces, in soundscope_tpu/ops/pallas_iir.py,
//   K3 kweight_energy_tp_pallas_prefix  (pallas_call :577)
//   K4 kweight_energy_pallas_prefix     (pallas_call :500)
//   K5 kweight_energy_pallas            (pallas_call :308)
// The TPU kernels walk the grid in order and carry the state in VMEM: K5 one
// block at a time, K3/K4 several blocks a step through strict-block-lower
// matrices of A_B powers. Neither schedule carries over: CUDA blocks run in
// no order, and the matrices exist for the TPU's matrix unit.
//
// K3/K4 ("split-time", ss_kweight_energy_rows): K1's passes over steps of
// L samples (iir_common.cuh), with a correction pass of its own: one thread
// per (track, step) walks the track's channels in order, refilters each
// from its s_entry, and adds its group sums of w_c * y^2 (masked at
// n_valid, float64 within a group) into z, which the wrapper zeroes. The
// thread owns its z span, so the channel sum needs no atomics and has one
// order: z = (0 + group_c0) + group_c1 + ... . Channels of weight 0 add
// nothing (K4 does not even filter them); K3 still takes their peaks.
//
// K5 ("chain", ss_kweight_energy_chain): the tile-scan core of
// iir_tile.cuh over the rows of nonzero weight (k5_tile), one launch that
// reads the input once: a CTA per segment of T = 4096 samples of a row,
// chained to the previous segment's CTA by its inclusive end state, each
// thread refiltering 32 samples from shared memory and writing its group
// sums (g | 32) to zr (b*ch, N/g); a second pass adds the channels in
// order into z. The previous K5 carried the state sample by sample on one
// thread per row: 2,000 threads, 16 of the 132 SMs, for the library scan.
//
// Bound on the H100: device-memory reads of the input (K3/K4 read it
// twice, K5 once). K3/K4 stream each thread's own contiguous span
// (stream_samples keeps the next 128 bytes in flight); K5 copies its tiles
// with cp.async, and its per-sample work (4 FMAs of zero state, 17 of
// refilter, 3 of energy) stays under the bytes' time.

#include <cstring>

#include "iir_common.cuh"
#include "iir_tile.cuh"

namespace {

// F = 0: energy only (K4); F = 2, 4: energy + peaks with F phases (K3)
template <int F, int KP>
__global__ void __launch_bounds__(THREADS)
rows_correct(const float* __restrict__ x, const int64_t* __restrict__ n_valid,
             const float* __restrict__ coef, const float* __restrict__ weights,
             const float* __restrict__ taps, int64_t b, int ch, int64_t n,
             int64_t nsteps, int64_t L, int64_t g,
             const float* __restrict__ s_entry, float* __restrict__ z,
             float* __restrict__ tp_part, float* __restrict__ sp_part) {
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= b * nsteps) return;
  const int64_t track = t / nsteps;
  const int64_t j = t - track * nsteps;
  const int64_t nv = __ldg(n_valid + track);
  const int64_t start = j * L;
  Filter f;
  load_filter(coef, f);
  Fir<(F > 1 ? F : 1), (F > 1 ? KP : 1)> fir;
  if (F > 1) fir.load(taps);
  float* zt = z + track * (n / g) + start / g;

  for (int c = 0; c < ch; ++c) {
    const int64_t row = track * ch + c;
    const float w = __ldg(weights + c);
    const bool energy = w != 0.f;
    if (F == 0 && !energy) continue;
    const float* xr = x + row * n;
    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = s_entry[(row * nsteps + j) * NS + i];
    if (F > 1) fir.reset(xr, start, nv);
    double acc = 0.0;
    int64_t k = 0, gi = 0;
    float sp = 0.f;
    stream_samples(xr, start, L, [&](int64_t gs, float xv) {
      const bool valid = gs < nv;
      if (energy) {
        const float y = output(f, s, xv);
        advance(f, s, xv);
        acc += valid ? (double)(w * (y * y)) : 0.0;
        if (++k == g) {
          zt[gi] += (float)acc;
          ++gi;
          acc = 0.0;
          k = 0;
        }
      }
      if (F > 0) {
        const float xm = valid ? xv : 0.f;
        sp = fmaxf(sp, fabsf(xm));
        if (F > 1) fir.push(xm, valid);
      }
    });
    if (F > 0) {
      tp_part[row * nsteps + j] = F > 1 ? fir.tp : 0.f;
      sp_part[row * nsteps + j] = sp;
    }
  }
}

// K5: the tile-scan core over the active rows. Each thread writes its
// group sums of g | 32 samples (float32, in sample order) into its own row
// of the tile, whose samples it has read; the CTA then copies the tile's
// group sums to zr coalesced.
template <int GLOG, bool MASK>
__device__ __forceinline__ void k5_span(const TileConsts& k, float4* tile, int r, V4 s,
                                        int64_t g0, int64_t nv, float w) {
  float* row = reinterpret_cast<float*>(tile);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float4 x4 = tile[tile_slot(r, c)];
    const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * c + i;
      const float y = step_filter(k, s, xs[i]);
      const float z = w * (y * y);
      acc += (!MASK || g0 + j < nv) ? z : 0.f;
      if (((j + 1) & ((1 << GLOG) - 1)) == 0) {
        const int q = j >> GLOG;         // <= j: a slot already read
        row[4 * tile_slot(r, q >> 2) + (q & 3)] = acc;
        acc = 0.f;
      }
    }
  }
}

// groups of 2^GLOG samples, GLOG <= 5
template <int GLOG>
__global__ void __launch_bounds__(256)
k5_tile(const __grid_constant__ TileArgs a) {
  extern __shared__ float4 tiles[];
  auto row_of = [&](int64_t ar) {
    const int64_t tr = ar / a.na;
    return tr * a.ch + a.chans[ar - tr * a.na];
  };
  tile_loop(a, tiles, false, row_of, [&](const TileScan& ts, float4* tile) {
    const int tid = threadIdx.x, P = blockDim.x;
    const int64_t g0 = ts.start + (int64_t)TS * tid;
    const int64_t nv = __ldg(a.n_valid + ts.row / a.ch);
    const float w = a.weights[ts.row % a.ch];
    if (g0 < a.n) {
      if (g0 + TS <= nv) k5_span<GLOG, false>(a.k, tile, tid + 1, ts.entry, g0, nv, w);
      else k5_span<GLOG, true>(a.k, tile, tid + 1, ts.entry, g0, nv, w);
    }
    __syncthreads();
    const float* z = reinterpret_cast<const float*>(tile);
    constexpr int PLOG = 5 - GLOG;                 // group sums per thread: 2^PLOG
    const int64_t ng = a.n >> GLOG;
    const int64_t q0 = ts.start >> GLOG;
    float* out = a.zr + ts.row * ng;
    for (int q = tid; q < P << PLOG; q += P) {
      if (q0 + q >= ng) break;
      const int r = (q >> PLOG) + 1, p = q & ((1 << PLOG) - 1);
      out[q0 + q] = z[4 * tile_slot(r, p >> 2) + (p & 3)];
    }
  });
}

template <int GLOG>
cudaError_t launch_k5(const TileArgs& a, int P, cudaStream_t st) {
  const size_t smem = tile_smem_bytes(P);
  int grid = 0;
  cudaError_t e = persistent_grid(k5_tile<GLOG>, P, smem, a.R * a.nseg, &grid);
  if (e != cudaSuccess) return e;
  k5_tile<GLOG><<<grid, P, smem, st>>>(a);
  return cudaGetLastError();
}

struct ChanList {
  int c[TILE_MAX_CH];
  int n;
};

// z[track, i] = (0 + zr[c0]) + zr[c1] + ... over the channels of nonzero
// weight, in channel order (the order rows_correct adds them in)
__global__ void __launch_bounds__(THREADS)
channel_sum(const float* __restrict__ zr, const ChanList cl, int64_t b, int ch,
            int64_t ng, float* __restrict__ z) {
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= b * ng) return;
  const int64_t track = t / ng;
  const int64_t i = t - track * ng;
  float acc = 0.f;
  for (int c = 0; c < cl.n; ++c) acc += zr[(track * ch + cl.c[c]) * ng + i];
  z[t] = acc;
}

}  // namespace

// K3 (factor 2 or 4: energy + peaks) or K4 (factor 0: energy only).
// z (b, n/group) must be zero on entry. Returns the first CUDA error of the
// launches, 0 on success.
extern "C" int ss_kweight_energy_rows(
    const float* x, const int64_t* n_valid, const float* coef,
    const float* weights, const float* taps, int factor, int64_t b, int ch,
    int64_t n, int64_t L, int64_t group, float* s_final, float* s_entry,
    float* z, float* tp_part, float* sp_part, float* tp, float* sp,
    void* stream) {
  if (factor != 0 && factor != 2 && factor != 4) return (int)cudaErrorInvalidValue;
  if (L <= 0 || L % 128 != 0 || n % L != 0 || ch <= 0 || group <= 0 ||
      L % group != 0)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  const int64_t rows = b * ch;
  const int64_t nsteps = n / L;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;

  zero_state_pass<<<blocks_for(rows * nsteps), THREADS, 0, st>>>(
      x, coef, rows, n, nsteps, L, s_final);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  prefix_pass<<<blocks_for(rows), THREADS, 0, st>>>(coef, rows, nsteps, s_final,
                                                    s_entry, nullptr);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  const unsigned gr = blocks_for(b * nsteps);
  if (factor == 4) {
    rows_correct<4, 13><<<gr, THREADS, 0, st>>>(x, n_valid, coef, weights, taps,
        b, ch, n, nsteps, L, group, s_entry, z, tp_part, sp_part);
  } else if (factor == 2) {
    rows_correct<2, 25><<<gr, THREADS, 0, st>>>(x, n_valid, coef, weights, taps,
        b, ch, n, nsteps, L, group, s_entry, z, tp_part, sp_part);
  } else {
    rows_correct<0, 1><<<gr, THREADS, 0, st>>>(x, n_valid, coef, weights, taps,
        b, ch, n, nsteps, L, group, s_entry, z, tp_part, sp_part);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (factor == 0) return 0;

  peaks_pass<<<blocks_for(rows * 32), THREADS, 0, st>>>(rows, nsteps, tp_part,
                                                        sp_part, tp, sp);
  return (int)cudaGetLastError();
}

// K5. consts: TileConsts as floats, weights ch (host memory). sync: int32
// (4 + 4 * b * na * nseg), all bits set, with na the channels of nonzero
// weight; zr (b*ch, n/group) is scratch (rows of weight 0 are not written);
// z (b, n/group) is written whole. group must divide 32.
extern "C" int ss_kweight_energy_chain(
    const float* x, const int64_t* n_valid, const float* consts, const float* weights,
    int64_t b, int ch, int64_t n, int64_t group, int64_t T, int* sync, float* zr,
    float* z, void* stream) {
  if (n <= 0 || n % 128 != 0 || ch <= 0 || ch > TILE_MAX_CH || group <= 0 ||
      TS % group != 0 || T % 1024 != 0 || T > 32 * 256)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  TileArgs a;
  memcpy(&a.k, consts, sizeof(TileConsts));
  memset(a.taps, 0, sizeof(a.taps));
  ChanList cl;
  cl.n = 0;
  for (int c = 0; c < ch; ++c) {
    a.weights[c] = weights[c];
    if (weights[c] != 0.f) a.chans[cl.n++] = c;
  }
  for (int c = 0; c < cl.n; ++c) cl.c[c] = a.chans[c];
  const int na = cl.n;
  const int64_t ng = n / group;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (na > 0) {
    a.x = x;
    a.n_valid = n_valid;
    a.sync = sync;
    a.n = n;
    a.nseg = (n + T - 1) / T;
    a.R = b * na;
    a.ch = ch;
    a.na = na;
    a.L = a.h = a.nsteps = 0;
    a.step_sums = a.tp_part = a.sp_part = nullptr;
    a.zr = zr;
    const int P = (int)(T / TS);
    switch (group) {
      case 1: e = launch_k5<0>(a, P, st); break;
      case 2: e = launch_k5<1>(a, P, st); break;
      case 4: e = launch_k5<2>(a, P, st); break;
      case 8: e = launch_k5<3>(a, P, st); break;
      case 16: e = launch_k5<4>(a, P, st); break;
      default: e = launch_k5<5>(a, P, st); break;
    }
    if (e != cudaSuccess) return (int)e;
  }
  channel_sum<<<blocks_for(b * ng), THREADS, 0, st>>>(zr, cl, b, ch, ng, z);
  return (int)cudaGetLastError();
}

// out[6]: registers, static smem, dynamic smem, local (spill) bytes per
// thread, threads, CTAs per SM of k5_tile at this tile and groups of 32.
extern "C" int ss_kweight_energy_chain_attrs(int64_t T, int* out) {
  kernel_attrs(k5_tile<5>, (int)(T / TS), out);
  return (int)cudaGetLastError();
}
