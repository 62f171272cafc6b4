// K3, K4, K5: K-weighted, masked, channel-weighted energy over the rows
// layout (b*ch, N) (channel-minor; a 3D (b, ch, N) tensor is the same
// memory), pre-summed over groups of g | 32 samples into z (b, N/g); K3
// adds the BS.1770 true peak and sample peak per row.
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
// All three run the tile-scan core of iir_tile.cuh, one launch that reads
// the input once, each thread refiltering 32 samples from shared memory:
//
//   k3_tile  K3 over every row (rows of weight 0 too, for their peaks):
//            segments of T = 8192, K1's masked polyphase FIR with its halo
//            row (TileFir) beside the group sums; partial peaks per (row,
//            segment), reduced by peaks_pass (iir_common.cuh).
//   k5_tile  K4 and K5 over the rows of nonzero weight (rows of weight 0
//            are neither read nor filtered): segments of T = 4096, group
//            sums only.
//
// Both write float32 group sums in sample order to zr (b*ch, N/g);
// channel_sum adds the channels in order into z. No float atomics: every
// launch gives the same bits.
//
// The chain. K3 and K4 serve few long rows (one file: 2 or 6 rows of
// 2^24 samples), K5 many short ones (the library scan: 2,000 rows of
// 720,000). On the plain chain (look-back depth 0) a row is N / T hops of
// about 0.45 us each on the H100, 1.8 ms a row at 4,096 segments: the
// chain, not the card, set K5's time on K4's input. K3 and K4 look back 32
// segments (ops/iir.py:LOOKBACK): N / (33 T) hops, 62 for K3's single
// file, 124 for K4's 5.1 file; 64 was no faster on the H100. They also
// take each next ticket late and skip the segments past n_valid
// (tile_loop). K5 keeps
// depth 0: its 2,000 rows fill the card along chains of 176 hops. The
// alternative, a launch that writes every segment's aggregate, a tree
// scan over each row's aggregates and a second launch that refilters, has
// no spin-wait but reads the input twice and launches three kernels; K4
// is bound by the bytes it reads, so the look-back, one read and no scan
// launch, was taken.
//
// Bounds on the H100: K3 operations (the FIR's 36 FMAs at 4x), as K1; K4
// and K5 the bytes of the input, as K5 was (about 30 instructions per
// sample under the reads' time).

#include <cstring>

#include "iir_common.cuh"
#include "iir_tile.cuh"

namespace {

// K4 and K5: the tile-scan core over the active rows. Each thread writes its
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

// groups of 2^GLOG samples, GLOG <= 5; look-back depth D: TILE_LOOKBACK
// (K4) or 0 (K5)
template <int GLOG, int D>
__global__ void __launch_bounds__(256)
k5_tile(const __grid_constant__ TileArgs a) {
  extern __shared__ float4 tiles[];
  auto row_of = [&](int64_t ar) {
    const int64_t tr = ar / a.na;
    return tr * a.ch + a.chans[ar - tr * a.na];
  };
  tile_loop<D>(a, tiles, false, row_of, [&](const TileScan& ts, float4* tile) {
    const int tid = threadIdx.x, P = blockDim.x;
    constexpr int PLOG = 5 - GLOG;                 // group sums per thread: 2^PLOG
    const int64_t ng = a.n >> GLOG;
    const int64_t q0 = ts.start >> GLOG;
    float* out = a.zr + ts.row * ng;
    if (ts.skip) {                                 // wholly past n_valid
      for (int q = tid; q < P << PLOG && q0 + q < ng; q += P) out[q0 + q] = 0.f;
      return;
    }
    const int64_t g0 = ts.start + (int64_t)TS * tid;
    const int64_t nv = __ldg(a.n_valid + ts.row / a.ch);
    const float w = a.weights[ts.row % a.ch];
    if (g0 < a.n) {
      if (g0 + TS <= nv) k5_span<GLOG, false>(a.k, tile, tid + 1, ts.entry, g0, nv, w);
      else k5_span<GLOG, true>(a.k, tile, tid + 1, ts.entry, g0, nv, w);
    }
    __syncthreads();
    const float* z = reinterpret_cast<const float*>(tile);
    for (int q = tid; q < P << PLOG; q += P) {
      if (q0 + q >= ng) break;
      const int r = (q >> PLOG) + 1, p = q & ((1 << PLOG) - 1);
      out[q0 + q] = z[4 * tile_slot(r, p >> 2) + (p & 3)];
    }
  });
}

template <int GLOG, int D>
cudaError_t launch_k5(const TileArgs& a, int P, cudaStream_t st) {
  const size_t smem = tile_smem_bytes(P);
  int grid = 0;
  cudaError_t e = persistent_grid(k5_tile<GLOG, D>, P, smem, a.R * a.nseg, &grid);
  if (e != cudaSuccess) return e;
  k5_tile<GLOG, D><<<grid, P, smem, st>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_k5(const TileArgs& a, int P, int64_t group, cudaStream_t st) {
  switch (group) {
    case 1: return launch_k5<0, D>(a, P, st);
    case 2: return launch_k5<1, D>(a, P, st);
    case 4: return launch_k5<2, D>(a, P, st);
    case 8: return launch_k5<3, D>(a, P, st);
    case 16: return launch_k5<4, D>(a, P, st);
    default: return launch_k5<5, D>(a, P, st);
  }
}

struct ChanList {
  int c[TILE_MAX_CH];
  int n;
};

// z[track, i] = (0 + zr[c0]) + zr[c1] + ... over the channels of nonzero
// weight, in channel order
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

// K3's span: refilters the thread's 32 samples (tile row r) from s and
// writes z = w * y^2, masked, over them (chunk c of row r after it is
// read); the FIR and the sample peak over the same samples. MASK: some
// sample is at or past n_valid.
template <int F, int KP, bool MASK>
__device__ __forceinline__ void k3_span(const TileArgs& a, float4* tile, int r, V4 s,
                                        int64_t g0, int64_t nv, float w, TileFir<F, KP>& fir,
                                        float& tp, float& sp) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float4 x4 = tile[tile_slot(r, c)];
    const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
    float zs[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = xs[i];
      const float y = step_filter(a.k, s, x);
      const bool valid = !MASK || g0 + 4 * c + i < nv;
      zs[i] = valid ? w * (y * y) : 0.f;
      sp = fmax_nan(sp, valid ? fabsf(x) : 0.f);
      fir.push(a, x, valid, tp);
    }
    tile[tile_slot(r, c)] = make_float4(zs[0], zs[1], zs[2], zs[3]);
  }
}

// The group sums of a tile of z (K3): output q of the segment adds the g
// samples of its group in order in float32, as k5_span does, and is
// written coalesced (zeros for a skipped segment).
__device__ __forceinline__ void k3_groups(const TileArgs& a, const float4* tile,
                                          const TileScan& ts) {
  const int g = (int)a.group, per = TS / g, P = blockDim.x;
  const int64_t ng = a.n / g;
  const int64_t q0 = ts.start / g;
  float* out = a.zr + ts.row * ng;
  const float* zf = reinterpret_cast<const float*>(tile);
  for (int q = threadIdx.x; q < P * per; q += P) {
    if (q0 + q >= ng) break;
    const int r = q / per + 1, j0 = (q % per) * g;
    float acc = 0.f;
    if (!ts.skip && g >= 4) {
      for (int c = j0 / 4; c < (j0 + g) / 4; ++c) {
        const float4 v = tile[tile_slot(r, c)];
        acc += v.x;
        acc += v.y;
        acc += v.z;
        acc += v.w;
      }
    } else if (!ts.skip) {
      for (int j = j0; j < j0 + g; ++j) acc += zf[4 * tile_slot(r, j >> 2) + (j & 3)];
    }
    out[q0 + q] = acc;
  }
}

// CTAs of 256 threads (T = 8192), 2 resident per SM as K1's
constexpr int K3_THREADS = 256;
constexpr int K3_MINB = 2;

template <int F, int KP>
__global__ void __launch_bounds__(K3_THREADS, K3_MINB)
k3_tile(const __grid_constant__ TileArgs a) {
  extern __shared__ float4 tiles[];
  __shared__ float pk[TILE_MAX_WARPS][2];
  tile_loop<TILE_LOOKBACK>(a, tiles, true, [](int64_t ar) { return ar; },
            [&](const TileScan& ts, float4* tile) {
    const int r = threadIdx.x + 1;
    const int64_t g0 = ts.start + (int64_t)TS * threadIdx.x;
    const int64_t nv = __ldg(a.n_valid + ts.row / a.ch);
    const float w = a.weights[ts.row % a.ch];
    if (ts.skip) {                                 // wholly past n_valid
      if (threadIdx.x == 0) {
        a.tp_part[ts.row * a.nseg + ts.seg] = 0.f;
        a.sp_part[ts.row * a.nseg + ts.seg] = 0.f;
      }
      if (w != 0.f) k3_groups(a, tile, ts);
      return;
    }
    TileFir<F, KP> fir;
    fir.halo(tile, r);
    __syncthreads();                     // every halo is read before z overwrites it
    float tp = 0.f, sp = 0.f;
    if (g0 < a.n) {
      if (g0 + TS <= nv) {
        k3_span<F, KP, false>(a, tile, r, ts.entry, g0, nv, w, fir, tp, sp);
      } else if (g0 < nv) {
        k3_span<F, KP, true>(a, tile, r, ts.entry, g0, nv, w, fir, tp, sp);
      } else {
#pragma unroll
        for (int c = 0; c < 8; ++c) tile[tile_slot(r, c)] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    warp_peaks(tp, sp, pk);
    __syncthreads();
    cta_peaks(pk, a.tp_part + ts.row * a.nseg + ts.seg, a.sp_part + ts.row * a.nseg + ts.seg);
    if (w != 0.f) k3_groups(a, tile, ts);
  });
}

template <int F, int KP>
cudaError_t launch_k3(const TileArgs& a, int P, cudaStream_t st) {
  const size_t smem = tile_smem_bytes(P);
  int grid = 0;
  cudaError_t e = persistent_grid(k3_tile<F, KP>, P, smem, a.R * a.nseg, &grid);
  if (e != cudaSuccess) return e;
  k3_tile<F, KP><<<grid, P, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// K3 (factor 2 or 4: energy + peaks, over every row) or K4 / K5 (factor 0:
// energy, over the rows of nonzero weight), on segments of T samples with
// a look-back of depth `lookback`: TILE_LOOKBACK (K3, K4) or 0 (K5).
// consts: TileConsts as floats, taps F x
// KP, weights ch (all host memory). sync: int32 (4 + 8 * R * nseg), all
// bits set, with R = b * ch for K3 and b * (channels of nonzero weight)
// for K4 / K5; zr (b*ch, n/group) is scratch (K3 writes the rows of
// nonzero weight, K4 / K5 the same); z (b, n/group) is written whole;
// tp_part, sp_part (b*ch, nseg), tp, sp (b*ch) for K3. group must divide
// 32. Returns the first CUDA error of the launches, 0 on success.
extern "C" int ss_kweight_energy_rows(
    const float* x, const int64_t* n_valid, const float* consts, const float* taps,
    const float* weights, int factor, int64_t b, int ch, int64_t n, int64_t group,
    int64_t T, int lookback, int* sync, float* zr, float* z, float* tp_part,
    float* sp_part, float* tp, float* sp, void* stream) {
  if (factor != 0 && factor != 2 && factor != 4) return (int)cudaErrorInvalidValue;
  if (n <= 0 || n % 128 != 0 || ch <= 0 || ch > TILE_MAX_CH || group <= 0 ||
      TS % group != 0 || T % 1024 != 0 || T > TS * 256 ||
      (lookback != TILE_LOOKBACK && (factor > 0 || lookback != 0)))
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  TileArgs a;
  memcpy(&a.k, consts, sizeof(TileConsts));
  memset(a.taps, 0, sizeof(a.taps));
  const int KP = factor == 4 ? 13 : (factor == 2 ? 25 : 0);
  if (factor > 0) memcpy(a.taps, taps, sizeof(float) * factor * KP);
  ChanList cl;
  cl.n = 0;
  for (int c = 0; c < ch; ++c) {
    a.weights[c] = weights[c];
    if (weights[c] != 0.f) a.chans[cl.n++] = c;
  }
  for (int c = 0; c < cl.n; ++c) cl.c[c] = a.chans[c];
  a.x = x;
  a.n_valid = n_valid;
  a.sync = sync;
  a.n = n;
  a.nseg = (n + T - 1) / T;
  a.ch = ch;
  a.na = cl.n;
  a.L = a.h = a.nsteps = 0;
  a.step_sums = nullptr;
  a.tp_part = tp_part;
  a.sp_part = sp_part;
  a.zr = zr;
  a.group = group;
  const int P = (int)(T / TS);
  const int64_t ng = n / group;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
  if (factor > 0) {
    a.R = b * ch;
    e = factor == 4 ? launch_k3<4, 13>(a, P, st) : launch_k3<2, 25>(a, P, st);
  } else if (cl.n > 0) {
    a.R = b * cl.n;
    e = lookback > 0 ? launch_k5<TILE_LOOKBACK>(a, P, group, st)
                     : launch_k5<0>(a, P, group, st);
  }
  if (e != cudaSuccess) return (int)e;
  channel_sum<<<blocks_for(b * ng), THREADS, 0, st>>>(zr, cl, b, ch, ng, z);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (factor == 0) return 0;
  peaks_pass<<<blocks_for(b * ch * 32), THREADS, 0, st>>>(b * ch, a.nseg, tp_part, sp_part,
                                                          tp, sp);
  return (int)cudaGetLastError();
}

// out[6]: registers, static smem, dynamic smem, local (spill) bytes per
// thread, threads, CTAs per SM of k3_tile (factor 2, 4) or k5_tile at
// groups of 32 (factor 0: K4 with a look-back, K5 without) at this tile.
extern "C" int ss_kweight_energy_rows_attrs(int factor, int64_t T, int lookback, int* out) {
  const int P = (int)(T / TS);
  if (factor == 4) kernel_attrs(k3_tile<4, 13>, P, out);
  else if (factor == 2) kernel_attrs(k3_tile<2, 25>, P, out);
  else if (lookback > 0) kernel_attrs(k5_tile<5, TILE_LOOKBACK>, P, out);
  else kernel_attrs(k5_tile<5, 0>, P, out);
  return (int)cudaGetLastError();
}
