// K7: the K-weighting filter with carried state, y and s_final from x and
// s0, for any length N >= 1 (the streaming meter's filter, one launch per
// push).
//
// Replaces soundscope_tpu/ops/pallas_iir.py:block_iir_pallas (pallas_call
// in _run, :67; kernel _iir_kernel :32-54). The TPU kernel walks the blocks
// in grid order and carries the 4-state in VMEM from zero:
//   y_j = x_j Tt + s Ot,  s = s A_B^T + x_j Wt.
// CUDA blocks run in no order. K7 runs the tile-scan core of iir_tile.cuh
// in its S0 mode instead, with the semantics of ops/biquad.block_iir (s0
// in, s_final out), in the modal basis of ops/biquad.py:modal_form (the
// basis of the JAX package's BlockFilter). One launch reads x once:
//
//   * a persistent CTA of 128 threads takes segments of T = 4,096 samples
//     of a row (the 60 Hz tick's 800 are one segment; segments of 1,024
//     were slower there) and copies each through the input's strides into
//     shared memory (the meter passes each channel as a strided view of
//     interleaved audio: a sample stride of C, and channel c starts 4c
//     bytes in, so 16-byte copies do not apply; lanes copy consecutive
//     samples);
//   * each thread's zero-state end state over its 32 samples is the matrix
//     form sum W[k] x_k; the warp scan, the warps in series and the
//     look-back of 32 segments give each thread's entry state, the row's
//     first segment entering from the caller's s0 (the records of a
//     segment -1);
//   * each thread refilters its 32 samples from its entry state into the
//     tile, which the CTA stores to y coalesced;
//   * the thread that holds the row's last sample writes s_final in matrix
//     form, A^m e + sum_(k<m) A^(m-1-k) B x_k over its m samples from its
//     entry state e (A^m from the host in float64, the sums from W).
//
// Why the matrix form: the carried state of the sample-by-sample float32
// recurrence drifts. Its slow high-pass mode (|lambda| = 0.995 at 44.1
// kHz) amplifies each sample's rounding about 200-fold, and its state
// component is unobserved in y (C ~ 1e-17), so the error shows in s_final
// only: up to 3e-5 per unit RMS of x against a float64 evaluation at
// (2, 44100), over the 2e-5 pin; the matrix form stays near 2e-6. So
// s_final never comes from the refilter.
//
// Rows of one segment (the tick) need no records: such a launch takes its
// tickets in grid-stride order and the wrapper passes no record buffer.
// Longer rows chain through the core's records, which the wrapper resets
// before each launch.
//
// Bound on the H100: at the meter's shapes ((2, 800) per tick, (2, 44100)
// per slab, (6, 192000) per 5.1 slab) it moves 13 KB, 0.7 MB or 9.2 MB,
// well under a microsecond at 3.35 TB/s below the 5.1 slab, so its time is
// the latency of one launch and its chain: a copy, the scan, the
// refilter of 32 samples and the store.

#include <cstring>

#include "iir_common.cuh"
#include "iir_tile.cuh"

namespace {

constexpr int K7_THREADS = 128;        // T <= 4096

__global__ void __launch_bounds__(K7_THREADS)
k7_tile(const __grid_constant__ TileArgs a) {
  extern __shared__ float4 tiles[];
  tile_loop<TILE_LOOKBACK, true>(a, tiles, false, [](int64_t ar) { return ar; },
                                 [&](const TileScan& ts, float4* tile) {
    const int tid = threadIdx.x, P = blockDim.x, r = tid + 1;
    const int64_t g0 = ts.start + (int64_t)TS * tid;
    const int64_t last = a.n - 1;
    float* tf = reinterpret_cast<float*>(tile);
    if (g0 <= last && last < g0 + TS) {              // s_final, before y overwrites x
      const int m = (int)(last - g0) + 1;
      V4 s = matvec2(a.AR, ts.entry);
      for (int j = 0; j < m; ++j) {
        const float x = tf[4 * tile_slot(r, j >> 2) + (j & 3)];
#pragma unroll
        for (int i = 0; i < 4; ++i) s.v[i] = fmaf(a.k.W[TS - m + j][i], x, s.v[i]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) a.s_out[4 * ts.row + i] = s.v[i];
    }
    if (g0 < a.n) {
      V4 s = ts.entry;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float4 x4 = tile[tile_slot(r, c)];
        float4 y4;
        y4.x = step_filter(a.k, s, x4.x);
        y4.y = step_filter(a.k, s, x4.y);
        y4.z = step_filter(a.k, s, x4.z);
        y4.w = step_filter(a.k, s, x4.w);
        tile[tile_slot(r, c)] = y4;
      }
    }
    __syncthreads();
    float* yr = a.y + ts.row * a.n;
    for (int q = tid; q < TS * P; q += P) {
      const int64_t g = ts.start + q;
      if (g >= a.n) break;
      yr[g] = tf[4 * tile_slot((q >> 5) + 1, (q >> 2) & 7) + (q & 3)];
    }
  });
}

}  // namespace

// x (rows, n) at strides (rs, cs) in samples; s0 (rows, 4) contiguous;
// consts: TileConsts for segments of T samples, ar: A^m as its two 2x2
// blocks, m = (n - 1) % 32 + 1 (both host memory). sync: int32 (4 + 8 *
// rows * nseg), all bits set, or null when T >= n (no records). y (rows,
// n) and s_out (rows, 4) are written whole. Returns the first CUDA error,
// 0 on success.
extern "C" int ss_block_iir_stream(const float* x, int64_t rs, int64_t cs, const float* s0,
                                   const float* consts, const float* ar, int64_t rows,
                                   int64_t n, int64_t T, int* sync, float* y, float* s_out,
                                   void* stream) {
  if (rows < 0 || n <= 0 || T % 1024 != 0 || T <= 0 || T > TS * K7_THREADS)
    return (int)cudaErrorInvalidValue;
  const int64_t nseg = (n + T - 1) / T;
  if (nseg > 1 && sync == nullptr) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  TileArgs a;
  memset(&a, 0, sizeof(a));
  memcpy(&a.k, consts, sizeof(TileConsts));
  memcpy(a.AR, ar, sizeof(a.AR));
  a.x = x;
  a.rs = rs;
  a.cs = cs;
  a.s0 = s0;
  a.y = y;
  a.s_out = s_out;
  a.sync = nseg > 1 ? sync : nullptr;
  a.n = n;
  a.nseg = nseg;
  a.R = rows;
  const int P = (int)(T / TS);
  const size_t smem = tile_smem_bytes(P);
  int grid = 0;
  cudaError_t e = persistent_grid(k7_tile, P, smem, rows * nseg, &grid);
  if (e != cudaSuccess) return (int)e;
  k7_tile<<<grid, P, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// out[6]: registers, static smem, dynamic smem, local (spill) bytes per
// thread, threads, CTAs per SM of k7_tile at segments of T samples.
extern "C" int ss_block_iir_stream_attrs(int64_t T, int* out) {
  kernel_attrs(k7_tile, (int)(T / TS), out);
  return (int)cudaGetLastError();
}
