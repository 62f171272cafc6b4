// The tile-scan core of the K-weighting energy kernels K1 (iir_chunked.cu)
// and K5 (iir_rows.cu, chain route).
//
// Both run the 4-state recurrence s <- A s + B x, y = C s + D x in the
// modal realisation (ops/biquad.py:modal_form; A is two 2x2 blocks, the
// wrapper checks it) over rows of N samples and sum z = w * y^2 masked at
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
//     segment's aggregate G.
//   * Thread 0 waits for the predecessor's inclusive end state (ticket
//     t - R), publishes s_out = A^T s_in + G for its successor, and only
//     then does the CTA refilter. The hop on the chain is one matrix-vector
//     product; nothing waits for a partial aggregate, so every run gives
//     the same bits.
//   * Each thread's entry state is A^(32 lane) (A^(1024 w) s_in + E_w) +
//     F_(lane-1), the lane power applied as a product of the scan's
//     matrices picked by the bits of the lane. It then refilters its 32
//     samples from shared memory and forms w * y^2 (K1 also runs the
//     polyphase FIR over the same samples and the halo).
//
// The carry records are float4s (rows x segments), set to the bit pattern
// 0xFFFFFFFF by the wrapper; a record is complete when none of its four
// words holds that pattern, which no float arithmetic produces (the
// card's NaN is 0x7FFFFFFF). Word 0 of the same int32 buffer is the ticket
// counter, so tickets count from -1 + 1 = 0.
//
// Constants: TileConsts, built on the host in float64 and rounded to
// float32 (ops/iir_tile.py), is passed by value: the kernel parameters
// live in the constant bank, whence FMAs read them without registers, and
// the wrappers upload nothing.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TS = 32;                 // samples per thread (S)
constexpr int TILE_MAX_WARPS = 16;     // P <= 512, T <= 16384
constexpr int KS_ROUNDS = 5;           // log2 of the warp
constexpr int TILE_MAX_CH = 16;
constexpr int TILE_MAX_TAPS = 52;      // 4 x 13 or 2 x 25

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
};

struct TileArgs {
  TileConsts k;
  float taps[TILE_MAX_TAPS];           // K1: F phases x KP taps
  float weights[TILE_MAX_CH];          // per channel
  int chans[TILE_MAX_CH];              // K5: the active (nonzero-weight) channels
  const float* x;
  const int64_t* n_valid;              // per track
  int* sync;                           // [0] ticket counter, then carry words
  int64_t n;                           // samples per row
  int64_t nseg;                        // segments per row
  int64_t R;                           // active rows
  int ch;                              // channels per track
  int na;                              // active channels per track (K5)
  // K1
  int64_t L, h, nsteps;
  float* step_sums;
  float* tp_part;
  float* sp_part;
  // K5
  float* zr;
};

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

// Shared-memory tile: row r holds samples start - 32 + 32 r .. + 31 as 8
// float4 chunks, chunk c stored at r * 8 + (c ^ (r & 7)). A quarter-warp
// reading chunk c of 8 consecutive rows then touches 32 distinct banks.
__device__ __forceinline__ int tile_slot(int r, int c) { return r * 8 + (c ^ (r & 7)); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
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

__device__ __forceinline__ V4 ld_carry(const int* p) {
  V4 r;
  asm volatile("ld.volatile.global.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(r.v[0]), "=f"(r.v[1]), "=f"(r.v[2]), "=f"(r.v[3])
               : "l"(p));
  return r;
}

__device__ __forceinline__ void st_carry(int* p, const V4& s) {
  asm volatile("st.volatile.global.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "f"(s.v[0]), "f"(s.v[1]), "f"(s.v[2]), "f"(s.v[3])
               : "memory");
}

__device__ __forceinline__ bool carry_ready(const V4& s) {
  bool ok = true;
#pragma unroll
  for (int i = 0; i < 4; ++i) ok &= __float_as_int(s.v[i]) != -1;
  return ok;
}

// What the scan gives each thread of the CTA.
struct TileScan {
  int64_t ticket, row, seg, start;
  V4 entry;                            // the state before the thread's first sample
};

// The scan of the module comment, up to each thread's entry state, over a
// tile already in shared memory. Every thread of the CTA calls it.
__device__ __forceinline__ V4 tile_scan(const TileArgs& a, const float4* tile,
                                        int64_t ticket, int64_t seg) {
  __shared__ V4 warp_sh[TILE_MAX_WARPS];
  __shared__ V4 s_in_sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = blockDim.x;
  const TileConsts& k = a.k;

  // the predecessor's record, read early: it is usually complete already
  const int* src = a.sync + 4 + 4 * (ticket - a.R);
  V4 s_in = {{0.f, 0.f, 0.f, 0.f}};
  if (tid == 0 && seg > 0) s_in = ld_carry(src);

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
      for (int j = 0; j < 4; ++j) f.v[j] = fmaf(k.W[4 * c + i][j], xs[i], f.v[j]);
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

  if (tid == 0) {
    // exclusive prefix over the warps in order, then the segment aggregate
    V4 e = {{0.f, 0.f, 0.f, 0.f}};
    const int nw = P / 32;
    for (int w = 0; w < nw; ++w) {
      const V4 t = warp_sh[w];
      warp_sh[w] = e;
      e = add(matvec(k.AW[1], e), t);
    }
    if (seg > 0) {
      while (!carry_ready(s_in)) {
        __nanosleep(20);
        s_in = ld_carry(src);
      }
    }
    if (seg + 1 < a.nseg) st_carry(a.sync + 4 + 4 * ticket, add(matvec(k.AT, s_in), e));
    s_in_sh = s_in;
  }
  __syncthreads();

  V4 v = add(matvec(k.AW[warp], s_in_sh), warp_sh[warp]);
#pragma unroll
  for (int q = 0; q < KS_ROUNDS; ++q)
    if ((lane >> q) & 1) v = matvec(k.KS[q], v);
  return add(v, fex);
}

// A persistent CTA's walk over the segments. Each CTA takes tickets one
// ahead: while it scans and refilters segment t from one tile buffer, the
// copy of its next ticket's segment into the other is in flight. (The
// smallest unfinished ticket is always one a CTA is working on, and its
// predecessor is finished, so the waits cannot deadlock.) body(ts, tile)
// runs once per segment with the tile in shared memory; tiles holds two
// buffers of 8 * (P + 1) float4. row_of maps an active-row index to a row.
template <class RowOf, class Body>
__device__ __forceinline__ void tile_loop(const TileArgs& a, float4* tiles, bool halo,
                                          RowOf row_of, Body body) {
  __shared__ int64_t ticket_sh[2];
  const int P = blockDim.x;
  const int64_t ntickets = a.R * a.nseg;
  const int64_t T = (int64_t)TS * P;
  auto buf = [&](int b) { return tiles + b * 8 * (P + 1); };
  auto start_copy = [&](int64_t t, float4* dst) {
    const int64_t seg = t / a.R;
    const int64_t row = row_of(t - seg * a.R);
    issue_tile(dst, a.x + row * a.n, seg * T, a.n, P, halo ? 0 : 1);
  };
  if (threadIdx.x == 0) ticket_sh[0] = (int64_t)atomicAdd(a.sync, 1) + 1;
  __syncthreads();
  int64_t t = ticket_sh[0];
  if (t >= ntickets) return;
  start_copy(t, buf(0));
  for (int b = 0;; b ^= 1) {
    if (threadIdx.x == 0) ticket_sh[b ^ 1] = (int64_t)atomicAdd(a.sync, 1) + 1;
    __syncthreads();
    const int64_t next = ticket_sh[b ^ 1];
    if (next < ntickets) {
      start_copy(next, buf(b ^ 1));
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    TileScan ts;
    ts.ticket = t;
    ts.seg = t / a.R;
    ts.row = row_of(t - ts.seg * a.R);
    ts.start = ts.seg * T;
    ts.entry = tile_scan(a, buf(b), t, ts.seg);
    body(ts, buf(b));
    __syncthreads();                     // the buffer is refilled next turn
    if (next >= ntickets) return;
    t = next;
  }
}

inline size_t tile_smem_bytes(int P) { return 2 * sizeof(float4) * 8 * (P + 1); }

// As many CTAs as fit on the card at once, at most one per ticket; sets
// the kernel's dynamic shared memory.
template <class K>
cudaError_t persistent_grid(K kernel, int P, size_t smem, int64_t ntickets, int* grid) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, P, smem)) !=
      cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t most = (int64_t)per_sm * sms;
  *grid = (int)(ntickets < most ? ntickets : most);
  return cudaSuccess;
}

// out[6]: registers, static smem, dynamic smem, local (spill) bytes per
// thread, threads, CTAs per SM, for P threads a CTA
template <class K>
void kernel_attrs(K kernel, int P, int* out) {
  cudaFuncAttributes fa;
  if (cudaFuncGetAttributes(&fa, kernel) != cudaSuccess) return;
  const size_t smem = tile_smem_bytes(P);
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

}  // namespace
