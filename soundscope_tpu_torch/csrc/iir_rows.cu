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
//   k5_tile  K4 (look-back 32), and K5 (the plain chain) with more than
//            two channels of nonzero weight, over the rows of nonzero
//            weight (rows of weight 0 are neither read nor filtered):
//            segments of T = 4096, group sums only.
//   k5_tile_tracks  K5 with one or two (mono, stereo): a ticket is one
//            track's segment of both channels in one tile, and the CTA
//            writes z itself (below).
//
// The others write float32 group sums in sample order to zr (b*ch, N/g);
// channel_sum adds the channels in order into z. No float atomics: every
// launch gives the same bits.
//
// The chain. K3 and K4 serve few long rows (one file: 2 or 6 rows of
// 2^24 samples), K5 many (the library scan: 600 stereo tracks of 11.52M
// samples). On the plain chain (look-back depth 0) a row is N / T hops of
// about 0.45 us each on the H100, 1.8 ms a row at 4,096 segments: the
// chain, not the card, set K5's time on K4's input. K3 and K4 look back 32
// segments (ops/iir.py:LOOKBACK): N / (33 T) hops, 62 for K3's single
// file, 124 for K4's 5.1 file; 64 was no faster on the H100. They also
// take each next ticket late and skip the segments past n_valid
// (tile_loop). K5 keeps depth 0: its rows or tracks fill the card along
// chains of N / T hops. The alternative, a launch that writes every segment's
// aggregate, a tree scan over each row's aggregates and a second launch
// that refilters, has no spin-wait but reads the input twice and launches
// three kernels; K4 is bound by the bytes it reads, so the look-back, one
// read and no scan launch, was taken.
//
// K5's track ticket. Its bound is the bytes of the valid samples, each
// read once, and z (b, N/g) written once: 14.7 ms at the library scan's
// shape (600 stereo tracks of 180-240 s in rows of 240 s). The
// instructions it issues come close: about 30 a sample (4 FMAs of the
// matrix-form zero state, 17 of the refilter, 1-2 for the square and its
// sum, the scan and the ticket's share of the rest), and on the H100 the
// kernel took 17.2 ms with the scan and the refilter left out and 21.7 ms
// with the copies left out (its first version, 27.5 ms whole). So the
// design spends few instructions a ticket. A ticket (track, segment)
// copies the segment of each weighted channel, Tc = ops/iir.py:
// chain_segment(channels) samples (4,096 mono, 2,048 stereo), into one
// tile of P = 128 threads: thread i works on channel i / (Tc / 32), whole
// warps of it. Thread 0 splits the ticket into segment and track once for
// the CTA, and the copy steps each thread's pointers by constants. The
// channels' scans run side by side: lane c of warp 0 runs channel c's pass
// over its warps and its wait for the channel's inclusive state of the
// track's previous segment, so the serial part of a ticket is paid once for
// both. The scan's powers of A are applied as their 2x2 blocks, as the
// refilter applies A, and each lane's A^(32 lane) in one step from a table
// built on the host. The CTA adds the channels' group sums in shared
// memory in channel order, (0 + z_c0) + z_c1, in float32, and writes z
// once, coalesced: no scratch of group sums per row and no second pass. A
// segment that starts at or past its track's n_valid is neither copied nor
// scanned: it writes z's zeros and no record (nothing valid follows it in
// its track, so no ticket waits on it), and the CTA counts it into a
// device integer once, as it exits (`k5.segments_skipped`). A record is
// the channel's inclusive state alone (G is read only by a look-back).
// More channels keep a ticket per row: in one tile they make segments of
// 512 samples for 5.1, and a track's chain, which all its channels then
// wait on together, hops 11,250 times over 30 s at 192 kHz; 200 such
// tracks took 19.1 ms on the H100 against 13.1 on the rows.
//
// Bounds on the H100: K3 operations (the FIR's 36 FMAs at 4x), as K1; K4
// and K5 the bytes of the input (about 30 instructions per sample just
// under the reads' time).

#include <cstring>

#include "iir_common.cuh"
#include "iir_tile.cuh"

namespace {

constexpr int K5_REC = 4;              // K5's record words per (ticket, channel): incl

// k5_tile_tracks' parameters: the core's, and what its walk adds
struct TrackArgs : TileArgs {
  int lanes_log;                       // 2^lanes_log threads per channel segment
  float* z;                            // (b, n/g), written whole
  unsigned long long* skipped;         // channel segments skipped past n_valid
  float LP[TS][8];                     // A^(32 l) for each lane l, its two 2x2 blocks
};
static_assert(sizeof(TrackArgs) <= 4096, "TrackArgs outgrows the classic 4 KB of parameters");

// K4 and K5: each thread writes its group sums of g | 32 samples (float32,
// in sample order) into its own row of the tile, whose samples it has read;
// the CTA then copies the tile's group sums out coalesced (K4 to zr, K5
// summed over the channels to z). WEIGHT false (K5, a channel of weight 1):
// each y^2 is added to its sum in one fused multiply-add.
template <int GLOG, bool MASK, bool WEIGHT = true>
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
      const float z = WEIGHT ? w * (y * y) : y * y;
      acc += (!MASK || g0 + j < nv) ? z : 0.f;
      if (((j + 1) & ((1 << GLOG) - 1)) == 0) {
        const int q = j >> GLOG;         // <= j: a slot already read
        row[4 * tile_slot(r, q >> 2) + (q & 3)] = acc;
        acc = 0.f;
      }
    }
  }
}

// K5: starts the copy of a ticket's channel segments, Tc = 32 Lc samples
// of each weighted channel of `track` from `start`, into tile rows 1 .. na Lc
// (channel c in rows c Lc + 1 ..), as one cp.async group; samples past n
// read as 0. Thread i copies chunk i mod 8 of rows i / 8 + 1 + m P / 8 of
// each channel: P and Lc are multiples of 64, so its swizzle is one for all
// its rows, and only a segment that runs past n checks its chunks.
__device__ __forceinline__ void issue_track(float4* tile, const TrackArgs& a, int64_t track,
                                            int64_t start) {
  const int llog = a.lanes_log, Lc = 1 << llog;
  const int c8 = threadIdx.x & 7, j0 = threadIdx.x >> 3, step = blockDim.x >> 3;
  const int swz = c8 ^ ((j0 + 1) & 7);
  const bool whole = start + ((int64_t)TS << llog) <= a.n;
  for (int c = 0; c < a.na; ++c) {
    const float* xr = a.x + (track * a.ch + a.chans[c]) * a.n;
    const float* src = xr + start + TS * j0 + 4 * c8;
    float4* dst = tile + 8 * ((c << llog) + j0 + 1) + swz;
    for (int j = j0; j < Lc; j += step, src += TS * step, dst += 8 * step) {
      const bool in = whole || start + TS * j + 4 * c8 < a.n;   // n % 32 == 0
      cp_async16(dst, in ? src : xr, in ? 16 : 0);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// M s with M a row-major 4x4 power of A read as its two 2x2 diagonal
// blocks, as step_filter reads A: in the modal realisation the other
// entries are rounding noise, under 1e-11 of the blocks' (ops/iir_tile.py
// checks A's)
__device__ __forceinline__ V4 matvec_modal(const float* __restrict__ M, const V4& s) {
  V4 r;
  r.v[0] = fmaf(M[1], s.v[1], M[0] * s.v[0]);
  r.v[1] = fmaf(M[5], s.v[1], M[4] * s.v[0]);
  r.v[2] = fmaf(M[11], s.v[3], M[10] * s.v[2]);
  r.v[3] = fmaf(M[15], s.v[3], M[14] * s.v[2]);
  return r;
}

// K5's scan of a ticket up to each thread's entry state, over a tile
// already in shared memory; every thread calls it. Thread i works on
// channel i >> lanes_log of the ticket, Lc / 32 whole warps a channel. As
// tile_scan at D = 0, with the powers of A as their 2x2 blocks
// (matvec_modal): lane c of warp 0 runs channel c's pass over its warps,
// waits for the channel's inclusive state of the track's previous segment
// (ticket - R) and publishes this segment's, unless no valid sample
// follows it; each thread steps its warp's entry state by A^(32 lane) from
// lp (a.LP in shared memory).
__device__ __forceinline__ V4 track_scan(const TrackArgs& a, const float4* tile,
                                         const float (*lp)[8], int64_t ticket, int64_t seg,
                                         int64_t nv) {
  __shared__ V4 warp_sh[TILE_MAX_WARPS];
  __shared__ V4 s_in_sh[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int llog = a.lanes_log;
  const int per = 1 << (llog - 5);                 // warps per channel
  const int cc = tid >> llog;
  const TileConsts& k = a.k;
  int* const rec = a.sync + 4;

  // the record that enters, read early: it is usually complete
  const bool has_incl = tid < a.na && seg > 0;
  const int* src = rec + K5_REC * ((ticket - a.R) * a.na + tid);
  V4 incl = {{0.f, 0.f, 0.f, 0.f}};
  if (has_incl) incl = ld_carry(src);

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
  // inclusive Kogge-Stone over the warp
#pragma unroll
  for (int q = 0; q < KS_ROUNDS; ++q) {
    const V4 o = shfl_up(f, 1 << q);
    const V4 g = add(matvec_modal(k.KS[q], o), f);
    if (lane >= (1 << q)) f = g;
  }
  V4 fex = shfl_up(f, 1);
  if (lane == 0) fex = V4{{0.f, 0.f, 0.f, 0.f}};
  if (lane == 31) warp_sh[warp] = f;
  __syncthreads();

  if (tid < a.na) {
    // channel tid: exclusive prefix over its warps in order, the segment
    // aggregate, the wait and the inclusive state
    V4 e = {{0.f, 0.f, 0.f, 0.f}};
    for (int w = tid * per; w < (tid + 1) * per; ++w) {
      const V4 t = warp_sh[w];
      warp_sh[w] = e;
      e = add(matvec_modal(k.AW[1], e), t);
    }
    V4 s_in = {{0.f, 0.f, 0.f, 0.f}};
    if (has_incl) s_in = wait_carry(src, incl);
    const int64_t next = (seg + 1) << (llog + 5);
    if (seg + 1 < a.nseg && next < nv)
      st_carry(rec + K5_REC * (ticket * a.na + tid), add(matvec_modal(k.AT, s_in), e));
    s_in_sh[tid] = s_in;
  }
  __syncthreads();

  if (cc >= a.na) return V4{{0.f, 0.f, 0.f, 0.f}};
  const V4 v = add(matvec_modal(k.AW[warp - cc * per], s_in_sh[cc]), warp_sh[warp]);
  return add(matvec2(lp[lane], v), fex);
}

// K5 on track tickets, groups of 2^GLOG samples, GLOG <= 5. Persistent
// CTAs take tickets t = (track t mod R, segment t / R) from the counter,
// each the next one as it starts on the current, whose copy is then in
// flight while it works (tile_loop at D = 0); thread 0 splits the ticket
// into its segment and track for the CTA. Each ticket writes its Tc / g
// entries of z, summed over the channels in order.
template <int GLOG>
__global__ void __launch_bounds__(256)
k5_tile_tracks(const __grid_constant__ TrackArgs a) {
  extern __shared__ float4 tiles[];
  __shared__ int64_t ticket_sh[2][3];
  __shared__ __align__(16) float lp[TS][8];        // a.LP, read by lane
  const int tid = threadIdx.x, P = blockDim.x;
  for (int i = tid; i < TS * 8; i += P) lp[i >> 3][i & 7] = a.LP[i >> 3][i & 7];
  const int llog = a.lanes_log;
  const int64_t Tc = (int64_t)TS << llog;
  constexpr int PLOG = 5 - GLOG;                   // group sums per thread: 2^PLOG
  const int Q = (int)(Tc >> GLOG);                 // entries of z per ticket
  const int64_t ng = a.n >> GLOG;
  const int64_t ntickets = a.R * a.nseg;
  auto buf = [&](int b) { return tiles + b * 8 * (P + 1); };
  // thread 0 takes a ticket and splits it: (ticket, segment, track)
  auto take = [&](int b) {
    const int64_t t = (int64_t)atomicAdd(a.sync, 1) + 1;
    const int64_t seg = t / a.R;
    ticket_sh[b][0] = t;
    ticket_sh[b][1] = seg;
    ticket_sh[b][2] = t - seg * a.R;
  };
  auto start_copy = [&](int64_t seg, int64_t track, float4* dst) {
    if (seg * Tc < __ldg(a.n_valid + track)) issue_track(dst, a, track, seg * Tc);
    else asm volatile("cp.async.commit_group;\n" ::);
  };
  unsigned long long skipped = 0;
  if (tid == 0) take(0);
  __syncthreads();
  int64_t t = ticket_sh[0][0], seg = ticket_sh[0][1], track = ticket_sh[0][2];
  if (t < ntickets) start_copy(seg, track, buf(0));
  for (int b = 0; t < ntickets; b ^= 1) {
    if (tid == 0) take(b ^ 1);
    __syncthreads();
    const int64_t next = ticket_sh[b ^ 1][0], next_seg = ticket_sh[b ^ 1][1],
                  next_track = ticket_sh[b ^ 1][2];
    if (next < ntickets) {
      start_copy(next_seg, next_track, buf(b ^ 1));
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const int64_t nv = __ldg(a.n_valid + track);
    const int64_t q0 = seg * Q;
    float* out = a.z + track * ng + q0;
    float4* tile = buf(b);
    if (seg * Tc >= nv) {                          // wholly past n_valid
      for (int q = tid; q < Q && q0 + q < ng; q += P) out[q] = 0.f;
      ++skipped;
    } else {
      const V4 entry = track_scan(a, tile, lp, t, seg, nv);
      const int cc = tid >> llog;
      const int64_t g0 = seg * Tc + (int64_t)TS * (tid - (cc << llog));
      if (cc < a.na && g0 < a.n) {
        const float w = a.weights[a.chans[cc]];
        const bool whole = g0 + TS <= nv;
        if (w == 1.f && whole) k5_span<GLOG, false, false>(a.k, tile, tid + 1, entry, g0, nv, w);
        else if (whole) k5_span<GLOG, false>(a.k, tile, tid + 1, entry, g0, nv, w);
        else k5_span<GLOG, true>(a.k, tile, tid + 1, entry, g0, nv, w);
      }
      __syncthreads();
      const float* zs = reinterpret_cast<const float*>(tile);
      for (int q = tid; q < Q && q0 + q < ng; q += P) {
        const int rq = (q >> PLOG) + 1, p = q & ((1 << PLOG) - 1);
        float acc = 0.f;
        for (int c = 0; c < a.na; ++c)
          acc += zs[4 * tile_slot((c << llog) + rq, p >> 2) + (p & 3)];
        out[q] = acc;
      }
    }
    t = next;                                      // (the next turn's first barrier
                                                   // orders the refill of this buffer)
    seg = next_seg;
    track = next_track;
  }
  if (tid == 0 && skipped) atomicAdd(a.skipped, skipped * (unsigned long long)a.na);
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

template <int GLOG>
cudaError_t launch_k5_tracks(const TrackArgs& a, int P, cudaStream_t st) {
  const size_t smem = tile_smem_bytes(P);
  int grid = 0;
  cudaError_t e = persistent_grid(k5_tile_tracks<GLOG>, P, smem, a.R * a.nseg, &grid);
  if (e != cudaSuccess) return e;
  k5_tile_tracks<GLOG><<<grid, P, smem, st>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_k5_tracks(const TrackArgs& a, int P, int64_t group, cudaStream_t st) {
  switch (group) {
    case 1: return launch_k5_tracks<0>(a, P, st);
    case 2: return launch_k5_tracks<1>(a, P, st);
    case 4: return launch_k5_tracks<2>(a, P, st);
    case 8: return launch_k5_tracks<3>(a, P, st);
    case 16: return launch_k5_tracks<4>(a, P, st);
    default: return launch_k5_tracks<5>(a, P, st);
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
// a look-back of depth `lookback`: TILE_LOOKBACK (K3, K4) or 0 (K5 with more
// than two channels of nonzero weight).
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

// K5 with one or two channels of nonzero weight: energy on tickets of one
// track's segment, Tc samples of each such channel (a power of two, at
// least 2048) in one tile of T samples (a multiple of 2048), na * Tc <= T
// (ops/iir.py:chain_segment).
// consts: TileConsts at Tc, lanes A^(32 l) for l < 32 as 2x2 blocks (32 x 8,
// ops/iir_tile.py:lane_powers), weights ch (host memory). sync: int32 (4 +
// K5_REC * b * na * nseg), all bits set, nseg = ceil(n / Tc), na the channels of
// nonzero weight; z (b, n/group) is written whole; skipped: one uint64 on
// the device, to which the launch adds the channel segments it skipped
// past n_valid. group must divide 32. Returns the launch's CUDA error, 0 on
// success.
extern "C" int ss_kweight_energy_chain(
    const float* x, const int64_t* n_valid, const float* consts, const float* lanes,
    const float* weights, int64_t b, int ch, int64_t n, int64_t group, int64_t T, int64_t Tc,
    int* sync, float* z, unsigned long long* skipped, void* stream) {
  if (n <= 0 || n % 128 != 0 || ch <= 0 || ch > TILE_MAX_CH || group <= 0 ||
      TS % group != 0 || T % 2048 != 0 || T > TS * 256 || Tc < 2048 || (Tc & (Tc - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  TrackArgs a;
  a.na = 0;
  for (int c = 0; c < ch; ++c) {
    a.weights[c] = weights[c];
    if (weights[c] != 0.f) a.chans[a.na++] = c;
  }
  if (a.na < 1 || a.na > 2 || a.na * Tc > T) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  memcpy(&a.k, consts, sizeof(TileConsts));
  memcpy(a.LP, lanes, sizeof(a.LP));
  memset(a.taps, 0, sizeof(a.taps));
  a.x = x;
  a.n_valid = n_valid;
  a.sync = sync;
  a.n = n;
  a.nseg = (n + Tc - 1) / Tc;
  a.R = b;
  a.ch = ch;
  a.L = a.h = a.nsteps = 0;
  a.step_sums = a.tp_part = a.sp_part = a.zr = nullptr;
  a.group = group;
  a.lanes_log = 0;
  while ((TS << a.lanes_log) < Tc) ++a.lanes_log;
  a.z = z;
  a.skipped = skipped;
  return (int)launch_k5_tracks(a, (int)(T / TS), group, st);
}

// out[6]: registers, static smem, dynamic smem, local (spill) bytes per
// thread, threads, CTAs per SM of k3_tile (factor 2, 4) or, at groups of
// 32, k5_tile (factor 0 with a look-back: K4; without: K5 on row tickets)
// or k5_tile_tracks (factor 0, no look-back, tracks: K5 on track tickets)
// at this tile.
extern "C" int ss_kweight_energy_rows_attrs(int factor, int64_t T, int lookback, int tracks,
                                            int* out) {
  const int P = (int)(T / TS);
  if (factor == 4) kernel_attrs(k3_tile<4, 13>, P, out);
  else if (factor == 2) kernel_attrs(k3_tile<2, 25>, P, out);
  else if (lookback > 0) kernel_attrs(k5_tile<5, TILE_LOOKBACK>, P, out);
  else if (tracks) kernel_attrs(k5_tile_tracks<5>, P, out);
  else kernel_attrs(k5_tile<5, 0>, P, out);
  return (int)cudaGetLastError();
}
