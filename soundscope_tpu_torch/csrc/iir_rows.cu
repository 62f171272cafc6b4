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
//   k3_tile_tracks  K3 over every channel (weight 0 too, for its peaks),
//            K1's masked polyphase FIR with its halo row (TileFir) beside
//            the group sums: a ticket is one mono or stereo file's segment
//            of every channel, each with its halo row, in one tile, and the
//            CTA writes z itself, or one row's segment of a file of more
//            channels (below); partial peaks per (row, segment), reduced by
//            peaks_pass (iir_common.cuh).
//   k5_tile  K4 (look-back 32), and K5 (the plain chain) with more than
//            two channels of nonzero weight, over the rows of nonzero
//            weight (rows of weight 0 are neither read nor filtered):
//            segments of T = 4096, group sums only.
//   k5_tile_tracks  K5 with one or two (mono, stereo): a ticket is one
//            track's segment of both channels in one tile, and the CTA
//            writes z itself (below).
//
// k5_tile, and k3_tile_tracks on a file of more than two channels, write
// float32 group sums in sample order to zr (b*ch, N/g); channel_sum adds
// the channels in order into z. No float atomics: every launch gives the
// same bits.
//
// The chain. K3 and K4 serve few long rows (one file: 2 or 6 rows of
// 2^24 samples), K5 many (the library scan: 600 stereo tracks of 11.52M
// samples). On the plain chain (look-back depth 0) a row is N / T hops of
// about 0.45 us each on the H100, 1.8 ms a row at 4,096 segments: the
// chain, not the card, set K5's time on K4's input. K3 and K4 look back 32
// segments (ops/iir.py:LOOKBACK): N / (33 T) hops, 124 for K3's single
// stereo file (segments of 4,096 a channel), 62 for its 5.1 file's rows
// (8,192), 124 for K4's 5.1 file; 64 was no faster on the H100. They also
// take each next ticket late and skip the segments past n_valid
// (tile_loop, k3_tile_tracks). K5 keeps depth 0: its rows or tracks fill the card along
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
// K3's ticket carries K5's over to the look-back. Its rows are few and
// long (a file, or the programmes of a QC batch: 16 rows of 345.6M
// samples). A mono or stereo file's ticket (file, segment) holds Tc = 8192
// / ch samples of each channel (4,096 stereo, 8,192 mono) in one tile of P
// = 256 threads, channel c in tile rows c (Lc + 1) .. c (Lc + 1) + Lc, the
// first of them its FIR halo: one row a buffer more than the core's tile,
// 2 CTAs per SM. The scan is track_scan's arithmetic (2x2-block powers,
// the lane table) with the look-back of 32 segments of Tc: each channel's
// serial part (its pass over its warps, its look-back over 32 lanes, its
// wait) runs on a warp of its own, channel c on warp c, side by side, so
// it is paid once for both. Each thread adds y^2 over its groups in order
// in registers (k5_span's z) and leaves the sums in its own tile row; the
// CTA adds the channels of nonzero weight in channel order, each times its
// weight, and writes z once. So there is no scratch of group sums per row
// and no second pass, which on row tickets cost the programmes' batch 691
// MB of writes read back by channel_sum (1.04 GB, 5.8 % of K3's time).
// Channels of weight 0 take their peaks and add nothing. Six channels do
// not split a tile into equal whole warps, and a 5.1 track's chain, which
// all its channels would wait on together, would be six times as long; so
// a file of more than two channels takes tickets of one row's segment of
// 8,192 (a mono file's), each row's weighted group sums go to zr and
// channel_sum adds them. Partial peaks stay per (row, segment of Tc), for
// peaks_pass.
//
// Bounds on the H100: K3 operations (the FIR's 36 FMAs at 4x), as K1; K4
// and K5 the bytes of the input (about 30 instructions per sample just
// under the reads' time).

#include <cstring>

#include "iir_common.cuh"
#include "iir_tile.cuh"

namespace {

constexpr int K5_REC = 4;              // K5's record words per (ticket, channel): incl

// the track kernels' parameters (k5_tile_tracks, k3_tile_tracks): the
// core's, and what their walk adds
struct TrackArgs : TileArgs {
  int lanes_log;                       // 2^lanes_log threads per channel segment
  float* z;                            // (b, n/g), written whole
  unsigned long long* skipped;         // K5: channel segments skipped past n_valid
  int wch;                             // K3: channels of a file; row r = track ch + c
                                       // takes weights[r % wch] and n_valid[r / wch]
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

// CTAs of 256 threads (T = 8192), 2 resident per SM as K1's
constexpr int K3_THREADS = 256;
constexpr int K3_MINB = 2;

// K3 on track tickets. A buffer holds each channel's halo row before its Lc
// rows of samples: P + ch rows, sized for two channels whatever the track
// has, so that one kernel has one dynamic shared memory size.
constexpr int K3_TRACK_CH = 2;

inline size_t k3_track_smem_bytes(int P) {
  return 2 * sizeof(float4) * 8 * (P + K3_TRACK_CH);
}

// A K3 ticket t split for the CTA: sh = (t, segment, track, file), the
// track's rows r = track ch + c .. reading n_valid[r / wch] (the file).
// Tickets count in the int32 counter, so the divisions are 32-bit.
__device__ __forceinline__ void k3_split(const TrackArgs& a, int t, int64_t* sh) {
  const int R = (int)a.R, s = t / R, track = t - s * R;
  sh[0] = t;
  sh[1] = s;
  sh[2] = track;
  sh[3] = a.ch == a.wch ? track : track / a.wch;
}

// Starts the copy of a K3 track ticket: Tc = 32 Lc samples of each of the
// track's channels from `start`, with the 32 before them (the FIR's halo),
// channel c in tile rows c (Lc + 1) (its halo) .. c (Lc + 1) + Lc, as one
// cp.async group; samples outside [0, n) read as 0. Thread i copies chunk
// i mod 8 of rows i / 8 + m P / 8 of each channel, so its swizzle is one for
// all of them, and only a segment at the row's start or past n checks its
// chunks.
template <int P>
__device__ __forceinline__ void issue_k3_track(float4* tile, const TrackArgs& a, int64_t track,
                                               int64_t start) {
  static_assert(P % 64 == 0, "rows i / 8 + m P / 8 keep their swizzle");
  const int Lc = 1 << a.lanes_log;
  const int c8 = threadIdx.x & 7, j0 = threadIdx.x >> 3;
  const bool whole = start >= TS && start + ((int64_t)TS << a.lanes_log) <= a.n;
  for (int c = 0; c < a.ch; ++c) {
    const int base = c * (Lc + 1);
    const float* xr = a.x + (track * a.ch + c) * a.n;
    int64_t g = start - TS + TS * j0 + 4 * c8;
    float4* dst = tile + 8 * (base + j0) + (c8 ^ ((base + j0) & 7));
    for (int j = j0; j <= Lc; j += P / 8, g += TS * (P / 8), dst += P) {
      const bool in = whole || (g >= 0 && g < a.n);      // n % 32 == 0: chunks are whole
      cp_async16(dst, in ? xr + g : xr, in ? 16 : 0);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// K3's scan of a track ticket up to each thread's entry state, over a tile
// already in shared memory; every thread calls it. Thread i works on
// channel i >> lanes_log, Lc / 32 whole warps a channel, on tile row
// c (Lc + 1) + 1 + (i mod Lc). As tile_scan at D = TILE_LOOKBACK, with
// track_scan's arithmetic (the powers of A as their 2x2 blocks, each
// lane's A^(32 lane) in one step from lp) and each channel's serial part
// on a warp of its own, side by side: lane 0 of warp c runs channel c's
// pass over its warps and publishes the channel's aggregate G, the lanes
// of warp c form its look-back over G(t - j R), j = 1 .. D, in a fixed
// tree, and lane 0 waits for incl(t - (D+1) R) and publishes incl(t). The
// records are per (ticket, channel); a record no valid segment reads is
// not published. The lane that publishes the ticket's last record (done
// counts the channels out) takes the CTA's next ticket into next_sh
// (k3_split).
__device__ __forceinline__ V4 k3_track_scan(const TrackArgs& a, const float4* tile,
                                            const float (*lp)[8], int64_t ticket, int64_t seg,
                                            int64_t nv, int* done, int64_t* next_sh) {
  constexpr int D = TILE_LOOKBACK;
  __shared__ V4 warp_sh[TILE_MAX_WARPS];
  __shared__ V4 s_in_sh[K3_TRACK_CH];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int llog = a.lanes_log, Lc = 1 << llog;
  const int per = 1 << (llog - 5);                 // warps per channel
  const int cc = tid >> llog;
  const int64_t Tc = (int64_t)TS << llog;
  const TileConsts& k = a.k;
  int* const rec = a.sync + 4;
  auto record = [&](int64_t t, int c) { return rec + REC * (t * a.ch + c); };

  // the records that enter, read early: they are usually complete. Lane
  // j - 1 of warp c takes channel c's G(t - j R), lane 0 also its
  // incl(t - (D+1) R).
  const bool scans = warp < a.ch;                  // warp c runs channel c's serial part
  const bool has_incl = scans && lane == 0 && seg > D;
  const int* src = record(ticket - (int64_t)(D + 1) * a.R, warp) + 4;
  V4 incl = {{0.f, 0.f, 0.f, 0.f}};
  if (has_incl) incl = ld_carry(src);
  const int j = lane + 1;                          // j <= 32 = D
  const bool has_g = scans && seg >= j;
  const int* gsrc = record(ticket - (int64_t)j * a.R, warp);
  V4 g = {{0.f, 0.f, 0.f, 0.f}};
  if (has_g) g = ld_carry(gsrc);

  // zero-state end state of the thread's sub-span, in matrix form
  const int r = cc * (Lc + 1) + (tid & (Lc - 1)) + 1;
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
    const V4 s = add(matvec_modal(k.KS[q], o), f);
    if (lane >= (1 << q)) f = s;
  }
  V4 fex = shfl_up(f, 1);
  if (lane == 0) fex = V4{{0.f, 0.f, 0.f, 0.f}};
  if (lane == 31) warp_sh[warp] = f;
  __syncthreads();

  if (scans) {
    // channel c = warp: exclusive prefix over its warps in order, then the
    // segment aggregate G, published before any wait
    V4 e = {{0.f, 0.f, 0.f, 0.f}};
    if (lane == 0) {
      for (int w = warp * per; w < (warp + 1) * per; ++w) {
        const V4 t = warp_sh[w];
        warp_sh[w] = e;
        e = add(matvec_modal(k.AW[1], e), t);
      }
      if (seg + 1 < a.nseg && (seg + 1) * Tc < nv) st_carry(record(ticket, warp), e);
    }
    // lane j - 1 forms A^(Tc (j-1)) G(t - j R); a fixed tree sums the lanes
    V4 s_in = {{0.f, 0.f, 0.f, 0.f}};
    if (has_g) s_in = lb_power(k, j - 1, wait_carry(gsrc, g));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s_in = add(s_in, shfl_down(s_in, o));
    if (lane == 0) {
      if (has_incl) s_in = add(lb_power(k, D, wait_carry(src, incl)), s_in);
      if (seg + D + 1 < a.nseg && (seg + D + 1) * Tc < nv)
        st_carry(record(ticket, warp) + 4, add(matvec_modal(k.AT, s_in), e));
      s_in_sh[warp] = s_in;
      if (atomicAdd(done, 1) == a.ch - 1) {
        *done = 0;
        k3_split(a, atomicAdd(a.sync, 1) + 1, next_sh);
      }
    }
  }
  __syncthreads();

  const V4 v = add(matvec_modal(k.AW[warp - cc * per], s_in_sh[cc]), warp_sh[warp]);
  return add(matvec2(lp[lane], v), fex);
}

// K3's span on a track ticket, every sample valid: refilters the thread's
// 32 samples (tile row r) from s, adds y^2 over each group of 2^glog
// samples in order in float32, each in one fused multiply-add (23.88 ->
// 23.40 ms a batch of the programme cell on the H100, against w y^2
// added), and writes the sum into the slot of its row that the group's
// index names, one the thread has already read (as k5_span); the FIR and
// the sample peak over the same samples. Where glog is the kernel's
// GLOG, the stores unroll to fixed slots.
template <int F, int KP>
__device__ __forceinline__ void k3_track_span(const TileArgs& a, float4* tile, int r, V4 s,
                                              int glog, TileFir<F, KP>& fir, float& tp,
                                              float& sp) {
  float* row = reinterpret_cast<float*>(tile);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float4 x4 = tile[tile_slot(r, c)];
    const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * c + i;
      const float x = xs[i];
      const float y = step_filter(a.k, s, x);
      acc = fmaf(y, y, acc);
      sp = fmax_nan(sp, fabsf(x));
      fir.push(a, x, true, tp);
      if (((j + 1) & ((1 << glog) - 1)) == 0) {
        const int q = j >> glog;                   // <= j: a slot already read
        row[4 * tile_slot(r, q >> 2) + (q & 3)] = acc;
        acc = 0.f;
      }
    }
  }
}

// k3_track_span for the thread of a channel whose 32 samples straddle
// n_valid (one a row in a launch): the samples at or past it masked, and
// the function out of line, so that the kernel's group sizes share one
// copy. Returns (tp, sp).
template <int F, int KP>
__device__ __noinline__ float2 k3_track_span_masked(const TileArgs& a, float4* tile, int r,
                                                    V4 s, int64_t g0, int64_t nv, int glog,
                                                    TileFir<F, KP> fir) {
  float* row = reinterpret_cast<float*>(tile);
  float acc = 0.f, tp = 0.f, sp = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float4 x4 = tile[tile_slot(r, c)];
    const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * c + i;
      const float x = xs[i];
      const float y = step_filter(a.k, s, x);
      const bool valid = g0 + j < nv;
      if (valid) acc = fmaf(y, y, acc);
      sp = fmax_nan(sp, valid ? fabsf(x) : 0.f);
      fir.push(a, x, valid, tp);
      if (((j + 1) & ((1 << glog) - 1)) == 0) {
        const int q = j >> glog;
        row[4 * tile_slot(r, q >> 2) + (q & 3)] = acc;
        acc = 0.f;
      }
    }
  }
  return make_float2(tp, sp);
}

// K3: groups of 2^GLOG samples, or of the launch's group where GLOG < 0
// (the groups other than 1 and 32, which no engine route takes: one
// instance for them). Persistent CTAs of P threads take tickets t =
// (track t mod R, segment t / R), Tc = 32 P / ch samples of each of the
// track's ch channels, from the counter; thread 0 (or the scan's last
// lane out) splits each for the CTA (k3_split). A track is a file's
// channels (ch = wch, 1 or 2) or one row of a file of more (ch = 1, the
// row's weight read at its channel). With the look-back the next ticket
// is taken once this one's records are out, and its copy overlaps the
// refilter (tile_loop at D > 0); a segment that starts at or past its
// file's n_valid is neither copied nor scanned and writes zeros. Each
// thread's group sums of y^2 stay in its tile row; the CTA adds the
// channels of nonzero weight in channel order, w_c0 z_c0 + w_c1 z_c1 in
// fused multiply-adds from 0, and writes its Tc / g entries of z once,
// coalesced. Partial peaks per (row, segment of Tc), for every channel.
template <int F, int KP, int GLOG>
__global__ void __launch_bounds__(K3_THREADS, K3_MINB)
k3_tile_tracks(const __grid_constant__ TrackArgs a) {
  constexpr int P = K3_THREADS;
  const int glog = GLOG >= 0 ? GLOG : __ffsll(a.group) - 1;
  const int plog = 5 - glog;                       // group sums per thread: 2^plog
  // a thread's group sums overwrite chunks 0 .. ((2^plog) - 1) / 4 of its
  // tile row; the next row's FIR reads it as its halo from chunk
  // (TS - (KH - 1)) / 4 on, before its own span: a barrier keeps the two
  // apart where they meet (g = 1 at factor 4, g <= 2 at factor 2)
  const bool halo_barrier =
      F > 1 && ((1 << plog) - 1) / 4 >= (TS - (TileFir<F, KP>::KH - 1)) / 4;
  extern __shared__ float4 tiles[];
  __shared__ int64_t ticket_sh[2][4];
  __shared__ __align__(16) float lp[TS][8];        // a.LP, read by lane
  __shared__ float pk[TILE_MAX_WARPS][2];
  __shared__ int done;
  const int tid = threadIdx.x;
  for (int i = tid; i < TS * 8; i += P) lp[i >> 3][i & 7] = a.LP[i >> 3][i & 7];
  const int llog = a.lanes_log, Lc = 1 << llog;
  const int per = 1 << (llog - 5);                 // warps per channel
  const int64_t Tc = (int64_t)TS << llog;
  const int Q = (int)(Tc >> glog);                 // entries of z per ticket
  const int64_t ng = a.n >> glog;
  const int64_t ntickets = a.R * a.nseg;
  const int cc = tid >> llog;
  const int r = cc * (Lc + 1) + (tid & (Lc - 1)) + 1;
  auto buf = [&](int b) { return tiles + b * 8 * (P + K3_TRACK_CH); };
  auto start_copy = [&](const int64_t* sh, float4* dst) {
    if (sh[1] * Tc < __ldg(a.n_valid + sh[3])) issue_k3_track<P>(dst, a, sh[2], sh[1] * Tc);
    else asm volatile("cp.async.commit_group;\n" ::);
  };
  if (tid == 0) {
    done = 0;
    k3_split(a, atomicAdd(a.sync, 1) + 1, ticket_sh[0]);
  }
  __syncthreads();
  if (ticket_sh[0][0] >= ntickets) return;
  start_copy(ticket_sh[0], buf(0));
  // the CTA's ticket is ticket_sh[b] and its next ticket_sh[b ^ 1], each
  // read from shared memory where it is needed, so that the refilter runs
  // with no ticket held in registers (at the 128 registers that 2 CTAs a SM
  // leave)
  for (int b = 0;; b ^= 1) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    float4* tile = buf(b);
    const int64_t* cur = ticket_sh[b];
    const int64_t* nx = ticket_sh[b ^ 1];
    const int64_t seg = cur[1];
    const int64_t nv = __ldg(a.n_valid + cur[3]);
    const bool skip = seg * Tc >= nv;                   // wholly past n_valid
    V4 entry = {{0.f, 0.f, 0.f, 0.f}};
    if (!skip) {
      entry = k3_track_scan(a, tile, lp, cur[0], seg, nv, &done, ticket_sh[b ^ 1]);
    } else {
      if (tid == 0) k3_split(a, atomicAdd(a.sync, 1) + 1, ticket_sh[b ^ 1]);
      __syncthreads();
    }
    if (nx[0] < ntickets) start_copy(nx, buf(b ^ 1));
    float tp = 0.f, sp = 0.f;
    if (!skip) {
      const int64_t g0 = seg * Tc + (int64_t)TS * (tid & (Lc - 1));
      TileFir<F, KP> fir;
      fir.halo(tile, r);
      if (halo_barrier) __syncthreads();
      if (g0 >= a.n) {                                   // past the row's end: no z entry
      } else if (g0 + TS <= nv) {
        k3_track_span<F, KP>(a, tile, r, entry, glog, fir, tp, sp);
      } else if (g0 < nv) {
        const float2 pk2 = k3_track_span_masked<F, KP>(a, tile, r, entry, g0, nv, glog, fir);
        tp = pk2.x;
        sp = pk2.y;
      } else {                                           // valid samples end before it
        float* row = reinterpret_cast<float*>(tile);
#pragma unroll
        for (int q = 0; q < (1 << plog); ++q) row[4 * tile_slot(r, q >> 2) + (q & 3)] = 0.f;
      }
      warp_peaks(tp, sp, pk);
      __syncthreads();
    }
    // the ticket's outputs: partial peaks per channel, then z
    const int64_t oseg = cur[1], track = cur[2], file = cur[3];
    const int64_t q0 = oseg * Q;
    float* out = a.z + track * ng + q0;
    const int64_t part = track * a.ch * a.nseg + oseg;  // + c nseg: row c of the track
    if (tid < a.ch) {                                    // channel tid's warps
      float m0 = 0.f, m1 = 0.f;
      for (int v = tid * per; !skip && v < (tid + 1) * per; ++v) {
        m0 = fmax_nan(m0, pk[v][0]);
        m1 = fmax_nan(m1, pk[v][1]);
      }
      a.tp_part[part + tid * a.nseg] = m0;
      a.sp_part[part + tid * a.nseg] = m1;
    }
    // the track's channels' weights: rows track ch + c of the file's wch
    const int wb = (int)(track * a.ch - file * a.wch);
    float wt[K3_TRACK_CH];
#pragma unroll
    for (int c = 0; c < K3_TRACK_CH; ++c) wt[c] = c < a.ch && !skip ? a.weights[wb + c] : 0.f;
    const float* zs = reinterpret_cast<const float*>(tile);
    for (int q = tid; q < Q && q0 + q < ng; q += P) {
      const int rq = (q >> plog) + 1, p = q & ((1 << plog) - 1);
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < K3_TRACK_CH; ++c)
        if (wt[c] != 0.f)
          acc = fmaf(wt[c], zs[4 * tile_slot(c * (Lc + 1) + rq, p >> 2) + (p & 3)], acc);
      out[q] = acc;
    }
    if (nx[0] >= ntickets) return;                 // (the next turn's first barrier
  }                                                // orders the refill of this buffer)
}

template <int F, int KP, int GLOG>
cudaError_t launch_k3_tracks(const TrackArgs& a, cudaStream_t st) {
  const size_t smem = k3_track_smem_bytes(K3_THREADS);
  int grid = 0;
  cudaError_t e =
      persistent_grid(k3_tile_tracks<F, KP, GLOG>, K3_THREADS, smem, a.R * a.nseg, &grid);
  if (e != cudaSuccess) return e;
  k3_tile_tracks<F, KP, GLOG><<<grid, K3_THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

// groups of 32 (48 kHz and its family) and 1 (44.1 kHz) in instances of
// their own, any other divisor of 32 through the run-time group
template <int F, int KP>
cudaError_t launch_k3_tracks(const TrackArgs& a, int64_t group, cudaStream_t st) {
  switch (group) {
    case 1: return launch_k3_tracks<F, KP, 0>(a, st);
    case 32: return launch_k3_tracks<F, KP, 5>(a, st);
    default: return launch_k3_tracks<F, KP, -1>(a, st);
  }
}

}  // namespace

// K4 or K5: energy over the rows of nonzero weight, on segments of T
// samples with a look-back of depth `lookback`: TILE_LOOKBACK (K4) or 0
// (K5 with more than two channels of nonzero weight). consts: TileConsts
// as floats, weights ch (host memory). sync: int32 (4 + 8 * R * nseg), all
// bits set, with R = b * (channels of nonzero weight); zr (b*ch, n/group)
// is scratch (the rows of nonzero weight are written); z (b, n/group) is
// written whole. group must divide 32. Returns the first CUDA error of the
// launches, 0 on success.
extern "C" int ss_kweight_energy_rows(
    const float* x, const int64_t* n_valid, const float* consts, const float* weights,
    int64_t b, int ch, int64_t n, int64_t group, int64_t T, int lookback, int* sync, float* zr,
    float* z, void* stream) {
  if (n <= 0 || n % 128 != 0 || ch <= 0 || ch > TILE_MAX_CH || group <= 0 ||
      TS % group != 0 || T % 1024 != 0 || T > TS * 256 ||
      (lookback != TILE_LOOKBACK && lookback != 0))
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
  a.x = x;
  a.n_valid = n_valid;
  a.sync = sync;
  a.n = n;
  a.nseg = (n + T - 1) / T;
  a.ch = ch;
  a.na = cl.n;
  a.L = a.h = a.nsteps = 0;
  a.step_sums = nullptr;
  a.tp_part = a.sp_part = nullptr;
  a.zr = zr;
  a.group = group;
  const int P = (int)(T / TS);
  const int64_t ng = n / group;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSuccess;
  if (cl.n > 0) {
    a.R = b * cl.n;
    e = lookback > 0 ? launch_k5<TILE_LOOKBACK>(a, P, group, st)
                     : launch_k5<0>(a, P, group, st);
  }
  if (e != cudaSuccess) return (int)e;
  channel_sum<<<blocks_for(b * ng), THREADS, 0, st>>>(zr, cl, b, ch, ng, z);
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

// K3 (factor 2 or 4: energy and peaks) on k3_tile_tracks. Files of one or
// two channels: tickets of one file's segment, Tc = 8192 / ch samples of
// each channel (ops/iir.py:k3_segment), in one tile of 256 threads, z
// written by the same launch. Files of more channels: tickets of one
// row's segment of Tc = 8192, each row's weighted group sums written to
// zr, then channel_sum. Then peaks_pass over the partial peaks per (row,
// segment of Tc). consts: TileConsts at Tc, lanes A^(32 l) for l < 32 as
// 2x2 blocks (32 x 8, ops/iir_tile.py:lane_powers), taps F x KP, weights
// ch (all host memory). sync: int32 (4 + 8 * b * ch * nseg), all bits
// set, nseg = ceil(n / Tc); zr (b*ch, n/group) is scratch for more than
// two channels (else unused); z (b, n/group) is written whole; tp_part,
// sp_part (b*ch, nseg), tp, sp (b*ch). group must divide 32. Returns the
// first CUDA error of the launches, 0 on success.
extern "C" int ss_kweight_energy_tp_tracks(
    const float* x, const int64_t* n_valid, const float* consts, const float* lanes,
    const float* taps, const float* weights, int factor, int64_t b, int ch, int64_t n,
    int64_t group, int64_t Tc, int* sync, float* zr, float* z, float* tp_part, float* sp_part,
    float* tp, float* sp, void* stream) {
  const bool tracks = ch <= K3_TRACK_CH;
  if ((factor != 2 && factor != 4) || n <= 0 || n % 128 != 0 || ch < 1 || ch > TILE_MAX_CH ||
      group <= 0 || TS % group != 0 || Tc * (tracks ? ch : 1) != (int64_t)TS * K3_THREADS ||
      (!tracks && zr == nullptr))
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  TrackArgs a;
  memcpy(&a.k, consts, sizeof(TileConsts));
  memcpy(a.LP, lanes, sizeof(a.LP));
  memset(a.taps, 0, sizeof(a.taps));
  const int KP = factor == 4 ? 13 : 25;
  memcpy(a.taps, taps, sizeof(float) * factor * KP);
  ChanList cl;
  cl.n = 0;
  for (int c = 0; c < ch; ++c) {
    a.weights[c] = weights[c];
    if (weights[c] != 0.f) cl.c[cl.n++] = c;
  }
  a.na = 0;
  a.x = x;
  a.n_valid = n_valid;
  a.sync = sync;
  a.n = n;
  a.nseg = (n + Tc - 1) / Tc;
  a.R = tracks ? b : b * ch;
  a.ch = tracks ? ch : 1;
  a.wch = ch;
  a.L = a.h = a.nsteps = 0;
  a.step_sums = a.zr = nullptr;
  a.tp_part = tp_part;
  a.sp_part = sp_part;
  a.group = group;
  a.lanes_log = 0;
  while ((TS << a.lanes_log) < Tc) ++a.lanes_log;
  a.z = tracks ? z : zr;
  a.skipped = nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = factor == 4 ? launch_k3_tracks<4, 13>(a, group, st)
                              : launch_k3_tracks<2, 25>(a, group, st);
  if (e != cudaSuccess) return (int)e;
  if (!tracks) {
    const int64_t ng = n / group;
    channel_sum<<<blocks_for(b * ng), THREADS, 0, st>>>(zr, cl, b, ch, ng, z);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  peaks_pass<<<blocks_for(b * ch * 32), THREADS, 0, st>>>(b * ch, a.nseg, tp_part, sp_part,
                                                          tp, sp);
  return (int)cudaGetLastError();
}

// out[6]: registers, static smem, dynamic smem, local (spill) bytes per
// thread, threads, CTAs per SM of k3_tile_tracks (factor 2, 4, groups of
// 32) or, at groups of 32, k5_tile (factor 0 with a look-back: K4;
// without: K5 on row tickets) or k5_tile_tracks (factor 0, no look-back,
// tracks: K5 on track tickets) at this tile.
extern "C" int ss_kweight_energy_rows_attrs(int factor, int64_t T, int lookback, int tracks,
                                            int* out) {
  const int P = (int)(T / TS);
  const size_t k3_smem = k3_track_smem_bytes(P);
  if (factor == 4) kernel_attrs(k3_tile_tracks<4, 13, 5>, P, out, k3_smem);
  else if (factor == 2) kernel_attrs(k3_tile_tracks<2, 25, 5>, P, out, k3_smem);
  else if (lookback > 0) kernel_attrs(k5_tile<5, TILE_LOOKBACK>, P, out);
  else if (tracks) kernel_attrs(k5_tile_tracks<5>, P, out);
  else kernel_attrs(k5_tile<5, 0>, P, out);
  return (int)cudaGetLastError();
}
