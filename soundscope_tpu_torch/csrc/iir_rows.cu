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
// K5 ("chain", ss_kweight_energy_chain): one thread per row carries the
// 4-state sample by sample through the whole row, as the TPU kernel
// carries it block by block, and writes its row's group sums to zr
// (b*ch, N/g); a second pass adds the channels in order into z. It reads
// the input once and has no prefix pass, but its parallelism is one thread
// per row.
//
// Bound on the H100: device-memory reads of the input (K3/K4 read it
// twice, K5 once) and, in K5, the serial chain of about 20 dependent FMA
// latencies per sample. Each thread streams its own contiguous span
// (stream_samples keeps the next 128 bytes in flight).

#include "iir_common.cuh"

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

__global__ void __launch_bounds__(THREADS)
chain_rows(const float* __restrict__ x, const int64_t* __restrict__ n_valid,
           const float* __restrict__ coef, const float* __restrict__ weights,
           int64_t rows, int ch, int64_t n, int64_t g, float* __restrict__ zr) {
  const int64_t row = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const float w = __ldg(weights + row % ch);
  if (w == 0.f) return;          // the channel sum never reads this row
  const int64_t nv = __ldg(n_valid + row / ch);
  Filter f;
  load_filter(coef, f);
  float s[NS] = {0.f, 0.f, 0.f, 0.f};
  float* zo = zr + row * (n / g);
  double acc = 0.0;
  int64_t k = 0, gi = 0;
  stream_samples(x + row * n, 0, n, [&](int64_t gs, float xv) {
    const float y = output(f, s, xv);
    advance(f, s, xv);
    acc += gs < nv ? (double)(w * (y * y)) : 0.0;
    if (++k == g) {
      zo[gi] = (float)acc;
      ++gi;
      acc = 0.0;
      k = 0;
    }
  });
}

// z[track, i] = (0 + zr[c0]) + zr[c1] + ... over the channels of nonzero
// weight, in channel order (the order rows_correct adds them in)
__global__ void __launch_bounds__(THREADS)
channel_sum(const float* __restrict__ zr, const float* __restrict__ weights,
            int64_t b, int ch, int64_t ng, float* __restrict__ z) {
  const int64_t t = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (t >= b * ng) return;
  const int64_t track = t / ng;
  const int64_t i = t - track * ng;
  float acc = 0.f;
  for (int c = 0; c < ch; ++c)
    if (__ldg(weights + c) != 0.f) acc += zr[(track * ch + c) * ng + i];
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

// K5. zr (b*ch, n/group) is scratch; z (b, n/group) is written whole.
extern "C" int ss_kweight_energy_chain(
    const float* x, const int64_t* n_valid, const float* coef,
    const float* weights, int64_t b, int ch, int64_t n, int64_t group,
    float* zr, float* z, void* stream) {
  if (n <= 0 || n % 128 != 0 || ch <= 0 || group <= 0 || n % group != 0)
    return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  const int64_t rows = b * ch;
  const int64_t ng = n / group;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;

  chain_rows<<<blocks_for(rows), THREADS, 0, st>>>(x, n_valid, coef, weights,
                                                   rows, ch, n, group, zr);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  channel_sum<<<blocks_for(b * ng), THREADS, 0, st>>>(zr, weights, b, ch, ng, z);
  return (int)cudaGetLastError();
}
