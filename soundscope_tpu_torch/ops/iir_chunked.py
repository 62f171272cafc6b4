"""K1: fused K-weighting energy + true peak over the frames view.

Replaces the TPU kernel ``soundscope_tpu/ops/pallas_iir_chunked.py:
kweight_energy_tp_chunked`` (body ``_chunked_kernel_factory``). The input
is the engine's canonical (b, ch, N/128, 128) frames view; rows = b*ch
signals of n = N samples each. Per row the kernel computes

* the K-weighted signal y (the 4-state cascade in its modal realisation),
* z = w_ch * y^2, masked at n_valid, summed per STEP of L samples into the
  step total and the energy before the step's one 100 ms boundary
  (L = 128 * 2^k <= h, so a step holds at most one boundary, which is what
  `subblock_sums_from_steps` needs to rebuild exact sub-block sums at any
  rate, 44.1 kHz included),
* the 49-tap polyphase true peak (4x below 96 kHz, 2x below 192 kHz) and
  the sample peak, both masked at n_valid; true peak = max(tp, sp).

The TPU kernel walks its grid in order and carries the filter state, the
previous chunk and running maxima in VMEM. CUDA blocks run in no order,
so csrc/iir_chunked.cu splits time instead, in three passes:

1. zero-state pass, one thread per (row, step): the final state of the
   step's samples filtered from a zero state;
2. prefix pass, one thread per row: s_entry[j+1] = A^L s_entry[j] +
   s_final0[j], with A^L built on the host in float64;
3. correction pass, one thread per (row, step): refilter from s_entry[j],
   accumulate the two energies (float64, fixed order, no atomics) and run
   the FIR over the same samples with a halo of K-1 raw samples (12 at
   4x, 24 at 2x) before the span; per-(row, step) partial peaks are then
   reduced per row by a fourth, deterministic max pass.

What bounds it on the H100: device-memory reads of the input, twice (pass
1 and pass 3, 737 MB each at 32 x 60 s of 48 kHz stereo), with one
strided stream per thread; the FIR's 52 FMAs per sample at 4x come next.
The design keeps every intermediate per (row, step) — a few floats —
so the only large traffic is the two input reads.

Every sample offset is int64: a 15-minute bucket pads to 2^26 samples and
128 rows of it pass 2^31.

`kweight_energy_tp_chunked` launches the kernel on a CUDA tensor and runs
`kweight_energy_tp_chunked_plain` on a CPU tensor; any other device
raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from soundscope_tpu_torch.core import constants as C
from soundscope_tpu_torch.ops.biquad import BlockFilter, block_iir
from soundscope_tpu_torch.ops.truepeak import _polyphase_taps, true_peak_masked

# kernel launches (one per call of kweight_energy_tp_chunked on CUDA)
LAUNCHES = 0


def step_length(n: int, h: int) -> int:
    """The largest step L = 128 * 2^k with L <= h and L | n."""
    if n % 128 or n <= 0:
        raise ValueError(f"frames view needs N a positive multiple of 128, got {n}")
    if h < 128:
        raise ValueError(
            f"the frames path needs a 100 ms sub-block of >= 128 samples, got {h}")
    L = 128
    while 2 * L <= h and n % (2 * L) == 0:
        L *= 2
    return L


def _check(x4: torch.Tensor, weights) -> tuple[int, int, int]:
    if x4.ndim != 4 or x4.shape[-1] != 128:
        raise ValueError(f"x4 must be (b, ch, N/128, 128), got {tuple(x4.shape)}")
    if x4.dtype != torch.float32:
        raise TypeError(f"x4 must be float32, got {x4.dtype}")
    b, ch, nc, _ = x4.shape
    if len(weights) != ch:
        raise ValueError(f"{len(weights)} channel weights for {ch} channels")
    return b, ch, nc * 128


def kweight_energy_tp_chunked_plain(filt: BlockFilter, x4: torch.Tensor,
                                    n_valid: torch.Tensor, weights, rate: int,
                                    h: int):
    """Plain PyTorch version of K1: block_iir, masked weighted square,
    exact step sums and true_peak_masked. Same arguments and results as
    `kweight_energy_tp_chunked`."""
    b, ch, n = _check(x4, weights)
    rows = b * ch
    L = step_length(n, h)
    nsteps = n // L
    dev = x4.device
    filt = filt.to(dev)
    x = x4.reshape(rows, n)
    nv = n_valid.to(dev, torch.int64).repeat_interleave(ch)          # (rows,)
    y, _ = block_iir(filt, x, x.new_zeros((rows, filt.A.shape[0])))
    w = torch.tensor(weights, dtype=torch.float32, device=dev).repeat(b)
    valid = torch.arange(n, device=dev)[None] < nv[:, None]
    z = torch.where(valid, y * y * w[:, None], 0.0).reshape(rows, nsteps, L)
    start = np.arange(nsteps, dtype=np.int64) * L
    bound = np.minimum(-(-start // h) * h, start + L)
    before = torch.arange(L, device=dev)[None] < torch.from_numpy(
        bound - start).to(dev)[:, None]                               # (nsteps, L)
    step_sums = torch.stack(
        [z.sum(dim=-1), torch.where(before, z, 0.0).sum(dim=-1)], dim=-1)
    tp, sp = true_peak_masked(x, nv[:, None], rate)
    return step_sums, tp, sp


def kweight_energy_tp_chunked(filt: BlockFilter, x4: torch.Tensor,
                              n_valid: torch.Tensor, weights, rate: int,
                              h: int):
    """Fused energy + true/sample peak over the frames view (K1).

    x4: (b, ch, N/128, 128) float32, contiguous. n_valid: (b,) integer
    valid lengths. weights: the ch channel weights. h: the 100 ms sub-block
    length (cfg.subblock). filt: the K-weighting BlockFilter.

    Returns (step_sums (rows, nsteps, 2), tp (rows,), sp (rows,)) with
    rows = b*ch and steps of `step_length(N, h)` samples:
    step_sums[..., 0] = the step's total channel-weighted K-energy,
    [..., 1] = the part before the step's 100 ms boundary. Feed to
    `subblock_sums_from_steps` for exact h-sample sub-block sums.
    """
    global LAUNCHES
    if x4.device.type == "cpu":
        return kweight_energy_tp_chunked_plain(filt, x4, n_valid, weights,
                                               rate, h)
    if x4.device.type != "cuda":
        raise ValueError(f"K1 runs on CPU or CUDA tensors, not {x4.device}")
    b, ch, n = _check(x4, weights)
    if not x4.is_contiguous():
        raise ValueError("x4 must be contiguous")
    if filt.A.shape != (4, 4):
        raise ValueError("K1 is built for the 4-state K-weighting cascade")
    rows = b * ch
    L = step_length(n, h)
    nsteps = n // L
    factor = C.true_peak_factor(rate)
    dev = x4.device
    f32 = dict(dtype=torch.float32, device=dev)
    coef = filt.constants(L, dev)
    taps = torch.from_numpy(
        _polyphase_taps(factor).reshape(-1) if factor > 1
        else np.zeros(1, np.float32)).to(dev)
    w = torch.tensor(weights, **f32)
    nv = n_valid.to(dev, torch.int64).contiguous()
    if nv.shape != (b,):
        raise ValueError(f"n_valid must be ({b},), got {tuple(nv.shape)}")
    s_final = torch.empty((rows, nsteps, 4), **f32)
    s_entry = torch.empty((rows, nsteps, 4), **f32)
    tp_part = torch.empty((rows, nsteps), **f32)
    sp_part = torch.empty((rows, nsteps), **f32)
    step_sums = torch.empty((rows, nsteps, 2), **f32)
    tp = torch.empty((rows,), **f32)
    sp = torch.empty((rows,), **f32)

    from soundscope_tpu_torch.ops import _build

    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.ss_kweight_energy_tp(
            x4.data_ptr(), nv.data_ptr(), coef.data_ptr(), w.data_ptr(),
            taps.data_ptr(), factor, rows, ch, n, L, h,
            s_final.data_ptr(), s_entry.data_ptr(), step_sums.data_ptr(),
            tp_part.data_ptr(), sp_part.data_ptr(), tp.data_ptr(),
            sp.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on_error(lib, err, "K1 kweight_energy_tp")
    LAUNCHES += 1
    return step_sums, tp, sp


@functools.lru_cache(maxsize=None)
def _subblock_gather_plan(n: int, h: int, span: int):
    """Static gather indices decomposing each complete h-sample sub-block
    into (right part of its first step) + (full middle steps) + (left
    part of its last step). NumPy, so the cache holds no device memory."""
    nb = n // h
    nsteps = n // span
    k = np.arange(nb, dtype=np.int64)
    s0 = k * h // span
    s1 = (k + 1) * h // span
    # s1 == nsteps happens when the sub-block ends exactly at the stream
    # end: the "middle" then includes the FINAL step (cum[nsteps] is a
    # valid index) and there is no partial last step.
    last_ok = s1 < nsteps
    s1c = np.minimum(s1, nsteps - 1)
    return s0, s1, s1c, last_ok.astype(np.float32)


def subblock_sums_from_steps(step_sums: torch.Tensor, h: int, span: int,
                             n: int) -> torch.Tensor:
    """Exact h-sample sub-block sums from K1's per-step outputs.

    step_sums: (..., nsteps, 2) with [..., 0] = step total, [..., 1] =
    energy before the step's unique 100 ms boundary (requires h >= span).
    Returns (..., n // h). The running sum over steps is taken in float64,
    so long tracks lose no precision to the cumulative-sum differences.
    """
    full = step_sums[..., 0]
    left = step_sums[..., 1]
    dev = step_sums.device
    s0, s1, s1c, ok = (torch.from_numpy(a).to(dev)
                       for a in _subblock_gather_plan(n, h, span))
    cum = torch.cumsum(full.double(), dim=-1)
    cum = torch.cat([torch.zeros_like(cum[..., :1]), cum], dim=-1)
    right0 = full[..., s0] - left[..., s0]
    mid = (cum[..., s1] - cum[..., s0 + 1]).float()
    return right0 + mid + left[..., s1c] * ok

