"""K1: fused K-weighting energy + true peak over the frames view.

Replaces the TPU kernel ``soundscope_tpu/ops/pallas_iir_chunked.py:
kweight_energy_tp_chunked`` (body ``_chunked_kernel_factory``). The input
is the engine's canonical (b, ch, N/128, 128) frames view; rows = b*ch
signals of n = N samples each. Per row the kernel computes

* the K-weighted signal y (the 4-state cascade in its modal realisation),
* z = w_ch * y^2, masked at n_valid, summed per STEP of L samples into the
  energy before the step's one 100 ms boundary and the energy from it on
  (L = 128 * 2^k <= h, so a step holds at most one boundary, which is what
  `subblock_sums_from_steps` needs to rebuild exact sub-block sums at any
  rate, 44.1 kHz included). Each part is a sum of its own samples: the
  JAX kernel's (total, left) leaves the right part to `total - left`,
  which loses a quiet part beside a loud one to float32 cancellation,
  a few hundredths of an LU near the -70 LUFS gate,
* the 49-tap polyphase true peak (4x below 96 kHz, 2x below 192 kHz) and
  the sample peak, both masked at n_valid; true peak = max(tp, sp).

The TPU kernel walks its grid in order and carries the filter state, the
previous chunk and running maxima in VMEM. CUDA blocks run in no order;
csrc/iir_chunked.cu runs the tile-scan core of csrc/iir_tile.cuh (host
side: ops/iir_tile.py) in one launch that reads the input once:

* a CTA per segment of T = max(L, 8192) samples of a row copies it, with
  the FIR's halo, into shared memory; each thread's zero-state end state
  over its 32 samples is a matrix product (W = A^(31-k) B from float64),
  the CTA scans those in a fixed order (Kogge-Stone in the warp, warps in
  series), waits for the previous segment's inclusive end state and
  publishes its own (segments are handed out by a ticket counter, so the
  chain cannot deadlock and every run gives the same bits);
* each thread then refilters its 32 samples from its entry state, sums
  z = w_ch * y^2 masked at n_valid in float32 into the parts before and
  from the step's boundary, and runs the FIR over the same samples
  and the halo; the step sums are added in a fixed order in float64, the
  partial peaks per (row, segment) reduced by a deterministic max pass.

What bounds it on the H100: operations. The function needs 104 float32
operations per sample at 4x against one 4-byte read: the FIR's 36 FMAs
(phase 0 of the interpolator is an impulse, whose outputs the sample peak
covers, and the other phases' last tap is zero), the filter's 5
multiplies and 12 FMAs, and the energy. The kernel issues about 70
instructions per sample: those, the 4 FMAs of the matrix-form zero state
and the peaks. The design keeps everything else off the per-sample path:
conflict-free 16-byte shared-memory reads, constants as kernel
parameters, a mask-free path for spans wholly valid and uncut, and one
4x4 product per segment on the chain. On an H100 SXM at the bench shape,
(32, 2, 22496, 128), it takes about 0.85 ms, 2.9x its bound; the
previous design, one thread per (row, step) sample by sample with two
reads of the input, took about 1.9 ms.

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
from soundscope_tpu_torch.core.device import upload
from soundscope_tpu_torch.ops import iir_tile
from soundscope_tpu_torch.ops.biquad import BlockFilter, block_iir
from soundscope_tpu_torch.ops.truepeak import true_peak_masked
from soundscope_tpu_torch.utils.metrics import GLOBAL


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
        [torch.where(before, z, 0.0).sum(dim=-1), torch.where(before, 0.0, z).sum(dim=-1)],
        dim=-1)
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
    step_sums[..., 0] = the step's channel-weighted K-energy before its
    100 ms boundary, [..., 1] = the part from the boundary on. Feed to
    `subblock_sums_from_steps` for exact h-sample sub-block sums. Counts
    `k1.steps` (rows * steps) in the registry, on either device.
    """
    b, ch, n = _check(x4, weights)
    if x4.device.type not in ("cpu", "cuda"):
        raise ValueError(f"K1 runs on CPU or CUDA tensors, not {x4.device}")
    L = step_length(n, h)
    GLOBAL.count("k1.steps", b * ch * (n // L))
    if x4.device.type == "cpu":
        return kweight_energy_tp_chunked_plain(filt, x4, n_valid, weights,
                                               rate, h)
    if not x4.is_contiguous():
        raise ValueError("x4 must be contiguous")
    if not iir_tile.modal_filter(filt):
        raise ValueError("K1 is built for the 4-state K-weighting cascade")
    if ch > iir_tile.MAX_CH:
        raise ValueError(f"K1 takes at most {iir_tile.MAX_CH} channels, got {ch}")
    rows = b * ch
    T = tile_length(L)
    nseg = -(-n // T)
    factor = C.true_peak_factor(rate)
    dev = x4.device
    f32 = dict(dtype=torch.float32, device=dev)
    consts = iir_tile.tile_constants(filt, T)
    taps = iir_tile.fir_taps(factor)
    w = np.asarray(weights, np.float32)
    nv = n_valid.to(dev, torch.int64).contiguous()
    if nv.shape != (b,):
        raise ValueError(f"n_valid must be ({b},), got {tuple(nv.shape)}")
    sync = iir_tile.sync_buffer(rows, nseg, dev)
    tp_part = torch.empty((rows, nseg), **f32)
    sp_part = torch.empty((rows, nseg), **f32)
    step_sums = torch.empty((rows, n // L, 2), **f32)
    tp = torch.empty((rows,), **f32)
    sp = torch.empty((rows,), **f32)

    from soundscope_tpu_torch.ops import _build

    _build.launch("ss_kweight_energy_tp", "K1 kweight_energy_tp", dev,
                  x4.data_ptr(), nv.data_ptr(), consts.ctypes.data, taps.ctypes.data,
                  w.ctypes.data, factor,
                  rows, ch, n, L, h, T, sync.data_ptr(), step_sums.data_ptr(),
                  tp_part.data_ptr(), sp_part.data_ptr(), tp.data_ptr(), sp.data_ptr())
    return step_sums, tp, sp


def tile_length(L: int) -> int:
    """K1's segment: T = max(L, 8192) samples, a multiple of the step L."""
    T = max(L, 8192)
    if T > iir_tile.TS * 32 * iir_tile.MAX_WARPS:
        raise ValueError(f"K1 takes steps of at most 16384 samples, got {L}")
    return T


def kernel_attributes(factor: int = 4, T: int = 8192) -> dict:
    """K1's resources as the CUDA runtime reports them (needs a card):
    registers per thread, static and dynamic shared memory bytes per CTA,
    local (spill) bytes per thread, threads per CTA and CTAs per SM."""
    from soundscope_tpu_torch.ops import _build

    return _build.attributes("ss_kweight_energy_tp_attrs", factor, T)


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


@functools.lru_cache(maxsize=64)
def _device_plan(n: int, h: int, span: int, device: torch.device):
    """The gather plan on `device`, uploaded once without a host sync."""
    return tuple(upload(a, device) for a in _subblock_gather_plan(n, h, span))


def subblock_sums_from_steps(step_sums: torch.Tensor, h: int, span: int,
                             n: int) -> torch.Tensor:
    """Exact h-sample sub-block sums from K1's per-step outputs.

    step_sums: (..., nsteps, 2) with [..., 0] = energy before the step's
    unique 100 ms boundary, [..., 1] = energy from it on (requires h >=
    span). Returns (..., n // h) float32: the right part of a sub-block's
    first step, the whole steps after it and the left part of its last
    step, added in float64 and rounded to float32 once. No part is a
    difference of float32 sums, and the running sum over steps is taken in
    float64, so long tracks lose no precision to its differences.
    """
    left = step_sums[..., 0].double()
    right = step_sums[..., 1].double()
    s0, s1, s1c, ok = _device_plan(n, h, span, step_sums.device)
    cum = torch.cumsum(left + right, dim=-1)
    cum = torch.cat([torch.zeros_like(cum[..., :1]), cum], dim=-1)
    mid = cum[..., s1] - cum[..., s0 + 1]
    return (right[..., s0] + mid + left[..., s1c] * ok).float()
