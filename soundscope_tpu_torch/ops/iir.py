"""K3, K4, K5: K-weighted energy over the rows layout.

The counterpart of the JAX package's ``ops/pallas_iir.py``. Each entry
takes the K-weighting `BlockFilter`, x as (b, ch, N) or as rows (b*ch, N)
(channel-minor: the same memory), the tracks' valid lengths n_valid (b,),
the ch channel weights and a group g dividing N, and returns

    z (b, N/g): sum over each group of g samples of
                mask(i < n_valid) * sum_c w_c * y_c[i]^2,

the channel-weighted squared K-weighted signal, masked at sample
granularity before the group sums. Channels of weight 0 (the 5.1 LFE)
contribute nothing.

* `kweight_energy_tp_prefix` (K3, replaces `kweight_energy_tp_pallas_prefix`,
  pallas_call at ``pallas_iir.py:577``) also returns the BS.1770 true peak
  and sample peak per row, tp = max(tp, sp); the FIR context is the masked
  previous samples and its outputs at positions >= n_valid do not count.
* `kweight_energy_prefix` (K4, replaces `kweight_energy_pallas_prefix`,
  ``pallas_iir.py:500``) is K3 without the peaks.
* `kweight_energy_chain` (K5, replaces `kweight_energy_pallas`,
  ``pallas_iir.py:308``) computes K4's z with a sequential schedule.

On the card (csrc/iir_rows.cu) K3 and K4 reuse K1's split-time passes over
steps of `span_length(N)` samples, with a correction pass that adds the
channels' group sums into z in channel order; K5 carries the state sample
by sample, one thread per row, and adds the channels in a second pass. See
that file for the design and what bounds it.

Each entry launches its kernel on a CUDA tensor and runs its `*_plain`
version on a CPU tensor; any other device raises. The plain versions are
the port's blocked filter (ops/biquad.block_iir) and true_peak_masked.
"""

from __future__ import annotations

import numpy as np
import torch

from soundscope_tpu_torch.core import constants as C
from soundscope_tpu_torch.ops.biquad import BlockFilter, block_iir
from soundscope_tpu_torch.ops.truepeak import _polyphase_taps, true_peak_masked

# kernel launches (one per call of an entry on CUDA)
LAUNCHES = {"K3": 0, "K4": 0, "K5": 0}

# longest step of the split-time kernels (K3, K4) and of K6's spans
MAX_SPAN = 4096


def span_length(n: int, cap: int = MAX_SPAN) -> int:
    """The largest L = 128 * k <= cap with L | n: the step of K3/K4 and the
    span of K6 (3200 at 15 s of 48 kHz, 4096 at a power-of-two bucket)."""
    if n % 128 or n <= 0:
        raise ValueError(f"the kernels need N a positive multiple of 128, got {n}")
    m = n // 128
    return 128 * max(k for k in range(1, cap // 128 + 1) if m % k == 0)


def rows_shape(x: torch.Tensor, weights) -> tuple[int, int, int]:
    """(b, ch, N) of a (b, ch, N) or rows (b*ch, N) float32 input."""
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    ch = len(weights)
    if x.ndim == 3:
        b, c, n = x.shape
        if c != ch:
            raise ValueError(f"{ch} channel weights for {c} channels")
    elif x.ndim == 2:
        if ch == 0 or x.shape[0] % ch:
            raise ValueError(f"{x.shape[0]} rows are not tracks of {ch} channels")
        b, n = x.shape[0] // ch, x.shape[1]
    else:
        raise ValueError(f"x must be (b, ch, N) or (b*ch, N), got {tuple(x.shape)}")
    return b, ch, n


def _energy_plain(filt: BlockFilter, x, n_valid, weights, group):
    b, ch, n = rows_shape(x, weights)
    if group <= 0 or n % group:
        raise ValueError(f"group {group} does not divide N = {n}")
    dev = x.device
    filt = filt.to(dev)
    x3 = x.reshape(b, ch, n)
    y, _ = block_iir(filt, x3, x3.new_zeros((b, ch, filt.A.shape[0])))
    z = x3.new_zeros((b, n))
    for c, w in enumerate(weights):
        if float(w) != 0.0:
            z = z + float(w) * (y[:, c] * y[:, c])
    valid = torch.arange(n, device=dev)[None] < n_valid.to(dev, torch.int64)[:, None]
    z = torch.where(valid, z, 0.0)
    return z.reshape(b, n // group, group).sum(dim=-1) if group > 1 else z


def kweight_energy_prefix_plain(filt: BlockFilter, x, n_valid, weights, group=1):
    """Plain PyTorch version of K4 (and K5): block_iir, the channel-weighted
    square in channel order, the mask, then the group sums."""
    return _energy_plain(filt, x, n_valid, weights, group)


def kweight_energy_chain_plain(filt: BlockFilter, x, n_valid, weights, group=1):
    """Plain PyTorch version of K5: the same function as K4's."""
    return _energy_plain(filt, x, n_valid, weights, group)


def kweight_energy_tp_prefix_plain(filt: BlockFilter, x, n_valid, weights,
                                   rate: int, group=1):
    """Plain PyTorch version of K3: K4's z plus true_peak_masked per row."""
    z = _energy_plain(filt, x, n_valid, weights, group)
    b, ch, n = rows_shape(x, weights)
    nv = n_valid.to(x.device, torch.int64).repeat_interleave(ch)
    tp, sp = true_peak_masked(x.reshape(b * ch, n), nv[:, None], rate)
    return z, tp, sp


def _launchable(filt: BlockFilter, x, n_valid, weights, what: str):
    """Check a CUDA input; returns (b, ch, n, nv int64 (b,))."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on CPU or CUDA tensors, not {x.device}")
    b, ch, n = rows_shape(x, weights)
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what}: x must be contiguous and 16-byte aligned")
    if n % 128:
        raise ValueError(f"{what}: N must be a multiple of 128, got {n}")
    if filt.A.shape != (4, 4):
        raise ValueError(f"{what} is built for the 4-state K-weighting cascade")
    nv = n_valid.to(x.device, torch.int64).contiguous()
    if nv.shape != (b,):
        raise ValueError(f"n_valid must be ({b},), got {tuple(nv.shape)}")
    return b, ch, n, nv


def _coef(filt: BlockFilter, steps: int, dev) -> torch.Tensor:
    """The kernels' float32 constants: A, B, C, D and A^steps."""
    return torch.from_numpy(np.concatenate([
        filt.A.reshape(-1), filt.Bv, filt.Cv, [filt.D],
        filt.power(steps).reshape(-1)]).astype(np.float32)).to(dev)


def _rows_kernel(filt, x, n_valid, weights, group, factor, what):
    """Launch ss_kweight_energy_rows: factor 0 is K4, 2 or 4 is K3."""
    b, ch, n, nv = _launchable(filt, x, n_valid, weights, what)
    L = span_length(n)
    if group <= 0 or L % group:
        raise ValueError(f"{what}: group {group} does not divide the step {L}")
    rows, nsteps = b * ch, n // L
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    coef = _coef(filt, L, dev)
    taps = torch.from_numpy(_polyphase_taps(factor).reshape(-1) if factor
                            else np.zeros(1, np.float32)).to(dev)
    w = torch.tensor([float(v) for v in weights], **f32)
    s_final = torch.empty((rows, nsteps, 4), **f32)
    s_entry = torch.empty((rows, nsteps, 4), **f32)
    z = torch.zeros((b, n // group), **f32)
    peaks = [torch.empty(s, **f32) for s in
             ((rows, nsteps), (rows, nsteps), (rows,), (rows,))] if factor else [None] * 4
    tp_part, sp_part, tp, sp = peaks

    from soundscope_tpu_torch.ops import _build

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.ss_kweight_energy_rows(
            x.data_ptr(), nv.data_ptr(), coef.data_ptr(), w.data_ptr(),
            taps.data_ptr(), factor, b, ch, n, L, group, s_final.data_ptr(),
            s_entry.data_ptr(), z.data_ptr(), ptr(tp_part), ptr(sp_part),
            ptr(tp), ptr(sp), torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on_error(lib, err, what)
    return z, tp, sp


def kweight_energy_tp_prefix(filt: BlockFilter, x: torch.Tensor,
                             n_valid: torch.Tensor, weights, rate: int,
                             group: int = 1):
    """Energy + true/sample peak (K3; JAX: kweight_energy_tp_pallas_prefix).

    x: (b, ch, N) or (b*ch, N) float32, N % 128 == 0 on CUDA. n_valid: (b,)
    integer valid lengths. weights: the ch channel weights. rate: the
    sample rate, which must need oversampling (< 192 kHz). Returns
    (z (b, N/group), tp (rows,), sp (rows,)).
    """
    factor = C.true_peak_factor(rate)
    if factor == 1:
        raise ValueError("K3 needs an oversampling true-peak factor (rate < 192 kHz)")
    if x.device.type == "cpu":
        return kweight_energy_tp_prefix_plain(filt, x, n_valid, weights, rate, group)
    out = _rows_kernel(filt, x, n_valid, weights, group, factor,
                       "K3 kweight_energy_tp_prefix")
    LAUNCHES["K3"] += 1
    return out


def kweight_energy_prefix(filt: BlockFilter, x: torch.Tensor,
                          n_valid: torch.Tensor, weights, group: int = 1):
    """Energy (K4; JAX: kweight_energy_pallas_prefix): z (b, N/group)."""
    if x.device.type == "cpu":
        return kweight_energy_prefix_plain(filt, x, n_valid, weights, group)
    z, _, _ = _rows_kernel(filt, x, n_valid, weights, group, 0,
                           "K4 kweight_energy_prefix")
    LAUNCHES["K4"] += 1
    return z


def kweight_energy_chain(filt: BlockFilter, x: torch.Tensor,
                         n_valid: torch.Tensor, weights, group: int = 1):
    """Energy (K5; JAX: kweight_energy_pallas) on the sequential schedule:
    one carried state per row. Same arguments and result as
    `kweight_energy_prefix`."""
    what = "K5 kweight_energy_chain"
    if x.device.type == "cpu":
        return kweight_energy_chain_plain(filt, x, n_valid, weights, group)
    b, ch, n, nv = _launchable(filt, x, n_valid, weights, what)
    if group <= 0 or n % group:
        raise ValueError(f"{what}: group {group} does not divide N = {n}")
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    coef = _coef(filt, 1, dev)
    w = torch.tensor([float(v) for v in weights], **f32)
    zr = torch.empty((b * ch, n // group), **f32)
    z = torch.empty((b, n // group), **f32)

    from soundscope_tpu_torch.ops import _build

    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.ss_kweight_energy_chain(
            x.data_ptr(), nv.data_ptr(), coef.data_ptr(), w.data_ptr(), b, ch,
            n, group, zr.data_ptr(), z.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on_error(lib, err, what)
    LAUNCHES["K5"] += 1
    return z
