"""BS.1770-4 / EBU R128 loudness math: block energies, gating, LRA.

Batchable functions over the channel-weighted squared K-weighted signal
z[n] = sum_ch w_ch * y_ch[n]^2. Block energies are windowed means of z;
loudness is -0.691 + 10*log10(energy).

Gating (BS.1770-4 §4): 400 ms blocks at 100 ms hop; absolute gate at
-70 LUFS; relative gate 10 LU below the mean of absolutely-gated blocks;
integrated loudness is the mean energy of blocks passing both gates.

Loudness range (EBU Tech 3342): 3 s blocks at 1 s hop; absolute gate
-70 LUFS; relative gate 20 LU below; LRA = l(95th) - l(10th percentile).

These are the exact-mode functions of the JAX package's ops/loudness.py
that the whole-file engine uses; every function takes an optional
validity mask.
"""

from __future__ import annotations

import torch

from soundscope_tpu_torch.core import constants as C

_ABS_GATE_ENERGY = float(10.0 ** ((C.ABSOLUTE_GATE_LUFS - C.LOUDNESS_OFFSET_DB) / 10.0))
NEG_INF = float("-inf")


def loudness_from_energy(e: torch.Tensor) -> torch.Tensor:
    """L = -0.691 + 10*log10(e), with e <= 0 mapping to -inf."""
    return torch.where(
        e > 0.0,
        C.LOUDNESS_OFFSET_DB + 10.0 * torch.log10(torch.clamp(e, min=1e-38)),
        NEG_INF,
    )


def weighted_square(y: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(..., C, N) K-weighted samples -> z (..., N)."""
    w = weights.to(y.dtype)
    return torch.einsum("...cn,c->...n", y * y, w)


def subblock_sums(z: torch.Tensor, h: int) -> torch.Tensor:
    """Sum z over complete 100 ms sub-blocks: (..., N) -> (..., N // h)."""
    nb = z.shape[-1] // h
    return z[..., : nb * h].reshape(*z.shape[:-1], nb, h).sum(dim=-1)


def _window_means(sums: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Mean energy over each trailing window of `w` sub-blocks.

    sums: (..., nb) -> (..., nb - w + 1); entry j is the energy of the
    block ending at sub-block j + w - 1.
    """
    if sums.shape[-1] < w:
        return sums[..., :0]
    c = torch.cumsum(sums, dim=-1)
    lead = c[..., w - 1:]
    lag = torch.cat(
        [torch.zeros_like(c[..., :1]), c[..., : c.shape[-1] - w]], dim=-1
    )
    return (lead - lag) / (w * h)


def gating_energies(sums: torch.Tensor, h: int) -> torch.Tensor:
    """400 ms gating-block energies at 100 ms hop: (..., nb) -> (..., nb-3)."""
    return _window_means(sums, h, C.MOMENTARY_SUBBLOCKS)


def shortterm_energies(sums: torch.Tensor, h: int) -> torch.Tensor:
    """3 s short-term energies at 100 ms hop: (..., nb) -> (..., nb-29)."""
    return _window_means(sums, h, C.SHORTTERM_SUBBLOCKS)


def lra_energies(sums: torch.Tensor, h: int) -> torch.Tensor:
    """3 s energies at 1 s hop (the LRA block cadence): first block ends at
    sub-block 30, then every 10th."""
    return shortterm_energies(sums, h)[..., :: C.LRA_HOP_SUBBLOCKS]


def gated_loudness(energies: torch.Tensor, mask: torch.Tensor | None = None):
    """Integrated loudness (LUFS) of gating-block energies (..., n)."""
    e = energies
    m = torch.ones(e.shape, dtype=torch.bool, device=e.device) if mask is None else mask
    # '>=' on both gates matches libebur128
    m1 = m & (e >= _ABS_GATE_ENERGY)
    n1 = m1.sum(dim=-1)
    sum1 = torch.where(m1, e, 0.0).sum(dim=-1)
    mean1 = sum1 / torch.clamp(n1, min=1)
    rel_gate = mean1 * 10.0 ** (C.RELATIVE_GATE_LU / 10.0)
    m2 = m1 & (e >= rel_gate.unsqueeze(-1))
    n2 = m2.sum(dim=-1)
    mean2 = torch.where(m2, e, 0.0).sum(dim=-1) / torch.clamp(n2, min=1)
    return torch.where((n1 > 0) & (n2 > 0), loudness_from_energy(mean2), NEG_INF)


def _masked_percentile_loudness(e, m2, n2, q: float):
    """Loudness at percentile q of the masked energies (libebur128 index
    convention: sorted[floor((n-1)*q + 0.5)])."""
    srt = torch.sort(torch.where(m2, e, float("inf")), dim=-1).values
    idx = torch.floor((n2.to(torch.float32) - 1.0) * q + 0.5).to(torch.int64)
    idx = torch.clamp(idx, 0, e.shape[-1] - 1)
    val = torch.gather(srt, -1, idx.unsqueeze(-1)).squeeze(-1)
    return loudness_from_energy(val)


def loudness_range(st_energies: torch.Tensor, mask: torch.Tensor | None = None):
    """EBU Tech 3342 loudness range (LU) from 3 s / 1 s-hop energies."""
    e = st_energies
    m = torch.ones(e.shape, dtype=torch.bool, device=e.device) if mask is None else mask
    m1 = m & (e >= _ABS_GATE_ENERGY)
    n1 = m1.sum(dim=-1)
    mean1 = torch.where(m1, e, 0.0).sum(dim=-1) / torch.clamp(n1, min=1)
    rel_gate = mean1 * 10.0 ** (C.LRA_RELATIVE_GATE_LU / 10.0)
    m2 = m1 & (e >= rel_gate.unsqueeze(-1))
    n2 = m2.sum(dim=-1)
    l_low = _masked_percentile_loudness(e, m2, n2, C.LRA_LOW_PERCENTILE)
    l_high = _masked_percentile_loudness(e, m2, n2, C.LRA_HIGH_PERCENTILE)
    return torch.where(n2 > 0, l_high - l_low, 0.0)
