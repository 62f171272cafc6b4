"""BS.1770-4 / EBU R128 loudness math: block energies, gating, LRA.

Batchable functions over the channel-weighted squared K-weighted signal
z[n] = sum_ch w_ch * y_ch[n]^2. Block energies are windowed means of z;
loudness is -0.691 + 10*log10(energy).

Gating (BS.1770-4 §4): 400 ms blocks at 100 ms hop; absolute gate at
-70 LUFS; relative gate 10 LU below the mean of absolutely-gated blocks;
integrated loudness is the mean energy of blocks passing both gates.

Loudness range (EBU Tech 3342): 3 s blocks at 1 s hop; absolute gate
-70 LUFS; relative gate 20 LU below; LRA = l(95th) - l(10th percentile).

The exact-mode functions take an optional validity mask; the whole-file
engine and the streaming meter's exact history use them. The histogram
mode (libebur128's) keeps counts per 0.08 LU bin and serves the streaming
meter's unbounded history; it quantises by at most half a bin.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from soundscope_tpu_torch.core import constants as C
from soundscope_tpu_torch.core.device import upload

_ABS_GATE_ENERGY = float(10.0 ** ((C.ABSOLUTE_GATE_LUFS - C.LOUDNESS_OFFSET_DB) / 10.0))
NEG_INF = float("-inf")


def loudness_from_energy(e: torch.Tensor) -> torch.Tensor:
    """L = -0.691 + 10*log10(e), with e <= 0 mapping to -inf."""
    return torch.where(
        e > 0.0,
        C.LOUDNESS_OFFSET_DB + 10.0 * torch.log10(torch.clamp(e, min=1e-38)),
        NEG_INF,
    )


def energy_from_loudness(l: float) -> float:
    """The energy of loudness l LUFS (the inverse of loudness_from_energy)."""
    return float(10.0 ** ((l - C.LOUDNESS_OFFSET_DB) / 10.0))


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

    The running sums are float64: a window is the difference of two of
    them, so a float32 sum keeps only about eps32 * max|cumsum| of a
    window's energy. Over a 2-hour programme (72,000 sub-blocks) that cost
    a quiet momentary window up to 0.45 LU against the float64 mean; the
    JAX package takes them in float32.
    """
    if sums.shape[-1] < w:
        return sums[..., :0]
    c = torch.cumsum(sums.double(), dim=-1)
    lead = c[..., w - 1:]
    lag = torch.cat(
        [torch.zeros_like(c[..., :1]), c[..., : c.shape[-1] - w]], dim=-1
    )
    return ((lead - lag) / (w * h)).to(sums.dtype)


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


# --- histogram mode (unbounded-duration streaming) ---------------------------

@functools.lru_cache(maxsize=None)
def _hist_bin_energies() -> np.ndarray:
    l = C.HIST_MIN_LUFS + (np.arange(C.HIST_BINS) + 0.5) * (
        (C.HIST_MAX_LUFS - C.HIST_MIN_LUFS) / C.HIST_BINS
    )
    return (10.0 ** ((l - C.LOUDNESS_OFFSET_DB) / 10.0)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _hist_constants(device: torch.device):
    """(bin-center energies, bin-center loudness) on `device`, float32."""
    width = (C.HIST_MAX_LUFS - C.HIST_MIN_LUFS) / C.HIST_BINS
    centers = C.HIST_MIN_LUFS + (np.arange(C.HIST_BINS) + 0.5) * width
    return (upload(_hist_bin_energies(), device),
            upload(centers.astype(np.float32), device))


def hist_bin_index(energies: torch.Tensor) -> torch.Tensor:
    """Histogram bin of each energy (int32); -1 when below the absolute gate."""
    l = loudness_from_energy(energies)
    width = (C.HIST_MAX_LUFS - C.HIST_MIN_LUFS) / C.HIST_BINS
    idx = torch.floor((l - C.HIST_MIN_LUFS) / width)
    idx = torch.clamp(torch.nan_to_num(idx, neginf=-1.0), 0, C.HIST_BINS - 1)
    return torch.where(l >= C.HIST_MIN_LUFS, idx.to(torch.int32), -1)


def _hist_gate(hist: torch.Tensor, rel_lu: float):
    """(counts as float32, bin energies, mask of bins above the relative
    gate, number of blocks) of a histogram (..., HIST_BINS)."""
    hist = hist.to(torch.float32)
    e_bins, _ = _hist_constants(hist.device)
    n1 = hist.sum(dim=-1)
    mean1 = (hist * e_bins).sum(dim=-1) / torch.clamp(n1, min=1.0)
    keep = e_bins >= (mean1 * 10.0 ** (rel_lu / 10.0)).unsqueeze(-1)
    return hist, e_bins, keep, n1


def gated_loudness_hist(hist: torch.Tensor):
    """Integrated loudness from the gating histogram (counts per bin;
    bin-center energies — <=0.04 LU quantisation)."""
    hist, e_bins, keep, n1 = _hist_gate(hist, C.RELATIVE_GATE_LU)
    n2 = torch.where(keep, hist, 0.0).sum(dim=-1)
    mean2 = torch.where(keep, hist * e_bins, 0.0).sum(dim=-1) / torch.clamp(n2, min=1.0)
    return torch.where((n1 > 0) & (n2 > 0), loudness_from_energy(mean2), NEG_INF)


def loudness_range_hist(hist: torch.Tensor):
    """LRA from the short-term histogram (bin centers as energies)."""
    hist, _, keep, _ = _hist_gate(hist, C.LRA_RELATIVE_GATE_LU)
    _, centers = _hist_constants(hist.device)
    counts = torch.where(keep, hist, 0.0)
    n2 = counts.sum(dim=-1)
    cum = torch.cumsum(counts, dim=-1)
    lo_target = torch.floor((n2 - 1.0) * C.LRA_LOW_PERCENTILE + 0.5) + 1.0
    hi_target = torch.floor((n2 - 1.0) * C.LRA_HIGH_PERCENTILE + 0.5) + 1.0
    # the first bin whose running count reaches the target
    lo_idx = torch.argmax((cum >= lo_target.unsqueeze(-1)).to(torch.int32), dim=-1)
    hi_idx = torch.argmax((cum >= hi_target.unsqueeze(-1)).to(torch.int32), dim=-1)
    return torch.where(n2 > 0, centers[hi_idx] - centers[lo_idx], 0.0)
