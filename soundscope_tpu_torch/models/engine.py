"""Offline (whole-file) analysis engine.

The entire file analysis — K-weighting, block energies, gated integrated
loudness, momentary / short-term timelines, LRA, true and sample peaks —
over a batch of planar tracks:

    result = analyze_batch_native(cfg, samples, n_valid)

Layouts (views of the same contiguous memory in torch):
  4D frames (b, ch, N/128, 128): the CLI's batch path. K1
    (ops/iir_chunked.py) computes the step energies and the fused true and
    sample peaks.
  3D (b, ch, N) and 2D rows (b*ch, N): `rows_plan` picks the energy route,
    K3 (fused energy + peaks), K4 (prefix) or K5 (chain) of ops/iir.py,
    with K6 (ops/truepeak_stream.py) for the peaks where they are not
    fused; `analyze_array`, the single-file entry, takes this layout.
Each kernel wrapper launches its kernel on a CUDA tensor and runs its
plain version on a CPU tensor.

Padding: callers pad N up to a bucket and pass the true length as
`n_valid`; all gating/timeline quantities are masked so padded zeros can
never influence results.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from soundscope_tpu_torch.core import constants as C
from soundscope_tpu_torch.core.config import MeterConfig
from soundscope_tpu_torch.ops import iir as IIR
from soundscope_tpu_torch.ops import loudness as L
from soundscope_tpu_torch.ops.biquad import block_iir, make_block_filter
from soundscope_tpu_torch.ops.iir_chunked import (
    kweight_energy_tp_chunked,
    step_length,
    subblock_sums_from_steps,
)
from soundscope_tpu_torch.ops.kweight import channel_weights, kweight_cascade_ss
from soundscope_tpu_torch.ops.truepeak import true_peak_masked
from soundscope_tpu_torch.ops.truepeak_stream import true_peak_stream

# rows at and above which the 3D/2D energy takes K5's chain
CHAIN_MIN_ROWS = 1024


def rows_plan(n: int, b: int, ch: int, rate: int, block: int) -> tuple[str, bool]:
    """(energy route, whether K6 runs) of the 3D/2D layout.

    Routes: "plain" when N is no multiple of the filter block or of 128
    (the reference runs its XLA path there too); "fused" (K3) when the rate
    needs true-peak oversampling and b*ch <= 64, the reference's row guard
    for its fused kernel; otherwise "chain" (K5) when b*ch >=
    CHAIN_MIN_ROWS, else "prefix" (K4).

    The threshold is the port's own, not a VMEM model. It sends the
    library scan (2,000 rows) down the chain and a one-track 5.1 file
    (6 rows) down the prefix, as the reference's dispatch does. K5 runs one
    thread per row and reads the input once; K4 runs b * N /
    span_length(N) threads and reads it twice. On an H100 at the library
    shape K4 took 6.3 ms and K5 26.2 ms (PERF.md): 2,000 rows are too few
    for the chain's single read to pay, so the threshold keeps the
    reference's routes until K5 gains parallelism or the threshold moves.

    K6 runs for the peaks when they are not fused, the rate needs
    oversampling and N % 128 == 0 (at factor 1 the peak is a masked max on
    every device, and an N of no multiple of 128 takes the plain peak).
    """
    factor = C.true_peak_factor(rate)
    if n % block or n % 128:
        route = "plain"
    elif factor > 1 and b * ch <= 64:
        route = "fused"
    elif b * ch >= CHAIN_MIN_ROWS:
        route = "chain"
    else:
        route = "prefix"
    return route, route != "fused" and factor > 1 and n % 128 == 0


@dataclasses.dataclass
class AnalysisResult:
    """Whole-file analysis products (masked timelines at 100 ms cadence),
    with a leading track axis."""

    integrated_lufs: torch.Tensor   # (b,)
    lra: torch.Tensor               # (b,) LU
    momentary: torch.Tensor         # (b, nm) LUFS, 400 ms @ 10 Hz
    shortterm: torch.Tensor         # (b, nst) LUFS, 3 s @ 10 Hz
    n_momentary: torch.Tensor       # (b,) valid prefix of `momentary`
    n_shortterm: torch.Tensor       # (b,) valid prefix of `shortterm`
    true_peak: torch.Tensor         # (b, C) linear
    sample_peak: torch.Tensor       # (b, C) linear

    def track(self, i: int) -> "AnalysisResult":
        """The result of track i, with the track axis dropped."""
        return AnalysisResult(**{f.name: getattr(self, f.name)[i]
                                 for f in dataclasses.fields(self)})


def _finish(cfg: MeterConfig, sums: torch.Tensor, n_valid: torch.Tensor,
            tp: torch.Tensor, sp: torch.Tensor) -> AnalysisResult:
    """Gating/timeline/LRA tail shared by every layout; `sums` is (b, nb)
    100 ms sub-block energies, tp/sp the (b, ch) peaks."""
    h = cfg.subblock
    b, nb = sums.shape
    dev = sums.device
    nb_valid = n_valid.to(dev, torch.int64) // h

    if nb >= C.MOMENTARY_SUBBLOCKS:
        e_gate = L.gating_energies(sums, h)
        m_gate = torch.arange(e_gate.shape[-1], device=dev)[None] < (
            nb_valid[:, None] - (C.MOMENTARY_SUBBLOCKS - 1))
        integrated = L.gated_loudness(e_gate, m_gate)
        momentary = torch.where(m_gate, L.loudness_from_energy(e_gate), L.NEG_INF)
        n_mom = torch.clamp(nb_valid - (C.MOMENTARY_SUBBLOCKS - 1), min=0)
    else:
        integrated = torch.full((b,), L.NEG_INF, device=dev)
        momentary = torch.zeros((b, 0), device=dev)
        n_mom = torch.zeros((b,), dtype=torch.int64, device=dev)

    if nb >= C.SHORTTERM_SUBBLOCKS:
        e_st = L.shortterm_energies(sums, h)
        m_st = torch.arange(e_st.shape[-1], device=dev)[None] < (
            nb_valid[:, None] - (C.SHORTTERM_SUBBLOCKS - 1))
        shortterm = torch.where(m_st, L.loudness_from_energy(e_st), L.NEG_INF)
        n_st = torch.clamp(nb_valid - (C.SHORTTERM_SUBBLOCKS - 1), min=0)
        lra = L.loudness_range(e_st[..., :: C.LRA_HOP_SUBBLOCKS],
                               m_st[..., :: C.LRA_HOP_SUBBLOCKS])
    else:
        shortterm = torch.zeros((b, 0), device=dev)
        n_st = torch.zeros((b,), dtype=torch.int64, device=dev)
        lra = torch.zeros((b,), device=dev)

    return AnalysisResult(
        integrated_lufs=integrated, lra=lra, momentary=momentary,
        shortterm=shortterm, n_momentary=n_mom, n_shortterm=n_st,
        true_peak=tp, sample_peak=sp,
    )


def analyze_batch_native(cfg: MeterConfig, samples: torch.Tensor,
                         n_valid: torch.Tensor) -> AnalysisResult:
    """Batched whole-file analysis on samples' device.

    samples: float32 (b, ch, N/128, 128) frames view, (b, ch, N), or rows
    (b*ch, N) with ch = cfg.channels. n_valid: (b,) valid lengths.
    """
    dev = samples.device
    h = cfg.subblock
    n_valid = torch.as_tensor(n_valid, device=dev).to(torch.int64)
    weights = channel_weights(cfg.channels)

    if samples.ndim == 4:
        b, ch, nc, _ = samples.shape
        n = nc * 128
        span = step_length(n, h)
        filt = make_block_filter(kweight_cascade_ss(cfg.rate), cfg.block, dev)
        step_sums, tp, sp = kweight_energy_tp_chunked(
            filt, samples, n_valid, tuple(float(v) for v in weights),
            cfg.rate, h)
        sums = subblock_sums_from_steps(
            step_sums, h, span, n).reshape(b, ch, -1).sum(dim=1)
        return _finish(cfg, sums, n_valid, tp.reshape(b, ch), sp.reshape(b, ch))

    if samples.ndim == 2:
        ch = cfg.channels
        b, n = samples.shape[0] // ch, samples.shape[1]
    else:
        b, ch, n = samples.shape
    w = tuple(float(v) for v in weights)
    filt = make_block_filter(kweight_cascade_ss(cfg.rate), cfg.block, dev)
    route, k6 = rows_plan(n, b, ch, cfg.rate, cfg.block)
    tp = sp = None
    if route == "plain":
        s3 = samples.reshape(b, ch, n)
        y, _ = block_iir(filt, s3, s3.new_zeros((b, ch, 4)))
        y = torch.where(torch.arange(n, device=dev) < n_valid[:, None, None], y, 0.0)
        sums = L.subblock_sums(L.weighted_square(y, torch.from_numpy(weights).to(dev)), h)
    else:
        # the kernels pre-sum groups of 32 samples where 32 divides the
        # 100 ms sub-block (48 kHz and its family); 44.1 kHz keeps z per sample
        g = 32 if h % 32 == 0 and cfg.block % 32 == 0 else 1
        if route == "fused":
            z, tp, sp = IIR.kweight_energy_tp_prefix(filt, samples, n_valid, w,
                                                     cfg.rate, g)
        elif route == "prefix":
            z = IIR.kweight_energy_prefix(filt, samples, n_valid, w, g)
        else:
            z = IIR.kweight_energy_chain(filt, samples, n_valid, w, g)
        hg = h // g
        nb = z.shape[-1] // hg
        sums = z[:, : nb * hg].reshape(b, nb, hg).double().sum(dim=-1).float()
    if k6:
        tp, sp = true_peak_stream(samples, n_valid, cfg.rate)
    elif tp is None:
        # at factor 1 this is the reference's masked max, without a kernel
        tp, sp = true_peak_masked(samples.reshape(b, ch, n),
                                  n_valid[:, None, None], cfg.rate)
    return _finish(cfg, sums, n_valid, tp.reshape(b, ch), sp.reshape(b, ch))


def analyze_fn(cfg: MeterConfig, samples: torch.Tensor,
               n_valid) -> AnalysisResult:
    """Single-track whole-file analysis: (C, N) or (C, N/128, 128) and a
    valid length -> result without a track axis."""
    nv = torch.as_tensor(n_valid, device=samples.device).reshape(1)
    return analyze_batch_native(cfg, samples[None], nv).track(0)


def pad_bucket(n: int, minimum: int = 1 << 15) -> int:
    """Padded length of a track: the next power of two, at least `minimum`."""
    b = minimum
    while b < n:
        b <<= 1
    return b


def analyze_array(samples: np.ndarray, cfg: MeterConfig,
                  device="cpu") -> AnalysisResult:
    """Host convenience: planar (C, N) numpy -> AnalysisResult on `device`.

    The track is padded to `pad_bucket` and analysed on the 3D layout, as
    in the reference, so `rows_plan` routes it (K3 for stereo below
    192 kHz, K4 for 5.1 at 192 kHz)."""
    ch, n = samples.shape
    npad = pad_bucket(n)
    x = np.zeros((ch, npad), np.float32)
    x[:, :n] = samples
    return analyze_fn(cfg, torch.from_numpy(x).to(device), n)
