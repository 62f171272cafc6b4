"""Throughput STFT: the display-spectrum pipeline over whole tracks.

The reference recomputes two 16384-point FFTs (mid + side) per playback
position update, one update per 2048 samples. The batch equivalent is a
full pooled spectrogram at that hop over every track:

* windows by contiguous slice-stacking (hop divides win);
* mid and side spectra from ONE complex FFT per window (pack z = l + i*r,
  split by conjugate symmetry, Mid = (L+R)/2, Side = (L-R)/2 by FFT
  linearity);
* pink-noise compensation and dBFS scaling folded into a per-bin LINEAR
  gain, so band max-pooling commutes with the monotonic log.

`stft_midside_display` is the plain version of K2 (ops/stft_pooled.py);
`spectrogram` is the host convenience the CLI calls.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from soundscope_tpu_torch.core import constants as C
from soundscope_tpu_torch.ops.fft import fft_pack2
from soundscope_tpu_torch.ops.spectrum import _bin_plan, _hann_np

HOP = 2048
# windows per plain-path chunk: bounds the transient (chunk, win) tensors
_CHUNK_WINDOWS = 256


def frame_signal(x: torch.Tensor, win: int, hop: int) -> torch.Tensor:
    """(..., N) -> (..., nw, win) overlapping windows via slice-stacking.

    Requires win % hop == 0. nw = N // hop - win // hop + 1 (at least 0).
    """
    if win % hop:
        raise ValueError("hop must divide win")
    n = x.shape[-1]
    k = win // hop
    nhop = n // hop
    nw = max(nhop - k + 1, 0)
    if nw == 0:
        return x.new_zeros((*x.shape[:-1], 0, win))
    frames = x[..., : nhop * hop].reshape(*x.shape[:-1], nhop, hop)
    return torch.cat([frames[..., i: i + nw, :] for i in range(k)], dim=-1)


@functools.lru_cache(maxsize=None)
def _pooled_gain_plan(n: int, rate: int, pool: int):
    """Per-bin linear gain over ALL n bins (zero outside the 20 Hz-20 kHz
    display range), plus chart-x centers of the `pool` aligned bands.

    Bands are `n // pool` CONSECUTIVE natural-order bins; out-of-range bins
    can never win the band max since their gain is exactly 0 and powers are
    non-negative.
    """
    lo, hi, freqs, pink_db, xmap = _bin_plan(
        n, rate, C.SPECTRUM_FMIN_HZ, C.SPECTRUM_FMAX_HZ
    )
    gain_full = np.zeros(n, np.float64)
    gain_full[lo:hi] = (4.0 / n) * 10.0 ** (pink_db.astype(np.float64) / 20.0)
    per = n // pool
    # chart x of each band = x of its center bin (clipped into range)
    centers = np.zeros(pool)
    for b in range(pool):
        c = b * per + per // 2
        c = min(max(c, lo), hi - 1)
        centers[b] = xmap[c - lo]
    return gain_full.astype(np.float32), per, centers


def stft_midside_display(
    l: torch.Tensor,
    r: torch.Tensor,
    rate: int,
    win: int = C.DEFAULT_FFT_SIZE,
    hop: int = HOP,
    pool: int = 128,
    gain_db: float = 0.0,
):
    """(..., N) L/R -> (chart_x (pool,), mid_db, side_db (..., nw, pool)).

    Pooled (band-max) display spectrogram of mid and side with the
    reference's exact per-bin scaling folded in before pooling. Bands are
    aligned groups of win/pool natural-order bins (zero gain outside the
    display range); bands fully outside read the -150 dB floor. Windows
    are processed in chunks so the transient memory stays bounded.
    """
    gain, per, centers = _pooled_gain_plan(win, rate, pool)
    w = torch.from_numpy(_hann_np(win)).to(l.device)
    g2 = torch.from_numpy(gain).to(l.device) ** 2
    nw = max(l.shape[-1] // hop - win // hop + 1, 0)

    def pooled_db(re, im):
        p = (re * re + im * im) * g2
        pm = p.reshape(*p.shape[:-1], pool, per).amax(dim=-1)
        return torch.where(
            pm > 0.0,
            10.0 * torch.log10(torch.clamp(pm, min=1e-38)) + gain_db,
            C.SPECTRUM_FLOOR_DB + gain_db,
        )

    mids, sides = [], []
    for lo in range(0, nw, _CHUNK_WINDOWS):
        cnt = min(_CHUNK_WINDOWS, nw - lo)
        span = slice(lo * hop, (lo + cnt - 1) * hop + win)
        lw = frame_signal(l[..., span], win, hop) * w
        rw = frame_signal(r[..., span], win, hop) * w
        Ar, Ai, Br, Bi = fft_pack2(lw, rw)
        # frequency-domain mid/side (FFT linearity)
        mids.append(pooled_db(0.5 * (Ar + Br), 0.5 * (Ai + Bi)))
        sides.append(pooled_db(0.5 * (Ar - Br), 0.5 * (Ai - Bi)))
    if not mids:
        empty = l.new_zeros((*l.shape[:-1], 0, pool))
        return centers, empty, empty.clone()
    return centers, torch.cat(mids, dim=-2), torch.cat(sides, dim=-2)


def spectrogram(samples_planar, rate: int, device="cpu"):
    """Host convenience: planar (C, N) -> dict of pooled display
    spectrograms over every window, computed on `device`.

    Above 40 kHz (where the display range sits below Nyquist) this runs K2
    (ops/stft_pooled.py: the CUDA kernel on a CUDA device); below, the
    plain version on any device.

    Returns {"chart_x": (pool,), "mid_db": (nw, pool), "side_db": ...,
    "hop": 2048, "win": 16384, "rate": rate} as numpy arrays.
    """
    from soundscope_tpu_torch.ops.stft_pooled import (
        rate_supported,
        stft_pooled_frames,
    )

    x = np.asarray(samples_planar, np.float32)
    l, r = (x[0], x[1]) if x.shape[0] >= 2 else (x[0], x[0])
    _, _, centers = _pooled_gain_plan(C.DEFAULT_FFT_SIZE, rate, 128)
    if rate_supported(rate):
        n = (x.shape[1] // HOP) * HOP
        frames = torch.from_numpy(np.stack([l[:n], r[:n]])).to(device)
        mid, side = stft_pooled_frames(frames.reshape(1, 2, n // 128, 128), rate)
    else:
        lt = torch.from_numpy(np.ascontiguousarray(l[None])).to(device)
        rt = torch.from_numpy(np.ascontiguousarray(r[None])).to(device)
        _, mid, side = stft_midside_display(lt, rt, rate)
    return {
        "chart_x": np.asarray(centers),
        "mid_db": mid[0].cpu().numpy(),
        "side_db": side[0].cpu().numpy(),
        "hop": HOP,
        "win": C.DEFAULT_FFT_SIZE,
        "rate": rate,
    }
