"""The plain pooled mid/side display spectrogram of a track.

The spectrogram: for window j (samples [2048 j, 2048 j + 16384)), the
periodic-Hann-windowed FFTs L and R, M = (L + R) / 2 and S = (L - R) / 2,
the power (|.| * gain)^2 with the per-bin display gain (design.pooled_gain),
the max over each band of 128 consecutive bins, then 10 log10 with the
-150 dB floor for a band of zero power.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import design as D
from benchmark.reference.precision import FLOAT64, Precision

WINDOWS = 128       # windows per FFT chunk


def _fft(x: torch.Tensor, p: Precision) -> tuple[torch.Tensor, torch.Tensor]:
    f = torch.fft.fft(x.to(p.work))
    return p.r(f.real), p.r(f.imag)


def pooled_spectrogram(track: torch.Tensor, rate: int, p: Precision = FLOAT64):
    """(mid dB, side dB), each (nw, 128) float64 NumPy, of a stereo track
    (2, N), nw = N // 2048 - 7."""
    win, hop, bands = D.FFT_SIZE, D.STFT_HOP, D.STFT_BANDS
    n = track.shape[-1]
    nw = max(n // hop - win // hop + 1, 0)
    dev = track.device
    w = p.r(torch.from_numpy(D.hann(win)).to(dev))
    g = p.r(torch.from_numpy(D.pooled_gain(win, rate)).to(dev))
    x = p.r(track)
    out = np.zeros((2, nw, bands))
    for j0 in range(0, nw, WINDOWS):
        j1 = min(nw, j0 + WINDOWS)
        idx = (torch.arange(j0, j1, device=dev)[:, None] * hop
               + torch.arange(win, device=dev)[None, :])
        lr, li = _fft(p.r(x[0][idx] * w), p)
        rr, ri = _fft(p.r(x[1][idx] * w), p)
        for k, sign in enumerate((1.0, -1.0)):
            re = p.r((lr + sign * rr) * 0.5)
            im = p.r((li + sign * ri) * 0.5)
            pw = p.r(p.r(re * re + im * im) * p.r(g * g))
            pm = pw.reshape(j1 - j0, bands, win // bands).amax(-1).double().cpu().numpy()
            with np.errstate(divide="ignore"):
                out[k, j0:j1] = np.where(pm > 0.0, 10.0 * np.log10(np.where(pm > 0, pm, 1.0)),
                                         D.FLOOR_DB)
    return out[0], out[1]
