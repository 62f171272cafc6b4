"""Display spectrum pipeline (src/analyzer.rs:11-104 of the reference).

1. Hann window (periodic).
2. Real FFT magnitude, bins limited to [20 Hz, 20 kHz].
3. dBFS scaling: val == 0 -> -150 dB, else 20*log10(val * 4 / N).
4. Pink-noise compensation: +10*log10(f / 1000) dB.
5. Log-frequency chart mapping:
   x = (log10(f) - log10(20)) / (log10(20000) - log10(20)) * 100.

The host builders (`_hann_np`, `_bin_plan`) are float64 NumPy, identical
to the JAX package's ops/spectrum.py; `spectrum_points` runs on the
samples' device with the constants cached there.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from soundscope_tpu_torch.core import constants as C
from soundscope_tpu_torch.core.device import upload
from soundscope_tpu_torch.ops.fft import rfft_mag


@functools.lru_cache(maxsize=None)
def _hann_np(n: int) -> np.ndarray:
    """Periodic Hann window (divides by n, not n - 1), float32."""
    i = np.arange(n, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * i / n))).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _bin_plan(n: int, rate: int, fmin: float, fmax: float):
    freqs = np.arange(n // 2 + 1, dtype=np.float64) * rate / n
    keep = (freqs >= fmin) & (freqs <= fmax)
    lo = int(np.argmax(keep))
    hi = lo + int(np.count_nonzero(keep))
    f = freqs[lo:hi]
    pink = C.PINK_SLOPE_DB_PER_DECADE * np.log10(f / C.PINK_REF_FREQ_HZ)
    xmap = (
        (np.log10(f) - math.log10(fmin))
        / (math.log10(fmax) - math.log10(fmin))
        * C.SPECTRUM_CHART_WIDTH
    )
    return lo, hi, f.astype(np.float32), pink.astype(np.float32), np.asarray(xmap)


@functools.lru_cache(maxsize=None)
def _pink_on(n: int, rate: int, fmin: float, fmax: float,
             device: torch.device) -> torch.Tensor:
    return upload(_bin_plan(n, rate, fmin, fmax)[3], device)


@functools.lru_cache(maxsize=None)
def hann_window(n: int, device=torch.device("cpu")) -> torch.Tensor:
    """The periodic Hann window on `device` (cached per device)."""
    return upload(_hann_np(n), device)


def spectrum_points(
    samples: torch.Tensor,
    rate: int,
    fmin: float = C.SPECTRUM_FMIN_HZ,
    fmax: float = C.SPECTRUM_FMAX_HZ,
    gain_db: torch.Tensor | float = 0.0,
):
    """Full display-spectrum pipeline on (..., N) windows.

    Returns (chart_x: np.ndarray (K,), values_db: tensor (..., K)).
    `gain_db` is the loudness-matched FFT gain compensation the app layer
    adds to every displayed point.
    """
    n = samples.shape[-1]
    lo, hi, _, _, xmap = _bin_plan(n, rate, fmin, fmax)
    xw = samples * hann_window(n, samples.device)
    mag = rfft_mag(xw)[..., lo:hi]
    scaled = torch.where(
        mag == 0.0,
        C.SPECTRUM_FLOOR_DB,
        20.0 * torch.log10(torch.clamp(mag, min=1e-37) * (4.0 / n)),
    )
    return xmap, scaled + _pink_on(n, rate, fmin, fmax, samples.device) + gain_db
