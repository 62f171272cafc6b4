"""Display-spectrum host plans (src/analyzer.rs:11-104 of the reference).

Only the two host builders the spectrogram path needs: the periodic Hann
window and the static bin plan (display range, pink-noise compensation,
log-frequency chart mapping). Both are float64 NumPy, identical to the
JAX package's ops/spectrum.py.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from soundscope_tpu_torch.core import constants as C


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
