"""Frozen constants and design math of BS.1770-4, EBU Tech 3342 and the
display pipeline, in float64 NumPy.

These are copies, not imports: the reference may take nothing from the
program under test. They follow ITU-R BS.1770-4 (the K-weighting analog
prototypes re-discretised by the bilinear transform, the 49-tap
Hann-windowed-sinc true-peak interpolator of Annex 2, the gates), EBU
Tech 3342 (LRA) and the display of the reference analyzer
(src/analyzer.rs:11-137: periodic Hann, 20 Hz-20 kHz bins, 4/N dBFS,
+3 dB/octave pink compensation). A later change to the
program's constants does not move them.
"""

from __future__ import annotations

import functools
import math

import numpy as np

# BS.1770-4 K-weighting analog prototypes
SHELF_F0_HZ = 1681.974450955533
SHELF_GAIN_DB = 3.999843853973347
SHELF_Q = 0.7071752369554196
SHELF_VB_EXP = 0.4996667741545416
HIPASS_F0_HZ = 38.13547087602444
HIPASS_Q = 0.5003270373238773

LOUDNESS_OFFSET_DB = -0.691
ABSOLUTE_GATE_LUFS = -70.0
RELATIVE_GATE_LU = -10.0
LRA_RELATIVE_GATE_LU = -20.0
LRA_LOW, LRA_HIGH = 0.10, 0.95
MOMENTARY_SUBBLOCKS = 4
SHORTTERM_SUBBLOCKS = 30
LRA_HOP_SUBBLOCKS = 10

TRUE_PEAK_TAPS = 49

# display pipeline
FFT_SIZE = 16384
STFT_HOP = 2048
STFT_BANDS = 128
FMIN_HZ, FMAX_HZ = 20.0, 20000.0
FLOOR_DB = -150.0
PINK_DB_PER_DECADE = 10.0
PINK_REF_HZ = 1000.0


def subblock(rate: int) -> int:
    """Samples per 100 ms sub-block (libebur128's rounding)."""
    return (rate + 5) // 10


def true_peak_factor(rate: int) -> int:
    return 4 if rate < 96000 else (2 if rate < 192000 else 1)


def channel_weights(channels: int) -> np.ndarray:
    s = 1.41
    if channels == 4:
        w = [1.0, 1.0, s, s]
    elif channels == 5:
        w = [1.0, 1.0, 1.0, s, s]
    else:
        w = ([1.0, 1.0, 1.0, 0.0, s, s][:channels]) + [0.0] * max(0, channels - 6)
    return np.asarray(w, np.float64)


def _biquad_ss(b, a):
    b0, b1, b2 = b
    _, a1, a2 = a
    return (np.array([[-a1, 1.0], [-a2, 0.0]]), np.array([b1 - a1 * b0, b2 - a2 * b0]),
            np.array([1.0, 0.0]), b0)


def _series(s1, s2):
    A1, B1, C1, D1 = s1
    A2, B2, C2, D2 = s2
    A = np.zeros((4, 4))
    A[:2, :2] = A1
    A[2:, :2] = np.outer(B2, C1)
    A[2:, 2:] = A2
    return A, np.concatenate([B1, B2 * D1]), np.concatenate([C1 * D2, C2]), D2 * D1


@functools.lru_cache(maxsize=None)
def kweight_ss(rate: int):
    """(A (4, 4), B (4,), C (4,), D) of the K-filter cascade, float64."""
    k = math.tan(math.pi * SHELF_F0_HZ / rate)
    vh = 10.0 ** (SHELF_GAIN_DB / 20.0)
    vb = vh ** SHELF_VB_EXP
    a0 = 1.0 + k / SHELF_Q + k * k
    shelf = ([(vh + vb * k / SHELF_Q + k * k) / a0, 2.0 * (k * k - vh) / a0,
              (vh - vb * k / SHELF_Q + k * k) / a0],
             [1.0, 2.0 * (k * k - 1.0) / a0, (1.0 - k / SHELF_Q + k * k) / a0])
    k = math.tan(math.pi * HIPASS_F0_HZ / rate)
    a0 = 1.0 + k / HIPASS_Q + k * k
    hipass = ([1.0, -2.0, 1.0],
              [1.0, 2.0 * (k * k - 1.0) / a0, (1.0 - k / HIPASS_Q + k * k) / a0])
    return _series(_biquad_ss(*shelf), _biquad_ss(*hipass))


@functools.lru_cache(maxsize=None)
def block_matrices(rate: int, block: int):
    """The blocked state-space identity of the K-filter over `block`
    samples: y = T x + O s, s' = A^block s + W x (float64)."""
    A, B, Cv, D = kweight_ss(rate)
    pows = [np.eye(4)]
    for _ in range(block):
        pows.append(pows[-1] @ A)
    h = np.empty(block)
    h[0] = D
    for m in range(1, block):
        h[m] = Cv @ pows[m - 1] @ B
    T = np.zeros((block, block))
    for k in range(block):
        T[k:, k] = h[: block - k]
    W = np.stack([pows[block - 1 - k] @ B for k in range(block)], axis=1)
    O = np.stack([Cv @ pows[m] for m in range(block)])
    return T, W, O, pows[block]


@functools.lru_cache(maxsize=None)
def polyphase_taps(factor: int) -> np.ndarray:
    """(factor, ceil(49 / factor)) float64: phase p, tap t is c[p + factor t]
    of the 49-tap Hann-windowed sinc with its cut-off at the input Nyquist."""
    j = np.arange(TRUE_PEAK_TAPS, dtype=np.float64)
    m = j - (TRUE_PEAK_TAPS - 1) / 2.0
    c = np.ones(TRUE_PEAK_TAPS)
    nz = np.abs(m) > 1e-6
    c[nz] = np.sin(m[nz] * np.pi / factor) / (m[nz] * np.pi / factor)
    c *= 0.5 * (1.0 - np.cos(2.0 * np.pi * j / (TRUE_PEAK_TAPS - 1)))
    k = -(-TRUE_PEAK_TAPS // factor)
    h = np.zeros((factor, k))
    for jj in range(TRUE_PEAK_TAPS):
        h[jj % factor, jj // factor] = c[jj]
    return h


@functools.lru_cache(maxsize=None)
def hann(n: int) -> np.ndarray:
    """Periodic Hann window (divides by n), float64."""
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))


@functools.lru_cache(maxsize=None)
def bin_plan(n: int, rate: int):
    """(lo, hi, pink dB of bins lo..hi-1) of the 20 Hz-20 kHz display bins."""
    f = np.arange(n // 2 + 1, dtype=np.float64) * rate / n
    keep = (f >= FMIN_HZ) & (f <= FMAX_HZ)
    lo = int(np.argmax(keep))
    hi = lo + int(np.count_nonzero(keep))
    return lo, hi, PINK_DB_PER_DECADE * np.log10(f[lo:hi] / PINK_REF_HZ)


@functools.lru_cache(maxsize=None)
def pooled_gain(n: int, rate: int) -> np.ndarray:
    """Linear display gain of every one of the n FFT bins (0 outside the
    display range): 4/n dBFS scaling and the pink compensation."""
    lo, hi, pink = bin_plan(n, rate)
    g = np.zeros(n)
    g[lo:hi] = (4.0 / n) * 10.0 ** (pink / 20.0)
    return g
