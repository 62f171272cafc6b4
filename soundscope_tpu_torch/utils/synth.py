"""Test/bench signal synthesis (EBU Tech 3341/3342 style stimuli)."""

from __future__ import annotations

import numpy as np


def db_to_lin(db: float) -> float:
    return float(10.0 ** (db / 20.0))


def sine(freq: float, seconds: float, rate: int, amp_dbfs: float = 0.0,
         phase: float = 0.0) -> np.ndarray:
    n = int(round(seconds * rate))
    t = np.arange(n, dtype=np.float64) / rate
    return (db_to_lin(amp_dbfs) * np.sin(2 * np.pi * freq * t + phase)).astype(np.float32)


def stereo(mono: np.ndarray, gain_l: float = 1.0, gain_r: float = 1.0) -> np.ndarray:
    """(N,) -> planar (2, N)."""
    return np.stack([mono * gain_l, mono * gain_r]).astype(np.float32)


def interleaved(planar: np.ndarray) -> np.ndarray:
    """(C, N) -> interleaved (N*C,)."""
    return np.ascontiguousarray(planar.T).reshape(-1)


def segments(parts: list[np.ndarray]) -> np.ndarray:
    """Concatenate along time (last axis)."""
    return np.concatenate(parts, axis=-1)


def pink_noise(seconds: float, rate: int, rng=None) -> np.ndarray:
    """Approximate pink noise via the Voss/spectral shaping method."""
    rng = rng or np.random.default_rng(0)
    n = int(round(seconds * rate))
    white = rng.standard_normal(n)
    spec = np.fft.rfft(white)
    f = np.fft.rfftfreq(n, 1.0 / rate)
    shaping = np.ones_like(f)
    shaping[1:] = 1.0 / np.sqrt(f[1:])
    shaped = np.fft.irfft(spec * shaping, n)
    shaped /= np.abs(shaped).max() + 1e-12
    return shaped.astype(np.float32)
