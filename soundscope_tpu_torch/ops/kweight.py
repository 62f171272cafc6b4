"""K-weighting filter design (ITU-R BS.1770-4).

The K-filter is a cascade of two biquads — a high-frequency shelf modelling
the acoustic effect of the head, and an RLB high-pass. BS.1770-4 tabulates
their coefficients at 48 kHz; for arbitrary sample rates we re-discretise
the published analog prototypes (see core/constants.py) with the bilinear
transform — the same rate-generalisation the reference's ebur128 backend
performs, so meters agree at 44.1 k / 48 k / 96 k / 192 kHz.

All design math is host-side float64 NumPy, identical to the JAX
package's ops/kweight.py; the device code consumes the derived float32
block matrices (ops/biquad.py).

Reference behavior consumed at: src/analyzer.rs:139-141 (add_frames_f32
feeds this cascade inside the ebur128 crate).
"""

from __future__ import annotations

import functools

import numpy as np

from soundscope_tpu_torch.core import constants as C


def design_kweight(rate: int) -> tuple[np.ndarray, np.ndarray]:
    """Return (b, a) of the two K-weighting biquads, shape (2, 3) each, f64.

    Row 0 = stage 1 shelf, row 1 = stage 2 high-pass. a[:, 0] == 1.
    """
    # Stage 1: high shelf.
    f0 = C.KW_SHELF_F0_HZ
    g_db = C.KW_SHELF_GAIN_DB
    q = C.KW_SHELF_Q
    k = np.tan(np.pi * f0 / rate)
    vh = 10.0 ** (g_db / 20.0)
    vb = vh ** C.KW_SHELF_VB_EXP
    a0 = 1.0 + k / q + k * k
    b_shelf = np.array(
        [
            (vh + vb * k / q + k * k) / a0,
            2.0 * (k * k - vh) / a0,
            (vh - vb * k / q + k * k) / a0,
        ]
    )
    a_shelf = np.array(
        [
            1.0,
            2.0 * (k * k - 1.0) / a0,
            (1.0 - k / q + k * k) / a0,
        ]
    )

    # Stage 2: RLB high-pass. Numerator is the normalised [1, -2, 1].
    f0 = C.KW_HIPASS_F0_HZ
    q = C.KW_HIPASS_Q
    k = np.tan(np.pi * f0 / rate)
    a0 = 1.0 + k / q + k * k
    b_hp = np.array([1.0, -2.0, 1.0])
    a_hp = np.array(
        [
            1.0,
            2.0 * (k * k - 1.0) / a0,
            (1.0 - k / q + k * k) / a0,
        ]
    )
    return np.stack([b_shelf, b_hp]), np.stack([a_shelf, a_hp])


def biquad_ss(b: np.ndarray, a: np.ndarray):
    """State-space (A, B, C, D) of one biquad in transposed direct form II.

        y[n]  = b0 x[n] + z1
        z1'   = (b1 - a1 b0) x[n] - a1 z1 + z2
        z2'   = (b2 - a2 b0) x[n] - a2 z1
    """
    b0, b1, b2 = b
    _, a1, a2 = a
    A = np.array([[-a1, 1.0], [-a2, 0.0]])
    B = np.array([b1 - a1 * b0, b2 - a2 * b0])
    Cv = np.array([1.0, 0.0])
    D = b0
    return A, B, Cv, D


def series_ss(ss1, ss2):
    """Series composition: input -> system 1 -> system 2 -> output."""
    A1, B1, C1, D1 = ss1
    A2, B2, C2, D2 = ss2
    n1, n2 = A1.shape[0], A2.shape[0]
    A = np.zeros((n1 + n2, n1 + n2))
    A[:n1, :n1] = A1
    A[n1:, :n1] = np.outer(B2, C1)
    A[n1:, n1:] = A2
    B = np.concatenate([B1, B2 * D1])
    Cv = np.concatenate([C1 * D2, C2])
    D = D2 * D1
    return A, B, Cv, D


@functools.lru_cache(maxsize=None)
def kweight_cascade_ss(rate: int):
    """State-space (A(4,4), B(4,), C(4,), D) of the full K-filter, f64."""
    bs, as_ = design_kweight(rate)
    ss = series_ss(biquad_ss(bs[0], as_[0]), biquad_ss(bs[1], as_[1]))
    return ss


def channel_weights(channels: int) -> np.ndarray:
    """BS.1770-4 channel weights under the default channel map.

    Default maps (matching the reference's ebur128 backend defaults):
      1: [L]                      2: [L, R]
      4: [L, R, Ls, Rs]           5: [L, R, C, Ls, Rs]
      other: [L, R, C, LFE, Ls, Rs, unused...]
    L/R/C weigh 1.0, surrounds 1.41, LFE and unused channels 0.
    """
    s = C.SURROUND_WEIGHT
    if channels == 4:
        w = [1.0, 1.0, s, s]
    elif channels == 5:
        w = [1.0, 1.0, 1.0, s, s]
    else:
        base = [1.0, 1.0, 1.0, 0.0, s, s]
        w = base[:channels] + [0.0] * max(0, channels - 6)
    return np.asarray(w, np.float64)
