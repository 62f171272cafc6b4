"""Trusted float64 NumPy chain of BS.1770-4 and of the pooled display
spectrogram: the port's own copy of the JAX package's
``tests/reference_impl.py`` (k_filter, subblock_sums, analyze_reference,
true_peak_reference) and of ``tools/tpu_conformance.py:f64_stft_pooled``.

It runs on the port's constants and design math (core/constants.py,
ops/kweight.py, ops/spectrum.py), which are bit-identical to the JAX
package's, so the two chains agree to float64 rounding
(tests/test_torch_conformance.py holds them to 1e-12). It is NumPy on the
host: nothing here touches a device, so it runs where JAX does not, as on
the card's machine. Slow and sequential on purpose: it exists to check
the kernels against the standard's budgets.
"""

from __future__ import annotations

import numpy as np

from soundscope_tpu_torch.core import constants as C
from soundscope_tpu_torch.ops.kweight import channel_weights, kweight_cascade_ss
from soundscope_tpu_torch.ops.spectrum import _bin_plan, _hann_np


def k_filter(x: np.ndarray, rate: int, block: int = 512) -> np.ndarray:
    """The K-filter over (C, N) in float64, by the blocked state-space
    identity (vectorised per block of `block` samples)."""
    A, Bv, Cv, D = kweight_cascade_ss(rate)
    n_state = A.shape[0]
    pows = [np.eye(n_state)]
    for _ in range(block):
        pows.append(pows[-1] @ A)
    h = np.empty(block)
    h[0] = D
    for m in range(1, block):
        h[m] = Cv @ pows[m - 1] @ Bv
    T = np.zeros((block, block))
    for k in range(block):
        T[k:, k] = h[: block - k]
    W = np.stack([pows[block - 1 - k] @ Bv for k in range(block)], axis=1)
    O = np.stack([Cv @ pows[m] for m in range(block)])
    A_B = pows[block]

    x = np.asarray(x, np.float64)
    ch, n = x.shape
    npad = -(-n // block) * block
    xp = np.zeros((ch, npad))
    xp[:, :n] = x
    y = np.empty_like(xp)
    s = np.zeros((ch, n_state))
    for j in range(npad // block):
        xb = xp[:, j * block: (j + 1) * block]
        y[:, j * block: (j + 1) * block] = xb @ T.T + s @ O.T
        s = s @ A_B.T + xb @ W.T
    return y[:, :n]


def subblock_sums(z: np.ndarray, h: int) -> np.ndarray:
    nb = z.shape[-1] // h
    return z[: nb * h].reshape(nb, h).sum(-1)


def analyze_reference(x: np.ndarray, rate: int) -> dict:
    """Full-chain results for planar (C, N) input: dict(integrated, lra,
    momentary[], shortterm[], true_peak[C])."""
    x = np.asarray(x, np.float64)
    ch = x.shape[0]
    w = channel_weights(ch)
    y = k_filter(x, rate)
    z = (w[:, None] * y * y).sum(0)
    h = C.samples_in_100ms(rate)
    sums = subblock_sums(z, h)
    nb = len(sums)

    mom = np.array([
        sums[j - 3: j + 1].sum() / (4 * h) for j in range(3, nb)
    ]) if nb >= 4 else np.zeros(0)
    st = np.array([
        sums[j - 29: j + 1].sum() / (30 * h) for j in range(29, nb)
    ]) if nb >= 30 else np.zeros(0)

    def loud(e):
        with np.errstate(divide="ignore"):
            return C.LOUDNESS_OFFSET_DB + 10.0 * np.log10(e)

    # integrated: absolute gate, then the relative gate
    gamma_a = 10.0 ** ((C.ABSOLUTE_GATE_LUFS - C.LOUDNESS_OFFSET_DB) / 10.0)
    e1 = mom[mom >= gamma_a]
    if len(e1) == 0:
        integrated = -np.inf
    else:
        gamma_r = e1.mean() * 10.0 ** (C.RELATIVE_GATE_LU / 10.0)
        e2 = e1[e1 >= gamma_r]
        integrated = loud(e2.mean()) if len(e2) else -np.inf

    # LRA per EBU Tech 3342 on 3 s blocks at a 1 s hop
    e_lra = st[:: C.LRA_HOP_SUBBLOCKS]
    e1 = e_lra[e_lra >= gamma_a]
    if len(e1) == 0:
        lra = 0.0
    else:
        gamma_r = e1.mean() * 10.0 ** (C.LRA_RELATIVE_GATE_LU / 10.0)
        e2 = np.sort(e1[e1 >= gamma_r])
        if len(e2) == 0:
            lra = 0.0
        else:
            nlo = int(np.floor((len(e2) - 1) * C.LRA_LOW_PERCENTILE + 0.5))
            nhi = int(np.floor((len(e2) - 1) * C.LRA_HIGH_PERCENTILE + 0.5))
            lra = loud(e2[nhi]) - loud(e2[nlo])

    return {
        "integrated": integrated,
        "lra": lra,
        "momentary": loud(mom) if len(mom) else mom,
        "shortterm": loud(st) if len(st) else st,
        "true_peak": true_peak_reference(x, rate),
    }


def true_peak_reference(x: np.ndarray, rate: int) -> np.ndarray:
    """Per-channel float64 polyphase true peak (BS.1770-4 Annex 2)."""
    factor = C.true_peak_factor(rate)
    sp = np.abs(x).max(-1)
    if factor == 1:
        return sp
    taps = C.TRUE_PEAK_TAPS
    j = np.arange(taps, dtype=np.float64)
    m = j - (taps - 1) / 2.0
    c = np.ones(taps)
    nz = np.abs(m) > 1e-6
    c[nz] = np.sin(m[nz] * np.pi / factor) / (m[nz] * np.pi / factor)
    c *= 0.5 * (1.0 - np.cos(2.0 * np.pi * j / (taps - 1)))
    out = np.zeros(x.shape[0])
    for ci in range(x.shape[0]):
        up = np.zeros(x.shape[1] * factor)
        up[::factor] = x[ci]
        y = np.convolve(up, c, mode="full")[: len(up)]
        out[ci] = max(np.abs(y).max(), sp[ci])
    return out


def f64_stft_pooled(x: np.ndarray, nw: int, rate: int):
    """The pooled mid/side display spectrogram of ONE stereo track (2, N)
    over its first `nw` windows, in float64: (mid_db, side_db), each
    (nw, 128) (the function K2 computes, ops/stft_pooled.py)."""
    win, hop, pool = C.DEFAULT_FFT_SIZE, 2048, 128
    lo, hi, _, pink_db, _ = _bin_plan(win, rate, C.SPECTRUM_FMIN_HZ, C.SPECTRUM_FMAX_HZ)
    gain = np.zeros(win, np.float64)
    gain[lo:hi] = (4.0 / win) * 10.0 ** (pink_db.astype(np.float64) / 20.0)
    w = _hann_np(win).astype(np.float64)
    per = win // pool

    l, r = x[0].astype(np.float64), x[1].astype(np.float64)
    mids = np.zeros((nw, pool))
    sides = np.zeros((nw, pool))
    for j in range(nw):
        sl = slice(j * hop, j * hop + win)
        L = np.fft.fft(l[sl] * w)
        R = np.fft.fft(r[sl] * w)
        for out, spec in ((mids, (L + R) / 2), (sides, (L - R) / 2)):
            p = (np.abs(spec) * gain) ** 2
            pm = p.reshape(pool, per).max(-1)
            out[j] = np.where(
                pm > 0.0, 10.0 * np.log10(np.maximum(pm, 1e-38)), C.SPECTRUM_FLOOR_DB
            )
    return mids, sides
