"""Plain BS.1770-4 / EBU Tech 3342 chain: K-weighting, 100 ms sub-block
energies, gating, momentary and short-term timelines, LRA, the 4x true peak.

Heavy stages run in PyTorch on the input's device (the card, where the
benchmark runs), in blocks of rows; the gating runs in NumPy on the
sub-block sums. The K-filter uses the blocked state-space identity of the
designed cascade (design.block_matrices), the true peak the polyphase
interpolator tap by tap. Nothing here imports the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import design as D
from benchmark.reference.precision import FLOAT64, Precision

BLOCK = 1024        # samples per block of the K-filter's state-space identity
ROWS = 16           # rows per chunk of the heavy stages


def k_filter(x: torch.Tensor, rate: int, p: Precision = FLOAT64) -> torch.Tensor:
    """The K-weighted signal of rows x (R, N), in p.work on x's device."""
    R, n = x.shape
    T, W, O, AB = (p.r(torch.from_numpy(m).to(x.device)) for m in D.block_matrices(rate, BLOCK))
    nblk = -(-n // BLOCK)
    xb = torch.zeros((R, nblk * BLOCK), dtype=p.work, device=x.device)
    xb[:, :n] = p.r(x)
    xb = xb.view(R, nblk, BLOCK)
    y = p.r(xb @ T.T)                       # zero-state response of each block
    u = p.r(xb @ W.T)                       # each block's input carried to its end
    states = torch.empty((R, nblk, 4), dtype=p.work, device=x.device)
    s = torch.zeros((R, 4), dtype=p.work, device=x.device)
    for j in range(nblk):
        states[:, j] = s
        s = p.r(s @ AB.T + u[:, j])
    y = p.r(y + states @ O.T)
    return y.reshape(R, -1)[:, :n]


def subblock_sums(x: torch.Tensor, rate: int, p: Precision = FLOAT64) -> np.ndarray:
    """Sums of z = sum_c w_c y_c^2 over each complete 100 ms sub-block of
    tracks x (b, ch, N): (b, N // h) float64."""
    b, ch, n = x.shape
    h = D.subblock(rate)
    nb = n // h
    w = D.channel_weights(ch)
    out = np.zeros((b, nb))
    per = max(1, ROWS // ch)
    for t0 in range(0, b, per):
        xs = x[t0:t0 + per, :, : nb * h]
        y = k_filter(xs.reshape(-1, nb * h), rate, p).reshape(xs.shape[0], ch, -1)
        z = p.r(sum(p.r(float(w[c]) * y[:, c] * y[:, c]) for c in range(ch) if w[c] != 0.0))
        out[t0:t0 + per] = p.r(z.reshape(xs.shape[0], nb, h).sum(-1)).double().cpu().numpy()
    return out


def peak_envelope(x: torch.Tensor, rate: int, p: Precision = FLOAT64) -> torch.Tensor:
    """(R, N) in p.work: at each sample m of rows x (R, N), the largest of
    |x[m]| and of the interpolator's outputs m*factor .. m*factor + factor-1
    (the interpolator started from zeros: outputs 0..N*factor - 1)."""
    factor = D.true_peak_factor(rate)
    xs = p.r(x)
    env = xs.abs()
    if factor > 1:
        taps = D.polyphase_taps(factor)
        k = taps.shape[1]
        n = x.shape[-1]
        xp = torch.nn.functional.pad(xs, (k - 1, 0))
        for ph in range(factor):
            y = torch.zeros_like(xs)
            for t in range(k):
                if taps[ph, t] != 0.0:
                    y = p.r(y + float(taps[ph, t]) * xp[:, k - 1 - t: k - 1 - t + n])
            env = torch.maximum(env, y.abs())
    return env


def peaks(x: torch.Tensor, rate: int, p: Precision = FLOAT64):
    """(true peak, sample peak) of each row of x (R, N), float64 NumPy."""
    R = x.shape[0]
    tp, sp = np.zeros(R), np.zeros(R)
    for r0 in range(0, R, ROWS):
        xs = x[r0:r0 + ROWS]
        tp[r0:r0 + ROWS] = peak_envelope(xs, rate, p).amax(-1).double().cpu().numpy()
        sp[r0:r0 + ROWS] = p.r(xs).abs().amax(-1).double().cpu().numpy()
    return tp, sp


def loudness(e) -> np.ndarray:
    e = np.asarray(e, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(e > 0.0, D.LOUDNESS_OFFSET_DB + 10.0 * np.log10(np.where(e > 0, e, 1.0)),
                        -np.inf)


def window_energies(sums: np.ndarray, h: int, w: int, p: Precision = FLOAT64) -> np.ndarray:
    """Mean energy of each trailing window of w sub-blocks of sums (nb,)."""
    if len(sums) < w:
        return np.zeros(0)
    c = np.concatenate([[0.0], np.cumsum(sums)])
    return p.rn((c[w:] - c[:-w]) / (w * h))


_ABS_GATE = 10.0 ** ((D.ABSOLUTE_GATE_LUFS - D.LOUDNESS_OFFSET_DB) / 10.0)


def gated_loudness(e: np.ndarray) -> float:
    """Integrated loudness of 400 ms block energies (both gates '>=')."""
    e1 = e[e >= _ABS_GATE]
    if len(e1) == 0:
        return -np.inf
    e2 = e1[e1 >= e1.mean() * 10.0 ** (D.RELATIVE_GATE_LU / 10.0)]
    return float(loudness(e2.mean())) if len(e2) else -np.inf


def loudness_range(e: np.ndarray) -> float:
    """EBU Tech 3342 LRA of 3 s energies at a 1 s hop."""
    e1 = e[e >= _ABS_GATE]
    if len(e1) == 0:
        return 0.0
    e2 = np.sort(e1[e1 >= e1.mean() * 10.0 ** (D.LRA_RELATIVE_GATE_LU / 10.0)])
    if len(e2) == 0:
        return 0.0
    lo = int(np.floor((len(e2) - 1) * D.LRA_LOW + 0.5))
    hi = int(np.floor((len(e2) - 1) * D.LRA_HIGH + 0.5))
    return float(loudness(e2[hi]) - loudness(e2[lo]))


def from_sums(sums: np.ndarray, rate: int, p: Precision = FLOAT64) -> dict:
    """Whole-file results of one track's sub-block sums (nb,): integrated,
    lra, momentary and shortterm timelines (LUFS at a 100 ms hop)."""
    h = D.subblock(rate)
    mom = window_energies(sums, h, D.MOMENTARY_SUBBLOCKS, p)
    st = window_energies(sums, h, D.SHORTTERM_SUBBLOCKS, p)
    return {"integrated": gated_loudness(mom), "lra": loudness_range(st[:: D.LRA_HOP_SUBBLOCKS]),
            "momentary": loudness(mom), "shortterm": loudness(st)}


def analyze(x: torch.Tensor, n_valid, rate: int, p: Precision = FLOAT64) -> list[dict]:
    """Whole-file results of tracks x (b, ch, N), each valid to n_valid[i]:
    a dict per track of integrated, lra, momentary, shortterm, true_peak
    (ch,), sample_peak (ch,). Tracks of one length are filtered together."""
    b, ch, _ = x.shape
    nv = [int(v) for v in n_valid]
    out: list[dict] = [{} for _ in range(b)]
    for n in sorted(set(nv)):
        idx = [i for i in range(b) if nv[i] == n]
        xs = x[idx, :, :n]
        sums = subblock_sums(xs, rate, p)
        tp, sp = peaks(xs.reshape(-1, n), rate, p)
        for j, i in enumerate(idx):
            out[i] = {**from_sums(sums[j], rate, p),
                      "true_peak": tp[j * ch:(j + 1) * ch], "sample_peak": sp[j * ch:(j + 1) * ch]}
    return out
