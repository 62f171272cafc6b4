"""Blocked state-space IIR filtering — the plain K-weighting filter.

The exact linear-algebra restatement of an IIR over blocks of length B,
as in the JAX package's ops/biquad.py:

    y_blk  = x_blk @ T^T  +  s0 @ O^T        (zero-state + state response)
    s_next = s0 @ A_B^T   +  x_blk @ W^T     (block state transition)

with, for the LTI system (A, B, C, D) of the cascade,
    T[n, k]  = h[n - k]       (lower-triangular Toeplitz of the impulse resp.)
    O[n, :]  = C A^n
    W[:, k]  = A^{B-1-k} B
    A_B      = A^B

The matrices are built on the host in float64 (bit-identical to the
reference) and applied in float32. The only sequential dependency, the
4-dimensional affine recurrence on s, is resolved with a doubling
(Hillis-Steele) scan over the blocks, since torch has no associative scan.

This is the plain version of K1's filter (ops/iir_chunked.py). K1 itself
runs the same system sample by sample in the modal realisation, so the
filter carries that realisation (A, B, C, D) in float64 as well.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class BlockFilter:
    """Blocked-application constants of one LTI system.

    Tensors (float32, on one device):
      Tt (B, B): Tt[k, n] = h[n - k]       (y0 = x @ Tt)
      Wt (B, n): Wt[k, :] = A^{B-1-k} B    (s_in = x @ Wt)
      Ot (n, B): Ot[:, n] = (C A^n)^T      (y_s = s0 @ Ot)
      A_pows (B + 1, n, n): A^0 .. A^B
    Host float64 (the modal realisation the tensors were built from):
      A (n, n), Bv (n,), Cv (n,), D, and A_block = A^B
    """

    Tt: torch.Tensor
    Wt: torch.Tensor
    Ot: torch.Tensor
    A_pows: torch.Tensor
    block: int
    A: np.ndarray
    Bv: np.ndarray
    Cv: np.ndarray
    D: float
    A_block: np.ndarray

    def to(self, device) -> "BlockFilter":
        return dataclasses.replace(
            self, Tt=self.Tt.to(device), Wt=self.Wt.to(device),
            Ot=self.Ot.to(device), A_pows=self.A_pows.to(device))

    def power(self, steps: int) -> np.ndarray:
        """A^steps in float64 (the state advance over `steps` samples),
        from A^B when B divides steps."""
        if steps % self.block == 0:
            return np.linalg.matrix_power(self.A_block, steps // self.block)
        return np.linalg.matrix_power(self.A, steps)


@functools.lru_cache(maxsize=None)
def _build_block_filter_np(ss_key, block: int):
    """ss_key: hashable ((A rows...), (B...), (C...), D) in f64."""
    A = np.asarray(ss_key[0], np.float64)
    Bv = np.asarray(ss_key[1], np.float64)
    Cv = np.asarray(ss_key[2], np.float64)
    D = float(ss_key[3])
    n = A.shape[0]
    B = block

    pows = np.empty((B + 1, n, n))
    pows[0] = np.eye(n)
    for i in range(1, B + 1):
        pows[i] = pows[i - 1] @ A

    h = np.empty(B)
    h[0] = D
    for m in range(1, B):
        h[m] = Cv @ pows[m - 1] @ Bv

    Tt = np.zeros((B, B))
    for k in range(B):
        Tt[k, k:] = h[: B - k]

    Wt = np.stack([pows[B - 1 - k] @ Bv for k in range(B)])  # (B, n)
    Ot = np.stack([Cv @ pows[m] for m in range(B)], axis=1)  # (n, B)
    return (
        Tt.astype(np.float32),
        Wt.astype(np.float32),
        Ot.astype(np.float32),
        pows.astype(np.float32),
    )


def modal_form(ss):
    """Real modal (block-diagonal) realization of (A, B, C, D).

    Direct-form cascade state matrices are highly non-normal: their powers
    transiently grow before decaying, which amplifies float32 rounding by
    orders of magnitude. The modal form has A made of 2x2 rotation-scaling
    blocks (one per complex pole pair), which is normal, so float32 state
    propagation is well conditioned. The transfer function is unchanged.
    Modes are balanced so input and output gains match.
    """
    evals, vecs = np.linalg.eig(np.asarray(ss[0], np.float64))
    n = len(evals)
    used = np.zeros(n, bool)
    cols = []
    for i in range(n):
        if used[i]:
            continue
        lam = evals[i]
        used[i] = True
        if abs(lam.imag) < 1e-12:
            cols.append(vecs[:, i].real[:, None])
        else:
            j = next(
                k for k in range(n)
                if not used[k] and abs(evals[k] - lam.conjugate()) < 1e-8
            )
            used[j] = True
            v = vecs[:, i]
            cols.append(np.stack([v.real, v.imag], axis=1))
    T = np.concatenate(cols, axis=1)
    Ti = np.linalg.inv(T)
    Am = Ti @ np.asarray(ss[0], np.float64) @ T
    Bm = Ti @ np.asarray(ss[1], np.float64)
    Cm = np.asarray(ss[2], np.float64) @ T
    # Balance per mode: scale so |B| ~ |C| blockwise.
    sizes = [c.shape[1] for c in cols]
    ofs = 0
    scale = np.ones(n)
    for sz in sizes:
        sl = slice(ofs, ofs + sz)
        nb = np.linalg.norm(Bm[sl]) + 1e-300
        nc = np.linalg.norm(Cm[sl]) + 1e-300
        scale[sl] = np.sqrt(nb / nc)
        ofs += sz
    Bm = Bm / scale
    Cm = Cm * scale
    Am = (Am / scale[:, None]) * scale[None, :]
    return Am, Bm, Cm, float(ss[3])


def make_block_filter(ss, block: int = 128, device="cpu") -> BlockFilter:
    """Build a BlockFilter from a float64 state-space tuple (A, B, C, D)."""
    A, Bv, Cv, D = modal_form(ss)
    key = (
        tuple(map(tuple, np.asarray(A))),
        tuple(np.asarray(Bv)),
        tuple(np.asarray(Cv)),
        float(D),
    )
    Tt, Wt, Ot, pows = _build_block_filter_np(key, block)
    return BlockFilter(
        Tt=torch.from_numpy(Tt).to(device), Wt=torch.from_numpy(Wt).to(device),
        Ot=torch.from_numpy(Ot).to(device),
        A_pows=torch.from_numpy(pows).to(device), block=block,
        A=np.asarray(A), Bv=np.asarray(Bv), Cv=np.asarray(Cv), D=float(D),
        A_block=np.linalg.matrix_power(np.asarray(A), block),
    )


def _affine_combine(left, right):
    """Composition of x -> x @ m1 + v1 then x -> x @ m2 + v2 (the one
    composition rule of the state scan)."""
    m1, v1 = left
    m2, v2 = right
    return m1 @ m2, (v1.unsqueeze(-2) @ m2).squeeze(-2) + v2


def _affine_scan(A_B: torch.Tensor, s0: torch.Tensor, s_in: torch.Tensor):
    """Prefix states of s_{j+1} = s_j @ A_B^T + s_in_j.

    s0: (..., n). s_in: (..., nb, n). Returns s_before: (..., nb, n) — the
    state at the start of each block — and s_final: (..., n).

    A doubling (Hillis-Steele) scan: after the round with distance d,
    element j holds the composition of elements max(0, j-2d+1) .. j. The
    maps' matrices are shared across the batch, so they are kept once,
    (nb, n, n), and broadcast in each combine.
    """
    nb = s_in.shape[-2]
    n = s_in.shape[-1]
    ABt = A_B.T

    # Fold s0 into the first element so the scan is homogeneous.
    v0 = s_in[..., 0, :] + s0 @ ABt
    v = torch.cat([v0.unsqueeze(-2), s_in[..., 1:, :]], dim=-2)
    M = ABt.expand(nb, n, n)
    d = 1
    while d < nb:
        m_new, v_new = _affine_combine((M[:-d], v[..., :-d, :]),
                                       (M[d:], v[..., d:, :]))
        M = torch.cat([M[:d], m_new], dim=0)
        v = torch.cat([v[..., :d, :], v_new], dim=-2)
        d *= 2
    s_before = torch.cat([s0.unsqueeze(-2), v[..., :-1, :]], dim=-2)
    return s_before, v[..., -1, :]


def block_iir(bf: BlockFilter, x: torch.Tensor, s0: torch.Tensor):
    """Apply the filter to x: (..., N) with initial state s0: (..., n).

    A trailing partial block (N % B != 0) is handled exactly with sliced
    block matrices. Returns (y (..., N), s_final (..., n)).
    """
    B = bf.block
    N = x.shape[-1]
    nfull = N // B
    rem = N - nfull * B
    batch = x.shape[:-1]

    if nfull > 0:
        xb = x[..., : nfull * B].reshape(*batch, nfull, B)
        y0 = xb @ bf.Tt
        s_in = xb @ bf.Wt
        s_before, s_last = _affine_scan(bf.A_pows[B], s0, s_in)
        y = (y0 + s_before @ bf.Ot).reshape(*batch, nfull * B)
    else:
        y = x[..., :0]
        s_last = s0

    if rem > 0:
        xr = x[..., nfull * B:]
        y0r = xr @ bf.Tt[:rem, :rem]
        ysr = s_last @ bf.Ot[:, :rem]
        s_in_r = xr @ bf.Wt[B - rem:, :]
        s_last = s_last @ bf.A_pows[rem].T + s_in_r
        y = torch.cat([y, y0r + ysr], dim=-1)

    return y, s_last
