"""Packed FFT of two real signals — the plain version inside K2's
counterpart (ops/stft.py).

The JAX package evaluates this transform as four-step DFT matmuls for the
TPU's matrix unit; the plain version here is `torch.fft.fft`. K2
(csrc/stft_pooled.cu) computes its own FFT in shared memory.
"""

from __future__ import annotations

import torch


def fft_pack2(a: torch.Tensor, b: torch.Tensor):
    """DFTs of TWO real signals with ONE complex FFT (pack z = a + i*b).

    Returns (Ar, Ai, Br, Bi), each (..., N) float32 — the full complex
    spectra of a and b, recovered via the conjugate-symmetry split
      A[k] = (Z[k] + conj(Z[-k]))/2,  B[k] = (Z[k] - conj(Z[-k]))/(2i).
    """
    z = torch.fft.fft(torch.complex(a.float(), b.float()), dim=-1)
    zr, zi = z.real, z.imag
    zr_rev = torch.roll(zr.flip(-1), 1, dims=-1)  # Z[-k].re
    zi_rev = torch.roll(zi.flip(-1), 1, dims=-1)  # Z[-k].im
    ar = 0.5 * (zr + zr_rev)
    ai = 0.5 * (zi - zi_rev)
    br = 0.5 * (zi + zi_rev)
    bi = 0.5 * (zr_rev - zr)
    return ar, ai, br, bi
