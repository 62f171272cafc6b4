"""FFTs on `torch.fft`.

`fft_pack2` is the packed FFT of two real signals, the plain version
inside K2's counterpart (ops/stft.py); the JAX package evaluates it as
four-step DFT matmuls for the TPU's matrix unit, and K2
(csrc/stft_pooled.cu) computes its own FFT in registers. `rfft_mag` is
the display spectrum's magnitude, which the JAX package computes outside
Pallas with `jnp.fft.rfft`; its TPU-only four-step matmul variant is not
ported.
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


def rfft_mag(x: torch.Tensor) -> torch.Tensor:
    """|rfft(x)| along the last axis: (..., N) -> (..., N//2 + 1)."""
    return torch.fft.rfft(x, dim=-1).abs()
