"""True-peak measurement (ITU-R BS.1770-4 Annex 2) — the plain version.

The signal is oversampled with a 49-tap Hann-windowed-sinc polyphase FIR
(factor 4 below 96 kHz, 2 below 192 kHz, none above) and the true peak is
the maximum absolute interpolated value, reported as a linear amplitude.
The polyphase filter is one `conv1d` with F output channels (phases).

K1 (ops/iir_chunked.py) computes the same FIR inside its kernel; this
module is its plain counterpart.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from soundscope_tpu_torch.core import constants as C


@functools.lru_cache(maxsize=None)
def _polyphase_taps(factor: int, taps: int = C.TRUE_PEAK_TAPS):
    """(factor, phase_len) float32 polyphase decomposition of the
    Hann-windowed sinc with cutoff at the input Nyquist."""
    j = np.arange(taps, dtype=np.float64)
    m = j - (taps - 1) / 2.0
    c = np.ones(taps)
    nz = np.abs(m) > 1e-6
    arg = m[nz] * np.pi / factor
    c[nz] = np.sin(arg) / arg
    c *= 0.5 * (1.0 - np.cos(2.0 * np.pi * j / (taps - 1)))
    phase_len = -(-taps // factor)
    h = np.zeros((factor, phase_len))
    for jj in range(taps):
        h[jj % factor, jj // factor] = c[jj]
    return h.astype(np.float32)


def sample_peak(x: torch.Tensor) -> torch.Tensor:
    """Max |x| along the last axis."""
    return x.abs().amax(dim=-1)


def polyphase_outputs(g: torch.Tensor, factor: int) -> torch.Tensor:
    """Oversampled outputs of the BS.1770 interpolator over g (..., M).

    g must include taps-per-phase - 1 samples of left context; returns
    (..., factor, M - (K-1)) where K is the per-phase tap count.

    On a CUDA tensor the convolution runs with cuDNN's TF32 mode off: TF32
    keeps about three decimal digits, far outside the true-peak pin.
    """
    h = torch.from_numpy(_polyphase_taps(factor)).to(g.device)   # (F, K)
    k = h.shape[1]
    batch = g.shape[:-1]
    lhs = g.reshape(int(np.prod(batch)) if batch else 1, 1, g.shape[-1])
    # conv output m: sum_t rev_h[p, t] * g[m + t]  == y_p[n], m = n.
    rhs = h.flip(-1).unsqueeze(1)                                 # (F, 1, K)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = torch.nn.functional.conv1d(lhs, rhs)                  # (b, F, M-K+1)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return y.reshape(*batch, factor, g.shape[-1] - k + 1)


def true_peak_masked(x: torch.Tensor, n_valid, rate: int):
    """(true_peak, sample_peak) over the first n_valid samples of (..., N).

    `n_valid` broadcasts against x's leading axes with a trailing axis of
    1 (e.g. (b, 1, 1) for x (b, ch, N)). Interpolator outputs at positions
    >= n_valid are masked so padding can never ring above the real signal.
    """
    n = x.shape[-1]
    valid = torch.arange(n, device=x.device) < torch.as_tensor(
        n_valid, device=x.device)
    x = torch.where(valid, x, 0.0)
    sp = sample_peak(x)
    factor = C.true_peak_factor(rate)
    if factor == 1:
        return sp, sp
    k = _polyphase_taps(factor).shape[1]
    g = torch.nn.functional.pad(x, (k - 1, 0))
    y = polyphase_outputs(g, factor)
    y = torch.where(valid.unsqueeze(-2), y, 0.0)
    tp = y.abs().amax(dim=(-2, -1))
    return torch.maximum(tp, sp), sp
