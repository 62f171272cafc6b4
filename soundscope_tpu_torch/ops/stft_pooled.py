"""K2: pooled mid/side display spectrogram over the frames view.

Replaces the TPU kernel ``soundscope_tpu/ops/pallas_stft.py:
stft_pooled_pallas_frames`` (kernel ``_make_kernel``). For every track and
every window w (frame rows [16w, 16w+128) of both channels, i.e. 16384
samples at a 2048-sample hop) it computes

1. mid (l+r)/2 and side (l-r)/2 under the periodic Hann window;
2. their real FFTs;
3. |M|^2 and |S|^2 of the bins below Nyquist (k < 8192), times the squared
   per-bin display gain (4/N dBFS, +3 dB/oct pink, 0 outside 20 Hz-20 kHz);
4. the max over each band of 128 consecutive bins, then 10*log10 with the
   -150 dB floor; bands 64-127 lie at or above Nyquist and read the floor.
   The max keeps a NaN (an overflowed power times a zero gain), so such a
   band reads the floor, as in the plain version.

The TPU evaluates the FFT as four-step 128x128 DFT matmuls, because its
matrix unit is its only fast unit: about 50 MFLOP per window. On the H100,
csrc/stft_pooled.cu runs two CTAs of 256 threads per (track, window), one
for mid and one for side, adjacent in launch order. Each takes the real
16384-point FFT of its channel as a packed complex 8192-point one in
float32 (about 0.55 MFLOP): 8192 = 32 x 16 x 16, each thread holding 32
complex values, three passes with two bank-conflict-free exchanges
through shared memory, and the pairs k and 8192 - k in one thread, so the
real-FFT split needs no exchange of its own; the band max reads the
powers back once in bin order. The Hann window is formed on the card from
a table of 1 - cos and sin, exact to a few ulps down to its edges.
`twiddles_np` gives the pass, split and window tables (32 KB).

What bounds it on the H100: not memory but the instructions it issues
and the latency between its barriers. At 256 threads and at most 128
registers, two independent CTAs share each SM, so one's shared-memory
exchanges, barriers and load overlap the other's butterflies. The
butterflies are radix-2 decimation in time in a fused multiply-add form
(six instructions a nontrivial butterfly), the split's twiddles come
from a (cos, tan) table, the exchanges' addresses are one base a thread
plus constants, and no thread selects between thread 0's self-paired
groups and the others'. PERF.md gives the measured times, instruction
counts and the ablations of this design and the ones before it.

All N/2048 - 7 windows are computed: the TPU kernel's truncation to a
multiple of its window chunk, and the tail fill around it, are not ported.
The JAX `dtype` argument is dropped; the port computes in f32.

`stft_pooled_frames` launches the kernel on a CUDA tensor and runs
`stft_pooled_frames_plain` on a CPU tensor; any other device raises.
`stft_pooled_packed` ((B, 2, N)) and `stft_pooled` (l, r) are views onto
it, the JAX package's other two entries. The
kernel pools only bins below Nyquist, so it needs rate > 40 kHz
(`rate_supported`); callers route lower rates to the plain
`ops/stft.stft_midside_display` on every device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from soundscope_tpu_torch.core import constants as C
from soundscope_tpu_torch.core.device import upload
from soundscope_tpu_torch.ops.spectrum import _hann_np
from soundscope_tpu_torch.ops.stft import HOP, _pooled_gain_plan, stft_midside_display
from soundscope_tpu_torch.utils.metrics import GLOBAL

WIN = C.DEFAULT_FFT_SIZE
BANDS = 128


def rate_supported(rate: int) -> bool:
    """The kernel pools only the sub-Nyquist half of the spectrum, which
    requires the 20 kHz display ceiling to sit strictly below Nyquist."""
    return rate > 2 * C.SPECTRUM_FMAX_HZ


def self_bins() -> np.ndarray:
    """The first bin k of each of the kernel's 17 self pairs (k, 8192 - k):
    256 + 512 s in group (0, 8) for s < 8, 512 (s - 7) in group (0, 0) for
    s < 16 (4096 pairs with itself), then bin 0."""
    s = np.arange(17)
    return np.where(s < 8, 256 + 512 * s, np.where(s < 16, 512 * (s - 7), 0))


def twiddles_np() -> np.ndarray:
    """The kernel's tables as (4115, 2) float32 from float64: twiddles W^e,
    W = exp(-2 pi i / WIN), as (cos, -sin): pass 1's W^(2 l k1) at 32 k1 + l
    (l, k1 < 32), pass 2's W^(64 v k1) at 8 k1 + v (v < 8) and W^(64 u k2)
    at 16 k2 + u (u, k2 < 16); then the real-FFT split's W^e (e <= 2048) as
    (cos, tan), so that W^e = cos (1 - i tan) with |tan| <= 1; then (1 -
    cos, sin) of 2 pi e / WIN (e <= 512) for the Hann window; then W^k of
    the self pairs' bins (`self_bins`) as (cos, -sin)."""
    l, u, v = np.arange(32), np.arange(16), np.arange(8)
    e = np.concatenate([2 * np.outer(l, l).ravel(), 64 * np.outer(l, v).ravel(),
                        64 * np.outer(u, u).ravel()])
    ang = 2.0 * np.pi * e.astype(np.float64) / WIN
    split = 2.0 * np.pi * np.arange(2049, dtype=np.float64) / WIN
    hann = 2.0 * np.pi * np.arange(513, dtype=np.float64) / WIN
    own = 2.0 * np.pi * self_bins().astype(np.float64) / WIN
    return np.concatenate([np.stack([np.cos(ang), -np.sin(ang)], axis=-1),
                           np.stack([np.cos(split), np.tan(split)], axis=-1),
                           np.stack([1.0 - np.cos(hann), np.sin(hann)], axis=-1),
                           np.stack([np.cos(own), -np.sin(own)], axis=-1)]
                          ).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _consts_np(rate: int):
    """Host constants of the kernel: Hann window (WIN,), squared gain of
    the bins below Nyquist (WIN/2,), the tables (4115, 2) — all float32
    from float64. The kernel forms its window from the twiddles; the Hann
    table stays an argument of its C entry."""
    gain, _, _ = _pooled_gain_plan(WIN, rate, BANDS)
    g2 = (gain.astype(np.float64) ** 2).astype(np.float32)
    if not rate_supported(rate) or np.any(g2[WIN // 2:] > 0.0):
        raise ValueError(
            f"stft_pooled_frames: display range reaches Nyquist at rate "
            f"{rate} (needs rate > {2 * C.SPECTRUM_FMAX_HZ}); use "
            "ops/stft.stft_midside_display")
    return _hann_np(WIN), np.ascontiguousarray(g2[: WIN // 2]), twiddles_np()


@functools.lru_cache(maxsize=None)
def _device_consts(rate: int, device: torch.device):
    return tuple(upload(a, device) for a in _consts_np(rate))


def _check(frames: torch.Tensor, rate: int) -> tuple[int, int, int]:
    if frames.ndim != 4 or frames.shape[1] != 2 or frames.shape[-1] != 128:
        raise ValueError(
            f"frames must be (B, 2, N/128, 128), got {tuple(frames.shape)}")
    if frames.dtype != torch.float32:
        raise TypeError(f"frames must be float32, got {frames.dtype}")
    _consts_np(rate)   # raises for rates the kernel cannot pool
    b, _, rows, _ = frames.shape
    n = rows * 128
    return b, n, max(n // HOP - WIN // HOP + 1, 0)


def stft_pooled_frames_plain(frames: torch.Tensor, rate: int):
    """Plain PyTorch version of K2, built on `stft_midside_display`."""
    _check(frames, rate)
    b, _, rows, _ = frames.shape
    x = frames.reshape(b, 2, rows * 128)
    _, mid, side = stft_midside_display(x[:, 0], x[:, 1], rate)
    return mid, side


def stft_pooled_frames(frames: torch.Tensor, rate: int):
    """frames: (B, 2, N/128, 128) float32 planar stereo -> (mid_db,
    side_db), each (B, nw, 128) float32 with nw = N // 2048 - 7 (K2).

    The call's host time is the registry's span `stft.pooled`, and its
    windows (B * nw) its counter `k2.windows`, on either device."""
    with GLOBAL.span("stft.pooled"):
        return _stft_pooled_frames(frames, rate)


def _stft_pooled_frames(frames: torch.Tensor, rate: int):
    b, n, nw = _check(frames, rate)
    if frames.device.type not in ("cpu", "cuda"):
        raise ValueError(f"K2 runs on CPU or CUDA tensors, not {frames.device}")
    GLOBAL.count("k2.windows", b * nw)
    if frames.device.type == "cpu":
        return stft_pooled_frames_plain(frames, rate)
    if not frames.is_contiguous():
        raise ValueError("frames must be contiguous")
    if frames.data_ptr() % 8:
        raise ValueError("frames must start on an 8-byte boundary (the kernel reads float2)")
    if b > 65535:
        raise ValueError(f"K2 takes at most 65535 tracks per call, got {b}")
    mid = torch.empty((b, nw, BANDS), dtype=torch.float32, device=frames.device)
    side = torch.empty_like(mid)
    if b == 0 or nw == 0:
        return mid, side
    hann, g2, tw = _device_consts(rate, frames.device)

    from soundscope_tpu_torch.ops import _build

    _build.launch("ss_stft_pooled", "K2 stft_pooled", frames.device,
                  frames.data_ptr(), b, n, nw, hann.data_ptr(), g2.data_ptr(),
                  tw.data_ptr(), mid.data_ptr(), side.data_ptr())
    return mid, side


def stft_pooled_packed(x: torch.Tensor, rate: int):
    """x: (B, 2, N) float32 planar stereo -> (mid_db, side_db), each (B,
    nw, 128), over the first N // 2048 hops (JAX:
    stft_pooled_pallas_packed). The frames view of those samples is a
    reshape, a copy only where N is no multiple of 2048. Launches K2 on a
    CUDA tensor."""
    if x.ndim != 3 or x.shape[1] != 2:
        raise ValueError(f"x must be (B, 2, N) stereo, got {tuple(x.shape)}")
    b, _, n = x.shape
    m = n // HOP * HOP
    frames = x[..., :m].reshape(b, 2, m // 128, 128).contiguous()
    return stft_pooled_frames(frames, rate)


def stft_pooled(l: torch.Tensor, r: torch.Tensor, rate: int):
    """l, r: (B, N) channel signals -> (mid_db, side_db): the packed entry
    on their stack (JAX: stft_pooled_pallas)."""
    return stft_pooled_packed(torch.stack([l, r], dim=1), rate)


def kernel_attributes() -> dict:
    """The kernel's resources as the CUDA runtime reports them (needs a
    card): registers per thread, static and dynamic shared memory bytes
    per CTA, local (spill) bytes per thread, threads per CTA and CTAs
    resident per SM."""
    from soundscope_tpu_torch.ops import _build

    return _build.attributes("ss_stft_pooled_attrs")
