"""K2: pooled mid/side display spectrogram over the frames view.

Replaces the TPU kernel ``soundscope_tpu/ops/pallas_stft.py:
stft_pooled_pallas_frames`` (kernel ``_make_kernel``). For every track and
every window w (frame rows [16w, 16w+128) of both channels, i.e. 16384
samples at a 2048-sample hop) it computes

1. the periodic Hann window and the packing z = (l+r)/2*w + i*(l-r)/2*w;
2. the complex FFT of z;
3. |M|^2 and |S|^2 by the conjugate split (k < 8192), times the squared
   per-bin display gain (4/N dBFS, +3 dB/oct pink, 0 outside 20 Hz-20 kHz);
4. the max over each band of 128 consecutive bins, then 10*log10 with the
   -150 dB floor; bands 64-127 lie at or above Nyquist and read the floor.

The TPU evaluates the FFT as four-step 128x128 DFT matmuls, because its
matrix unit is its only fast unit: about 50 MFLOP per window. On the H100,
csrc/stft_pooled.cu runs one CTA of 1024 threads per (track, window): a
radix-4 decimation-in-time FFT over the 16384 complex f32 values held in
128 KB of shared memory (about 1 MFLOP per window, in full f32).

What bounds it on the H100: shared-memory traffic of the seven radix-4
stages (each reads and writes all 128 KB), with one 128 KB CTA per SM.
Device-memory traffic is small: overlapping windows re-read the input
8x, mostly from L2.

All N/2048 - 7 windows are computed: the TPU kernel's truncation to a
multiple of its window chunk, and the tail fill around it, are not ported.
The JAX `dtype` argument is dropped; the port computes in f32.

`stft_pooled_frames` launches the kernel on a CUDA tensor and runs
`stft_pooled_frames_plain` on a CPU tensor; any other device raises. The
kernel pools only bins below Nyquist, so it needs rate > 40 kHz
(`rate_supported`); callers route lower rates to the plain
`ops/stft.stft_midside_display` on every device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from soundscope_tpu_torch.core import constants as C
from soundscope_tpu_torch.ops.spectrum import _hann_np
from soundscope_tpu_torch.ops.stft import HOP, _pooled_gain_plan, stft_midside_display

WIN = C.DEFAULT_FFT_SIZE
BANDS = 128

# kernel launches (one per call of stft_pooled_frames on CUDA)
LAUNCHES = 0


def rate_supported(rate: int) -> bool:
    """The kernel pools only the sub-Nyquist half of the spectrum, which
    requires the 20 kHz display ceiling to sit strictly below Nyquist."""
    return rate > 2 * C.SPECTRUM_FMAX_HZ


@functools.lru_cache(maxsize=None)
def _consts_np(rate: int):
    """Host constants of the kernel: Hann window (WIN,), squared gain of
    the bins below Nyquist (WIN/2,), twiddles exp(-2 pi i k / WIN) as
    (WIN, 2) (cos, -sin) — all float32 from float64."""
    gain, _, _ = _pooled_gain_plan(WIN, rate, BANDS)
    g2 = (gain.astype(np.float64) ** 2).astype(np.float32)
    if not rate_supported(rate) or np.any(g2[WIN // 2:] > 0.0):
        raise ValueError(
            f"stft_pooled_frames: display range reaches Nyquist at rate "
            f"{rate} (needs rate > {2 * C.SPECTRUM_FMAX_HZ}); use "
            "ops/stft.stft_midside_display")
    ang = 2.0 * np.pi * np.arange(WIN, dtype=np.float64) / WIN
    tw = np.stack([np.cos(ang), -np.sin(ang)], axis=-1).astype(np.float32)
    return _hann_np(WIN), np.ascontiguousarray(g2[: WIN // 2]), tw


@functools.lru_cache(maxsize=None)
def _device_consts(rate: int, device: torch.device):
    return tuple(torch.from_numpy(a).to(device) for a in _consts_np(rate))


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
    side_db), each (B, nw, 128) float32 with nw = N // 2048 - 7 (K2)."""
    global LAUNCHES
    if frames.device.type == "cpu":
        return stft_pooled_frames_plain(frames, rate)
    if frames.device.type != "cuda":
        raise ValueError(f"K2 runs on CPU or CUDA tensors, not {frames.device}")
    b, n, nw = _check(frames, rate)
    if not frames.is_contiguous():
        raise ValueError("frames must be contiguous")
    if b > 65535:
        raise ValueError(f"K2 takes at most 65535 tracks per call, got {b}")
    mid = torch.empty((b, nw, BANDS), dtype=torch.float32, device=frames.device)
    side = torch.empty_like(mid)
    if b == 0 or nw == 0:
        return mid, side
    hann, g2, tw = _device_consts(rate, frames.device)

    from soundscope_tpu_torch.ops import _build

    lib = _build.library()
    with torch.cuda.device(frames.device):
        err = lib.ss_stft_pooled(
            frames.data_ptr(), b, n, nw, hann.data_ptr(), g2.data_ptr(),
            tw.data_ptr(), mid.data_ptr(), side.data_ptr(),
            torch.cuda.current_stream(frames.device).cuda_stream)
    _build.raise_on_error(lib, err, "K2 stft_pooled")
    LAUNCHES += 1
    return mid, side
