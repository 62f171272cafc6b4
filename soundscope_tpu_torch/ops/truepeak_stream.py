"""K6: streaming true peak and sample peak over (..., N).

Replaces the TPU kernel ``soundscope_tpu/ops/pallas_truepeak.py:
true_peak_pallas`` (pallas_call at ``:166``). Per row of x (..., N) it
computes the BS.1770-4 Annex 2 true peak (the 49-tap polyphase
interpolator, 4x below 96 kHz and 2x below 192 kHz) and the sample peak
over the first n_valid samples, with interpolator outputs at positions >=
n_valid ignored; tp = max(tp, sp).

`n_valid` is a scalar, or one length per track (a leading batch axis)
repeated over the remaining rows, as in the reference. At factor 1
(>= 192 kHz) the reference makes no kernel call and takes a masked max;
so does `true_peak_stream`, on every device.

On a CUDA tensor `true_peak_stream` launches csrc/truepeak_stream.cu: each
(row, segment of TILE samples) an independent ticket of the tile-scan
core's persistent, double-buffered copy (with the FIR's 32-sample halo),
each CTA a contiguous run of them; the FIR of K1 and K3 without phase 0
over each thread's 32 samples, one partial peak per CTA and row, then a
deterministic per-row max. It reads a track's n_valid per row (no
expanded copy) and takes the taps by value. On a CPU tensor it runs
`true_peak_stream_plain` (ops/truepeak.true_peak_masked); any other
device raises.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from soundscope_tpu_torch.core import constants as C
from soundscope_tpu_torch.core.device import upload
from soundscope_tpu_torch.ops import iir_tile
from soundscope_tpu_torch.ops.truepeak import true_peak_masked

# samples per segment (CTA of 256 threads)
TILE = 8192


def _rows(x: torch.Tensor, n_valid):
    """(x as (rows, N), n_valid as int64 on x's device, the rows each length
    covers, x's leading shape): one length per `per` consecutive rows (a
    track's channels); a host value is uploaded without a host sync."""
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    batch, n = x.shape[:-1], x.shape[-1]
    rows = math.prod(batch)
    if isinstance(n_valid, torch.Tensor):
        nv = n_valid.to(x.device, torch.int64).reshape(-1).contiguous()
    else:
        nv = upload(np.asarray(n_valid, np.int64).reshape(-1), x.device)
    if nv.numel() == 0 or rows % nv.numel():
        raise ValueError(f"{nv.numel()} valid lengths for {rows} rows")
    return x.reshape(rows, n), nv, rows // nv.numel(), batch


def true_peak_stream_plain(x: torch.Tensor, n_valid, rate: int):
    """Plain PyTorch version of K6: true_peak_masked per row. Same
    arguments and results as `true_peak_stream`."""
    x2, nv, per, batch = _rows(x, n_valid)
    if C.true_peak_factor(rate) > 1 and x2.shape[1] % 128:
        raise ValueError(f"N must be a multiple of 128, got {x2.shape[1]}")
    tp, sp = true_peak_masked(x2, nv.repeat_interleave(per)[:, None], rate)
    return tp.reshape(batch), sp.reshape(batch)


def true_peak_stream(x: torch.Tensor, n_valid, rate: int):
    """(true_peak, sample_peak), each of x's leading shape (...,), over the
    first n_valid samples of x (..., N) float32, N % 128 == 0 where the
    rate needs oversampling."""
    factor = C.true_peak_factor(rate)
    if x.device.type == "cpu" or factor == 1:
        return true_peak_stream_plain(x, n_valid, rate)
    if x.device.type != "cuda":
        raise ValueError(f"K6 runs on CPU or CUDA tensors, not {x.device}")
    x2, nv, per, batch = _rows(x, n_valid)
    rows, n = x2.shape
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("K6: x must be contiguous and 16-byte aligned")
    if n % 128 or n == 0:
        raise ValueError(f"K6: N must be a positive multiple of 128, got {n}")
    taps = iir_tile.fir_taps(factor)          # checks phase 0 and the last taps
    dev = x.device
    nseg = -(-n // TILE)
    part = torch.empty((2, rows, nseg), dtype=torch.float32, device=dev)
    out = torch.empty((2, rows), dtype=torch.float32, device=dev)

    from soundscope_tpu_torch.ops import _build

    _build.launch("ss_true_peak_stream", "K6 true_peak_stream", dev,
                  x2.data_ptr(), nv.data_ptr(), per, taps.ctypes.data, factor, rows, n,
                  part[0].data_ptr(), part[1].data_ptr(), out[0].data_ptr(),
                  out[1].data_ptr())
    return out[0].reshape(batch), out[1].reshape(batch)


def kernel_attributes(factor: int = 4) -> dict:
    """K6's resources at this factor (2 or 4) as the CUDA runtime reports
    them (needs a card); the keys of ops/_build.ATTRIBUTE_KEYS."""
    from soundscope_tpu_torch.ops import _build

    return _build.attributes("ss_true_peak_stream_attrs", factor)
