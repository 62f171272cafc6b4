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

On a CUDA tensor `true_peak_stream` launches csrc/truepeak_stream.cu (one
thread per (row, span of `span_length(N)` samples) with the FIR halo, then
a deterministic per-row max); on a CPU tensor it runs
`true_peak_stream_plain` (ops/truepeak.true_peak_masked); any other device
raises.
"""

from __future__ import annotations

import numpy as np
import torch

from soundscope_tpu_torch.core import constants as C
from soundscope_tpu_torch.ops.iir import span_length
from soundscope_tpu_torch.ops.truepeak import _polyphase_taps, true_peak_masked

# kernel launches (one per call of true_peak_stream that runs the kernel)
LAUNCHES = 0


def _rows(x: torch.Tensor, n_valid):
    """x as (rows, N) and n_valid as (rows,) int64 on x's device."""
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    batch, n = x.shape[:-1], x.shape[-1]
    rows = int(np.prod(batch)) if batch else 1
    nva = torch.as_tensor(n_valid, device=x.device).to(torch.int64).reshape(-1)
    if nva.numel() == 1:
        nv = nva.expand(rows)
    elif rows % nva.numel() == 0:
        nv = nva.repeat_interleave(rows // nva.numel())
    else:
        raise ValueError(f"{nva.numel()} valid lengths for {rows} rows")
    return x.reshape(rows, n), nv.contiguous(), batch


def true_peak_stream_plain(x: torch.Tensor, n_valid, rate: int):
    """Plain PyTorch version of K6: true_peak_masked per row. Same
    arguments and results as `true_peak_stream`."""
    x2, nv, batch = _rows(x, n_valid)
    if C.true_peak_factor(rate) > 1 and x2.shape[1] % 128:
        raise ValueError(f"N must be a multiple of 128, got {x2.shape[1]}")
    tp, sp = true_peak_masked(x2, nv[:, None], rate)
    return tp.reshape(batch), sp.reshape(batch)


def true_peak_stream(x: torch.Tensor, n_valid, rate: int):
    """(true_peak, sample_peak), each of x's leading shape (...,), over the
    first n_valid samples of x (..., N) float32, N % 128 == 0 where the
    rate needs oversampling."""
    global LAUNCHES
    factor = C.true_peak_factor(rate)
    if x.device.type == "cpu" or factor == 1:
        return true_peak_stream_plain(x, n_valid, rate)
    if x.device.type != "cuda":
        raise ValueError(f"K6 runs on CPU or CUDA tensors, not {x.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("K6: x must be contiguous and 16-byte aligned")
    x2, nv, batch = _rows(x, n_valid)
    rows, n = x2.shape
    L = span_length(n)
    nsteps = n // L
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    taps = torch.from_numpy(_polyphase_taps(factor).reshape(-1)).to(dev)
    tp_part = torch.empty((rows, nsteps), **f32)
    sp_part = torch.empty((rows, nsteps), **f32)
    tp = torch.empty((rows,), **f32)
    sp = torch.empty((rows,), **f32)

    from soundscope_tpu_torch.ops import _build

    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.ss_true_peak_stream(
            x2.data_ptr(), nv.data_ptr(), taps.data_ptr(), factor, rows, n, L,
            tp_part.data_ptr(), sp_part.data_ptr(), tp.data_ptr(), sp.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on_error(lib, err, "K6 true_peak_stream")
    LAUNCHES += 1
    return tp.reshape(batch), sp.reshape(batch)
