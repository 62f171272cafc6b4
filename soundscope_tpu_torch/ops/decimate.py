"""Min-max waveform decimation.

The reference's bucket math, exactly (src/analyzer.rs:107-137):
`window_secs * 1000` buckets; bucket i covers samples
[floor(i*spp), min(ceil((i+1)*spp), len)) with spp = len / buckets —
fractional boundaries, so adjacent buckets may share one sample. Empty
buckets yield (0.0, 0.0); buckets whose start >= len are truncated (a
validity count is returned instead of a shorter list).

The bucket boundaries are host integers, planned once per (length,
buckets) as in the JAX package, so the decimation is one gather into a
(buckets, max_width) matrix plus masked row min/max.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from soundscope_tpu_torch.core.device import upload


@functools.lru_cache(maxsize=64)
def _bucket_plan(n: int, buckets: int):
    spp = n / buckets
    starts = np.minimum((np.arange(buckets) * spp).astype(np.int64), n)
    ends = np.minimum(np.ceil((np.arange(1, buckets + 1) * spp)).astype(np.int64), n)
    ends = np.maximum(ends, starts)
    valid = int(np.count_nonzero(starts < n))
    width = int(max(1, (ends - starts).max()))
    idx = starts[:, None] + np.arange(width)[None, :]
    mask = idx < ends[:, None]
    idx = np.clip(idx, 0, max(n - 1, 0))
    return idx.astype(np.int32), mask, valid


@functools.lru_cache(maxsize=16)
def _plan_on(n: int, buckets: int, device: torch.device):
    idx, mask, _ = _bucket_plan(n, buckets)
    return upload(idx.astype(np.int64), device), upload(mask, device)


def minmax_decimate(samples: torch.Tensor, window_secs: float):
    """Decimate (..., n) samples into `window_secs*1000` min/max buckets.

    Returns (mins (..., W), maxs (..., W), valid_buckets: int). The first
    `valid_buckets` entries are the reference's emitted points.
    """
    n = samples.shape[-1]
    buckets = int(window_secs * 1000.0)
    if buckets <= 0 or n == 0:
        z = samples.new_zeros((*samples.shape[:-1], max(buckets, 0)))
        return z, z, 0
    valid = _bucket_plan(n, buckets)[2]
    idx, mask = _plan_on(n, buckets, samples.device)
    g = samples[..., idx]  # (..., W, width)
    mins = torch.where(mask, g, float("inf")).amin(dim=-1)
    maxs = torch.where(mask, g, float("-inf")).amax(dim=-1)
    any_valid = mask.any(dim=-1)
    return torch.where(any_valid, mins, 0.0), torch.where(any_valid, maxs, 0.0), valid


def waveform_points(samples, window_secs: float) -> np.ndarray:
    """Host convenience: (2*valid, 2) array of (x, y) points in the
    reference's emission order [(x, min), (x, max), ...]."""
    mins, maxs, valid = minmax_decimate(torch.as_tensor(samples), window_secs)
    mins = mins[..., :valid].cpu().numpy()
    maxs = maxs[..., :valid].cpu().numpy()
    xs = np.arange(valid, dtype=np.float64)
    pts = np.empty((2 * valid, 2))
    pts[0::2, 0] = xs
    pts[1::2, 0] = xs
    pts[0::2, 1] = mins
    pts[1::2, 1] = maxs
    return pts
