"""Channel layout helpers: de-interleave and mid/side decomposition.

mid = (l + r) / 2, side = (l - r) / 2 over interleaved stereo, as the
reference's player computes them. `deinterleave` returns a strided view;
K7 reads it through its strides.
"""

from __future__ import annotations

import torch


def deinterleave(samples: torch.Tensor, channels: int) -> torch.Tensor:
    """(..., frames*channels) interleaved -> (..., channels, frames) view."""
    *batch, n = samples.shape
    frames = n // channels
    x = samples[..., : frames * channels].reshape(*batch, frames, channels)
    return x.movedim(-1, -2)


def interleave(planar: torch.Tensor) -> torch.Tensor:
    """(..., channels, frames) -> (..., frames*channels) interleaved."""
    *batch, ch, frames = planar.shape
    return planar.movedim(-2, -1).reshape(*batch, frames * ch)


def mid_side_split(samples: torch.Tensor):
    """Interleaved stereo (..., 2*frames) -> (mid (..., frames), side)."""
    return mid_side_from_planar(deinterleave(samples, 2))


def mid_side_from_planar(planar: torch.Tensor):
    """(..., 2, frames) -> (mid, side)."""
    left = planar[..., 0, :]
    right = planar[..., 1, :]
    return (left + right) * 0.5, (left - right) * 0.5
