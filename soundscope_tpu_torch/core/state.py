"""Meter state: the carried state of one streaming BS.1770-4 meter.

A dataclass of tensors with the JAX package's fields, in its order and
with its dtypes (int32 counters and histograms, float32 values), so that
a checkpoint written by either package loads in the other
(utils/checkpoint.py). The streaming transition (models/meter.py) returns
a new state; it never writes into the one it was given. All shapes follow
from the :class:`MeterConfig`.
"""

from __future__ import annotations

import dataclasses

import torch

from soundscope_tpu_torch.core import constants as C
from soundscope_tpu_torch.core.config import MeterConfig
from soundscope_tpu_torch.core.device import default_device


@dataclasses.dataclass
class MeterState:
    """Carried state of one streaming BS.1770-4 meter.

    Energy bookkeeping uses "z" = sum_ch w_ch * y_ch^2, the channel-weighted
    squared K-weighted signal, so block energies are plain windowed means.
    """

    # K-weighting cascade state per channel, in the filter's modal basis: (channels, 4).
    filt_state: torch.Tensor

    # Ring of the most recent 3 s of z (exact momentary/short-term windows
    # ending at the last pushed sample): (30 * subblock,).
    z_ring: torch.Tensor
    z_pos: torch.Tensor          # int32 write cursor into z_ring
    frames_total: torch.Tensor   # int32 total frames pushed since reset (wraps)

    # 100 ms sub-block accumulator.
    subblock_partial: torch.Tensor  # f32 partial sum of the current sub-block
    subblock_fill: torch.Tensor     # int32 samples in the partial sub-block
    subblock_ring: torch.Tensor     # (30,) last completed sub-block sums
    subblocks_done: torch.Tensor    # int32 completed sub-blocks since reset

    # Exact gating histories (used when cfg.max_blocks > 0).
    block_energy: torch.Tensor      # (max(max_blocks, 1),) 400 ms block energies
    block_count: torch.Tensor       # int32
    lra_energy: torch.Tensor        # (max(max_lra_blocks, 1),) 3 s / 1 s-hop energies
    lra_count: torch.Tensor         # int32

    # Histogram gating histories (always kept; unbounded duration).
    block_hist: torch.Tensor        # (HIST_BINS,) int32 counts
    lra_hist: torch.Tensor          # (HIST_BINS,) int32 counts

    # Peaks.
    true_peak: torch.Tensor         # (channels,) linear true peak since reset
    sample_peak: torch.Tensor       # (channels,) linear sample peak since reset
    tp_tail: torch.Tensor           # (channels, TRUE_PEAK_TAPS - 1) input tail

    def to(self, device) -> "MeterState":
        return MeterState(**{f.name: getattr(self, f.name).to(device)
                             for f in dataclasses.fields(self)})


def init_meter_state(cfg: MeterConfig, device=None) -> MeterState:
    """A fresh state on `device`: the card when there is one, unless the
    caller asks for the CPU."""
    device = default_device(device)
    ch = cfg.channels
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return MeterState(
        filt_state=torch.zeros((ch, 4), **f32),
        z_ring=torch.zeros((cfg.shortterm_window,), **f32),
        z_pos=torch.zeros((), **i32),
        frames_total=torch.zeros((), **i32),
        subblock_partial=torch.zeros((), **f32),
        subblock_fill=torch.zeros((), **i32),
        subblock_ring=torch.zeros((C.SHORTTERM_SUBBLOCKS,), **f32),
        subblocks_done=torch.zeros((), **i32),
        block_energy=torch.zeros((max(cfg.max_blocks, 1),), **f32),
        block_count=torch.zeros((), **i32),
        lra_energy=torch.zeros((max(cfg.max_lra_blocks, 1),), **f32),
        lra_count=torch.zeros((), **i32),
        block_hist=torch.zeros((C.HIST_BINS,), **i32),
        lra_hist=torch.zeros((C.HIST_BINS,), **i32),
        true_peak=torch.zeros((ch,), **f32),
        sample_peak=torch.zeros((ch,), **f32),
        tp_tail=torch.zeros((ch, C.TRUE_PEAK_TAPS - 1), **f32),
    )
