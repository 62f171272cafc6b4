"""Meter configuration.

The static parameters of one BS.1770-4 meter: channel count, sample rate,
exact-history capacity and the block length of the blocked K-weighting
filter. Unlike the JAX package there is no ``iir_impl``: kernel versus
plain version is decided by the input tensor's device.
"""

from __future__ import annotations

import dataclasses

from soundscope_tpu_torch.core import constants as C


@dataclasses.dataclass(frozen=True)
class MeterConfig:
    """Static parameters of a BS.1770-4 meter.

    Attributes:
      channels: number of input channels.
      rate: sample rate in Hz.
      max_blocks: capacity of the exact gating-block energy history
        (100 ms cadence); 0 selects histogram mode in the streaming meter
        (models/meter.py), which the whole-file engine never uses.
      block: inner block length of the blocked state-space K-weighting
        filter (ops/biquad.py).
    """

    channels: int = C.DEFAULT_CHANNELS
    rate: int = C.DEFAULT_RATE
    max_blocks: int = 36_000
    block: int = 128

    def __post_init__(self):
        if self.channels < 1:
            raise ValueError(f"channels must be >= 1, got {self.channels}")
        if self.rate < 16 or self.rate > 2_822_400:
            # same validity envelope as libebur128
            raise ValueError(f"unsupported sample rate {self.rate}")

    @property
    def subblock(self) -> int:
        """Samples per 100 ms sub-block."""
        return C.samples_in_100ms(self.rate)

    @property
    def momentary_window(self) -> int:
        return self.subblock * C.MOMENTARY_SUBBLOCKS

    @property
    def shortterm_window(self) -> int:
        return self.subblock * C.SHORTTERM_SUBBLOCKS

    @property
    def max_lra_blocks(self) -> int:
        """Capacity of the exact short-term (LRA) history (1 s cadence)."""
        return 0 if self.max_blocks == 0 else max(self.max_blocks // C.LRA_HOP_SUBBLOCKS + 1, 16)

    @property
    def true_peak_factor(self) -> int:
        return C.true_peak_factor(self.rate)
