"""The one traffic generator: programme-like signal of any channel count
made on the device from a seed, and the seeded draws the drivers need.

A track is a run of sections of `section_s` seconds (drawn between the two
bounds, in units of 128 samples), each either silence (probability
`silence`) or Gaussian noise at an RMS level drawn between the two bounds of
`level_dbfs`, every channel after the first correlated with the first
(`correlation`: one coefficient for all of them, or a list of one per
channel after the first), hard-clipped at `ceiling_dbfs` as a loud master's
limiter leaves it. A section's level and silence hold for every channel.
So the gates, the LRA and the spectrogram's floor do real work, and the
true peak too: Gaussian noise alone rarely has an inter-sample peak above
its largest sample, while the clipped runs of the loud sections ring over
the ceiling between samples. Everything comes from one
torch.Generator on the device, in a few large calls; the same seed gives
the same signal.
"""

from __future__ import annotations

import math
import random

import torch

UNIT = 128          # samples per unit of a section boundary


def torch_generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    return g


def correlations(signal: dict, channels: int) -> list[float]:
    """Each channel's correlation with channel 0, for channels 1 and on."""
    c = signal["correlation"]
    if not isinstance(c, list):
        return [float(c)] * (channels - 1)
    if len(c) != channels - 1:
        raise ValueError(f"{len(c)} correlations for {channels} channels: "
                         f"give one per channel after the first")
    return [float(v) for v in c]


def tracks(seed: int, b: int, n: int, rate: int, signal: dict, device,
           channels: int = 2) -> torch.Tensor:
    """(b, channels, n) float32 programme-like signal on `device`; n % 128 == 0."""
    if n % UNIT:
        raise ValueError(f"track length {n} is no multiple of {UNIT}")
    cs = correlations(signal, channels)
    g = torch_generator(seed, device)
    x = torch.empty((b, channels, n), dtype=torch.float32, device=device)
    x.normal_(generator=g)
    for k, c in enumerate(cs, 1):
        x[:, k].mul_(math.sqrt(1.0 - c * c)).add_(x[:, 0], alpha=c)
    units = n // UNIT
    lo_s, hi_s = signal["section_s"]
    lo_u, hi_u = max(1, round(lo_s * rate / UNIT)), max(1, round(hi_s * rate / UNIT))
    sections = units // lo_u + 1
    length = torch.randint(lo_u, hi_u + 1, (b, sections), generator=g, device=device)
    lo_db, hi_db = signal["level_dbfs"]
    level = torch.rand((b, sections), generator=g, device=device) * (hi_db - lo_db) + lo_db
    gain = torch.pow(10.0, level / 20.0)
    gain = torch.where(torch.rand((b, sections), generator=g, device=device) < signal["silence"],
                       0.0, gain)
    ends = torch.cumsum(length, dim=1)
    which = torch.searchsorted(ends, torch.arange(units, device=device).expand(b, units)
                               .contiguous(), right=True)
    unit_gain = torch.gather(gain, 1, which.clamp(max=sections - 1))
    x.view(b, channels, units, UNIT).mul_(unit_gain[:, None, :, None])
    ceiling = 10.0 ** (signal["ceiling_dbfs"] / 20.0)
    return x.clamp_(-ceiling, ceiling)


class Reservoir:
    """A uniform sample of k items of a stream of unknown length, drawn from
    the seed (Algorithm R): which items are kept depends on the seed alone."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.items: list = []
        self.seen = 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item
