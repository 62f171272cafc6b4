"""Reference-compatible Analyzer facade.

The public surface of the reference's ``Analyzer`` (src/analyzer.rs:47-183)
and of the JAX package's models/analyzer.py, method for method:

    create_loudness_meter(channels, rate)
    get_fft(samples)
    get_waveform(samples, window_secs)      (static)
    add_samples(interleaved)
    reset()
    get_shortterm_lufs() / get_momentary_lufs()
    get_integrated_lufs()
    get_loudness_range()
    get_true_peak() -> (left, right)        (linear)
    sample_rate
    calculate_integrated_lufs(ch, samples)

A host object holding a MeterState on its device: the card when there is
one, unless the caller passes ``device="cpu"``. Each push of a CUDA tensor
filters through K7; `calculate_integrated_lufs` runs the whole-file engine
(K3 on the card). NumPy arrays or tensors in, Python floats and NumPy
arrays out.
"""

from __future__ import annotations

import numpy as np
import torch

from soundscope_tpu_torch.core import constants as C
from soundscope_tpu_torch.core.config import MeterConfig
from soundscope_tpu_torch.core.device import as_float32, default_device
from soundscope_tpu_torch.core.state import init_meter_state
from soundscope_tpu_torch.models import meter as M
from soundscope_tpu_torch.models.engine import analyze_array
from soundscope_tpu_torch.ops.decimate import waveform_points
from soundscope_tpu_torch.ops.midside import deinterleave
from soundscope_tpu_torch.ops.spectrum import spectrum_points


def _left_right(v: torch.Tensor) -> tuple[float, float]:
    v = v.cpu().numpy()
    return float(v[0]), float(v[1]) if v.shape[0] > 1 else float(v[0])


class Analyzer:
    """Drop-in analog of the reference Analyzer (default: 2 ch, 44.1 kHz)."""

    def __init__(self, channels: int = 2, rate: int = C.DEFAULT_RATE,
                 max_blocks: int = 36_000, device=None):
        self.device = default_device(device)
        self._cfg = MeterConfig(channels=channels, rate=rate, max_blocks=max_blocks)
        self._state = init_meter_state(self._cfg, self.device)

    # -- meter lifecycle -----------------------------------------------------

    def create_loudness_meter(self, channels: int, rate: int) -> None:
        self._cfg = MeterConfig(
            channels=channels, rate=rate, max_blocks=self._cfg.max_blocks
        )
        self._state = init_meter_state(self._cfg, self.device)

    def reset(self) -> None:
        self._state = init_meter_state(self._cfg, self.device)

    @property
    def sample_rate(self) -> int:
        return self._cfg.rate

    @property
    def channels(self) -> int:
        return self._cfg.channels

    @property
    def config(self) -> MeterConfig:
        return self._cfg

    @property
    def state(self):
        """The meter state — the checkpoint surface."""
        return self._state

    # -- streaming -------------------------------------------------------------

    def add_samples(self, interleaved) -> None:
        """Push interleaved f32 frames (length multiple of channels)."""
        planar = deinterleave(as_float32(interleaved, self.device), self._cfg.channels)
        n = int(planar.shape[-1])
        if n == 0:
            return
        step = M.meter_step(self._cfg)
        # At most 1 s per step, as the JAX facade feeds its jitted step:
        # slab boundaries do not change the result (chunk-boundary
        # invariance), and a whole file in one push would need its
        # sub-block one-hot at full length.
        slab = self._cfg.rate
        for i in range(0, n, slab):
            self._state = step(self._state, planar[:, i:i + slab])

    # -- queries ---------------------------------------------------------------

    def get_shortterm_lufs(self) -> float:
        return float(M.shortterm_lufs(self._cfg, self._state))

    def get_momentary_lufs(self) -> float:
        return float(M.momentary_lufs(self._cfg, self._state))

    def get_integrated_lufs(self) -> float:
        return float(M.integrated_lufs(self._cfg, self._state))

    def get_loudness_range(self) -> float:
        return float(M.loudness_range_lu(self._cfg, self._state))

    def get_true_peak(self) -> tuple[float, float]:
        """Linear true peak of channels (0, 1), like the reference."""
        return _left_right(self._state.true_peak)

    def get_sample_peak(self) -> tuple[float, float]:
        return _left_right(self._state.sample_peak)

    # -- stateless analysis ------------------------------------------------------

    def get_fft(self, samples, gain_db: float = 0.0) -> np.ndarray:
        """Display spectrum of one window: (K, 2) array of (chart_x, dB)."""
        xs, vals = spectrum_points(as_float32(samples, self.device), self._cfg.rate,
                                   gain_db=gain_db)
        return np.stack([np.asarray(xs, np.float64),
                         vals.cpu().numpy().astype(np.float64)], axis=-1)

    @staticmethod
    def get_waveform(samples, window_secs: float, device=None) -> np.ndarray:
        """(2*valid, 2) of (x, min)/(x, max) pairs — src/analyzer.rs:107-137.
        A tensor is decimated on its own device, a NumPy array on `device`
        (None: the card when there is one)."""
        if isinstance(samples, torch.Tensor):
            return waveform_points(samples.to(torch.float32), window_secs)
        return waveform_points(as_float32(samples, default_device(device)), window_secs)

    def calculate_integrated_lufs(self, channels: int, samples) -> float | None:
        """Whole-buffer integrated LUFS of interleaved samples (the
        reference feeds a fresh meter 2 s chunks; here one offline pass of
        the engine, whose result chunking cannot change)."""
        x = np.asarray(samples, np.float32)
        frames = x.shape[-1] // channels
        if frames == 0:
            return None
        planar = x[: frames * channels].reshape(frames, channels).T
        cfg = MeterConfig(channels=channels, rate=self._cfg.rate, max_blocks=0)
        res = analyze_array(np.ascontiguousarray(planar), cfg, device=self.device)
        return float(res.integrated_lufs)
