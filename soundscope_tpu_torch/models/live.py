"""Device-resident live analysis — the streaming mic/player path.

The reference's per-tick loop copies a 30 s host ring buffer, splits
mid/side on the CPU, and runs FFT + LUFS per tick (src/tui.rs:1427-1480).
As in the JAX package, the ring stays on the device:

    state' = push(state, chunk)     # ring update + meter transition (K7)
    frame  = snapshot(state)        # spectrum (mid+side), waveform
                                    # min/max, LUFS, true peak

and the host receives display-sized products only. `frame()` is the JAX
package's, computed as it computes it: the whole ring rolled oldest-first
by an index gather, mid/side, two spectra of the newest 16,384 frames,
and the min/max decimation of the first 15 s of mid.

LiveState extends the meter state with a raw pseudo-stereo ring
(interleaved, rate*seconds samples, the layout of the reference's capture
ring).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from soundscope_tpu_torch.core import constants as C
from soundscope_tpu_torch.core.config import MeterConfig
from soundscope_tpu_torch.core.device import as_float32, default_device
from soundscope_tpu_torch.core.state import MeterState, init_meter_state
from soundscope_tpu_torch.models import meter as M
from soundscope_tpu_torch.ops.decimate import minmax_decimate
from soundscope_tpu_torch.ops.spectrum import _bin_plan, spectrum_points
from soundscope_tpu_torch.utils.metrics import GLOBAL as RT


@dataclasses.dataclass
class LiveState:
    meter: MeterState
    ring: torch.Tensor      # (ring_n,) interleaved samples, on the device
    pos: torch.Tensor       # int32 write cursor


@dataclasses.dataclass
class LiveFrame:
    """One display frame (everything the TUI renders per tick)."""

    fft_mid: torch.Tensor       # (K,) dB values at the precomputed chart x
    fft_side: torch.Tensor      # (K,)
    wf_min: torch.Tensor        # (W,) waveform bucket minima (15 s window)
    wf_max: torch.Tensor        # (W,)
    shortterm: torch.Tensor     # () LUFS
    momentary: torch.Tensor     # () LUFS
    integrated: torch.Tensor    # () LUFS
    lra: torch.Tensor           # () LU
    true_peak: torch.Tensor     # (C,) linear


def init_live_state(cfg: MeterConfig, seconds: int = C.CAPTURE_RING_SECONDS,
                    device=None) -> LiveState:
    """A fresh live state on `device` (None: the card when there is one)."""
    device = default_device(device)
    return LiveState(
        meter=init_meter_state(cfg, device),
        ring=torch.zeros((cfg.rate * seconds,), dtype=torch.float32, device=device),
        pos=torch.zeros((), dtype=torch.int32, device=device),
    )


def live_push(cfg: MeterConfig):
    """(state, interleaved chunk) -> state, for any chunk length."""
    step = M.meter_step(cfg)

    def push(state: LiveState, chunk: torch.Tensor) -> LiveState:
        n = chunk.shape[-1]
        ring_n = state.ring.shape[0]
        pos = state.pos.to(torch.int64)
        # only the newest ring_n samples land: a longer push would write
        # some positions twice, which a scatter leaves unordered
        k = min(n, ring_n)
        idx = (pos + (n - k) + torch.arange(k, device=chunk.device)) % ring_n
        ring = state.ring.index_put((idx,), chunk[n - k:])
        frames = n // cfg.channels
        planar = chunk[: frames * cfg.channels].reshape(frames, cfg.channels).T
        meter = step(state.meter, planar)
        return LiveState(meter=meter, ring=ring, pos=((pos + n) % ring_n).to(torch.int32))

    return push


def live_frame(cfg: MeterConfig):
    """state -> LiveFrame, the reference's mic-mode analysis windows
    (src/tui.rs:1427-1480): FFT over the newest 2^14 frames of mid/side,
    waveform over the first 15 s of mid, loudness from the meter."""
    n_fft = C.DEFAULT_FFT_SIZE

    def frame(state: LiveState, gain_db=0.0) -> LiveFrame:
        ring_n = state.ring.shape[0]
        order = (state.pos.to(torch.int64)
                 + torch.arange(ring_n, device=state.ring.device)) % ring_n
        ordered = state.ring[order]                    # oldest-first
        # pseudo-stereo interleave: a rate*S-sample ring holds S/2 seconds
        # of frames; analyze the NEWEST end (reference: tui.rs:1431-1437)
        mid = (ordered[0::2] + ordered[1::2]) * 0.5
        side = (ordered[0::2] - ordered[1::2]) * 0.5
        fft_lo = mid.shape[0] - n_fft
        _, v_mid = spectrum_points(mid[fft_lo:fft_lo + n_fft], cfg.rate, gain_db=gain_db)
        _, v_side = spectrum_points(side[fft_lo:fft_lo + n_fft], cfg.rate, gain_db=gain_db)
        wf_min, wf_max, _ = minmax_decimate(mid, 15.0)
        return LiveFrame(
            fft_mid=v_mid,
            fft_side=v_side,
            wf_min=wf_min,
            wf_max=wf_max,
            shortterm=M.shortterm_lufs(cfg, state.meter),
            momentary=M.momentary_lufs(cfg, state.meter),
            integrated=M.integrated_lufs(cfg, state.meter),
            lra=M.loudness_range_lu(cfg, state.meter),
            true_peak=state.meter.true_peak,
        )

    return frame


class LiveAnalyzer:
    """Host handle over the device-resident live pipeline.

    push() accepts any chunk length, as a NumPy array or a tensor (a
    tensor already on the device is not copied); frame() returns NumPy
    display products only.
    """

    def __init__(self, cfg: MeterConfig | None = None,
                 seconds: int = C.CAPTURE_RING_SECONDS, device=None):
        self.cfg = cfg or MeterConfig(max_blocks=0)
        self.seconds = seconds
        self.device = default_device(device)
        self.state = init_live_state(self.cfg, seconds, self.device)
        self._push = live_push(self.cfg)
        self._frame = live_frame(self.cfg)

    def push(self, interleaved) -> None:
        with RT.span("live.push"):
            x = as_float32(interleaved, self.device)
            if x.shape[-1] == 0:
                return
            self.state = self._push(self.state, x)

    def frame(self, gain_db: float = 0.0) -> LiveFrame:
        f = self._frame(self.state, gain_db)
        return LiveFrame(**{k.name: getattr(f, k.name).cpu().numpy()
                            for k in dataclasses.fields(f)})

    def reset(self) -> None:
        self.state = init_live_state(self.cfg, self.seconds, self.device)

    def save(self, path: str) -> None:
        """Checkpoint the full live state (ring + meter) to `path`."""
        from soundscope_tpu_torch.utils.checkpoint import save_live

        save_live(path, self.cfg, self.state, self.seconds)

    @classmethod
    def restore(cls, path: str, device=None) -> "LiveAnalyzer":
        """Resume a mic session bit-exactly from a save() checkpoint."""
        from soundscope_tpu_torch.utils.checkpoint import load_live

        cfg, seconds, state = load_live(path, device)
        self = cls(cfg, seconds=seconds, device=device)
        self.state = state
        return self

    @property
    def spectrum_chart_x(self) -> np.ndarray:
        _, _, _, _, xmap = _bin_plan(
            C.DEFAULT_FFT_SIZE, self.cfg.rate,
            C.SPECTRUM_FMIN_HZ, C.SPECTRUM_FMAX_HZ,
        )
        return xmap
