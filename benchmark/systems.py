"""What the drivers drive: the port's entries (`Program`), or the reference
put in their place at bfloat16 (`Control`).

A driver calls only these methods, so a test can put a broken program in
their place, and the control comes out of the same run as the program.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from benchmark.reference import bs1770, display
from benchmark.reference.precision import BFLOAT16


class Program:
    """soundscope_tpu_torch, imported when first driven."""

    name = "program"

    def meter_config(self, config: dict):
        from soundscope_tpu_torch.core.config import MeterConfig

        return MeterConfig(channels=config["channels"], rate=config["rate"],
                           max_blocks=config["max_blocks"])

    def analyze_batch(self, mc, x, n_valid):
        from soundscope_tpu_torch.models.engine import analyze_batch_native

        return analyze_batch_native(mc, x, n_valid)

    def spectrogram(self, frames, rate: int):
        from soundscope_tpu_torch.ops.stft_pooled import stft_pooled_frames

        return stft_pooled_frames(frames, rate)


def _result(refs: list[dict], device) -> types.SimpleNamespace:
    """The reference's per-track results in the shape of the engine's
    AnalysisResult (timelines padded with -inf to one length)."""
    def t(v, dtype=torch.float32):
        return torch.as_tensor(np.asarray(v), dtype=dtype, device=device)

    def padded(key):
        m = max(len(r[key]) for r in refs)
        return t([np.concatenate([r[key], np.full(m - len(r[key]), -np.inf)]) for r in refs])

    return types.SimpleNamespace(
        integrated_lufs=t([r["integrated"] for r in refs]), lra=t([r["lra"] for r in refs]),
        momentary=padded("momentary"), shortterm=padded("shortterm"),
        n_momentary=t([len(r["momentary"]) for r in refs], torch.int64),
        n_shortterm=t([len(r["shortterm"]) for r in refs], torch.int64),
        true_peak=t([r["true_peak"] for r in refs]), sample_peak=t([r["sample_peak"] for r in refs]))


class Control(Program):
    """The reference in bfloat16, in the program's place."""

    name = "control"

    def analyze_batch(self, mc, x, n_valid):
        b = n_valid.shape[0]
        tracks = x.reshape(b, mc.channels, -1)
        return _result(bs1770.analyze(tracks, n_valid.tolist(), mc.rate, BFLOAT16), x.device)

    def spectrogram(self, frames, rate: int):
        b = frames.shape[0]
        out = [display.pooled_spectrogram(frames[i].reshape(2, -1), rate, BFLOAT16)
               for i in range(b)]
        return tuple(torch.as_tensor(np.stack([o[k] for o in out]), dtype=torch.float32,
                                     device=frames.device) for k in (0, 1))
