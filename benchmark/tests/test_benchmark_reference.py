"""The plain reference pinned to the standard's own cases."""

import numpy as np
import torch

from benchmark.reference import bs1770, display
from benchmark.reference import design as D
from benchmark.reference.precision import BFLOAT16

RATE = 48000


def sine(freq, seconds, dbfs, phase=0.0):
    t = np.arange(int(seconds * RATE)) / RATE
    return 10 ** (dbfs / 20) * np.sin(2 * np.pi * freq * t + phase)


def test_ebu_tech_3341_case_1():
    """997 Hz at -23 dBFS in both channels reads -23.0 +- 0.1 LUFS."""
    s = sine(997.0, 20.0, -23.0)
    x = torch.from_numpy(np.stack([s, s]))[None]
    r = bs1770.analyze(x, [x.shape[-1]], RATE)[0]
    assert abs(r["integrated"] + 23.0) < 0.1
    assert np.all(np.abs(r["shortterm"] + 23.0) < 0.1)
    assert np.all(np.abs(r["momentary"] + 23.0) < 0.1)
    assert abs(r["lra"]) < 0.1


def test_true_peak_of_a_full_scale_sine_between_samples():
    """A full-scale 12 kHz sine at 45 degrees: every sample at +-0.7071, the
    true peak at full scale within the standard's 0.1 dB. A 50 ms fade-in
    keeps the onset's ringing (+0.1 dB) out of the reading."""
    s = sine(12000.0, 1.0, 0.0, np.pi / 4) * np.minimum(1.0, np.arange(RATE) / 2400)
    tp, sp = bs1770.peaks(torch.from_numpy(s)[None], RATE)
    assert abs(sp[0] - np.sqrt(0.5)) < 1e-9
    assert abs(20 * np.log10(tp[0])) < 0.1


def test_k_filter_matches_the_direct_recurrence():
    """The blocked state-space identity equals the state recurrence."""
    x = np.random.default_rng(0).standard_normal(3000)
    A, B, C, Dd = D.kweight_ss(RATE)
    s = np.zeros(4)
    y = np.empty_like(x)
    for i, v in enumerate(x):
        y[i] = C @ s + Dd * v
        s = A @ s + B * v
    got = bs1770.k_filter(torch.from_numpy(x)[None], RATE)[0].numpy()
    np.testing.assert_allclose(got, y, rtol=0, atol=1e-10)


def test_spectrogram_band_of_a_sine():
    """A 1 kHz sine in both channels: the mid spectrogram's top band holds
    1 kHz, the side reads the floor in every band."""
    s = sine(1000.0, 1.0, -6.0)
    mid, side = display.pooled_spectrogram(torch.from_numpy(np.stack([s, s])), RATE)
    assert np.all(mid.argmax(-1) == int(1000.0 / (RATE / D.FFT_SIZE)) // 128)
    assert np.all(side == D.FLOOR_DB)


def test_the_control_is_another_precision():
    """The bfloat16 control differs from float64 by far more than float32 rounding."""
    x = torch.from_numpy(np.stack([sine(997.0, 4.0, -23.0)] * 2))[None]
    a = bs1770.analyze(x, [x.shape[-1]], RATE)[0]
    b = bs1770.analyze(x, [x.shape[-1]], RATE, BFLOAT16)[0]
    assert abs(a["integrated"] - b["integrated"]) > 1e-4
