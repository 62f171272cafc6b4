"""The port's LiveAnalyzer against the JAX LiveAnalyzer, on the CPU, on
the pushes of tests/test_live.py.

LiveFrame fields: waveform minima and maxima exactly, loudness at 1e-3 LU,
true peak 1e-6, spectra at 1e-3 dB wherever a bin lies within 80 dB of the
frame's peak (further down, float32 FFT rounding, about 120 dB below a
full-scale peak, gives each FFT library its own values).
"""

import dataclasses

import numpy as np
import pytest

from soundscope_tpu.core.config import MeterConfig as JaxMeterConfig
from soundscope_tpu.models.live import LiveAnalyzer as JaxLive
from soundscope_tpu.utils.synth import sine
from soundscope_tpu_torch.core.config import MeterConfig
from soundscope_tpu_torch.models.live import LiveAnalyzer, LiveFrame

RATE = 48000


def _pseudo_stereo(mono):
    out = np.zeros(2 * len(mono), np.float32)
    out[0::2] = mono
    return out


def _pair(seconds=30):
    return (JaxLive(JaxMeterConfig(channels=2, rate=RATE, max_blocks=0), seconds=seconds),
            LiveAnalyzer(MeterConfig(channels=2, rate=RATE, max_blocks=0),
                         seconds=seconds, device="cpu"))


def _same_frame(jf, tf):
    assert [f.name for f in dataclasses.fields(LiveFrame)] == \
        [f.name for f in dataclasses.fields(jf)]
    for name in ("wf_min", "wf_max"):
        np.testing.assert_array_equal(getattr(tf, name), np.asarray(getattr(jf, name)))
    for name in ("shortterm", "momentary", "integrated", "lra"):
        want, got = float(getattr(jf, name)), float(getattr(tf, name))
        assert got == want or abs(got - want) < 1e-3, (name, got, want)
    np.testing.assert_allclose(tf.true_peak, np.asarray(jf.true_peak), rtol=0, atol=1e-6)
    for name in ("fft_mid", "fft_side"):
        want, got = np.asarray(getattr(jf, name)), getattr(tf, name)
        assert got.shape == want.shape
        near = want > want.max() - 80.0
        np.testing.assert_allclose(got[near], want[near], rtol=0, atol=1e-3)


def test_mic_semantics_match_jax():
    ja, ta = _pair()
    buf = _pseudo_stereo(sine(500.0, 16.0, RATE, -12.0))
    hop = 2 * (RATE // 100)
    for lo in range(0, len(buf) - hop, hop * 25):  # 250 ms batches
        ja.push(buf[lo: lo + hop * 25])
        ta.push(buf[lo: lo + hop * 25])
    jf, tf = ja.frame(), ta.frame()
    _same_frame(jf, tf)
    np.testing.assert_array_equal(ta.spectrum_chart_x, ja.spectrum_chart_x)
    np.testing.assert_array_equal(ta.state.ring.numpy(), np.asarray(ja.state.ring))
    assert int(ta.state.pos) == int(ja.state.pos)
    assert tf.wf_min.shape == (15000,)


def test_reset_matches_jax():
    ja, ta = _pair()
    for la in (ja, ta):
        la.push(_pseudo_stereo(sine(440.0, 1.0, RATE, -10.0)))
    _same_frame(ja.frame(), ta.frame())
    assert float(ta.frame().true_peak.max()) > 0.1
    ja.reset()
    ta.reset()
    assert float(ta.frame().true_peak.max()) == 0.0
    _same_frame(ja.frame(), ta.frame())


def test_frame_shows_newest_audio():
    ja, ta = _pair()
    for la in (ja, ta):
        la.push(_pseudo_stereo(np.zeros(RATE * 20, np.float32)))
        la.push(_pseudo_stereo(sine(2000.0, 1.0, RATE, -10.0)))
    jf, tf = ja.frame(), ta.frame()
    _same_frame(jf, tf)
    peak_x = ta.spectrum_chart_x[int(np.argmax(tf.fft_mid))]
    expect = (np.log10(2000) - np.log10(20)) / (np.log10(20000) - np.log10(20)) * 100
    assert abs(peak_x - expect) < 2.0


@pytest.mark.parametrize("seconds", [1, 2])
def test_push_longer_than_the_ring(seconds):
    """Only the newest ring's worth of samples lands, in order, after the
    cursor advances by the whole push."""
    ja, ta = _pair(seconds)
    rng = np.random.default_rng(seconds)
    first = rng.standard_normal(1234).astype(np.float32)
    long = rng.standard_normal(RATE * seconds * 3 + 777).astype(np.float32) * 0.1
    for la in (ja, ta):
        la.push(first)
        la.push(long)
    ring_n = RATE * seconds
    pos = (1234 + len(long)) % ring_n
    expect = np.roll(long[-ring_n:], pos)
    np.testing.assert_array_equal(ta.state.ring.numpy(), expect)
    np.testing.assert_array_equal(np.asarray(ja.state.ring), expect)
    assert int(ta.state.pos) == int(ja.state.pos) == pos
    _same_frame(ja.frame(), ta.frame())
