"""The port's Analyzer facade against the JAX Analyzer, on the CPU.

Queries at the meter pins (1e-3 LU, true peak 1e-6), get_waveform exactly,
calculate_integrated_lufs at the engine pin (2e-3 LU); then the verify
recipe's readings and the facade's probes.

get_fft is held at 1e-3 dB plus the rounding of a float32 FFT: an error
of about 1e-6 of the largest bin's magnitude, which in a bin 90 dB below
the peak is some hundredths of a dB (torch and XLA call different FFT
libraries). Within 40 dB of the peak that term stays under 1e-4 dB.
"""

import numpy as np
import pytest

from soundscope_tpu.models.analyzer import Analyzer as JaxAnalyzer
from soundscope_tpu.utils.synth import interleaved, sine, stereo
from soundscope_tpu_torch import Analyzer


def _noise_track(rate, seconds, seed):
    x = np.random.default_rng(seed).standard_normal((2, rate * seconds)) * 0.05
    x[:, x.shape[1] // 2:] *= 3.0
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def pushed_60s():
    x = interleaved(_noise_track(48000, 60, 41))
    ja, ta = JaxAnalyzer(rate=48000), Analyzer(rate=48000, device="cpu")
    ja.add_samples(x)
    ta.add_samples(x)
    return ja, ta


def test_add_samples_60s_matches_jax(pushed_60s):
    ja, ta = pushed_60s
    assert int(ta.state.frames_total) == 60 * 48000
    for q in ("get_shortterm_lufs", "get_momentary_lufs", "get_integrated_lufs",
              "get_loudness_range"):
        assert abs(getattr(ta, q)() - getattr(ja, q)()) < 1e-3, q
    np.testing.assert_allclose(ta.get_true_peak(), ja.get_true_peak(), rtol=0, atol=1e-6)
    assert ta.get_sample_peak() == ja.get_sample_peak()
    np.testing.assert_array_equal(ta.state.block_hist.numpy(), np.asarray(ja.state.block_hist))


@pytest.mark.parametrize("rate", [44100, 48000])
def test_get_fft_matches_jax(rate):
    rng = np.random.default_rng(rate)
    x = (sine(1234.5, 16384 / rate, rate, -6.0)[:16384]
         + rng.standard_normal(16384).astype(np.float32) * 0.01)
    for gain in (0.0, -4.5):
        want = JaxAnalyzer(rate=rate).get_fft(x, gain)
        got = Analyzer(rate=rate, device="cpu").get_fft(x, gain)
        assert got.shape == want.shape and got.dtype == np.float64
        # JAX returns the chart x through its jitted program, in float32
        np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=0, atol=1e-5)
        below = want[:, 1].max() - want[:, 1]
        bound = 1e-3 + 20 * np.log10(1 + 1e-6 * 10 ** (below / 20))
        assert np.all(np.abs(got[:, 1] - want[:, 1]) <= bound)
        near = below < 40.0
        np.testing.assert_allclose(got[near, 1], want[near, 1], rtol=0, atol=1e-3)


@pytest.mark.parametrize("n,secs", [(44100, 15.0), (500, 1.0), (7, 0.01), (0, 1.0)])
def test_get_waveform_exact(n, secs):
    s = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    np.testing.assert_array_equal(Analyzer.get_waveform(s, secs, device="cpu"),
                                  JaxAnalyzer.get_waveform(s, secs))


def test_calculate_integrated_lufs_matches_jax():
    x = interleaved(_noise_track(48000, 9, 42))
    got = Analyzer(rate=48000, device="cpu").calculate_integrated_lufs(2, x)
    want = JaxAnalyzer(rate=48000).calculate_integrated_lufs(2, x)
    assert abs(got - want) < 2e-3
    assert Analyzer(device="cpu").calculate_integrated_lufs(2, np.zeros(0, np.float32)) is None


def test_verify_recipe_readings():
    """EBU Tech 3341 case 1 (997 Hz at -23 dBFS, stereo) and the 1 s
    waveform: the readings .claude/skills/verify/SKILL.md lists."""
    a = Analyzer(rate=48000, device="cpu")
    a.add_samples(interleaved(stereo(sine(997.0, 4.0, 48000, -23.0))))
    assert abs(a.get_shortterm_lufs() + 23.0) < 0.1
    assert abs(a.get_integrated_lufs() + 23.0) < 0.1
    assert abs(a.get_true_peak()[0] - 0.0708) < 1e-3
    assert a.get_waveform(np.sin(np.arange(44100) / 44100.0), 15.0, device="cpu").shape == (30000, 2)
    res = 48000 / 16384
    pts = a.get_fft(sine(round(997.0 / res) * res, 16384 / 48000, 48000)[:16384])
    x_997 = (np.log10(997) - np.log10(20)) / (np.log10(20000) - np.log10(20)) * 100
    assert abs(pts[np.argmax(pts[:, 1]), 0] - x_997) < 0.5


def test_facade_probes():
    with pytest.raises(ValueError):
        Analyzer(channels=0, device="cpu")
    with pytest.raises(ValueError):
        Analyzer(rate=5, device="cpu")
    a = Analyzer(device="cpu")
    a.add_samples(np.zeros(0, np.float32))
    a.add_samples(np.zeros(1, np.float32))           # half a frame: nothing
    assert a.get_integrated_lufs() == -np.inf
    a.add_samples(np.full(2 * 4410, 1.5, np.float32))
    assert a.get_true_peak()[0] > 1.0
    a.create_loudness_meter(6, 96000)
    assert (a.sample_rate, a.channels) == (96000, 6)
    a.reset()
    assert a.get_true_peak() == (0.0, 0.0)
    assert a.device.type == "cpu"


def test_display_ops_match_jax():
    """mid/side, (de)interleave and the min/max decimation on batches."""
    import jax.numpy as jnp

    import soundscope_tpu.ops.decimate as JD
    import soundscope_tpu.ops.midside as JMS
    import torch

    from soundscope_tpu_torch.ops import decimate as TD
    from soundscope_tpu_torch.ops import midside as TMS

    rng = np.random.default_rng(51)
    x = rng.standard_normal((3, 2 * 1001 + 1)).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    for ch in (1, 2, 6):
        np.testing.assert_array_equal(TMS.deinterleave(xt, ch).numpy(),
                                      np.asarray(JMS.deinterleave(xj, ch)))
        planar = TMS.deinterleave(xt, ch)
        np.testing.assert_array_equal(TMS.interleave(planar).numpy(),
                                      np.asarray(JMS.interleave(jnp.asarray(planar.numpy()))))
    for a, b in zip(TMS.mid_side_split(xt), JMS.mid_side_split(xj)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    planar = x[:, :2000].reshape(3, 2, 1000)
    for a, b in zip(TMS.mid_side_from_planar(torch.from_numpy(planar)),
                    JMS.mid_side_from_planar(jnp.asarray(planar))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    s = rng.standard_normal((4, 8000)).astype(np.float32)
    for secs in (2.0, 0.333, 9.0):
        got = TD.minmax_decimate(torch.from_numpy(s), secs)
        want = JD.minmax_decimate(jnp.asarray(s), secs)
        assert got[2] == want[2]
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
