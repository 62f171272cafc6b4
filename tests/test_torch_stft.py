"""K2 of the PyTorch port (ops/stft_pooled.py) against the JAX package.

On the CPU the port's wrapper runs K2's plain version. In float32 it is
held to JAX `stft_midside_display` and to the JAX Pallas kernel in
interpret mode within 1e-3 dB (the display pins of tests/test_stft.py);
against the JAX bfloat16 path within 0.1 dB on bands above -140 dB.
The kernel computes every window; the Pallas kernel truncates to whole
window chunks, so the first windows both produce are compared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soundscope_tpu.ops.pallas_stft import stft_pooled_pallas_frames
from soundscope_tpu.ops.stft import frame_signal as jax_frame_signal
from soundscope_tpu.ops.stft import spectrogram as jax_spectrogram
from soundscope_tpu.ops.stft import stft_midside_display as jax_display
from soundscope_tpu_torch.ops import stft_pooled as K2
from soundscope_tpu_torch.ops.stft import frame_signal, spectrogram, stft_midside_display

RATES = [48000, 44100]


def _stereo(rate, b, hops, seed=3):
    rng = np.random.default_rng(seed + rate)
    return (rng.standard_normal((b, 2, 2048 * hops)) * 0.3).astype(np.float32)


def _frames(x):
    b, _, n = x.shape
    return torch.from_numpy(x.reshape(b, 2, n // 128, 128))


@pytest.mark.parametrize("rate", RATES)
def test_plain_k2_matches_jax_xla(rate):
    x = _stereo(rate, 2, 24)
    mid, side = K2.stft_pooled_frames(_frames(x), rate)
    _, jm, js = jax_display(jnp.asarray(x[:, 0]), jnp.asarray(x[:, 1]), rate)
    assert mid.shape == jm.shape == (2, 24 - 7, 128)
    assert np.abs(mid.numpy() - np.asarray(jm)).max() < 1e-3
    assert np.abs(side.numpy() - np.asarray(js)).max() < 1e-3


@pytest.mark.parametrize("rate", RATES)
def test_plain_k2_matches_pallas_interpret(rate):
    x = _stereo(rate, 1, 24, seed=5)
    mid, side = K2.stft_pooled_frames(_frames(x), rate)
    jm, js = stft_pooled_pallas_frames(
        jnp.asarray(x.reshape(1, 2, -1, 128)), rate, interpret=True)
    nw = jm.shape[1]
    assert 0 < nw <= mid.shape[1]
    assert np.abs(mid.numpy()[:, :nw] - np.asarray(jm)).max() < 1e-3
    assert np.abs(side.numpy()[:, :nw] - np.asarray(js)).max() < 1e-3


@pytest.mark.parametrize("rate", RATES)
def test_port_f32_within_bf16_display_tolerance(rate):
    x = _stereo(rate, 1, 24, seed=9)
    mid, _ = K2.stft_pooled_frames(_frames(x), rate)
    _, m16, _ = jax_display(jnp.asarray(x[:, 0]), jnp.asarray(x[:, 1]), rate,
                            dtype=jnp.bfloat16)
    m32 = mid.numpy()
    d = np.abs(m32 - np.asarray(m16))[m32 > -140]
    assert d.size and d.max() < 0.1


def test_frame_signal_matches_jax():
    x = np.arange(2048 * 12, dtype=np.float32)
    got = frame_signal(torch.from_numpy(x), 16384, 2048)
    want = np.asarray(jax_frame_signal(jnp.asarray(x), 16384, 2048))
    assert got.shape == (5, 16384)
    np.testing.assert_array_equal(got.numpy(), want)
    assert frame_signal(torch.zeros(100), 16384, 2048).shape == (0, 16384)


def test_chunked_plain_path_matches_one_shot(monkeypatch):
    """The plain version processes windows in chunks to bound memory; the
    chunk size changes no value beyond float32 FFT rounding (the batched
    FFT may vectorise differently per batch size)."""
    import soundscope_tpu_torch.ops.stft as S

    x = torch.from_numpy(_stereo(48000, 1, 20, seed=13))
    _, m1, s1 = stft_midside_display(x[:, 0], x[:, 1], 48000)
    monkeypatch.setattr(S, "_CHUNK_WINDOWS", 4)
    _, m2, s2 = stft_midside_display(x[:, 0], x[:, 1], 48000)
    assert m1.shape == m2.shape == (1, 13, 128)
    assert (m1 - m2).abs().max() < 1e-4 and (s1 - s2).abs().max() < 1e-4


@pytest.mark.parametrize("rate", [48000, 32000])
def test_spectrogram_matches_jax(rate):
    """`spectrogram` (the CLI's product) against the JAX one on an
    unaligned planar track: K2's plain version above 40 kHz, the plain
    display path below; the same windows either way."""
    rng = np.random.default_rng(rate)
    x = (rng.standard_normal((2, 2048 * 20 + 777)) * 0.3).astype(np.float32)
    got = spectrogram(x, rate)
    want = jax_spectrogram(x, rate)
    assert got["mid_db"].shape == want["mid_db"].shape == (13, 128)
    np.testing.assert_array_equal(got["chart_x"], want["chart_x"])
    assert np.abs(got["mid_db"] - want["mid_db"]).max() < 1e-3
    assert np.abs(got["side_db"] - want["side_db"]).max() < 1e-3
    assert (got["hop"], got["win"], got["rate"]) == (2048, 16384, rate)


def test_k2_rejects_what_it_cannot_pool():
    fr = _frames(_stereo(48000, 1, 10))
    with pytest.raises(ValueError):
        K2.stft_pooled_frames(fr, 32000)            # Nyquist below 20 kHz
    with pytest.raises(ValueError):
        K2.stft_pooled_frames(fr[:, :1], 48000)     # needs two channels
    with pytest.raises(TypeError):
        K2.stft_pooled_frames(fr.double(), 48000)
    with pytest.raises(ValueError):
        K2.stft_pooled_frames(fr.to("meta"), 48000)
    before = K2.LAUNCHES
    K2.stft_pooled_frames(fr, 48000)
    assert K2.LAUNCHES == before                    # CPU: plain, no launch
