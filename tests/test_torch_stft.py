"""K2 of the PyTorch port (ops/stft_pooled.py) against the JAX package.

On the CPU the port's wrapper runs K2's plain version. In float32 it is
held to JAX `stft_midside_display` and to the JAX Pallas kernel in
interpret mode within 1e-3 dB (the display pins of tests/test_stft.py);
against the JAX bfloat16 path within 0.1 dB on bands above -140 dB.
The kernel computes every window; the Pallas kernel truncates to whole
window chunks, so the first windows both produce are compared.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soundscope_tpu.ops.pallas_stft import stft_pooled_pallas_frames
from soundscope_tpu.ops.stft import frame_signal as jax_frame_signal
from soundscope_tpu.ops.stft import spectrogram as jax_spectrogram
from soundscope_tpu.ops.stft import stft_midside_display as jax_display
from soundscope_tpu_torch.ops import stft_pooled as K2
from soundscope_tpu_torch.ops.stft import (
    frame_signal,
    spectrogram,
    spectrogram_batch,
    stft_midside_display,
)
from soundscope_tpu_torch.utils.metrics import launches

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


def _assert_same_bands(got, want):
    """Band by band: NaN, +Inf and -Inf in the same places, equal where
    either is at the -150 dB floor, within 1e-3 dB elsewhere."""
    for cls in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(cls(got), cls(want))
    floor = (got == -150.0) | (want == -150.0)
    np.testing.assert_array_equal(got[floor], want[floor])
    rest = np.isfinite(want) & ~floor
    assert np.abs(got[rest] - want[rest]).max() < 1e-3


def test_plain_k2_on_nonfinite_input_matches_pallas_interpret():
    """NaN, +Inf, -Inf and the bit pattern 0xFFFFFFFF in the left channel
    of 2 tracks of 10 windows: K2's plain version against the Pallas
    kernel in interpret mode (one chunk of 10 windows), which packs mid +
    i side into one FFT as K2 does. Every band non-finite in the same way
    in both, equal where either is at the -150 dB floor, within 1e-3 dB
    elsewhere: the reference that K2 is held to on the card. The windows
    a bad sample reaches read the floor, the others are finite."""
    rate = 48000
    x = _stereo(rate, 2, 17, seed=11)               # 10 windows a track
    n = x.shape[-1]
    x[0, 0, 100] = np.inf                            # window 0 alone
    x[0, 0, n - 100] = -np.inf                       # window 9 alone
    x[1, 0, 5000] = np.nan                           # windows 0-2
    x.view(np.int32)[1, 0, 30000] = -1               # windows 7-9
    hit = [[0, 9], [0, 1, 2, 7, 8, 9]]               # the windows each track's reach
    mid, side = K2.stft_pooled_frames(_frames(x), rate)
    jm, js = stft_pooled_pallas_frames(jnp.asarray(x.reshape(2, 2, -1, 128)), rate,
                                       wchunk=10, interpret=True)
    for got, want in ((mid.numpy(), np.asarray(jm)), (side.numpy(), np.asarray(js))):
        assert got.shape == want.shape == (2, 10, 128)
        _assert_same_bands(got, want)
        for t, ws in enumerate(hit):
            clear = np.setdiff1d(np.arange(10), ws)
            assert (got[t, ws] == -150.0).all()
            assert np.isfinite(got[t, clear]).all() and (got[t, clear, :64] > -150.0).any()


def test_plain_k2_on_overflowing_input_matches_jax_xla():
    """Finite samples at 1e23 whose bins' powers overflow float32: K2's
    plain version against the JAX package's XLA display path, band by
    band. Within 20 Hz-20 kHz the bands read +Inf; band 0 holds bins of
    zero gain, whose Inf x 0 is NaN, and reads the floor. The card check
    (chip_smoke.py --nonfinite K2) holds K2 to this. The Pallas kernel
    reads every band of such a window at the floor instead: its mid and
    side powers 0.25 (p + p_rev +- 2 c) take Inf - Inf."""
    rate = 48000
    x = _stereo(rate, 1, 17, seed=13)
    x[..., 5 * 2048: 6 * 2048] *= 1e24              # windows 0-5
    mid, side = K2.stft_pooled_frames(_frames(x), rate)
    _, jm, js = jax_display(jnp.asarray(x[:, 0]), jnp.asarray(x[:, 1]), rate)
    for got, want in ((mid.numpy(), np.asarray(jm)), (side.numpy(), np.asarray(js))):
        _assert_same_bands(got, want)
        loud = got[0, :6]
        assert (loud[:, 0] == -150.0).all() and np.isposinf(loud[:, 1:53]).all()
        assert (loud[:, 53:] == -150.0).all() and np.isfinite(got[0, 6:]).all()


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
    got = spectrogram(x, rate, "cpu")
    want = jax_spectrogram(x, rate)
    assert got["mid_db"].shape == want["mid_db"].shape == (13, 128)
    np.testing.assert_array_equal(got["chart_x"], want["chart_x"])
    assert np.abs(got["mid_db"] - want["mid_db"]).max() < 1e-3
    assert np.abs(got["side_db"] - want["side_db"]).max() < 1e-3
    assert (got["hop"], got["win"], got["rate"]) == (2048, 16384, rate)


@pytest.mark.parametrize("rate,channels", [(48000, 2), (48000, 1), (32000, 6), (32000, 1)])
def test_spectrogram_batch_matches_per_item(rate, channels):
    """A zero-padded batch of tracks of three lengths gives each track the
    JAX `spectrogram` of its own samples: its N // 2048 - 7 windows, L/R
    from channels 0 and 1 (a mono track its own L and R), within 1e-3 dB;
    one K2 over the batch above 40 kHz, the plain path per item below.
    Bands under -140 dB are compared as -140: a mono track's side is the
    rounding left by L - R = 0 (-170 to -190 dB), which each FFT rounds
    its own way."""
    rng = np.random.default_rng(rate + channels)
    lens = [2048 * 20 + 777, 2048 * 9, 2048 * 5]
    x = np.zeros((3, channels, lens[0]), np.float32)
    for i, n in enumerate(lens):
        x[i, :, :n] = rng.standard_normal((channels, n)) * 0.3
    got = spectrogram_batch(torch.from_numpy(x), lens, rate)
    assert [g["mid_db"].shape[0] for g in got] == [13, 2, 0]
    for i, n in enumerate(lens):
        want = jax_spectrogram(x[i, :, :n], rate)
        one = spectrogram(x[i, :, :n], rate, "cpu")
        assert got[i]["mid_db"].shape == want["mid_db"].shape == one["mid_db"].shape
        for k in ("mid_db", "side_db"):
            g, w, o = (np.maximum(d[k], -140.0) for d in (got[i], want, one))
            assert np.abs(g - w).max(initial=0.0) < 1e-3
            assert np.abs(g - o).max(initial=0.0) < 1e-3
        for k in ("chart_x", "hop", "win", "rate"):
            np.testing.assert_array_equal(got[i][k], want[k])


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
    before = launches()["K2"]
    K2.stft_pooled_frames(fr, 48000)
    assert launches()["K2"] == before                    # CPU: plain, no launch


# --- the CUDA kernel's pass structure (csrc/stft_pooled.cu), emulated in
# float64 with its float32 constants: index maps, twiddles, exchange
# layouts, the bin pairing and the band pool -------------------------------

_T = 512            # threads per CTA
_N = 16384


@functools.lru_cache(maxsize=None)
def _cu_cos32_table():
    """cos(2 pi b / 32), b = 0..7, as written in the kernel source."""
    import re
    from pathlib import Path

    import soundscope_tpu_torch

    src = (Path(soundscope_tpu_torch.__file__).parent / "csrc" / "stft_pooled.cu").read_text()
    body = src[src.index("float cos32_q(int b)"):]
    body = body[: body.index("default:")]
    vals = dict(re.findall(r"case (\d+): return \(?(?:float\))?([0-9.e+-]+)f?\)?;", body))
    return np.array([float(vals[str(b)]) for b in range(8)], np.float32)


def _rot32(j):
    """W_32^j as the kernel's rot32 forms it (float32 constants)."""
    c = _cu_cos32_table().astype(np.float64)

    def cos32(j):
        j %= 32
        a = j if j <= 16 else 32 - j
        return (c[a] if a < 8 else 0.0) if a <= 8 else -(c[16 - a] if 16 - a < 8 else 0.0)

    j %= 32
    return {0: 1.0, 8: -1j, 16: -1.0, 24: 1j}.get(j, cos32(j) - 1j * cos32(j - 8))


def _dft_registers(v):
    """The kernel's in-register dft<N> over the last axis: radix-2 DIF
    stages, then the bit-reversal renaming."""
    v = np.array(v, np.complex128)
    n = v.shape[-1]
    bits = n.bit_length() - 1
    s = n // 2
    while s >= 1:
        for j in range(0, n, 2 * s):
            for i in range(s):
                a, b = v[..., j + i].copy(), v[..., j + i + s].copy()
                v[..., j + i] = a + b
                v[..., j + i + s] = (a - b) * _rot32(16 // s * i)
        s //= 2
    rev = [int(format(k, f"0{bits}b")[::-1], 2) for k in range(n)]
    return v[..., rev]


def _s1(k1, t):
    return 512 * k1 + (t ^ ((k1 & 1) << 4))


def _s2(k1, k2, u):
    return 512 * k2 + 32 * u + (k1 ^ (2 * u))


def _pass3_groups(t):
    """Thread t's two groups in pass 3: (k1, k2) and its partner."""
    k1, k2 = t & 31, t >> 5
    b2 = (31 - k2) if k1 else ((32 - k2) if k2 else 16)
    return (k1, k2), ((32 - k1) & 31, b2)


def _banks_distinct(addr):
    """Every warp (32 consecutive threads) touches 32 distinct banks."""
    a = np.asarray(addr).reshape(-1, 32)
    return all(len(set((row % 32).tolist())) == 32 for row in a)


def _pass1_twiddles(tab):
    """Pass 1's twiddles W^(t k1), (512, 32), as the kernel forms them:
    W^(t a) W^(8 t b) for k1 = a + 8 b, each factor W^e the product of
    the coarse W^(128 (e >> 7)) and the fine W^(e & 127)."""
    def factor(e):
        return tab[128 + (e >> 7)] * tab[e & 127]

    t = np.arange(_T)[:, None]
    k1 = np.arange(32)[None, :]
    a, b = k1 & 7, k1 >> 3
    return np.where(a == 0, 1.0, factor(t * a)) * np.where(b == 0, 1.0, factor(8 * t * b))


def _kernel_fft(z):
    """The kernel's FFT of one window, pass by pass, in float64 with the
    float32 twiddle tables; also returns the shared-memory addresses of
    every exchange, one row per instruction, in thread order."""
    tab = K2.twiddles_np().astype(np.float64)
    tab = tab[:, 0] + 1j * tab[:, 1]
    fine, coarse, p2 = tab[:128], tab[128:256], tab[256:]
    t = np.arange(_T)
    ks = np.arange(32)
    # load: thread t holds z[t + 512 m]
    v = z[t[:, None] + _T * ks[None, :]]
    v = _dft_registers(v) * _pass1_twiddles(tab)
    buf = np.zeros(_N, np.complex128)
    w1 = [_s1(k1, t) for k1 in range(32)]
    for k1 in range(32):
        buf[w1[k1]] = v[:, k1]
    # pass 2: thread (k1, u) = (t >> 4, t & 15)
    k1, u = t >> 4, t & 15
    r1 = [_s1(k1, u + 16 * m) for m in range(32)]
    v = np.stack([buf[a] for a in r1], axis=1)
    v = _dft_registers(v) * p2[u[:, None] * ks[None, :]]
    w2 = [_s2(k1, k2, u) for k2 in range(32)]
    buf2 = np.full(_N, np.nan, np.complex128)
    for k2 in range(32):
        buf2[w2[k2]] = v[:, k2]
    # pass 3: two groups per thread, 16-point DFTs over u
    X = np.full(_N, np.nan, np.complex128)
    r2 = []
    groups = [_pass3_groups(i) for i in range(_T)]
    for which in range(2):
        g1 = np.array([g[which][0] for g in groups])
        g2 = np.array([g[which][1] for g in groups])
        rows = [_s2(g1, g2, uu) for uu in range(16)]
        r2 += rows
        vv = _dft_registers(np.stack([buf2[a] for a in rows], axis=1))
        for k3 in range(16):
            X[g1 + 32 * g2 + 1024 * k3] = vv[:, k3]
    return X, {"exchange 1 write": w1, "exchange 1 read": r1,
               "exchange 2 write": w2, "exchange 2 read": r2}


def test_kernel_register_dft_constants_and_structure():
    c = _cu_cos32_table()
    want = np.cos(2 * np.pi * np.arange(8) / 32).astype(np.float32)
    np.testing.assert_array_equal(c, want)   # float64 rounded to float32
    rng = np.random.default_rng(1)
    for n in (16, 32):
        v = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
        np.testing.assert_allclose(_dft_registers(v), np.fft.fft(v, axis=-1),
                                   rtol=0, atol=1e-6 * np.abs(v).sum())


def test_kernel_pass_structure_matches_numpy_fft():
    rng = np.random.default_rng(7)
    z = rng.standard_normal(_N) + 1j * rng.standard_normal(_N)
    X, addrs = _kernel_fft(z)
    want = np.fft.fft(z)
    assert not np.isnan(X).any()               # every bin written once
    err = np.abs(X - want).max() / np.abs(want).max()
    assert err < 1e-6, err                     # float32 twiddle tables
    for name, rows in addrs.items():
        for a in rows:                         # each instruction: a permutation
            assert _banks_distinct(a), name    # of 32 banks in every warp
        assert len(set(np.concatenate(rows).tolist())) == _N, name   # a bijection


def test_kernel_twiddle_factorisation():
    tab = K2.twiddles_np().astype(np.float64)
    tab = tab[:, 0] + 1j * tab[:, 1]
    e = np.arange(_T)[:, None] * np.arange(32)[None, :]
    np.testing.assert_allclose(_pass1_twiddles(tab), np.exp(-2j * np.pi * e / _N),
                               rtol=0, atol=4e-7)
    assert (8 * (_T - 1) * 3) >> 7 < 128          # every factor's coarse index
    j = np.arange(512)
    np.testing.assert_allclose(tab[256 + j], np.exp(-2j * np.pi * 32 * j / _N),
                               rtol=0, atol=1e-7)
    assert (np.arange(16)[:, None] * np.arange(32)).max() < 512


def _kernel_pool(X, g2):
    """Pass 3's pairing (bin k with -k inside one thread), the bin-order
    power writes and the warp band pool; returns (mid, side) powers per
    band (64,), and the power-write and pool-read addresses."""
    pm = np.full(_N // 2, np.nan)
    ps = np.full(_N // 2, np.nan)
    writes = []
    for t in range(_T):
        (a1, a2), (b1, b2) = _pass3_groups(t)
        for k3 in range(8):
            for (g1, gg2), (p1, p2), kk3 in (
                    ((a1, a2), (a1, a2) if t == 0 else (b1, b2),
                     (16 - k3) % 16 if t == 0 else 15 - k3),
                    ((b1, b2), (b1, b2) if t == 0 else (a1, a2), 15 - k3)):
                k = g1 + 32 * gg2 + 1024 * k3
                kp = p1 + 32 * p2 + 1024 * kk3
                assert kp == (-k) % _N
                a, c = X[k], X[kp]
                assert np.isnan(pm[k])
                pm[k] = 0.25 * abs(a + np.conj(c)) ** 2 * g2[k]
                ps[k] = 0.25 * abs(a - np.conj(c)) ** 2 * g2[k]
    for k3 in range(8):
        for which in range(2):
            t = np.arange(_T)
            g = [_pass3_groups(i)[which] for i in t]
            writes.append(np.array([g1 + 32 * gg2 + 1024 * k3 for g1, gg2 in g]))
    lane, q = np.arange(_T) & 31, np.arange(_T) >> 5
    reads = [(4 * q + (j & 3)) * 128 + lane + 32 * i for j in range(4) for i in range(4)]
    mid = np.array([pm[b * 128:(b + 1) * 128].max() for b in range(64)])
    side = np.array([ps[b * 128:(b + 1) * 128].max() for b in range(64)])
    assert not np.isnan(pm).any() and not np.isnan(ps).any()
    return mid, side, writes, reads


@pytest.mark.parametrize("rate", RATES)
def test_kernel_emulation_matches_plain_k2(rate):
    """The emulated kernel (passes, pairing, pool, dB) against K2's plain
    version on a short track: every window within 1e-3 dB."""
    x = _stereo(rate, 1, 10, seed=21)              # 3 windows
    hann, g2, _ = K2._consts_np(rate)
    mid_w, side_w = K2.stft_pooled_frames_plain(_frames(x), rate)
    nw = mid_w.shape[1]
    for w in range(nw):
        l = x[0, 0, 2048 * w: 2048 * w + _N].astype(np.float64)
        r = x[0, 1, 2048 * w: 2048 * w + _N].astype(np.float64)
        hw = 0.5 * hann.astype(np.float64)
        X, _ = _kernel_fft((l + r) * hw + 1j * (l - r) * hw)
        mid, side, writes, reads = _kernel_pool(X, g2.astype(np.float64))
        for a in writes + reads:
            assert _banks_distinct(a)
        for got, want in ((mid, mid_w[0, w]), (side, side_w[0, w])):
            db = np.where(got > 0, 10 * np.log10(np.maximum(got, 1e-38)), -150.0)
            want = want.numpy()
            assert np.abs(db - want[:64]).max() < 1e-3
            assert (want[64:] == -150.0).all()
