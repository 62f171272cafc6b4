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


# --- the CUDA kernel (csrc/stft_pooled.cu), emulated in float64 with its
# float32 constants: the Hann window and the even/odd packing, the 32 x 16
# x 16 passes with their index maps, twiddles and exchange layouts, the
# real-FFT split with its k <-> 8192 - k pairing, and the band pool ------

_T = 256            # threads per CTA
_N = 16384          # window
_H = _N // 2        # points of the packed complex FFT
_TW_P1, _TW_WARP, _TW_P2, _TW_SPLIT, _TW_HANN, _TW_SELF = 0, 1024, 1280, 1536, 3585, 4098


def _cu_switch(name, n):
    """The float32 constants of the kernel source's switch `name` (its
    cases 0..n-1, the last one its default)."""
    import re
    from pathlib import Path

    import soundscope_tpu_torch

    src = (Path(soundscope_tpu_torch.__file__).parent / "csrc" / "stft_pooled.cu").read_text()
    body = src[src.index(f"float {name}(int"):]
    body = body[: body.index("\n}\n")]
    vals = dict(re.findall(r"(case \d+|default): return \(?(?:float\))?([0-9.e+-]+)f?\)?;", body))
    return np.array([float(vals.get(f"case {b}", vals.get("default"))) for b in range(n)],
                    np.float32)


@functools.lru_cache(maxsize=None)
def _cu_cos32_table():
    """cos(2 pi b / 32), b = 0..7, as written in the kernel source."""
    return _cu_switch("cos32_q", 8)


@functools.lru_cache(maxsize=None)
def _cu_tan32_table():
    """tan(2 pi b / 32), b = 0..4, as written in the kernel source."""
    return _cu_switch("tan32_q", 5)


def _cos32(j):
    """The kernel's cos32(j): cos(2 pi j / 32) from its float32 constants."""
    c = _cu_cos32_table().astype(np.float64)
    j %= 32
    a = j if j <= 16 else 32 - j
    return (c[a] if a < 8 else 0.0) if a <= 8 else -(c[16 - a] if 16 - a < 8 else 0.0)


def _bfly_form(e):
    """The kernel's bfly for w = W_32^e (0 < e < 16, e != 8) from its
    float32 constants: (f, s, cot), w = f (1 - i s) where |tan| <= 1 (cot
    False: f = cos, s = tan), else w = f (s - i) (f = sin, s = cot)."""
    c = _cu_cos32_table().astype(np.float64)
    tn = _cu_tan32_table().astype(np.float64)
    if e <= 4:
        return c[e], tn[e], False
    if e >= 12:
        return -c[16 - e], -tn[16 - e], False
    if e < 8:
        return c[8 - e], tn[8 - e], True
    return c[e - 8], -tn[e - 8], True


def _fma_times(b, f, s, cot):
    """w b as the kernel's FMA form computes it: f (p, q), (p, q) = (b.x +
    s b.y, b.y - s b.x) or, in the cotangent form, (s b.x + b.y, s b.y -
    b.x)."""
    if cot:
        p, q = s * b.real + b.imag, s * b.imag - b.real
    else:
        p, q = b.real + s * b.imag, b.imag - s * b.real
    return f * p + 1j * (f * q)


def _dft_registers(v):
    """The kernel's in-register dft<N> over the last axis: the bit-reversal
    renaming of the inputs, then radix-2 decimation-in-time stages of half
    width h = 1, 2, ..., N / 2, each butterfly a +- w b with w = W_32^(16 i
    / h): additions for w = 1, -i, else the FMA form."""
    v = np.array(v, np.complex128)
    n = v.shape[-1]
    bits = n.bit_length() - 1
    rev = [int(format(k, f"0{bits}b")[::-1], 2) for k in range(n)]
    a = v[..., rev]
    h = 1
    while h < n:
        for j in range(0, n, 2 * h):
            for i in range(h):
                e = 16 * i // h
                x, b = a[..., j + i].copy(), a[..., j + i + h].copy()
                wb = b if e == 0 else -1j * b if e == 8 else _fma_times(b, *_bfly_form(e))
                a[..., j + i], a[..., j + i + h] = x + wb, x - wb
        h *= 2
    return a


def _table():
    """The tables as complex (cos, -sin) entries; the split's and the
    window's regions hold other pairs (`_split_table`, `_hann4`)."""
    tab = K2.twiddles_np().astype(np.float64)
    return tab[:, 0] + 1j * tab[:, 1]


def _split_table():
    """The split's (cos, tan)(2 pi e / 16384), e <= 2048, from its float32."""
    tab = K2.twiddles_np()[_TW_SPLIT:_TW_HANN].astype(np.float64)
    return tab[:, 0], tab[:, 1]


def _split_twiddle(base, j):
    """W^k, k = base + 512 j, as the kernel's split_pair reads it: (f, s,
    cot, table element index) with W^k = f (1 - i s) (cot False) or f (s -
    i); (cos, tan)(k) for j < 4, (sin, cot)(k) = (cos, tan)(4096 - k) for j
    < 8 or (cos, -tan)(k - 4096) for j < 12, (cos, tan)(k) = (-cos,
    -tan)(8192 - k) above."""
    f, s = _split_table()
    if j < 4:
        e, sf, ss, cot = base + 512 * j, 1.0, 1.0, False
    elif j < 8:
        e, sf, ss, cot = 4096 - 512 * j - base, 1.0, 1.0, True
    elif j < 12:
        e, sf, ss, cot = base + 512 * j - 4096, 1.0, -1.0, True
    else:
        e, sf, ss, cot = 8192 - 512 * j - base, -1.0, -1.0, False
    return sf * f[e], ss * s[e], cot, _TW_SPLIT + e


def _s1(t, k1):
    return 256 * k1 + (t ^ ((k1 & 1) << 3))


def _s2(k1, k2, u):
    return 512 * k2 + 32 * u + (k1 ^ ((u & 7) << 1))


def _pass3_groups(t):
    """Thread t's two groups in pass 3, (k1, k2) and its partner, as
    arrays over t."""
    k1, k2 = t & 31, t >> 5
    b2 = np.where(k1 > 0, 15 - k2, np.where(k2 > 0, 16 - k2, 8))
    return (k1, k2), ((32 - k1) & 31, b2)


def _banks_distinct(addr, width=1):
    """No bank conflict in any warp. addr: one element index per thread in
    thread order (-1: the thread is idle), elements of `width` 4-byte
    words. A warp is served in `width` phases of 32 / width lanes; in a
    phase no two different elements may share a bank (lanes on one
    element are a broadcast). For 32 different words a warp: 32 distinct
    banks."""
    for phase in np.asarray(addr).reshape(-1, 32 // width):
        elems = {int(e) for e in phase if e >= 0}
        if len({(e * width) % 32 for e in elems}) != len(elems):
            return False
    return True


def _hann4(dtype=np.float64):
    """The kernel's window over the packed layout: (256, 32, 2), thread t,
    register m, even and odd sample of z[t + 256 m]: Hann / 4 = (vers b +
    cos b (1 - cos a) + sin b sin a) / 8 from the table's (1 - cos a, sin
    a) at a = 2 pi e / 16384 and the source's constants at b = 2 pi m / 32;
    past the middle the mirrored sample, e = 2 (256 - t) or 2 (255 - t) + 1
    at 31 - m. In `dtype`: float32 shows the kernel's rounding."""
    vs = K2.twiddles_np()[_TW_HANN:_TW_SELF].astype(dtype)
    vers = _cu_switch("vers32", 16).astype(dtype)
    t = np.arange(_T)
    out = np.empty((_T, 32, 2), dtype)
    for par in range(2):
        lo, hi = vs[2 * t + par], vs[(512 - 2 * t) if par == 0 else (511 - 2 * t)]
        for m in range(16):
            c = dtype(0.125) * dtype(_cos32(m))
            s = dtype(0.125) * dtype(_cos32(m - 8))
            v = dtype(0.125) * vers[m]
            out[:, m, par] = c * lo[:, 0] + (s * lo[:, 1] + v)
            out[:, 31 - m, par] = c * hi[:, 0] + (s * hi[:, 1] + v)
    return out


def _kernel_load(l, r, side):
    """z[n] = x[2n] + i x[2n+1] of the channel x = (l +- r) Hann / 4, as
    the kernel's thread t holds it in register m (n = t + 256 m)."""
    h = _hann4()
    s = (l.astype(np.float64) + (-1.0 if side else 1.0) * r.astype(np.float64))
    s = s.reshape(32, _T, 2).transpose(1, 0, 2)          # sample 2 (t + 256 m) + par
    return (s[..., 0] * h[..., 0] + 1j * s[..., 1] * h[..., 1]).T.reshape(-1)


def _kernel_fft(z):
    """The kernel's 8192-point FFT of z, pass by pass; returns the pass-3
    registers of every thread (group A, its partner B: (256, 16) each),
    Z in bin order and the shared-memory element indices of every
    exchange and twiddle read, one row per instruction in thread order."""
    tab = _table()
    t = np.arange(_T)
    lane, wp = t & 31, t >> 5
    ks = np.arange(32)
    v = _dft_registers(z[t[:, None] + 256 * ks[None, :]])
    p1 = [_TW_P1 + 32 * k1 + lane for k1 in range(1, 32)]
    for k1 in range(1, 32):
        v[:, k1] *= tab[p1[k1 - 1]]                # the lane part W^(2 lane k1)
    buf = np.full(_H, np.nan, np.complex128)
    w1 = [_s1(t, k1) for k1 in range(32)]
    for k1 in range(32):
        buf[w1[k1]] = v[:, k1]
    # pass 2: thread (k1, u0) = (t >> 3, t & 7), units u0 and u0 + 8; the
    # warp part W^(64 (m2 >> 1) k1) of pass 1's twiddle first
    k1, u0 = t >> 3, t & 7
    pw = [_TW_WARP + 8 * k1 + j for j in range(1, 8)]
    r1, w2, p2 = [], [], []
    buf2 = np.full(_H, np.nan, np.complex128)
    for u in (u0, u0 + 8):
        rows = [_s1(u + 16 * m, k1) for m in range(16)]
        vv = np.stack([buf[a] for a in rows], axis=1)
        for m in range(2, 16):
            vv[:, m] *= tab[pw[m // 2 - 1]]
        vv = _dft_registers(vv)
        tw = [_TW_P2 + 16 * k2 + u for k2 in range(1, 16)]
        for k2 in range(1, 16):
            vv[:, k2] *= tab[tw[k2 - 1]]
        rows_w = [_s2(k1, k2, u) for k2 in range(16)]
        for k2 in range(16):
            buf2[rows_w[k2]] = vv[:, k2]
        r1 += rows
        w2 += rows_w
        p2 += tw
    # pass 3: two groups per thread, 16-point DFTs over u
    X = np.full(_H, np.nan, np.complex128)
    regs, r2 = [], []
    for g1, g2 in _pass3_groups(t):
        rows = [_s2(g1, g2, u) for u in range(16)]
        vv = _dft_registers(np.stack([buf2[a] for a in rows], axis=1))
        for k3 in range(16):
            X[g1 + 32 * g2 + 512 * k3] = vv[:, k3]
        regs.append(vv)
        r2 += rows
    exchanges = {"exchange 1 write": w1, "exchange 1 read": r1,
                 "exchange 2 write": w2, "exchange 2 read": r2}
    twiddles = {"pass 1 lane": p1, "pass 2 warp part": pw, "pass 2": p2}
    return regs[0], regs[1], X, exchanges, twiddles


def _kernel_split(A, B):
    """The split and its power writes: pair j of thread (k1, k2) is (k,
    8192 - k), k = k1 + 32 k2 + 512 j, from A[j] and B[15 - j], in every
    thread; thread 0's groups (0, 0) and (0, 8) are their own partners, so
    its pairs write its (0, 0) bins wrongly (and float 8192, past the
    powers). Threads s < 17 then form thread 0's self pair s from the
    operands it left in shared memory: B[s] with B[15 - s] (s < 8), A[j]
    with A[16 - j] (j = s - 7), A[0] with itself (bin 0). Returns the
    powers in bin order (8192,), the power-write element indices (-1:
    idle) and the split-table reads."""
    tab = _table()
    t = np.arange(_T)
    lane, wp = t & 31, t >> 5
    base = lane + 32 * wp
    P = np.full(_H, np.nan)
    writes, reads = [], []

    def split_power(a, c, f, s, cot):
        er, ei = a.real + c.real, a.imag - c.imag
        dr, di = a.real - c.real, a.imag + c.imag
        o = _fma_times(di - 1j * dr, 1.0, s, cot)      # W^k O = f o, O = (di, -dr)
        ox, oy = o.real, o.imag
        pr, pi, nr, ni = er + f * ox, ei + f * oy, er - f * ox, ei - f * oy
        return pr ** 2 + pi ** 2, nr ** 2 + ni ** 2

    own = base == 0                               # thread 0's generic writes
    for j in range(16):
        f, s, cot, e = _split_twiddle(base, j)
        pa, pb = split_power(A[:, j], B[:, 15 - j], f, s, cot)
        for k, p in ((base + 512 * j, pa), (_H - base - 512 * j, pb)):
            assert (k[own] % 512 == 0).all()      # (0, 0)'s bins, or 8192
            assert np.isnan(P[k[~own]]).all()     # every other bin written once
            P[k[~own]] = p[~own]
            writes.append(k)
        reads.append(e)
    j = [s if s < 8 else (s - 7) % 9 for s in range(17)]     # s = 16: A[0]
    a = np.array([B[0, j[s]] if s < 8 else A[0, j[s]] for s in range(17)])
    c = np.array([B[0, 15 - j[s]] if s < 8 else A[0, (16 - j[s]) % 16] for s in range(17)])
    k = K2.self_bins()
    w = tab[_TW_SELF + np.arange(17)]             # (cos, -sin)
    er, ei, dr, di = a.real + c.real, a.imag - c.imag, a.real - c.real, a.imag + c.imag
    tr, ti = w.real * di + w.imag * dr, w.imag * di - w.real * dr
    pa, pb = (er + tr) ** 2 + (ei + ti) ** 2, (er - tr) ** 2 + (ei - ti) ** 2
    assert np.isnan(P[k]).all() and np.isnan(P[_H - k[:-1]][k[:-1] != 4096]).all()
    P[k] = pa
    P[(_H - k)[:-1]] = pb[:-1]                     # bin 4096 takes its second power
    assert not np.isnan(P).any()
    return P, writes, reads


def _kernel_pool(P, g2):
    """Lane l of warp wp reads float4 l of bands 8 wp .. 8 wp + 7 and of
    the squared gains; a butterfly of shuffles (xor 16, 8, 4: keep the half
    of the bands that lane bit picks, max with the partner's other half;
    then xor 2, 1) leaves band 8 wp + (l >> 2) in lane l. Returns the band
    maxima (64,) as the lanes l % 4 == 0 write them, and the read element
    indices (float4)."""
    t = np.arange(_T)
    lane, wp = t & 31, t >> 5
    reads = [(8 * wp + j) * 32 + lane for j in range(8)]
    q = (P * g2).reshape(64, 32, 4).max(axis=2)            # (band, lane)
    m = np.stack([q[8 * wp + j, lane] for j in range(8)], axis=1)  # (t, 8)
    h = 4
    for o in (16, 8, 4):
        up = (lane & o) > 0
        keep = np.where(up[:, None], m[:, h:2 * h], m[:, :h])
        send = np.where(up[:, None], m[:, :h], m[:, h:2 * h])
        m = np.maximum(keep, send[t ^ o])
        h //= 2
    mine = m[:, 0]
    for o in (2, 1):
        mine = np.maximum(mine, mine[t ^ o])
    bands = np.full(64, np.nan)
    w = (lane & 3) == 0
    bands[8 * wp[w] + (lane[w] >> 2)] = mine[w]
    assert not np.isnan(bands).any()
    return bands, reads


def test_kernel_register_dft_constants_and_structure():
    c = _cu_cos32_table()
    want = np.cos(2 * np.pi * np.arange(8) / 32).astype(np.float32)
    np.testing.assert_array_equal(c, want)   # float64 rounded to float32
    want = np.tan(2 * np.pi * np.arange(5) / 32).astype(np.float32)
    np.testing.assert_array_equal(_cu_tan32_table(), want)
    rng = np.random.default_rng(1)
    for n in (16, 32):
        v = rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
        np.testing.assert_allclose(_dft_registers(v), np.fft.fft(v, axis=-1),
                                   rtol=0, atol=1e-6 * np.abs(v).sum())


def test_kernel_pass_structure_matches_numpy_fft():
    """The 32 x 16 x 16 passes against np.fft.fft; every exchange a
    bijection and, like every twiddle read (through L1, whose banks are
    shared memory's), free of bank conflicts."""
    rng = np.random.default_rng(7)
    z = rng.standard_normal(_H) + 1j * rng.standard_normal(_H)
    A, B, X, exchanges, twiddles = _kernel_fft(z)
    want = np.fft.fft(z)
    assert not np.isnan(X).any()               # every bin written once
    err = np.abs(X - want).max() / np.abs(want).max()
    assert err < 1e-6, err                     # float32 twiddle tables
    for name, rows in exchanges.items():
        for a in rows:                         # float2, each instruction
            assert _banks_distinct(a, width=2), name   # a permutation
        assert len(set(np.concatenate(rows).tolist())) == _H, name   # a bijection
    for name, rows in twiddles.items():
        for a in rows:
            assert _banks_distinct(a, width=2), name   # float2 reads


def test_kernel_twiddle_factorisation():
    tab = _table()
    t = np.arange(_T)[:, None]
    k1 = np.arange(32)[None, :]
    got = tab[_TW_P1 + 32 * k1 + (t & 31)] * tab[_TW_WARP + 8 * k1 + (t >> 5)]
    np.testing.assert_allclose(got, np.exp(-2j * np.pi * t * k1 / _H), rtol=0, atol=4e-7)
    assert _TW_WARP + 8 * 31 + 7 < _TW_P2      # the warp part's (k1, v) rows
    u = np.arange(16)
    np.testing.assert_allclose(tab[_TW_P2 + 16 * u[None, :] + u[:, None]],
                               np.exp(-2j * np.pi * np.outer(u, u) / 256), rtol=0, atol=1e-7)
    e = np.arange(2049)
    f, s = _split_table()
    np.testing.assert_allclose(np.stack([f, s], axis=-1),
                               np.stack([np.cos(2 * np.pi * e / _N), np.tan(2 * np.pi * e / _N)],
                                        axis=-1), rtol=1e-7, atol=0)
    e = np.arange(513)
    vs = K2.twiddles_np()[_TW_HANN:_TW_SELF].astype(np.float64)
    a = 2 * np.pi * e / _N
    np.testing.assert_allclose(vs, np.stack([1 - np.cos(a), np.sin(a)], axis=-1), rtol=1e-7, atol=0)
    k = K2.self_bins()
    assert sorted(k) == sorted(set(k)) and (k % 256 == 0).all() and k.max() == 4096
    np.testing.assert_allclose(tab[_TW_SELF:], np.exp(-2j * np.pi * k / _N), rtol=0, atol=1e-7)
    assert K2.twiddles_np().shape == (4115, 2)


def test_kernel_fma_twiddles():
    """The FMA forms of the butterflies' and the split's twiddles: every
    multiplier that enters an FMA (tan or cot) within [-1, 1], and the
    factor times (1, -tan), or (cot, -1), gives W^e to 1e-7: the register
    DFTs' W_32^e from the source's constants, and the split's W^k for
    every k that a thread forms, k = base + 512 j with base <= 256, as the
    kernel reads it from the table by its symmetries."""
    for e in range(1, 16):
        if e != 8:
            f, s, cot = _bfly_form(e)
            assert abs(s) <= 1.0, e
            w = f * (s - 1j) if cot else f * (1 - 1j * s)
            assert abs(w - np.exp(-2j * np.pi * e / 32)) < 1e-7, e
    _, tn = _split_table()
    assert (np.abs(tn) <= 1.0).all()
    base = np.arange(257)
    for j in range(16):
        f, s, cot, e = _split_twiddle(base, j)
        assert (np.abs(s) <= 1.0).all() and (e >= _TW_SPLIT).all() and (e < _TW_HANN).all()
        w = f * (s - 1j) if cot else f * (1 - 1j * s)
        k = base + 512 * j
        assert np.abs(w - np.exp(-2j * np.pi * k / _N)).max() < 1e-7, j


def test_kernel_hann_from_twiddles():
    """The window formed in float32 from the table's (1 - cos, sin) and
    the source's constants against Hann / 4 in float64, sample by sample,
    to a few ulps relative, down to the edges where the window is 1e-8:
    there 1 - cos of a rounded cosine keeps no digit."""
    assert (_cu_switch("vers32", 16) ==
            (1 - np.cos(2 * np.pi * np.arange(16) / 32)).astype(np.float32)).all()
    got = _hann4(np.float32).transpose(1, 0, 2).reshape(-1).astype(np.float64)
    want = 0.125 * (1 - np.cos(2 * np.pi * np.arange(_N) / _N))
    assert got[0] == 0.0
    assert (np.abs(got[1:] - want[1:]) / want[1:]).max() < 3e-7


@pytest.mark.parametrize("side", [False, True])
def test_kernel_split_matches_numpy_rfft(side):
    """Load, packing, passes and split against np.fft.rfft of the windowed
    mid or side in float64, bin by bin below Nyquist (gain 1); the pass-3
    reads of a pair's two groups, the split's table reads and its bin-order
    power writes free of bank conflicts (the 17 self pairs' writes, to bins
    256 apart, share a bank: two writes of 17 threads a CTA)."""
    rng = np.random.default_rng(17 + side)
    l, r = rng.standard_normal((2, _N)).astype(np.float32)
    z = _kernel_load(l, r, side)
    A, B, _, exchanges, _ = _kernel_fft(z)
    P, writes, reads = _kernel_split(A, B)
    m = (l.astype(np.float64) + (-1 if side else 1) * r.astype(np.float64)) / 2
    want = np.abs(np.fft.rfft(m * np.asarray(K2._consts_np(48000)[0], np.float64))[:_H]) ** 2
    assert np.abs(P - want).max() / want.max() < 2e-6
    for a in exchanges["exchange 2 read"] + reads:
        assert _banks_distinct(a, width=2)
    for a in writes:
        assert _banks_distinct(a)


@pytest.mark.parametrize("rate", RATES)
def test_kernel_emulation_matches_plain_k2(rate):
    """The emulated kernel (window, passes, split, pool, dB), one CTA per
    channel, against K2's plain version on a short track: every window
    within 1e-3 dB."""
    x = _stereo(rate, 1, 10, seed=21)              # 3 windows
    _, g2, _ = K2._consts_np(rate)
    planes = K2.stft_pooled_frames_plain(_frames(x), rate)
    nw = planes[0].shape[1]
    for w in range(nw):
        l, r = x[0, :, 2048 * w: 2048 * w + _N]
        for side, want in enumerate(planes):
            A, B, *_ = _kernel_fft(_kernel_load(l, r, side))
            P, _, _ = _kernel_split(A, B)
            bands, reads = _kernel_pool(P, g2.astype(np.float64))
            np.testing.assert_array_equal(
                bands, (P * g2).reshape(64, 128).max(axis=1))   # the butterfly's bands
            for a in reads:
                assert _banks_distinct(a, width=4)
            db = np.where(bands > 0, 10 * np.log10(np.maximum(bands, 1e-38)), -150.0)
            want = want[0, w].numpy()
            assert np.abs(db - want[:64]).max() < 1e-3
            assert (want[64:] == -150.0).all()
