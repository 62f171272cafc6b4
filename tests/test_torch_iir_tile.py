"""The tile-scan core of K1, K3, K4 and K5 (csrc/iir_tile.cuh,
ops/iir_tile.py), emulated in float64 on its float32 host constants,
against the JAX package.

`emulate` repeats the kernels' passes in their order: the matrix-form zero
state of each thread's 32 samples, the Kogge-Stone scan over a warp's
lanes, the warps in series, each segment's entry state from a look-back of
depth D (s_in(t) = A^(T D) incl(t - D - 1) + sum_(j=1..D) A^(T (j-1))
G(t - j), incl(t) = A^T s_in(t) + G(t); D = 0 is the plain chain), each
thread's entry state A^(32 lane) (A^(1024 w) s_in + E_w) + F_(lane-1) with
the lane power applied bit by bit, the refilter with A as its two 2x2
blocks, float32-sized partial sums per thread and the fixed-order step
(K1) or group and channel (K3, K4, K5) sums. K5 with one or two
weighted channels scans each channel's segment of its track tickets
(`IIR.chain_segment` samples) with the powers of A as their 2x2 blocks
and each lane's power in one step (`modal`); K3 the same way, on
segments of `IIR.k3_segment` samples of a mono or stereo file's channels
or on rows of TP_TILE segments with more channels, with the look-back of
LOOKBACK segments (`emulate_k3_tracks`). It is held to the JAX
Pallas kernels in interpret mode and to the XLA chain at the port's pins
(tests/test_torch_iir_chunked.py, tests/test_torch_iir_rows.py): sub-block
sums rtol 3e-4 / atol 2e-5, z per group rtol 1e-3 / atol 1e-6 * max|z|,
true peak rtol 2e-6 / atol 1e-7, sample peak exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soundscope_tpu.core import constants as JC
from soundscope_tpu.ops.biquad import block_iir as jax_block_iir
from soundscope_tpu.ops.biquad import make_block_filter as jax_block_filter
from soundscope_tpu.ops.kweight import channel_weights, kweight_cascade_ss
from soundscope_tpu.ops.loudness import weighted_square
from soundscope_tpu.ops.pallas_iir import (
    kweight_energy_pallas,
    kweight_energy_pallas_prefix,
    kweight_energy_tp_pallas_prefix,
)
from soundscope_tpu.ops.pallas_iir_chunked import chunked_plan
from soundscope_tpu.ops.pallas_iir_chunked import kweight_energy_tp_chunked as jax_k1
from soundscope_tpu.ops.pallas_iir_chunked import subblock_sums_from_steps as jax_sub
from soundscope_tpu.ops.truepeak import true_peak_masked as jax_true_peak
from soundscope_tpu_torch.ops import iir as IIR
from soundscope_tpu_torch.ops import iir_chunked as K1
from soundscope_tpu_torch.ops import iir_tile
from soundscope_tpu_torch.utils.params import block_filter_from_numpy

TS = iir_tile.TS


def _filters(rate):
    jf = jax_block_filter(kweight_cascade_ss(rate), 128)
    tf = block_filter_from_numpy(np.asarray(jf.Tt), np.asarray(jf.Wt),
                                 np.asarray(jf.Ot), np.asarray(jf.A_pows), 128,
                                 device="cpu")
    return jf, tf


def _block_matrix(lb):
    """The 4x4 block-diagonal matrix of a look-back power's 8 values."""
    M = np.zeros((4, 4))
    M[:2, :2] = lb[:4].reshape(2, 2)
    M[2:, 2:] = lb[4:].reshape(2, 2)
    return M


def _scan(k, x, T, D=0, s0=None):
    """Entry state of every thread: (rows, nseg, P, 4), x (rows, nseg, P, 32)
    in x's dtype, as tile_scan computes it with a look-back of depth D. s0
    (rows, 4): the rows enter from s0 (K7, S0 mode), which stands as the
    records of a segment -1 (G(-1) = incl(-1) = s0): segment s <= D takes
    A^(T s) s0."""
    rows, nseg, P, _ = x.shape
    dt = x.dtype
    nw = P // 32
    f = np.einsum("rspk,kj->rspj", x, k["W"])
    F = f.reshape(rows, nseg, nw, 32, 4)
    for q in range(5):                              # Kogge-Stone, lanes >= d
        d = 1 << q
        new = F.copy()
        new[..., d:, :] = F[..., :-d, :] @ k["KS"][q].T + F[..., d:, :]
        F = new
    fex = np.zeros_like(F)
    fex[..., 1:, :] = F[..., :-1, :]
    tot = F[..., 31, :]                             # (rows, nseg, nw, 4)
    E = np.zeros_like(tot)
    e = np.zeros((rows, nseg, 4), dt)
    for w in range(nw):                             # warps in series
        E[:, :, w] = e
        e = e @ k["AW"][1].T + tot[:, :, w]
    LB = [_block_matrix(v) for v in k["LB"]]        # LB[b] = A^(T 2^b)

    def power(m):                                   # A^(T m), as lb_power
        M = np.eye(4)
        for b in range(len(LB)):
            if (m >> b) & 1:
                M = LB[b] @ M
        return M

    Pj = np.stack([power(j - 1) for j in range(1, D + 1)]) if D else np.zeros((0, 4, 4))
    Pj, PD = Pj.astype(dt), power(D).astype(dt)
    s_in = np.zeros((rows, nseg, 4), dt)
    incl = np.zeros((rows, nseg, 4), dt)
    for s in range(nseg):                           # the look-back
        m = min(D, s)
        acc = np.einsum("rmj,mij->ri", e[:, s - m: s][:, ::-1], Pj[:m])
        if s > D:
            acc += incl[:, s - D - 1] @ PD.T
        elif s0 is not None:                        # segment -1's record
            acc += s0 @ power(s).astype(dt).T
        s_in[:, s] = acc
        incl[:, s] = acc @ k["AT"].T + e[:, s]
    v = np.einsum("wij,rsj->rswi", k["AW"][:nw], s_in) + E
    v = np.broadcast_to(v[:, :, :, None, :], F.shape).copy()
    if "LP" in k:                                   # K5: A^(32 lane) in one step
        v = np.einsum("lij,rswlj->rswli", k["LP"], v)
    else:
        lane = np.arange(32)
        for q in range(5):
            on = ((lane >> q) & 1).astype(bool)
            v[..., on, :] = v[..., on, :] @ k["KS"][q].T
    return (v + fex).reshape(rows, nseg, P, 4)


def _refilter(k, x, s):
    """y over each thread's 32 samples from its entry state, with A read as
    its two 2x2 blocks."""
    A = k["A"].copy()
    A[:2, 2:] = 0.0
    A[2:, :2] = 0.0
    y = np.empty_like(x)
    for j in range(TS):
        y[..., j] = s @ k["C"] + k["D"] * x[..., j]
        s = s @ A.T + x[..., j, None] * k["B"]
    return y


def _modal(M):
    """M (..., 4, 4) with its two 2x2 diagonal blocks alone."""
    M = M.copy()
    M[..., :2, 2:] = 0.0
    M[..., 2:, :2] = 0.0
    return M


def emulate_tile(filt, x, T, D=0, modal=False):
    """y (rows, n) of the tile-scan core on x (rows, n) float32, look-back
    depth D; modal: the scan's powers of A read as their two 2x2 blocks and
    each lane's A^(32 lane) taken in one step (K5's track_scan)."""
    rows, n = x.shape
    nseg = -(-n // T)
    xp = np.zeros((rows, nseg * T))
    xp[:, :n] = x
    xs = xp.reshape(rows, nseg, T // TS, TS)
    k = {name: np.asarray(v, np.float64)
         for name, v in iir_tile.unpack(iir_tile.tile_constants(filt, T)).items()}
    if modal:
        k.update({name: _modal(k[name]) for name in ("KS", "AW", "AT")})
        k["LP"] = np.stack([_block_matrix(v)
                            for v in iir_tile.lane_powers(filt).astype(np.float64)])
    y = _refilter(k, xs, _scan(k, xs, T, D))
    return y.reshape(rows, -1)[:, :n]


def _peaks(x, nvr, rate):
    """(tp, sp) per row of x (rows, n) float32 as K1 and K3 take them."""
    rows, n = x.shape
    valid = np.arange(n)[None] < nvr[:, None]
    factor = JC.true_peak_factor(rate)
    sp = np.where(valid, np.abs(x), 0.0).max(-1)
    tp = np.zeros(rows)
    if factor > 1:
        # phases 1 .. F-1 over taps 0 .. KP-2, as TileFir (phase 0 is an
        # impulse the sample peak covers; the other phases' last tap is 0)
        taps = iir_tile.fir_taps(factor).reshape(factor, -1).astype(np.float64)
        kp = taps.shape[1] - 1
        xh = np.concatenate([np.zeros((rows, kp - 1)), x], -1)
        for p in range(1, factor):
            acc = sum(taps[p, t] * xh[:, kp - 1 - t: kp - 1 - t + n] for t in range(kp))
            tp = np.maximum(tp, np.where(valid, np.abs(acc), 0.0).max(-1))
    return np.maximum(tp, sp).astype(np.float32), sp.astype(np.float32)


def emulate_k1(filt, x, nv, weights, rate, h):
    """K1's step sums and peaks: x (b, ch, n) float32."""
    b, ch, n = x.shape
    L = K1.step_length(n, h)
    T = K1.tile_length(L)
    rows = b * ch
    nvr = np.repeat(nv, ch)
    y = emulate_tile(filt, x.reshape(rows, n), T)
    g = np.arange(n)
    valid = g[None] < nvr[:, None]
    w = np.tile(np.asarray(weights, np.float32), b)
    z = np.where(valid, w[:, None] * (y * y), 0.0)
    start = (g // L) * L
    bound = np.minimum(-(-start // h) * h, start + L)
    # each part a float32 sum per thread, then float64 over the step
    left, right = (np.where(side, z, 0.0).reshape(rows, n // TS, TS).sum(-1)
                   .astype(np.float32).astype(np.float64)
                   for side in (g < bound, g >= bound))
    per = L // TS
    steps = np.stack([left.reshape(rows, -1, per).sum(-1),
                      right.reshape(rows, -1, per).sum(-1)], -1).astype(np.float32)
    tp, sp = _peaks(x.reshape(rows, n), nvr, rate)
    return steps, tp, sp


def emulate_k5(filt, x, nv, weights, group, T=None, D=0, modal=None):
    """K5's z (b, n/group): x (b, ch, n) float32; with one or two weighted
    channels each on segments of IIR.chain_segment samples (track_scan's
    scan of a channel segment is tile_scan's of a row), else on rows of
    CHAIN_TILE segments; with T = CHAIN_TILE and D = LOOKBACK, K4's. K3's z
    is the same sum at T = k3_segment(ch), or TP_TILE on the rows of more
    channels, with modal powers (emulate_k3_tracks). modal: the scan's as
    track_scan's (by default where K5 takes track tickets)."""
    b, ch, n = x.shape
    na = sum(1 for w in weights if w != 0.0)
    tracks = T is None and na <= IIR.TRACK_CHANNELS
    if T is None:
        T = IIR.chain_segment(na) if tracks else IIR.CHAIN_TILE
    modal = tracks if modal is None else modal
    y = emulate_tile(filt, x.reshape(b * ch, n), T, D, modal=modal).reshape(b, ch, n)
    valid = np.arange(n)[None] < nv[:, None]
    z = np.zeros((b, n // group))
    for c, w in enumerate(weights):
        if w != 0.0:
            zc = np.where(valid, np.float32(w) * (y[:, c] * y[:, c]), 0.0)
            z = z + zc.reshape(b, -1, group).sum(-1).astype(np.float32)
    return z.astype(np.float32)


def emulate_k3_tracks(filt, x, nv, weights, rate, group):
    """K3's (z, tp, sp), x (b, ch, n) float32: each channel on segments of
    IIR.k3_segment(ch) samples (4,096 stereo, 8,192 mono) or, with more
    than K3_TRACK_CHANNELS channels, on rows of TP_TILE segments, with the
    look-back of LOOKBACK segments, the scan's powers of A as their 2x2
    blocks and each lane's A^(32 lane) in one step (k3_track_scan's scan of
    a channel segment is tile_scan's of a row with track_scan's
    arithmetic); group sums per channel in float32, added in channel
    order; the peaks per row."""
    b, ch, n = x.shape
    T = IIR.k3_segment(ch) if ch <= IIR.K3_TRACK_CHANNELS else IIR.TP_TILE
    z = emulate_k5(filt, x, nv, weights, group, T, IIR.LOOKBACK, modal=True)
    return (z, *_peaks(x.reshape(b * ch, n), np.repeat(nv, ch), rate))


def emulate_rows(kernel, filt, x, nv, weights, rate, group):
    """K3's (z, tp, sp) or K4's (z, None, None) on x (b, ch, n) float32."""
    if kernel == "K4":
        return emulate_k5(filt, x, nv, weights, group, IIR.CHAIN_TILE, IIR.LOOKBACK), None, None
    return emulate_k3_tracks(filt, x, nv, weights, rate, group)


def _noise(shape, seed):
    x = (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(np.float32)
    x[..., shape[-1] // 2:] *= 3.0
    return x


# rate, b, n, n_valid: 48 kHz ragged, 44.1 kHz ragged (boundaries inside a
# thread's 32 samples), 96 kHz (factor 2), n_valid inside a segment,
# 81,920 Hz, where h = T = 8192 puts a 100 ms boundary on every segment
# edge, and 192 kHz ragged (factor 1, steps and tiles of 16,384 samples:
# 512 threads, 16 warps in series)
K1_CASES = [
    (48000, 3, 65536, (65536, 65536 - 700, 32768)),
    (44100, 3, 65536, (65536, 65536 - 700, 32768)),
    (96000, 2, 65536, (65536, 65536)),
    (48000, 2, 65536, (8192 * 3 + 1000, 8192 * 5 + 17)),
    (81920, 2, 65536, (65536, 8192 * 6)),
    (192000, 2, 65536, (65536 - 700, 16384 * 2 + 999)),
]


@pytest.mark.parametrize("rate,b,n,nv", K1_CASES)
def test_k1_algorithm_matches_jax(rate, b, n, nv):
    jf, tf = _filters(rate)
    h = JC.samples_in_100ms(rate)
    x = _noise((b, 2, n), rate + b)
    nv = np.asarray(nv, np.int32)
    w = tuple(float(v) for v in channel_weights(2))
    steps, tp, sp = emulate_k1(tf, x, nv, w, rate, h)
    L = K1.step_length(n, h)
    got = K1.subblock_sums_from_steps(torch.from_numpy(steps), h, L, n).reshape(
        b, 2, -1).sum(1).numpy()

    # the XLA chain
    y, _ = jax.jit(jax_block_iir)(jf, jnp.asarray(x), jnp.zeros((b, 2, 4)))
    y = jnp.where(jnp.arange(n)[None, None] < jnp.asarray(nv)[:, None, None], y, 0.0)
    z = np.asarray(weighted_square(y, jnp.asarray(w)))
    nb = n // h
    np.testing.assert_allclose(got, z[:, : nb * h].reshape(b, nb, h).sum(-1),
                               rtol=3e-4, atol=2e-5)
    tpj, spj = jax_true_peak(jnp.asarray(x), jnp.asarray(nv)[:, None, None], rate)
    np.testing.assert_allclose(tp.reshape(b, 2), np.asarray(tpj), rtol=2e-6, atol=1e-7)
    np.testing.assert_array_equal(sp.reshape(b, 2), np.asarray(spj))

    # the Pallas kernel in interpret mode
    nc = n // 128
    S = chunked_plan(n, nc, b * 2, h, JC.true_peak_factor(rate))
    st, tpk, _ = jax_k1(jf.Tt, jf.Wt, jf.Ot, jf.A_pows, jnp.asarray(x.reshape(b, 2, nc, 128)),
                        jnp.asarray(nv), w, rate, h, interpret=True)
    want = np.asarray(jax_sub(st, h, S * 128, n)).reshape(b, 2, -1).sum(1)
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=2e-5)
    np.testing.assert_allclose(tp, np.asarray(tpk), rtol=2e-6, atol=1e-7)


# rate, b, ch, group: g = 32 and g = 1, 44.1 kHz (track tickets of 2,048
# a channel), 5.1 with the zero-weight LFE (rows), mono (4,096), b = 3; N
# = 28,928 leaves a partial last segment
K5_CASES = [(48000, 3, 2, 32), (48000, 3, 2, 1), (44100, 3, 2, 1), (48000, 2, 6, 32),
            (48000, 3, 1, 32)]


@pytest.mark.parametrize("rate,b,ch,group", K5_CASES)
def test_k5_algorithm_matches_pallas_interpret_and_xla(rate, b, ch, group):
    n = 226 * 128
    jf, tf = _filters(rate)
    x = _noise((b, ch, n), rate + 10 * b + ch)
    nv = np.asarray([n, n - 700, n // 2 + 5][:b], np.int32)
    w = tuple(float(v) for v in channel_weights(ch))
    got = emulate_k5(tf, x, nv, w, group)
    want = np.asarray(kweight_energy_pallas(
        jf.Tt, jf.Wt, jf.Ot, jnp.transpose(jf.A_pows[128]), jnp.asarray(x),
        jnp.asarray(nv), w, interpret=True, group=group))
    assert got.shape == want.shape == (b, n // group)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6 * np.abs(want).max())
    hg = JC.samples_in_100ms(rate) // group
    nb = n // group // hg

    def sums(z):
        return z[:, : nb * hg].reshape(b, nb, hg).astype(np.float64).sum(-1)

    np.testing.assert_allclose(sums(got), sums(want), rtol=3e-4, atol=2e-5)
    # the XLA chain: block_iir, the mask, the weighted square, group sums
    y, _ = jax.jit(jax_block_iir)(jf, jnp.asarray(x), jnp.zeros((b, ch, 4)))
    y = jnp.where(jnp.arange(n)[None, None] < jnp.asarray(nv)[:, None, None], y, 0.0)
    chain = np.asarray(weighted_square(y, jnp.asarray(w))).reshape(b, -1, group).sum(-1)
    np.testing.assert_allclose(got, chain, rtol=1e-3, atol=1e-6 * np.abs(chain).max())
    np.testing.assert_allclose(sums(got), sums(chain), rtol=3e-4, atol=2e-5)
    if ch == 6:
        y = x.copy()
        y[:, 3] *= 7.0                              # the LFE adds nothing
        np.testing.assert_array_equal(emulate_k5(tf, y, nv, w, group), got)


def _jax_rows(kernel, jf, x, nv, w, rate, group):
    """The JAX K3 / K4 Pallas kernel in interpret mode."""
    args = (jf.Tt, jf.Wt, jf.Ot, jf.A_pows, jnp.asarray(x), jnp.asarray(nv), w)
    if kernel == "K4":
        return np.asarray(kweight_energy_pallas_prefix(*args, interpret=True, group=group)), None
    z, tp, _ = kweight_energy_tp_pallas_prefix(*args, rate, interpret=True, group=group)
    return np.asarray(z), np.asarray(tp)


def _xla_rows(jf, x, nv, w, rate, group):
    """The XLA chain: z (b, n/group), tp and sp (b*ch,)."""
    b, ch, n = x.shape
    y, _ = jax.jit(jax_block_iir)(jf, jnp.asarray(x), jnp.zeros((b, ch, 4)))
    y = jnp.where(jnp.arange(n)[None, None] < jnp.asarray(nv)[:, None, None], y, 0.0)
    z = np.asarray(weighted_square(y, jnp.asarray(w))).reshape(b, -1, group).sum(-1)
    tp, sp = jax_true_peak(jnp.asarray(x), jnp.asarray(nv)[:, None, None], rate)
    return z, np.asarray(tp).reshape(-1), np.asarray(sp).reshape(-1)


def _energy_pins(got, want, rate, group):
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6 * np.abs(want).max())
    hg = JC.samples_in_100ms(rate) // group
    nb = got.shape[-1] // hg
    assert nb >= 1

    def sums(z):
        return z[:, : nb * hg].reshape(z.shape[0], nb, hg).astype(np.float64).sum(-1)

    np.testing.assert_allclose(sums(got), sums(want), rtol=3e-4, atol=2e-5)


# kernel, rate, b, ch, group: N = 28,928 leaves a partial last segment at
# every tile (K3's 8,192 on rows and on mono tracks, 4,096 on stereo
# tracks, K4's 4,096); ragged n_valid; 44.1 kHz groups of 1; 5.1 with the
# zero-weight LFE (K3 on tickets of its rows, which still take its
# peaks); mono and stereo at 96 kHz (factor 2) on K3's track tickets
K3_K4_CASES = [("K3", 48000, 3, 2, 32), ("K3", 44100, 3, 2, 1), ("K3", 96000, 2, 6, 32),
               ("K4", 48000, 3, 2, 32), ("K4", 44100, 3, 2, 1), ("K4", 192000, 2, 6, 32),
               ("K3", 48000, 3, 1, 32), ("K3", 96000, 3, 2, 32), ("K3", 96000, 3, 1, 1)]


@pytest.mark.parametrize("kernel,rate,b,ch,group", K3_K4_CASES)
def test_k3_k4_algorithm_matches_pallas_interpret_and_xla(kernel, rate, b, ch, group):
    n = 226 * 128
    jf, tf = _filters(rate)
    x = _noise((b, ch, n), rate + 20 * b + ch)
    nv = np.asarray([n, n - 700, n // 2 + 5][:b], np.int32)
    w = tuple(float(v) for v in channel_weights(ch))
    z, tp, sp = emulate_rows(kernel, tf, x, nv, w, rate, group)
    assert z.shape == (b, n // group)
    want, tpk = _jax_rows(kernel, jf, x, nv, w, rate, group)
    _energy_pins(z, want, rate, group)
    chain, tpx, spx = _xla_rows(jf, x, nv, w, rate, group)
    _energy_pins(z, chain, rate, group)
    if kernel == "K3":
        np.testing.assert_allclose(tp, tpk, rtol=2e-6, atol=1e-7)
        np.testing.assert_allclose(tp, tpx, rtol=2e-6, atol=1e-7)
        np.testing.assert_array_equal(sp, spx)
    if ch == 6:
        y = x.copy()
        y[:, 3] *= 7.0                              # the LFE adds no energy
        zy, tpy, _ = emulate_rows(kernel, tf, y, nv, w, rate, group)
        np.testing.assert_array_equal(zy, z)
        if kernel == "K3":
            lfe = np.arange(b * ch) % ch == 3
            assert (tpy[lfe] > 6 * tp[lfe]).all()


# a few long rows: enough segments at the kernels' own tile that the
# look-back reaches the inclusive state depth + 1 segments back, and a
# partial last segment
@pytest.mark.parametrize("kernel,n", [("K3", 2200 * 128), ("K4", 1129 * 128)])
def test_k3_k4_long_rows_match_xla(kernel, n):
    T = IIR.TP_TILE if kernel == "K3" else IIR.CHAIN_TILE
    assert -(-n // T) > IIR.LOOKBACK + 1 and n % T
    rate = 48000
    jf, tf = _filters(rate)
    x = _noise((1, 2, n), 7)
    nv = np.asarray([n - 5000], np.int32)
    w = tuple(float(v) for v in channel_weights(2))
    z, tp, sp = emulate_rows(kernel, tf, x, nv, w, rate, 32)
    chain, tpx, spx = _xla_rows(jf, x, nv, w, rate, 32)
    _energy_pins(z, chain, rate, 32)
    if kernel == "K3":
        np.testing.assert_allclose(tp, tpx, rtol=2e-6, atol=1e-7)
        np.testing.assert_array_equal(sp, spx)


@pytest.mark.parametrize("D", [0, 1, 3, 32])
def test_lookback_reproduces_the_recurrence(D):
    """Any look-back depth gives the serial filter: segments of 1,024
    samples (one warp), 41 of them with a partial last one, so the
    inclusive state D + 1 segments back enters for every D."""
    _, tf = _filters(48000)
    T = 1024
    x = _noise((2, 40 * T + 512), 11)
    s = np.zeros((2, 4))
    want = np.empty(x.shape)
    for i in range(x.shape[1]):
        want[:, i] = s @ tf.Cv + tf.D * x[:, i]
        s = s @ tf.A.T + x[:, i, None] * tf.Bv
    np.testing.assert_allclose(emulate_tile(tf, x, T, D), want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("channels", [1, 2])
def test_k5_channel_segments_reproduce_the_recurrence(channels):
    """K5's scan on the channel segments chain_segment gives (4,096 and
    2,048 samples: 4 and 2 warps), its powers of A read as their 2x2 blocks
    and each lane's in one step, is the serial filter, over 9 segments and
    a partial one."""
    _, tf = _filters(48000)
    T = IIR.chain_segment(channels)
    x = _noise((2, 9 * T + 128), 13)
    s = np.zeros((2, 4))
    want = np.empty(x.shape)
    for i in range(x.shape[1]):
        want[:, i] = s @ tf.Cv + tf.D * x[:, i]
        s = s @ tf.A.T + x[:, i, None] * tf.Bv
    np.testing.assert_allclose(emulate_tile(tf, x, T, modal=True), want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("channels", [1, 2])
def test_k3_track_segments_reproduce_the_recurrence(channels):
    """K3's scan on the channel segments of its track tickets (k3_segment:
    8,192 and 4,096 samples, 8 and 4 warps), with the look-back of LOOKBACK
    segments, its powers of A read as their 2x2 blocks and each lane's in
    one step, is the serial filter over 34 segments and a partial one: from
    segment 33 on the inclusive state LOOKBACK + 1 segments back enters."""
    _, tf = _filters(48000)
    T = IIR.k3_segment(channels)
    assert T * channels == IIR.TP_TILE
    x = _noise((2, 34 * T + 128), 17)
    s = np.zeros((2, 4))
    want = np.empty(x.shape)
    for i in range(x.shape[1]):
        want[:, i] = s @ tf.Cv + tf.D * x[:, i]
        s = s @ tf.A.T + x[:, i, None] * tf.Bv
    got = emulate_tile(tf, x, T, IIR.LOOKBACK, modal=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("rate", [44100, 48000, 96000, 192000])
def test_host_matrices_reproduce_the_recurrence(rate):
    """Each float32 matrix of TileConsts is the float64 recurrence rounded
    once: W[k] = A^(31-k) B, KS[r] = A^(32 2^r), AW[w] = A^(1024 w), A^T,
    and the look-back's A^(T (m+1)), which are block-diagonal; and the
    emulated scan of one segment equals the serial filter."""
    _, tf = _filters(rate)
    T = 8192
    k = iir_tile.unpack(iir_tile.tile_constants(tf, T))
    A, B = tf.A, tf.Bv

    def power(m):
        out = np.eye(4)
        for _ in range(m):
            out = A @ out
        return out

    def close(got, want):
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-7 * max(1.0, np.abs(want).max()))

    for i in range(TS):
        close(k["W"][i], power(TS - 1 - i) @ B)
    for r in range(5):
        close(k["KS"][r], power(TS << r))
    for w in range(iir_tile.MAX_WARPS):
        close(k["AW"][w], power(1024 * w))
    AT = power(T)
    close(k["AT"], AT)
    lb = AT
    for b in range(iir_tile.LB_BITS):                  # A^(T 2^b), its 2x2 blocks
        close(k["LB"][b], np.concatenate([lb[:2, :2].reshape(-1), lb[2:, 2:].reshape(-1)]))
        off = lb.copy()
        off[:2, :2] = off[2:, 2:] = 0.0
        assert np.abs(off).max() <= 1e-9
        lb = lb @ lb
    close(k["A"], A.astype(np.float32))
    assert iir_tile.modal_blocks_ok(tf.A)

    x = _noise((2, 2 * T + 4096), rate)
    s = np.zeros((2, 4))
    want = np.empty(x.shape)
    for i in range(x.shape[1]):
        want[:, i] = s @ tf.Cv + tf.D * x[:, i]
        s = s @ A.T + x[:, i, None] * B
    np.testing.assert_allclose(emulate_tile(tf, x, T), want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("rate", [44100, 48000, 192000])
def test_lane_powers_are_the_blocks_of_a_to_32_lane(rate):
    """K5's lane powers: A^(32 l) for each lane l, float64 rounded once, as
    the two 2x2 blocks (the rest is rounding noise); cached, read-only."""
    _, tf = _filters(rate)
    lp = iir_tile.lane_powers(tf)
    assert lp.shape == (TS, 8) and lp.dtype == np.float32 and not lp.flags.writeable
    assert lp is iir_tile.lane_powers(tf)
    A = np.asarray(tf.A, np.float64)
    for lane in (0, 1, 5, 31):
        want = np.linalg.matrix_power(A, TS * lane)
        np.testing.assert_allclose(_block_matrix(lp[lane].astype(np.float64)), _modal(want),
                                   rtol=0, atol=1e-7 * max(1.0, np.abs(want).max()))
        assert np.abs(want - _modal(want)).max() <= 1e-9


def test_tile_constants_are_cached_and_read_only():
    _, tf = _filters(48000)
    a = iir_tile.tile_constants(tf, 8192)
    assert a is iir_tile.tile_constants(tf, 8192)
    assert a.dtype == np.float32 and a.size == iir_tile.TILE_FLOATS
    assert not a.flags.writeable
    assert iir_tile.tile_constants(tf, 16384) is not a
    bad = np.eye(4)
    bad[0, 3] = 1e-3
    assert not iir_tile.modal_blocks_ok(bad)


def test_sync_buffer_layout():
    buf = iir_tile.sync_buffer(3, 5, "cpu")
    # the ticket counter, then two float4s (G, incl) per (row, segment)
    assert buf.dtype == torch.int32 and buf.numel() == 4 + 8 * 15
    assert bool((buf == -1).all())
    # K5: the inclusive state alone per (track, segment, channel)
    assert iir_tile.sync_buffer(3, 5, "cpu", iir_tile.INCL_WORDS).numel() == 4 + 4 * 15
    assert K1.tile_length(128) == 8192 and K1.tile_length(16384) == 16384
    assert K1.step_length(65536, 19200) == 16384        # the 192 kHz case above
    with pytest.raises(ValueError):
        K1.tile_length(32768)
