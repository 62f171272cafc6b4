"""The tile-scan core of K1 and K5 (csrc/iir_tile.cuh, ops/iir_tile.py),
emulated in float64 on its float32 host constants, against the JAX package.

`emulate` repeats the kernels' passes in their order: the matrix-form zero
state of each thread's 32 samples, the Kogge-Stone scan over a warp's
lanes, the warps in series, the hop from segment to segment
(s_out = A^T s_in + G), each thread's entry state A^(32 lane) (A^(1024 w)
s_in + E_w) + F_(lane-1) with the lane power applied bit by bit, the
refilter with A as its two 2x2 blocks, float32-sized partial sums per
thread and the fixed-order step (K1) or group and channel (K5) sums. It is
held to the JAX Pallas kernels in interpret mode and to the XLA chain at
the port's pins (tests/test_torch_iir_chunked.py, tests/test_torch_iir_rows.py):
sub-block sums rtol 3e-4 / atol 2e-5, z per group rtol 1e-3 / atol 1e-6 *
max|z|, true peak rtol 2e-6 / atol 1e-7, sample peak exact.
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
from soundscope_tpu.ops.pallas_iir import kweight_energy_pallas
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
                                 np.asarray(jf.Ot), np.asarray(jf.A_pows), 128)
    return jf, tf


def _scan(k, x, T):
    """Entry state of every thread: (rows, nseg, P, 4), x (rows, nseg, P, 32)
    float64, as tile_scan computes it."""
    rows, nseg, P, _ = x.shape
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
    e = np.zeros((rows, nseg, 4))
    for w in range(nw):                             # warps in series
        E[:, :, w] = e
        e = e @ k["AW"][1].T + tot[:, :, w]
    s_in = np.zeros((rows, nseg, 4))
    for s in range(1, nseg):                        # the chain of segments
        s_in[:, s] = s_in[:, s - 1] @ k["AT"].T + e[:, s - 1]
    v = np.einsum("wij,rsj->rswi", k["AW"][:nw], s_in) + E
    v = np.broadcast_to(v[:, :, :, None, :], F.shape).copy()
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


def emulate_tile(filt, x, T):
    """y (rows, n) of the tile-scan core on x (rows, n) float32."""
    rows, n = x.shape
    nseg = -(-n // T)
    xp = np.zeros((rows, nseg * T))
    xp[:, :n] = x
    xs = xp.reshape(rows, nseg, T // TS, TS)
    k = {name: np.asarray(v, np.float64)
         for name, v in iir_tile.unpack(iir_tile.tile_constants(filt, T)).items()}
    y = _refilter(k, xs, _scan(k, xs, T))
    return y.reshape(rows, -1)[:, :n]


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
    zt = z.reshape(rows, n // TS, TS)
    tot = zt.sum(-1).astype(np.float32).astype(np.float64)   # float32 per thread
    left = np.where(g < bound, z, 0.0).reshape(rows, n // TS, TS).sum(-1)
    left = left.astype(np.float32).astype(np.float64)
    per = L // TS
    steps = np.stack([tot.reshape(rows, -1, per).sum(-1),
                      left.reshape(rows, -1, per).sum(-1)], -1).astype(np.float32)
    factor = JC.true_peak_factor(rate)
    sp = np.where(valid, np.abs(x.reshape(rows, n)), 0.0).max(-1)
    tp = np.zeros(rows)
    if factor > 1:
        # phases 1 .. F-1 over taps 0 .. KP-2, as k1_span (phase 0 is an
        # impulse the sample peak covers; the other phases' last tap is 0)
        taps = K1._taps(factor).reshape(factor, -1).astype(np.float64)
        kp = taps.shape[1] - 1
        xh = np.concatenate([np.zeros((rows, kp - 1)), x.reshape(rows, n)], -1)
        for p in range(1, factor):
            acc = sum(taps[p, t] * xh[:, kp - 1 - t: kp - 1 - t + n] for t in range(kp))
            tp = np.maximum(tp, np.where(valid, np.abs(acc), 0.0).max(-1))
    return steps, np.maximum(tp, sp).astype(np.float32), sp.astype(np.float32)


def emulate_k5(filt, x, nv, weights, group):
    """K5's z (b, n/group): x (b, ch, n) float32."""
    b, ch, n = x.shape
    y = emulate_tile(filt, x.reshape(b * ch, n), IIR.CHAIN_TILE).reshape(b, ch, n)
    valid = np.arange(n)[None] < nv[:, None]
    z = np.zeros((b, n // group))
    for c, w in enumerate(weights):
        if w != 0.0:
            zc = np.where(valid, np.float32(w) * (y[:, c] * y[:, c]), 0.0)
            z = z + zc.reshape(b, -1, group).sum(-1).astype(np.float32)
    return z.astype(np.float32)


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


# rate, b, ch, group: g = 32 and g = 1, 44.1 kHz, 5.1 with the zero-weight
# LFE, b = 3; N = 28,928 leaves a partial last segment
K5_CASES = [(48000, 3, 2, 32), (48000, 3, 2, 1), (44100, 3, 2, 1), (48000, 2, 6, 32)]


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


@pytest.mark.parametrize("rate", [44100, 48000, 96000, 192000])
def test_host_matrices_reproduce_the_recurrence(rate):
    """Each float32 matrix of TileConsts is the float64 recurrence rounded
    once: W[k] = A^(31-k) B, KS[r] = A^(32 2^r), AW[w] = A^(1024 w), A^T;
    and the emulated scan of one segment equals the serial filter."""
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
    close(k["AT"], power(T))
    close(k["A"], A.astype(np.float32))
    assert iir_tile.modal_blocks_ok(tf.A)

    x = _noise((2, 2 * T + 4096), rate)
    s = np.zeros((2, 4))
    want = np.empty(x.shape)
    for i in range(x.shape[1]):
        want[:, i] = s @ tf.Cv + tf.D * x[:, i]
        s = s @ A.T + x[:, i, None] * B
    np.testing.assert_allclose(emulate_tile(tf, x, T), want, rtol=0, atol=2e-6)


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
    assert buf.dtype == torch.int32 and buf.numel() == 4 + 4 * 15
    assert bool((buf == -1).all())
    assert K1.tile_length(128) == 8192 and K1.tile_length(16384) == 16384
    assert K1.step_length(65536, 19200) == 16384        # the 192 kHz case above
    with pytest.raises(ValueError):
        K1.tile_length(32768)
