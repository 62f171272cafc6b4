"""K7's plain version against the JAX package: block_iir_zero against the
Pallas kernel block_iir_pallas in interpret mode, block_iir_stream_plain
against the XLA block_iir with a carried state, and the kernel's algorithm
(csrc/block_iir.cu: the tile-scan core in its S0 mode), emulated on its
float32 host constants, against the same and against float64.

`emulate_stream` repeats the kernel's passes: segments of IIR.CHAIN_TILE
samples, the core's scan and look-back of
tests/test_torch_iir_tile.py with each row entering from s0 (the records
of a segment -1), the refilter for y, and s_final in matrix form from the
entry state of the sub-span that holds the row's last sample (A^m from
ops/iir_tile.power_blocks, the sums from W).

Pins: y and s_final within 2e-5 abs for unit-variance input
(tests/test_pallas_iir.py's pin for the Pallas kernel against block_iir).
"""

import concurrent.futures
import dataclasses
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import soundscope_tpu.ops.biquad as jbq
from soundscope_tpu.ops.kweight import kweight_cascade_ss
from soundscope_tpu.ops.pallas_iir import block_iir_pallas
from soundscope_tpu_torch.core.config import MeterConfig
from soundscope_tpu_torch.models.engine import analyze_batch_native
from soundscope_tpu_torch.ops import iir as IIR
from soundscope_tpu_torch.ops import iir_tile
from soundscope_tpu_torch.ops import kweight as tkw
from soundscope_tpu_torch.ops.biquad import kweight_filter, make_block_filter
from soundscope_tpu_torch.utils.metrics import launches
from tests.test_torch_iir_tile import _block_matrix, _refilter, _scan

LENGTHS = [1, 7, 127, 333, 800, 2048, 44100]


def _inputs(seed, shape):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    s0 = (rng.standard_normal((*shape[:-1], 4)) * 0.5).astype(np.float32)
    return x, s0


@pytest.mark.parametrize("shape", [(1, 128 * 8), (3, 2, 128 * 16)])
def test_block_iir_zero_matches_pallas_interpret(shape):
    x, _ = _inputs(71, shape)
    jf = jbq.make_block_filter(kweight_cascade_ss(48000), block=128)
    want = np.asarray(block_iir_pallas(jf, jnp.asarray(x), interpret=True))
    tf = make_block_filter(kweight_cascade_ss(48000), 128)
    before = launches()
    got = IIR.block_iir_zero(tf, torch.from_numpy(x)).numpy()
    assert launches() == before          # a CPU tensor launches nothing
    assert got.shape == want.shape
    assert np.abs(got - want).max() < 2e-5


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("rate", [48000, 44100])
def test_block_iir_stream_plain_matches_jax_block_iir(n, rate):
    x, s0 = _inputs(n + rate, (2, n))
    jf = jbq.make_block_filter(kweight_cascade_ss(rate), block=128)
    yj, sj = jbq.block_iir(jf, jnp.asarray(x), jnp.asarray(s0))
    tf = make_block_filter(kweight_cascade_ss(rate), 128)
    yt, st = IIR.block_iir_stream(tf, torch.from_numpy(x), torch.from_numpy(s0))
    assert yt.shape == (2, n) and st.shape == (2, 4)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=2e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=2e-5)


def emulate_stream(filt, x, s0, T=None, dtype=np.float64):
    """(y (rows, n), s_final (rows, 4)) of K7 on x (rows, n) float32 from s0,
    in `dtype` on the float32 host constants; T: the segment (the kernel's
    IIR.CHAIN_TILE by default)."""
    rows, n = x.shape
    T = T or IIR.CHAIN_TILE
    nseg = -(-n // T)
    xp = np.zeros((rows, nseg * T), dtype)
    xp[:, :n] = x
    xs = xp.reshape(rows, nseg, T // iir_tile.TS, iir_tile.TS)
    k = {name: np.asarray(v, dtype)
         for name, v in iir_tile.unpack(iir_tile.tile_constants(filt, T)).items()}
    entry = _scan(k, xs, T, IIR.LOOKBACK, s0.astype(dtype))
    y = _refilter(k, xs, entry).reshape(rows, -1)[:, :n]
    th, m = (n - 1) // iir_tile.TS, (n - 1) % iir_tile.TS + 1
    AR = _block_matrix(iir_tile.power_blocks(filt, m)).astype(dtype)
    s = entry.reshape(rows, -1, 4)[:, th] @ AR.T
    for j in range(m):
        s = s + xp[:, th * iir_tile.TS + j, None] * k["W"][iir_tile.TS - m + j]
    return y, s


# N, rows, T: the lengths in use (a partial last sub-span for all but 800
# and 2048), one segment (the tick) and many (the 1 s slab's 11), and
# 44,100 at T = 1,024: 44 segments, past the look-back's 32, so s0 enters
# through the inclusive state as well (the 5.1 slab's 47 do so on the card)
STREAM_CASES = [(n, rows, None) for n in (1, 7, 333, 800, 2048, 44100) for rows in (2, 6)]
STREAM_CASES.append((44100, 2, 1024))


@pytest.mark.parametrize("n,rows,T", STREAM_CASES)
def test_kernel_stream_algorithm_matches_jax(n, rows, T):
    """The kernel's passes and constant layout, with a carried state in the
    JAX filter's modal basis (the basis of the port's BlockFilter), against
    the XLA block_iir and a float64 evaluation of the recurrence."""
    rate = 44100 if n == 44100 else 48000
    x, s0 = _inputs(900 + n + rows, (rows, n))
    jf = jbq.make_block_filter(kweight_cascade_ss(rate), block=128)
    yj, sj = jbq.block_iir(jf, jnp.asarray(x), jnp.asarray(s0))
    tf = make_block_filter(kweight_cascade_ss(rate), 128)
    if T is not None:
        assert -(-n // T) > IIR.LOOKBACK + 1
    y, s = emulate_stream(tf, x, s0, T)
    rms = float(np.sqrt((x.astype(np.float64) ** 2).mean()))
    np.testing.assert_allclose(y, np.asarray(yj), rtol=0, atol=2e-5 * rms)
    np.testing.assert_allclose(s, np.asarray(sj), rtol=0, atol=2e-5 * rms)
    yt, st = _float64(tf, x, s0)
    np.testing.assert_allclose(y, yt, rtol=0, atol=2e-5 * rms)
    np.testing.assert_allclose(s, st, rtol=0, atol=2e-5 * rms)


def _float64(filt, x, s0):
    """The recurrence sample by sample in float64."""
    s = s0.astype(np.float64)
    y = np.empty(x.shape)
    for i in range(x.shape[1]):
        y[:, i] = s @ filt.Cv + filt.D * x[:, i]
        s = s @ filt.A.T + x[:, i, None] * filt.Bv
    return y, s


@pytest.mark.parametrize("rate,shape", [(48000, (2, 800)), (44100, (2, 44100))])
def test_kernel_carried_state_holds_the_pin_against_float64(rate, shape):
    """The kernel's passes in float32 (numpy, no fused multiply-add) against
    a float64 evaluation of the same filter: y and s_final within the pin
    of 2e-5 per unit RMS of x over several seeds with a random carried
    state. The sample-by-sample float32 recurrence drifts in the slow
    high-pass mode, whose state C barely observes: up to 3e-5 per unit RMS
    in s_final at (2, 44100); s_final is therefore taken in matrix form."""
    tf = make_block_filter(kweight_cascade_ss(rate), 128)
    for seed in range(4):
        rng = np.random.default_rng(seed)
        x = (rng.standard_normal(shape) * 0.3).astype(np.float32)
        s0 = (rng.standard_normal((shape[0], 4)) * 0.1).astype(np.float32)
        yt, st = _float64(tf, x, s0)
        y, sf = emulate_stream(tf, x, s0, dtype=np.float32)
        assert y.dtype == sf.dtype == np.float32
        rms = float(np.sqrt((x.astype(np.float64) ** 2).mean()))
        assert np.abs(y - yt).max() < 2e-5 * rms
        assert np.abs(sf - st).max() < 2e-5 * rms


def test_end_state_constants():
    """A^m for the last sub-span, m = 1 .. 32, as K7 reads it: two 2x2
    blocks of the float64 power rounded once, cached on the filter."""
    tf = make_block_filter(kweight_cascade_ss(44100), 128)
    for m in (1, 5, 31, 32):
        want = np.linalg.matrix_power(tf.A, m)
        got = iir_tile.power_blocks(tf, m)
        assert got.dtype == np.float32 and not got.flags.writeable
        np.testing.assert_allclose(_block_matrix(got), want, rtol=0, atol=2e-7)
        assert iir_tile.power_blocks(tf, m) is got


def test_modal_basis_agrees_with_jax():
    """The state the port carries is the JAX state: same realisation, and
    a state handed over mid-stream continues the JAX stream."""
    ss = kweight_cascade_ss(48000)
    ja, jb, jc, jd = jbq.modal_form(ss)
    tf = make_block_filter(ss, 128)
    np.testing.assert_array_equal(tf.A, ja)
    np.testing.assert_array_equal(tf.Bv, jb)
    np.testing.assert_array_equal(tf.Cv, jc)
    assert tf.D == jd
    x, s0 = _inputs(5, (2, 1500))
    jf = jbq.make_block_filter(ss, block=128)
    y_all, _ = jbq.block_iir(jf, jnp.asarray(x), jnp.asarray(s0))
    _, s_mid = jbq.block_iir(jf, jnp.asarray(x[:, :700]), jnp.asarray(s0))
    y_rest, _ = IIR.block_iir_stream(tf, torch.from_numpy(x[:, 700:]),
                                     torch.from_numpy(np.array(s_mid)))
    np.testing.assert_allclose(y_rest.numpy(), np.asarray(y_all)[:, 700:],
                               rtol=0, atol=2e-5)


def test_strided_input_and_empty_push():
    """The meter's channel view of interleaved audio (stride = channels)
    filters as its contiguous copy; N = 0 returns s0."""
    tf = make_block_filter(kweight_cascade_ss(48000), 128)
    inter, s0 = _inputs(8, (2 * 333,))
    s0 = np.stack([s0, -s0])
    view = torch.from_numpy(inter).reshape(333, 2).T
    assert view.stride() == (1, 2)
    y1, s1 = IIR.block_iir_stream(tf, view, torch.from_numpy(s0))
    y2, s2 = IIR.block_iir_stream(tf, view.contiguous(), torch.from_numpy(s0))
    np.testing.assert_array_equal(y1.numpy(), y2.numpy())
    np.testing.assert_array_equal(s1.numpy(), s2.numpy())
    y0, s_empty = IIR.block_iir_stream(tf, torch.zeros((2, 0)), torch.from_numpy(s0))
    assert y0.shape == (2, 0)
    np.testing.assert_array_equal(s_empty.numpy(), s0)


@pytest.mark.parametrize("rate", [44100, 48000, 96000, 192000])
def test_kweight_filter_is_built_once_and_bit_identical(rate):
    """kweight_filter: one BlockFilter per (rate, block, device), whose
    tensors and kernel constants are make_block_filter's bit for bit; two
    engine calls through it on one frames batch give the same bits."""
    filt = kweight_filter(rate, 128, "cpu")
    assert filt is kweight_filter(rate, 128, torch.device("cpu"))
    assert filt is kweight_filter(rate)
    own = make_block_filter(tkw.kweight_cascade_ss(rate), 128)
    for name in ("Tt", "Wt", "Ot", "A_pows"):
        assert torch.equal(getattr(filt, name), getattr(own, name))
    np.testing.assert_array_equal(filt.A_block, own.A_block)
    for T in (2048, 4096, 8192, 16384):
        consts = iir_tile.tile_constants(filt, T)
        np.testing.assert_array_equal(consts, iir_tile.tile_constants(own, T))
        assert iir_tile.tile_constants(kweight_filter(rate, 128, "cpu"), T) is consts

    cfg = MeterConfig(channels=2, rate=rate, max_blocks=0)
    n = 128 * (rate // 64)                                  # 2 s
    x = torch.from_numpy(np.random.default_rng(rate).standard_normal(
        (2, 2, n // 128, 128)).astype(np.float32) * 0.1)
    nv = torch.tensor([n, n - 777])
    a, b = analyze_batch_native(cfg, x, nv), analyze_batch_native(cfg, x, nv)
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, f.name).numpy(), getattr(b, f.name).numpy())


def test_kweight_filter_is_one_object_across_threads():
    """Threads that ask at once for a filter not built yet all get the one
    BlockFilter that later calls get."""
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with concurrent.futures.ThreadPoolExecutor(16) as pool:
            futures = [pool.submit(kweight_filter, 32000, 64, "cpu") for _ in range(64)]
            got = [f.result(timeout=60) for f in futures]
    finally:
        sys.setswitchinterval(switch)
    assert all(f is got[0] for f in got)
    assert got[0] is kweight_filter(32000, 64)
