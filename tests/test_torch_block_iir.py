"""K7's plain version against the JAX package: block_iir_zero against the
Pallas kernel block_iir_pallas in interpret mode, block_iir_stream_plain
against the XLA block_iir with a carried state, and the kernel's split-time
algorithm (csrc/block_iir.cu), emulated in float64 with its float32
constants, against the same.

Pins: y and s_final within 2e-5 abs for unit-variance input
(tests/test_pallas_iir.py's pin for the Pallas kernel against block_iir).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import soundscope_tpu.ops.biquad as jbq
from soundscope_tpu.ops.kweight import kweight_cascade_ss
from soundscope_tpu.ops.pallas_iir import block_iir_pallas
from soundscope_tpu_torch.ops import iir as IIR
from soundscope_tpu_torch.ops.biquad import make_block_filter

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
    before = dict(IIR.LAUNCHES)
    got = IIR.block_iir_zero(tf, torch.from_numpy(x)).numpy()
    assert IIR.LAUNCHES == before          # a CPU tensor launches nothing
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


def _split_time(filt, x, s0, L, dtype=np.float64):
    """csrc/block_iir.cu's three passes on its float32 constants
    (ops/biquad.BlockFilter.constants and weight_table), in `dtype`: the
    matrix-form zero state over the full steps before the last, the prefix
    from s0 with A^L, the correction by the recurrence, and s_final in
    matrix form from the last step's entry state with A^r."""
    coef = filt.constants(L, "cpu").numpy().astype(dtype)
    A, B, Cv, D = coef[:16].reshape(4, 4), coef[16:20], coef[20:24], coef[24]
    AL = coef[25:41].reshape(4, 4)
    W = filt.weight_table(L, "cpu").numpy().astype(dtype)
    rows, n = x.shape
    nsteps = -(-n // L)
    r = n - (nsteps - 1) * L
    Ar = filt.constants(r, "cpu").numpy().astype(dtype)[25:41].reshape(4, 4)
    xp = np.zeros((rows, nsteps * L), dtype)
    xp[:, :n] = x
    xs = xp.reshape(rows, nsteps, L)
    s_final0 = np.zeros((rows, nsteps, 4), dtype)
    for i in range(L):
        s_final0 = (s_final0 + xs[..., i, None] * W[i]).astype(dtype)
    s_entry = np.zeros((rows, nsteps, 4), dtype)
    s = s0.astype(dtype)
    for j in range(nsteps):
        s_entry[:, j] = s
        s = (s @ AL.T + s_final0[:, j]).astype(dtype)
    y = np.zeros((rows, nsteps, L), dtype)
    s = s_entry.copy()
    for i in range(L):
        y[..., i] = s @ Cv + D * xs[..., i]
        s = (s @ A.T + xs[..., i, None] * B).astype(dtype)
    s = (s_entry[:, -1] @ Ar.T).astype(dtype)
    for i in range(r):
        s = (s + xs[:, -1, i, None] * W[L - r + i]).astype(dtype)
    return y.reshape(rows, -1)[:, :n], s


@pytest.mark.parametrize("n", [1, 7, 333, 800, 2048])
def test_kernel_split_time_algorithm_matches_jax(n):
    """The kernel's passes and constant layout, with a carried state in the
    JAX filter's modal basis: the basis of the port's BlockFilter."""
    x, s0 = _inputs(900 + n, (2, n))
    jf = jbq.make_block_filter(kweight_cascade_ss(48000), block=128)
    yj, sj = jbq.block_iir(jf, jnp.asarray(x), jnp.asarray(s0))
    tf = make_block_filter(kweight_cascade_ss(48000), 128)
    y, s = _split_time(tf, x, s0, IIR.STREAM_STEP)
    np.testing.assert_allclose(y, np.asarray(yj), rtol=0, atol=2e-5)
    np.testing.assert_allclose(s, np.asarray(sj), rtol=0, atol=2e-5)


@pytest.mark.parametrize("rate,shape", [(48000, (2, 800)), (44100, (2, 44100))])
def test_kernel_carried_state_holds_the_pin_against_float64(rate, shape):
    """The kernel's passes in float32 (numpy, no fused multiply-add) against
    a float64 evaluation of the same filter: y and s_final within the pin
    of 2e-5 per unit RMS of x over several seeds with a random carried
    state. The sample-by-sample float32 recurrence this replaces drifts in
    the slow high-pass mode, whose state C barely observes: up to 3e-5 per
    unit RMS in s_final at (2, 44100)."""
    tf = make_block_filter(kweight_cascade_ss(rate), 128)
    for seed in range(4):
        rng = np.random.default_rng(seed)
        x = (rng.standard_normal(shape) * 0.3).astype(np.float32)
        s0 = (rng.standard_normal((shape[0], 4)) * 0.1).astype(np.float32)
        s = s0.astype(np.float64)
        yt = np.empty(shape)
        for i in range(shape[1]):
            yt[:, i] = s @ tf.Cv + tf.D * x[:, i]
            s = s @ tf.A.T + x[:, i, None] * tf.Bv
        y, sf = _split_time(tf, x, s0, IIR.STREAM_STEP, np.float32)
        rms = float(np.sqrt((x.astype(np.float64) ** 2).mean()))
        assert np.abs(y - yt).max() < 2e-5 * rms
        assert np.abs(sf - s).max() < 2e-5 * rms


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
