"""K3, K4 and K5 of the PyTorch port (ops/iir.py) against the JAX package.

On the CPU the port's entries run their plain versions; they are held to
the JAX Pallas kernels in interpret mode (kweight_energy_tp_pallas_prefix,
kweight_energy_pallas_prefix, kweight_energy_pallas), fed the same JAX
filter:

* 100 ms sub-block sums of z: rtol 3e-4 / atol 2e-5 (K1's pins);
* z itself, per group: rtol 1e-3, atol 1e-6 * max|z| (measured: at most
  1.4e-4 * (|z| + 1e-5 * max|z|); the reference's Toeplitz product is a
  bf16x2 split worth about 21 bits, the port's filter is full float32);
* true peak rtol 2e-6 / atol 1e-7, sample peak exact.

The rows layout must equal the 3D layout bit for bit, and group-32 output
must equal group-1 output regrouped, as in tests/test_pallas_iir.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soundscope_tpu.ops.biquad import make_block_filter as jax_block_filter
from soundscope_tpu.ops.kweight import channel_weights, kweight_cascade_ss
from soundscope_tpu.ops.pallas_iir import (
    kweight_energy_pallas,
    kweight_energy_pallas_prefix,
    kweight_energy_tp_pallas_prefix,
)
from soundscope_tpu_torch.ops import iir as IIR
from soundscope_tpu_torch.utils.params import block_filter_from_numpy

# 226 blocks of 128 = 2 x 113: the prefix kernels take 2 blocks a grid
# step, which keeps interpret mode quick, and the track holds 6 sub-blocks
# at 48 kHz
NB = 226
N = NB * 128


def _inputs(rate, b, ch=2, seed=3):
    rng = np.random.default_rng(seed + rate + 10 * b + ch)
    x = (rng.standard_normal((b, ch, N)) * 0.1).astype(np.float32)
    x[..., N // 2:] *= 3.0
    nv = np.asarray([N, N - 700, N // 2][:b], np.int32)
    jf = jax_block_filter(kweight_cascade_ss(rate), 128)
    tf = block_filter_from_numpy(np.asarray(jf.Tt), np.asarray(jf.Wt),
                                 np.asarray(jf.Ot), np.asarray(jf.A_pows), 128)
    w = tuple(float(v) for v in channel_weights(ch))
    return x, nv, jf, tf, w


def _jax(kernel, jf, x, nv, w, group, rate=None):
    args = (jf.Tt, jf.Wt, jf.Ot)
    if kernel == "K5":
        return np.asarray(kweight_energy_pallas(
            *args, jnp.transpose(jf.A_pows[128]), jnp.asarray(x), jnp.asarray(nv),
            w, interpret=True, group=group)), None, None
    if kernel == "K4":
        return np.asarray(kweight_energy_pallas_prefix(
            *args, jf.A_pows, jnp.asarray(x), jnp.asarray(nv), w, interpret=True,
            group=group)), None, None
    z, tp, sp = kweight_energy_tp_pallas_prefix(
        *args, jf.A_pows, jnp.asarray(x), jnp.asarray(nv), w, rate,
        interpret=True, group=group)
    return np.asarray(z), np.asarray(tp), np.asarray(sp)


def _port(kernel, tf, x, nv, w, group, rate=None):
    xt, nvt = torch.from_numpy(x), torch.from_numpy(nv)
    if kernel == "K3":
        z, tp, sp = IIR.kweight_energy_tp_prefix(tf, xt, nvt, w, rate, group)
        return z.numpy(), tp.numpy(), sp.numpy()
    fn = IIR.kweight_energy_prefix if kernel == "K4" else IIR.kweight_energy_chain
    return fn(tf, xt, nvt, w, group).numpy(), None, None


def _assert_energy_close(got, want, rate, group):
    zmax = np.abs(want).max()
    assert zmax > 0
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6 * zmax)
    hg = ((rate + 5) // 10) // group
    nb = got.shape[-1] // hg
    assert nb >= 1

    def sums(z):
        return z[:, : nb * hg].reshape(z.shape[0], nb, hg).astype(np.float64).sum(-1)

    np.testing.assert_allclose(sums(got), sums(want), rtol=3e-4, atol=2e-5)


CASES = [
    # kernel, rate, b, ch, group
    ("K3", 48000, 3, 2, 32), ("K3", 48000, 3, 2, 1), ("K3", 44100, 3, 2, 1),
    ("K3", 96000, 3, 2, 32), ("K3", 48000, 1, 2, 32),
    ("K4", 48000, 3, 2, 32), ("K4", 48000, 3, 2, 1), ("K4", 44100, 3, 2, 1),
    ("K4", 48000, 1, 2, 32), ("K4", 192000, 1, 6, 32), ("K4", 192000, 2, 6, 32),
    ("K5", 48000, 3, 2, 32), ("K5", 48000, 3, 2, 1), ("K5", 44100, 3, 2, 1),
    ("K5", 48000, 1, 2, 32),
]


@pytest.mark.parametrize("kernel,rate,b,ch,group", CASES)
def test_plain_matches_pallas_interpret(kernel, rate, b, ch, group):
    x, nv, jf, tf, w = _inputs(rate, b, ch)
    got, tp, sp = _port(kernel, tf, x, nv, w, group, rate)
    want, tpj, spj = _jax(kernel, jf, x, nv, w, group, rate)
    assert got.shape == want.shape == (b, N // group)
    _assert_energy_close(got, want, rate, group)
    if kernel == "K3":
        assert tp.shape == sp.shape == (b * ch,)
        np.testing.assert_allclose(tp, tpj, rtol=2e-6, atol=1e-7)
        np.testing.assert_allclose(sp, spj, rtol=0, atol=0)
        assert (tp >= sp).all()


@pytest.mark.parametrize("kernel", ["K3", "K4", "K5"])
def test_rows_layout_equals_3d_and_groups_regroup(kernel):
    x, nv, _, tf, w = _inputs(48000, 3)
    z3, tp3, sp3 = _port(kernel, tf, x, nv, w, 32, 48000)
    z2, tp2, sp2 = _port(kernel, tf, x.reshape(3 * 2, N), nv, w, 32, 48000)
    np.testing.assert_array_equal(z2, z3)
    z1, _, _ = _port(kernel, tf, x, nv, w, 1, 48000)
    np.testing.assert_array_equal(
        torch.from_numpy(z1).reshape(3, -1, 32).sum(-1).numpy(), z3)
    if kernel == "K3":
        np.testing.assert_array_equal(tp2, tp3)
        np.testing.assert_array_equal(sp2, sp3)


def test_zero_weight_channel_contributes_nothing():
    """The 5.1 LFE (weight 0) adds no energy: scaling it changes nothing,
    while K3 still reports its peaks."""
    x, nv, _, tf, w = _inputs(96000, 2, ch=6)
    assert w[3] == 0.0
    y = x.copy()
    y[:, 3] *= 7.0
    for kernel in ("K4", "K5"):
        np.testing.assert_array_equal(_port(kernel, tf, y, nv, w, 32)[0],
                                      _port(kernel, tf, x, nv, w, 32)[0])
    zx, tpx, _ = _port("K3", tf, x, nv, w, 32, 96000)
    zy, tpy, _ = _port("K3", tf, y, nv, w, 32, 96000)
    np.testing.assert_array_equal(zy, zx)
    lfe = np.arange(12) % 6 == 3
    assert (tpy[lfe] > 6 * tpx[lfe]).all()
    np.testing.assert_array_equal(tpy[~lfe], tpx[~lfe])


def test_mask_is_at_sample_granularity():
    """Samples at and beyond n_valid never reach z, whatever they hold,
    and a group cut by n_valid keeps only its valid part."""
    x, nv, _, tf, w = _inputs(48000, 3)
    nv = np.asarray([N - 17, N - 700, N // 2 + 5], np.int32)
    y = x.copy()
    for i, v in enumerate(nv):
        y[i, :, v:] = 100.0
    for kernel in ("K3", "K4", "K5"):
        np.testing.assert_array_equal(_port(kernel, tf, y, nv, w, 32, 48000)[0],
                                      _port(kernel, tf, x, nv, w, 32, 48000)[0])
    z1 = _port("K4", tf, x, nv, w, 1)[0]
    for i, v in enumerate(nv):
        assert (z1[i, v:] == 0).all() and z1[i, v - 1] > 0


@pytest.mark.parametrize("n,want", [
    (720000, 3200), (1 << 24, 4096), (128 * 1129, 128), (128 * 226, 256),
    (128 * 64, 4096), (128, 128),
])
def test_span_length(n, want):
    L = IIR.span_length(n)
    assert L == want and n % L == 0 and L % 128 == 0 and L <= IIR.MAX_SPAN


def test_inputs_rejected_and_cpu_launches_nothing():
    x, nv, _, tf, w = _inputs(48000, 1)
    xt, nvt = torch.from_numpy(x), torch.from_numpy(nv)
    with pytest.raises(ValueError):
        IIR.span_length(1000)
    with pytest.raises(TypeError):
        IIR.kweight_energy_prefix(tf, xt.double(), nvt, w)
    with pytest.raises(ValueError):
        IIR.kweight_energy_chain(tf, xt, nvt, w[:1])           # 2 channels, 1 weight
    with pytest.raises(ValueError):
        IIR.kweight_energy_prefix(tf, torch.zeros(3, N), nvt, w)  # 3 rows, ch 2
    with pytest.raises(ValueError):
        IIR.kweight_energy_prefix(tf, xt, nvt, w, group=7)     # 7 does not divide N
    with pytest.raises(ValueError):
        IIR.kweight_energy_tp_prefix(tf, xt, nvt, w, 192000)   # no oversampling
    for fn in (IIR.kweight_energy_prefix, IIR.kweight_energy_chain):
        with pytest.raises(ValueError):
            fn(tf, xt.to("meta"), nvt, w)
    with pytest.raises(ValueError):
        IIR.kweight_energy_tp_prefix(tf, xt.to("meta"), nvt, w, 48000)
    before = dict(IIR.LAUNCHES)
    _port("K3", tf, x, nv, w, 32, 48000)
    _port("K4", tf, x, nv, w, 32)
    _port("K5", tf, x, nv, w, 32)
    assert IIR.LAUNCHES == before
