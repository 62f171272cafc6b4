"""K6 of the PyTorch port (ops/truepeak_stream.py) against the JAX package.

On the CPU `true_peak_stream` runs its plain version; it is held to
`true_peak_pallas` in interpret mode at the pins of
tests/test_pallas_iir.py: true peak rtol 2e-6 / atol 1e-7 (float32 FIR
sums in different orders), sample peak exact. At factor 1 (192 kHz) both
take a masked max, so both results are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soundscope_tpu.ops.pallas_truepeak import pick_block, true_peak_pallas
from soundscope_tpu_torch.ops import truepeak_stream as K6

# lengths for which the reference picks each of its block sizes
LENGTHS = {512: 512 * 20, 384: 384 * 25, 256: 256 * 37, 128: 128 * 73}


def _inputs(n, shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((*shape, n)) * 0.2).astype(np.float32)
    # one loud inter-sample peak in the valid region of every row
    x[..., n // 3] = 0.9
    x[..., n // 3 + 1] = 0.9
    return x


@pytest.mark.parametrize("blk", [512, 384, 256, 128])
@pytest.mark.parametrize("rate", [48000, 96000])
def test_plain_matches_pallas_interpret_per_track(blk, rate):
    n = LENGTHS[blk]
    assert pick_block(n) == blk
    x = _inputs(n, (3, 2), blk + rate)
    nv = np.asarray([n, n - 333, n // 2], np.int32)
    tp, sp = K6.true_peak_stream(torch.from_numpy(x), torch.from_numpy(nv), rate)
    tpj, spj = true_peak_pallas(jnp.asarray(x), jnp.asarray(nv), rate, interpret=True)
    assert tp.shape == sp.shape == (3, 2)
    np.testing.assert_allclose(tp.numpy(), np.asarray(tpj), rtol=2e-6, atol=1e-7)
    np.testing.assert_array_equal(sp.numpy(), np.asarray(spj))
    # the rows layout gives the same peaks
    tp2, sp2 = K6.true_peak_stream(torch.from_numpy(x.reshape(6, n)),
                                   torch.from_numpy(nv), rate)
    np.testing.assert_array_equal(tp2.numpy(), tp.numpy().reshape(-1))
    np.testing.assert_array_equal(sp2.numpy(), sp.numpy().reshape(-1))


@pytest.mark.parametrize("rate", [48000, 96000])
def test_plain_matches_pallas_interpret_scalar_n_valid(rate):
    n = LENGTHS[512]
    x = _inputs(n, (4,), rate)
    for nv in (n, n - 1000):
        tp, sp = K6.true_peak_stream(torch.from_numpy(x), nv, rate)
        tpj, spj = true_peak_pallas(jnp.asarray(x), jnp.int32(nv), rate, interpret=True)
        assert tp.shape == (4,)
        np.testing.assert_allclose(tp.numpy(), np.asarray(tpj), rtol=2e-6, atol=1e-7)
        np.testing.assert_array_equal(sp.numpy(), np.asarray(spj))


def test_factor_one_is_a_masked_max():
    """At 192 kHz neither package oversamples: tp = sp = the masked max,
    exactly, and nothing is launched."""
    n = LENGTHS[384]
    x = _inputs(n, (2, 6), 192)
    x[1, :, n - 10] = 5.0            # beyond n_valid of track 1: must not count
    nv = np.asarray([n, n - 100], np.int32)
    before = K6.LAUNCHES
    tp, sp = K6.true_peak_stream(torch.from_numpy(x), torch.from_numpy(nv), 192000)
    assert K6.LAUNCHES == before
    tpj, spj = true_peak_pallas(jnp.asarray(x), jnp.asarray(nv), 192000, interpret=True)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(tpj))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(spj))
    np.testing.assert_array_equal(tp.numpy(), sp.numpy())
    assert float(sp[1].max()) < 5.0


def test_padding_never_rings_and_inputs_rejected():
    """Interpolator outputs at positions >= n_valid do not count: a loud
    sample right after the valid region leaves tp unchanged."""
    n = LENGTHS[256]
    x = _inputs(n, (1, 2), 5)
    nv = np.asarray([n - 40], np.int32)
    tp0, _ = K6.true_peak_stream(torch.from_numpy(x), torch.from_numpy(nv), 48000)
    y = x.copy()
    y[..., n - 40:] = 50.0
    tp1, _ = K6.true_peak_stream(torch.from_numpy(y), torch.from_numpy(nv), 48000)
    np.testing.assert_array_equal(tp1.numpy(), tp0.numpy())
    with pytest.raises(ValueError):
        K6.true_peak_stream(torch.zeros(2, 1000), 1000, 48000)   # N % 128
    with pytest.raises(ValueError):
        K6.true_peak_stream(torch.zeros(3, 256), torch.tensor([256, 256]), 48000)
    with pytest.raises(TypeError):
        K6.true_peak_stream(torch.zeros(2, 256, dtype=torch.float64), 256, 48000)
    with pytest.raises(ValueError):
        K6.true_peak_stream(torch.zeros(2, 256, device="meta"), 256, 48000)
