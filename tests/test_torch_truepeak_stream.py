"""K6 of the PyTorch port (ops/truepeak_stream.py) against the JAX package.

On the CPU `true_peak_stream` runs its plain version; it is held to
`true_peak_pallas` in interpret mode at the pins of
tests/test_pallas_iir.py: true peak rtol 2e-6 / atol 1e-7 (float32 FIR
sums in different orders), sample peak exact. At factor 1 (192 kHz) both
take a masked max, so both results are exact.

`emulate_k6` repeats the kernel's partition (csrc/truepeak_stream.cu):
segments of K6.TILE samples, each with only the 32 samples before it as
its halo, the FIR of phases 1 .. F-1 over taps 0 .. KP-2 (ops/iir_tile.
fir_taps: phase 0 is an impulse the sample peak covers, the other phases'
last tap is zero), outputs and samples masked at n_valid, segments that
start at or past n_valid skipped, then the per-row max, tp = max(tp, sp).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soundscope_tpu.core import constants as JC
from soundscope_tpu.ops.pallas_truepeak import pick_block, true_peak_pallas
from soundscope_tpu.ops.truepeak import true_peak_masked as jax_true_peak
from soundscope_tpu_torch.ops import iir_tile
from soundscope_tpu_torch.ops import truepeak_stream as K6
from soundscope_tpu_torch.utils.metrics import launches

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
    before = launches()["K6"]
    tp, sp = K6.true_peak_stream(torch.from_numpy(x), torch.from_numpy(nv), 192000)
    assert launches()["K6"] == before
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


def emulate_k6(x, nv, rate, T=K6.TILE):
    """(tp, sp) per row of x (rows, n) float32, nv (rows,), as k6_tile and
    peaks_pass take them."""
    rows, n = x.shape
    factor = JC.true_peak_factor(rate)
    taps = iir_tile.fir_taps(factor).reshape(factor, -1).astype(np.float64)
    kh = taps.shape[1] - 1                          # taps read per phase
    nseg = -(-n // T)
    xp = np.zeros((rows, 32 + nseg * T))            # 32 zeros before sample 0
    xp[:, 32: 32 + n] = x
    parts = np.zeros((2, rows, nseg))
    for seg in range(nseg):
        start = seg * T
        tile = xp[:, start: start + 32 + T].copy()  # the halo, then the segment
        g = start + np.arange(T)
        valid = (g[None] < nv[:, None]) & (g[None] < n)
        tp = np.zeros((rows, T))
        for p in range(1, factor):
            acc = sum(taps[p, t] * tile[:, 32 - t: 32 - t + T] for t in range(kh))
            tp = np.maximum(tp, np.abs(acc))
        live = start < nv                           # else skipped: partials 0
        parts[0, :, seg] = np.where(live, np.where(valid, tp, 0.0).max(-1), 0.0)
        parts[1, :, seg] = np.where(live, np.where(valid, np.abs(tile[:, 32:]), 0.0).max(-1), 0.0)
    sp = parts[1].max(-1)
    return np.maximum(parts[0].max(-1), sp).astype(np.float32), sp.astype(np.float32)


# per-track n_valid over 3 stereo tracks of N = 3 T + 1,280 (a partial last
# segment): ragged, on segment boundaries (the segment that starts at
# n_valid is skipped, and the rows past it too) and under one thread's 32
# samples
K6_NV = {"ragged": lambda n: [n, n - 333, 2 * K6.TILE + 77],
         "boundary": lambda n: [K6.TILE, 2 * K6.TILE, n],
         "short": lambda n: [1, 20, 31]}


@pytest.mark.parametrize("case", sorted(K6_NV))
@pytest.mark.parametrize("rate", [48000, 96000])
def test_kernel_partition_matches_pallas_interpret_and_xla(case, rate):
    n = 3 * K6.TILE + 1280
    x = _inputs(n, (3, 2), len(case) + rate)
    # loud samples on each side of every segment boundary: their FIR
    # outputs need the halo
    for b in range(K6.TILE, n, K6.TILE):
        x[..., b - 3: b + 3] = np.asarray([0.8, -0.9, 0.95, 0.9, -0.85, 0.7], np.float32)
    nv = np.asarray(K6_NV[case](n), np.int32)
    tp, sp = emulate_k6(x.reshape(6, n), np.repeat(nv, 2), rate)
    tpj, spj = true_peak_pallas(jnp.asarray(x), jnp.asarray(nv), rate, interpret=True)
    np.testing.assert_allclose(tp, np.asarray(tpj).reshape(-1), rtol=2e-6, atol=1e-7)
    np.testing.assert_array_equal(sp, np.asarray(spj).reshape(-1))
    tpx, spx = jax_true_peak(jnp.asarray(x), jnp.asarray(nv)[:, None, None], rate)
    np.testing.assert_allclose(tp, np.asarray(tpx).reshape(-1), rtol=2e-6, atol=1e-7)
    np.testing.assert_array_equal(sp, np.asarray(spx).reshape(-1))
    # a halo of 32 samples is the FIR's whole context
    assert iir_tile.fir_taps(JC.true_peak_factor(rate)).size // JC.true_peak_factor(rate) <= 33


def test_taps_meet_the_wrappers_check(monkeypatch):
    """The 4x and 2x taps the kernel reads: phase 0 an impulse, the other
    phases' last tap zero (36 and 24 FMAs a sample); taps that break either
    are refused. The kernel reads n_valid per track, one per `per` rows."""
    for factor, fmas in ((4, 36), (2, 24)):
        taps = iir_tile.fir_taps(factor).reshape(factor, -1)
        assert taps[0].max() == 1.0 and np.sort(np.abs(taps[0]))[-2] < 1e-12
        assert not taps[1:, -1].any()
        assert (factor - 1) * (taps.shape[1] - 1) == fmas
    good = iir_tile._polyphase_taps(4)
    bad0, bad1 = good.copy(), good.copy()
    bad0[0, 0] = 1e-3
    bad1[2, -1] = 1e-3
    for bad in (bad0, bad1):
        monkeypatch.setattr(iir_tile, "_polyphase_taps", lambda f, b=bad: b)
        with pytest.raises(ValueError):
            iir_tile.fir_taps.__wrapped__(4)
    x = torch.zeros((3, 2, 256))
    x2, nv, per, batch = K6._rows(x, torch.tensor([256, 128, 64]))
    assert x2.shape == (6, 256) and batch == (3, 2)
    assert per == 2 and nv.dtype == torch.int64 and nv.tolist() == [256, 128, 64]
    _, nv, per, _ = K6._rows(x, 200)
    assert per == 6 and nv.tolist() == [200]
    with pytest.raises(ValueError):
        K6._rows(x, torch.tensor([1, 2, 3, 4]))
