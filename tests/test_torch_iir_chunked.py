"""K1 of the PyTorch port (ops/iir_chunked.py) against the JAX package.

On the CPU the port's wrapper runs K1's plain version; it is held to the
JAX XLA chain (block_iir -> mask -> weighted_square -> exact sub-block
sums, and true_peak_masked) and to the JAX Pallas kernel in interpret
mode, at the tolerances of tests/test_pallas_iir_chunked.py: sub-block
sums rtol 3e-4 / atol 2e-5 (float32 filters in different orders), true
peak rtol 2e-6 / atol 1e-7 (float32 FIR sums in different orders),
sample peak exact. The same JAX filter feeds both packages.
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
from soundscope_tpu.ops.pallas_iir_chunked import (
    chunked_plan,
)
from soundscope_tpu.ops.pallas_iir_chunked import (
    kweight_energy_tp_chunked as jax_k1,
)
from soundscope_tpu.ops.pallas_iir_chunked import (
    subblock_sums_from_steps as jax_subblock_sums,
)
from soundscope_tpu.ops.truepeak import true_peak_masked as jax_true_peak
from soundscope_tpu_torch.ops import iir_chunked as K1
from soundscope_tpu_torch.utils.params import block_filter_from_numpy
from soundscope_tpu_torch.utils.metrics import launches

CASES = [(48000, 3, "ragged"), (44100, 3, "ragged"), (96000, 2, "full")]
NC = 512  # n = 65536 samples


def _inputs(rate, b, raggedness, seed=7):
    rng = np.random.default_rng(seed + rate + b)
    n = NC * 128
    x = (rng.standard_normal((b, 2, n)) * 0.1).astype(np.float32)
    if raggedness == "ragged":
        nv = np.asarray([n, n - 700, n // 2][:b], np.int32)
    else:
        nv = np.full((b,), n, np.int32)
    jf = jax_block_filter(kweight_cascade_ss(rate), 128)
    tf = block_filter_from_numpy(np.asarray(jf.Tt), np.asarray(jf.Wt),
                                 np.asarray(jf.Ot), np.asarray(jf.A_pows), 128,
                                 device="cpu")
    w = tuple(float(v) for v in channel_weights(2))
    return x, nv, jf, tf, w


def _port(x, nv, tf, w, rate):
    b, ch, n = x.shape
    h = rate // 10
    x4 = torch.from_numpy(x.reshape(b, ch, n // 128, 128))
    steps, tp, sp = K1.kweight_energy_tp_chunked(
        tf, x4, torch.from_numpy(nv), w, rate, h)
    sums = K1.subblock_sums_from_steps(steps, h, K1.step_length(n, h), n)
    return (sums.reshape(b, ch, -1).sum(1).numpy(),
            tp.reshape(b, ch).numpy(), sp.reshape(b, ch).numpy())


@pytest.mark.parametrize("rate,b,raggedness", CASES)
def test_plain_k1_matches_xla_chain(rate, b, raggedness):
    x, nv, jf, tf, w = _inputs(rate, b, raggedness)
    n = x.shape[-1]
    h = rate // 10
    got, tp, sp = _port(x, nv, tf, w, rate)

    y, _ = jax.jit(jax_block_iir)(jf, jnp.asarray(x), jnp.zeros((b, 2, 4)))
    pos = jnp.arange(n)
    nvj = jnp.asarray(nv)
    y = jnp.where(pos[None, None, :] < nvj[:, None, None], y, 0.0)
    z = np.asarray(weighted_square(y, jnp.asarray(w)))
    nb = n // h
    want = z[:, : nb * h].reshape(b, nb, h).sum(-1)
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=2e-5)

    tp_ref, sp_ref = jax_true_peak(jnp.asarray(x), nvj[:, None, None], rate)
    np.testing.assert_allclose(tp, np.asarray(tp_ref), rtol=2e-6, atol=1e-7)
    np.testing.assert_allclose(sp, np.asarray(sp_ref), rtol=0, atol=0)


@pytest.mark.parametrize("rate,b,raggedness", CASES)
def test_plain_k1_matches_pallas_interpret(rate, b, raggedness):
    x, nv, jf, tf, w = _inputs(rate, b, raggedness, seed=11)
    n = x.shape[-1]
    h = rate // 10
    got, tp, sp = _port(x, nv, tf, w, rate)

    S = chunked_plan(n, NC, b * 2, h, JC.true_peak_factor(rate))
    steps, tpj, spj = jax_k1(
        jf.Tt, jf.Wt, jf.Ot, jf.A_pows, jnp.asarray(x.reshape(b, 2, NC, 128)),
        jnp.asarray(nv), w, rate, h, interpret=True)
    want = np.asarray(jax_subblock_sums(steps, h, S * 128, n)).reshape(
        b, 2, -1).sum(1)
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=2e-5)
    np.testing.assert_allclose(tp, np.asarray(tpj).reshape(b, 2),
                               rtol=2e-6, atol=1e-7)
    np.testing.assert_allclose(sp, np.asarray(spj).reshape(b, 2),
                               rtol=0, atol=0)


@pytest.mark.parametrize("h", [4096, 4410, 4800, 9600])
def test_subblock_gather_exact(rng, h):
    """The per-step (pre-boundary, from the boundary) decomposition
    reconstructs exact h-sample sub-block sums for any h >= span, h | n
    included; the port's glue agrees with the JAX glue on its (total,
    pre-boundary) decomposition of the same steps."""
    span = 4096
    n = span * 24
    z = rng.standard_normal((3, n)).astype(np.float64)
    nsteps = n // span
    zs = z.reshape(3, nsteps, span)
    full = zs.sum(-1)
    left = np.zeros_like(full)
    right = np.zeros_like(full)
    for s in range(nsteps):
        start = s * span
        bound = min(-(-start // h) * h, start + span)
        left[:, s] = zs[:, s, : bound - start].sum(-1)
        right[:, s] = zs[:, s, bound - start:].sum(-1)
    step_sums = np.stack([left, right], axis=-1).astype(np.float32)

    got = K1.subblock_sums_from_steps(torch.from_numpy(step_sums), h, span,
                                      n).numpy()
    nb = n // h
    want = z[:, : nb * h].reshape(3, nb, h).sum(-1)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-4)
    jax_steps = np.stack([full, left], axis=-1).astype(np.float32)
    jax_got = np.asarray(jax_subblock_sums(jnp.asarray(jax_steps), h, span, n))
    np.testing.assert_allclose(got, jax_got, rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize("n,h,want", [
    (65536, 4800, 4096), (65536, 4410, 4096), (65536, 9600, 8192),
    (2879488, 4800, 4096), (128 * 703, 4800, 128), (1 << 26, 4800, 4096),
    (65536, 800, 512), (65536, 128, 128),
])
def test_step_length(n, h, want):
    L = K1.step_length(n, h)
    assert L == want and n % L == 0 and L <= h


def test_step_length_and_inputs_rejected():
    with pytest.raises(ValueError):
        K1.step_length(65536, 100)          # sub-block shorter than a chunk
    with pytest.raises(ValueError):
        K1.step_length(1000, 4800)          # not a frames view
    x, nv, _, tf, w = _inputs(48000, 1, "full")
    x4 = torch.from_numpy(x.reshape(1, 2, NC, 128))
    with pytest.raises(TypeError):
        K1.kweight_energy_tp_chunked(tf, x4.double(), torch.from_numpy(nv),
                                     w, 48000, 4800)
    with pytest.raises(ValueError):
        K1.kweight_energy_tp_chunked(tf, x4, torch.from_numpy(nv), w[:1],
                                     48000, 4800)
    with pytest.raises(ValueError):
        K1.kweight_energy_tp_chunked(tf, x4.to("meta"), torch.from_numpy(nv),
                                     w, 48000, 4800)


def test_cpu_run_launches_nothing():
    """The launch counter counts kernel launches only: a CPU tensor takes
    the plain version and leaves it unchanged."""
    x, nv, _, tf, w = _inputs(48000, 1, "full")
    before = launches()["K1"]
    _port(x, nv, tf, w, 48000)
    assert launches()["K1"] == before


@pytest.mark.parametrize("rate", [48000, 44100])
def test_plain_k1_steps_match_pallas_interpret(rate):
    """Step by step: the port's left + right and left against the JAX
    kernel's (total, left) at the same span, at the sub-block tolerances."""
    x, nv, jf, tf, w = _inputs(rate, 3, "ragged", seed=13)
    b, ch, n = x.shape
    h = rate // 10
    S = chunked_plan(n, NC, b * ch, h, JC.true_peak_factor(rate))
    assert S * 128 == K1.step_length(n, h)
    steps, _, _ = K1.kweight_energy_tp_chunked(
        tf, torch.from_numpy(x.reshape(b, ch, NC, 128)), torch.from_numpy(nv), w, rate, h)
    steps = steps.numpy()
    want, _, _ = jax_k1(jf.Tt, jf.Wt, jf.Ot, jf.A_pows, jnp.asarray(x.reshape(b, ch, NC, 128)),
                        jnp.asarray(nv), w, rate, h, interpret=True)
    want = np.asarray(want).reshape(steps.shape)
    np.testing.assert_allclose(steps[..., 0] + steps[..., 1], want[..., 0], rtol=3e-4, atol=2e-5)
    np.testing.assert_allclose(steps[..., 0], want[..., 1], rtol=3e-4, atol=2e-5)


def _floored_gap(got, want):
    return float(np.max(np.abs(np.maximum(got, -70.0) - np.maximum(want, -70.0))))


def test_frames_route_keeps_a_quiet_part_beside_a_loud_one():
    """A loud section (-10 dBFS) that ends 8 samples before a 100 ms
    boundary inside a step, then programme near -70 LUFS: the step's part
    from the boundary on holds the filter's decay and quiet samples alone.
    Taken as the step's float32 total less its left part it lost 3.3e-3 LU
    of momentary loudness; summed on its own, the frames route (K1's plain
    version) comes within the rows route's (K3's) error of the float64
    chain."""
    from soundscope_tpu_torch.core.config import MeterConfig
    from soundscope_tpu_torch.models.engine import analyze_batch_native
    from soundscope_tpu_torch.tools import reference64

    rate, n = 48000, 1 << 19
    end = 23 * 4800 - 8                     # the boundary lies in step 26 of 4,096
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, n))
    x[1] = 0.8 * x[0] + 0.6 * x[1]
    gain = np.full(n, 10 ** (-74 / 20))
    gain[:end] = 10 ** (-10 / 20)
    x = (x * gain).astype(np.float32)
    ref = reference64.analyze_reference(x.astype(np.float64), rate)
    cfg = MeterConfig(channels=2, rate=rate, max_blocks=0)
    nv = torch.tensor([n])

    def timeline_gap(res):
        m, s = int(res.n_momentary[0]), int(res.n_shortterm[0])
        return max(_floored_gap(res.momentary[0, :m].numpy(), ref["momentary"]),
                   _floored_gap(res.shortterm[0, :s].numpy(), ref["shortterm"]))

    frames = analyze_batch_native(cfg, torch.from_numpy(x).reshape(1, 2, n // 128, 128), nv)
    rows = analyze_batch_native(cfg, torch.from_numpy(x)[None], nv)   # the fused route, K3
    assert timeline_gap(frames) <= 1.5 * timeline_gap(rows)
    assert timeline_gap(rows) < 2e-5
