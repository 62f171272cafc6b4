"""The port's streaming meter against the JAX meter on the same pushes.

Every state field is compared after the stream: counters and histograms
exactly, float fields at rtol 1e-4; the queries at the pins of
tests/test_meter_stream.py (1e-3 LU, true peak 1e-6). The JAX filter runs
the blocked Toeplitz matmul with an associative scan, the port's plain
version the same matrices with a doubling scan (K7 on the card).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soundscope_tpu.core.config import MeterConfig as JaxMeterConfig
from soundscope_tpu.core.state import init_meter_state as jax_init
from soundscope_tpu.models import meter as JM
from soundscope_tpu.utils.synth import segments, sine, stereo
from soundscope_tpu_torch.core.config import MeterConfig
from soundscope_tpu_torch.core.state import MeterState, init_meter_state
from soundscope_tpu_torch.models import meter as TM
from soundscope_tpu_torch.utils.params import meter_state_from_numpy

PUSHES_A = [16384, 1000, 333, 4800]
PUSHES_B = [7, 16384, 101, 4800, 12345]
QUERIES = ("integrated_lufs", "shortterm_lufs", "momentary_lufs", "loudness_range_lu")


def _signal(ch, rate, seconds, seed):
    """Noise that steps up by 12 dB halfway (keeps the gates and LRA busy)."""
    x = np.random.default_rng(seed).standard_normal((ch, int(rate * seconds)))
    x = (x * 0.05).astype(np.float32)
    x[:, x.shape[1] // 2:] *= 4.0
    return x


def _chunks(n, sizes):
    pos = i = 0
    while pos < n:
        size = min(sizes[i % len(sizes)], n - pos)
        yield pos, size
        pos += size
        i += 1


_JAX_STEPS = {}


def _jax_push(cfg, state, x, sizes):
    for pos, size in _chunks(x.shape[1], sizes):
        key = (cfg, size)
        if key not in _JAX_STEPS:
            _JAX_STEPS[key] = jax.jit(JM.meter_step(cfg))
        state = _JAX_STEPS[key](state, jnp.asarray(x[:, pos:pos + size]))
    return state


def _torch_push(cfg, state, x, sizes):
    step = TM.meter_step(cfg)
    for pos, size in _chunks(x.shape[1], sizes):
        state = step(state, torch.from_numpy(x[:, pos:pos + size]))
    return state


def _jax_fields(state) -> dict:
    return {f.name: np.array(getattr(state, f.name)) for f in dataclasses.fields(state)}


def _same_state(js, ts):
    assert [f.name for f in dataclasses.fields(js)] == \
        [f.name for f in dataclasses.fields(MeterState)]
    for name, want in _jax_fields(js).items():
        got = getattr(ts, name).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, name
        if want.dtype == np.int32:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       atol=1e-6 * max(float(np.abs(want).max()), 1e-30),
                                       err_msg=name)


def _same_queries(jcfg, js, tcfg, ts):
    for q in QUERIES:
        want = float(getattr(JM, q)(jcfg, js))
        got = float(getattr(TM, q)(tcfg, ts))
        assert got == want or abs(got - want) < 1e-3, (q, got, want)
    np.testing.assert_allclose(TM.true_peak_linear(ts).numpy(),
                               np.asarray(JM.true_peak_linear(js)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("ch,rate,max_blocks,sizes,seconds", [
    (2, 48000, 1000, PUSHES_A, 7),
    (2, 48000, 1000, PUSHES_B, 7),
    (2, 48000, 0, PUSHES_A, 7),
    (2, 48000, 0, PUSHES_B, 7),
    (1, 44100, 1000, PUSHES_A, 6),
    (2, 44100, 0, PUSHES_B, 6),
    (6, 48000, 1000, PUSHES_B, 5),
    (2, 192000, 1000, PUSHES_A, 4),
    (6, 192000, 0, PUSHES_B, 4),
])
def test_meter_matches_jax(ch, rate, max_blocks, sizes, seconds):
    x = _signal(ch, rate, seconds, seed=ch * 1000 + rate // 100 + max_blocks)
    jcfg = JaxMeterConfig(channels=ch, rate=rate, max_blocks=max_blocks)
    tcfg = MeterConfig(channels=ch, rate=rate, max_blocks=max_blocks)
    js = _jax_push(jcfg, jax_init(jcfg), x, sizes)
    ts = _torch_push(tcfg, init_meter_state(tcfg, "cpu"), x, sizes)
    assert int(ts.frames_total) == x.shape[1]
    _same_state(js, ts)
    _same_queries(jcfg, js, tcfg, ts)


def test_exact_history_overflows_into_histogram():
    """A small max_blocks: both exact histories fill, the counts run on,
    and the queries switch to the histograms as JAX's do."""
    x = _signal(2, 48000, 20, seed=11)
    jcfg = JaxMeterConfig(channels=2, rate=48000, max_blocks=40)
    tcfg = MeterConfig(channels=2, rate=48000, max_blocks=40)
    js = _jax_push(jcfg, jax_init(jcfg), x, [48000])
    ts = _torch_push(tcfg, init_meter_state(tcfg, "cpu"), x, [48000])
    assert int(ts.block_count) > tcfg.max_blocks
    assert int(ts.lra_count) > tcfg.max_lra_blocks
    _same_state(js, ts)
    _same_queries(jcfg, js, tcfg, ts)


def test_pushes_longer_than_the_rings():
    """One push longer than the 3 s z ring and than the 30-entry sub-block
    ring, then short ones: only the newest values are kept, as in JAX."""
    x = _signal(2, 48000, 8, seed=12)
    jcfg = JaxMeterConfig(channels=2, rate=48000, max_blocks=100)
    tcfg = MeterConfig(channels=2, rate=48000, max_blocks=100)
    sizes = [4 * 48000 + 333, 1000]
    js = _jax_push(jcfg, jax_init(jcfg), x, sizes)
    ts = _torch_push(tcfg, init_meter_state(tcfg, "cpu"), x, sizes)
    _same_state(js, ts)
    _same_queries(jcfg, js, tcfg, ts)


def test_stream_begun_in_jax_finishes_in_port():
    x = _signal(2, 48000, 8, seed=13)
    half = 48000 * 3 + 777
    jcfg = JaxMeterConfig(channels=2, rate=48000, max_blocks=1000)
    tcfg = MeterConfig(channels=2, rate=48000, max_blocks=1000)
    j_half = _jax_push(jcfg, jax_init(jcfg), x[:, :half], PUSHES_A)
    j_all = _jax_push(jcfg, j_half, x[:, half:], PUSHES_B)
    carried = meter_state_from_numpy(_jax_fields(j_half), "cpu")
    t_all = _torch_push(tcfg, carried, x[:, half:], PUSHES_B)
    _same_state(j_all, t_all)
    _same_queries(jcfg, j_all, tcfg, t_all)


def test_chunk_boundaries_do_not_matter():
    x = _signal(2, 48000, 3, seed=14)
    cfg = MeterConfig(channels=2, rate=48000, max_blocks=1000)
    s1 = _torch_push(cfg, init_meter_state(cfg, "cpu"), x, [48000 * 3])
    s2 = _torch_push(cfg, init_meter_state(cfg, "cpu"), x, PUSHES_B)
    for q in ("integrated_lufs", "shortterm_lufs", "momentary_lufs"):
        assert abs(float(getattr(TM, q)(cfg, s1)) - float(getattr(TM, q)(cfg, s2))) < 1e-3
    np.testing.assert_allclose(s1.true_peak.numpy(), s2.true_peak.numpy(), atol=1e-6)
    for f in ("subblocks_done", "block_count", "lra_count", "block_hist", "lra_hist"):
        np.testing.assert_array_equal(getattr(s1, f).numpy(), getattr(s2, f).numpy())


def test_window_ends_at_last_sample_and_zero_state():
    cfg = MeterConfig(channels=1, rate=48000, max_blocks=100)
    s = init_meter_state(cfg, "cpu")
    assert float(TM.integrated_lufs(cfg, s)) == -np.inf
    assert float(TM.shortterm_lufs(cfg, s)) == -np.inf
    assert float(TM.loudness_range_lu(cfg, s)) == 0.0
    assert float(TM.true_peak_linear(s).max()) == 0.0
    loud = stereo(segments([sine(997.0, 3.5, 48000, -10.0)]))[:1]
    s = _torch_push(cfg, s, loud, [1111])
    m1 = float(TM.momentary_lufs(cfg, s))
    s = TM.meter_step(cfg)(s, torch.zeros((1, 48000 // 5)))
    assert 2.0 < m1 - float(TM.momentary_lufs(cfg, s)) < 4.0


def test_frames_total_wraps_as_int32():
    cfg = MeterConfig(channels=1, rate=48000, max_blocks=0)
    s = init_meter_state(cfg, "cpu")
    s.frames_total = torch.tensor(2**31 - 100, dtype=torch.int32)
    s = TM.meter_step(cfg)(s, torch.zeros((1, 300)))
    assert s.frames_total.dtype == torch.int32
    assert int(s.frames_total) == -(2**31) + 200


def test_histogram_and_peak_ops_match_jax():
    """The meter's building blocks on their own: histogram bins (exactly,
    including energies below the gate and zero), the histogram queries,
    and the streaming true peak with a carried tail at each factor."""
    import soundscope_tpu.ops.loudness as JL
    import soundscope_tpu.ops.truepeak as JT
    from soundscope_tpu_torch.ops import loudness as TL
    from soundscope_tpu_torch.ops import truepeak as TT

    rng = np.random.default_rng(31)
    e = (10.0 ** rng.uniform(-9, 1, 4000)).astype(np.float32)
    e[:3] = [0.0, 1e-30, 10.0 ** ((-70.0 + 0.691) / 10.0)]
    np.testing.assert_array_equal(TL.hist_bin_index(torch.from_numpy(e)).numpy(),
                                  np.asarray(JL.hist_bin_index(jnp.asarray(e))))
    np.testing.assert_array_equal(TL._hist_bin_energies(), JL._hist_bin_energies())
    hist = rng.integers(0, 50, (3, 1000)).astype(np.int32)
    hist[1, :600] = 0
    hist[2] = 0
    for t_fn, j_fn in ((TL.gated_loudness_hist, JL.gated_loudness_hist),
                       (TL.loudness_range_hist, JL.loudness_range_hist)):
        np.testing.assert_allclose(t_fn(torch.from_numpy(hist)).numpy(),
                                   np.asarray(j_fn(jnp.asarray(hist))), rtol=0, atol=1e-4)
    x = (rng.standard_normal((2, 3000)) * 0.3).astype(np.float32)
    tail = (rng.standard_normal((2, 48)) * 0.3).astype(np.float32)
    for factor in (1, 2, 4):
        pt, tt = TT.oversampled_abs_peak(torch.from_numpy(x), torch.from_numpy(tail), factor)
        pj, tj = JT.oversampled_abs_peak(jnp.asarray(x), jnp.asarray(tail), factor)
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=2e-6, atol=1e-7)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    for rate in (44100, 96000, 192000):
        np.testing.assert_allclose(TT.true_peak_kernel(torch.from_numpy(x), rate).numpy(),
                                   np.asarray(JT.true_peak_kernel(jnp.asarray(x), rate)),
                                   rtol=2e-6, atol=1e-7)
