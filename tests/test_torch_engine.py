"""The port's whole-file engine against the JAX one.

The port's 4D frames path (K1's plain version on the CPU) and its 3D path
are held to the JAX engine's 4D path with the Pallas kernels in interpret
mode and to its 3D XLA path, at the pins of
tests/test_pallas_iir_chunked.py: integrated, LRA and valid short-term
within 2e-3 LU; true peak rtol 2e-6; n_momentary and n_shortterm exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import soundscope_tpu.ops.pallas_iir_chunked as JPC
from soundscope_tpu.core.config import MeterConfig as JaxMeterConfig
from soundscope_tpu.models.engine import analyze_batch_native as jax_analyze
from soundscope_tpu.utils.synth import sine, stereo
from soundscope_tpu_torch.core.config import MeterConfig
from soundscope_tpu_torch.models.engine import (
    AnalysisResult,
    analyze_array,
    analyze_batch_native,
    analyze_fn,
    pad_bucket,
)
from soundscope_tpu_torch.ops import iir_chunked as K1
from soundscope_tpu_torch.ops import loudness as TL
from soundscope_tpu_torch.utils.params import meter_config_from_jax

B, CH, NC = 2, 2, 2048
N = NC * 128


def _inputs(rate):
    rng = np.random.default_rng(rate)
    x = (rng.standard_normal((B, CH, N)) * 0.1).astype(np.float32)
    # a louder second half keeps the gates and the LRA percentiles busy
    x[:, :, N // 2:] *= 3.0
    nv = np.asarray([N, N - 777], np.int32)
    return x, nv


def _assert_close(port: AnalysisResult, ref):
    np.testing.assert_allclose(port.integrated_lufs.numpy(),
                               np.asarray(ref.integrated_lufs), rtol=0, atol=2e-3)
    np.testing.assert_allclose(port.lra.numpy(), np.asarray(ref.lra),
                               rtol=0, atol=2e-3)
    np.testing.assert_array_equal(port.n_momentary.numpy(),
                                  np.asarray(ref.n_momentary))
    np.testing.assert_array_equal(port.n_shortterm.numpy(),
                                  np.asarray(ref.n_shortterm))
    st_ref = np.asarray(ref.shortterm)
    m = st_ref > -1e9
    assert m.any()
    np.testing.assert_array_equal(port.shortterm.numpy() > -1e9, m)
    np.testing.assert_allclose(port.shortterm.numpy()[m], st_ref[m],
                               rtol=0, atol=2e-3)
    mo_ref = np.asarray(ref.momentary)
    mm = mo_ref > -1e9
    np.testing.assert_allclose(port.momentary.numpy()[mm], mo_ref[mm],
                               rtol=0, atol=2e-3)
    np.testing.assert_allclose(port.true_peak.numpy(),
                               np.asarray(ref.true_peak), rtol=2e-6, atol=1e-7)
    np.testing.assert_array_equal(port.sample_peak.numpy(),
                                  np.asarray(ref.sample_peak))


@pytest.mark.parametrize("rate", [48000, 44100])
def test_engine_4d_matches_jax_pallas_interpret(rate, monkeypatch):
    orig = JPC.kweight_energy_tp_chunked
    monkeypatch.setattr(JPC, "kweight_energy_tp_chunked",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    x, nv = _inputs(rate)
    jcfg = JaxMeterConfig(channels=CH, rate=rate, max_blocks=0,
                          iir_impl="pallas")
    ref = jax_analyze(jcfg)(jnp.asarray(x.reshape(B, CH, NC, 128)),
                            jnp.asarray(nv))
    cfg = meter_config_from_jax(jcfg)
    port = analyze_batch_native(cfg, torch.from_numpy(x.reshape(B, CH, NC, 128)),
                                torch.from_numpy(nv))
    _assert_close(port, ref)


@pytest.mark.parametrize("rate", [48000, 44100])
def test_engine_3d_and_rows_match_jax_xla(rate):
    x, nv = _inputs(rate)
    jcfg = JaxMeterConfig(channels=CH, rate=rate, max_blocks=0, iir_impl="xla")
    ref = jax.jit(jax_analyze(jcfg))(jnp.asarray(x), jnp.asarray(nv))
    cfg = MeterConfig(channels=CH, rate=rate, max_blocks=0)
    port3 = analyze_batch_native(cfg, torch.from_numpy(x), torch.from_numpy(nv))
    _assert_close(port3, ref)
    # the rows layout is a view of the same memory and gives the same result
    port2 = analyze_batch_native(cfg, torch.from_numpy(x.reshape(B * CH, N)),
                                 torch.from_numpy(nv))
    for f in ("integrated_lufs", "lra", "shortterm", "true_peak"):
        assert torch.equal(getattr(port2, f), getattr(port3, f))
    # and the port's 4D path agrees with its own 3D path
    port4 = analyze_batch_native(cfg, torch.from_numpy(x.reshape(B, CH, NC, 128)),
                                 torch.from_numpy(nv))
    _assert_close(port4, _as_numpy(port3))


def _as_numpy(r: AnalysisResult):
    return type("R", (), {k: v.numpy() for k, v in vars(r).items()})()


def test_ebu3341_case1():
    """EBU Tech 3341 case 1: 997 Hz at -23 dBFS stereo reads -23.0 LUFS
    (integrated and short-term) with true peak 0.0708, through the frames
    path as the CLI and analyze_array drive it."""
    x = stereo(sine(997.0, 20.0, 48000, -23.0))
    res = analyze_array(x, MeterConfig(channels=2, rate=48000))
    assert abs(float(res.integrated_lufs) + 23.0) < 0.1
    st = res.shortterm[: int(res.n_shortterm)]
    assert st.numel() > 0 and float((st + 23.0).abs().max()) < 0.1
    assert np.allclose(res.true_peak.numpy(), 10 ** (-23 / 20), atol=1e-3)
    assert res.true_peak.shape == (2,)


def test_analyze_fn_and_short_inputs():
    cfg = MeterConfig(channels=2, rate=48000)
    x = stereo(sine(997.0, 0.2, 48000, -23.0))      # shorter than 400 ms
    res = analyze_array(x, cfg)
    assert float(res.integrated_lufs) == float("-inf")
    assert int(res.n_momentary) == 0 and int(res.n_shortterm) == 0
    assert float(res.lra) == 0.0
    # single track on the 3D layout: same peaks as the frames path
    n = pad_bucket(x.shape[1])
    xp = np.zeros((2, n), np.float32)
    xp[:, : x.shape[1]] = x
    r3 = analyze_fn(cfg, torch.from_numpy(xp), x.shape[1])
    np.testing.assert_allclose(r3.true_peak.numpy(), res.true_peak.numpy(),
                               rtol=2e-6, atol=1e-7)
    assert pad_bucket(1) == 1 << 15 and pad_bucket((1 << 15) + 1) == 1 << 16


def test_frames_path_rejects_tiny_subblocks():
    cfg = MeterConfig(channels=1, rate=1000)        # h = 100 < 128
    with pytest.raises(ValueError):
        analyze_batch_native(cfg, torch.zeros(1, 1, 256, 128), torch.tensor([256 * 128]))
    assert K1.step_length(256 * 128, cfg.subblock * 2) == 128


def test_gating_functions_match_jax(rng):
    from soundscope_tpu.ops import loudness as JL

    e = (10 ** rng.uniform(-4, -1, (3, 200))).astype(np.float32)
    mask = rng.uniform(size=(3, 200)) > 0.2
    te, tm = torch.from_numpy(e), torch.from_numpy(mask)
    np.testing.assert_allclose(TL.gated_loudness(te, tm).numpy(),
                               np.asarray(JL.gated_loudness(jnp.asarray(e), jnp.asarray(mask))),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(TL.loudness_range(te, tm).numpy(),
                               np.asarray(JL.loudness_range(jnp.asarray(e), jnp.asarray(mask))),
                               rtol=0, atol=1e-4)
    sums = torch.from_numpy(e)
    for fn in ("gating_energies", "shortterm_energies", "lra_energies"):
        np.testing.assert_allclose(getattr(TL, fn)(sums, 4800).numpy(),
                                   np.asarray(getattr(JL, fn)(jnp.asarray(e), 4800)),
                                   rtol=1e-4, atol=0)
    assert float(TL.loudness_from_energy(torch.tensor(0.0))) == float("-inf")
