"""Host design constants of the PyTorch port against the JAX package:
every float64 builder is bit-identical, and the parameter converter
round-trips the JAX filter."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import soundscope_tpu.core.constants as JC
import soundscope_tpu.ops.biquad as jbq
import soundscope_tpu.ops.kweight as jkw
import soundscope_tpu.ops.spectrum as jsp
import soundscope_tpu.ops.stft as jst
import soundscope_tpu.ops.truepeak as jtp
import soundscope_tpu_torch.core.constants as TC
import soundscope_tpu_torch.ops.biquad as tbq
import soundscope_tpu_torch.ops.kweight as tkw
import soundscope_tpu_torch.ops.spectrum as tsp
import soundscope_tpu_torch.ops.stft as tst
import soundscope_tpu_torch.ops.truepeak as ttp
from soundscope_tpu.core.config import MeterConfig as JaxMeterConfig
from soundscope_tpu_torch.core.config import MeterConfig
from soundscope_tpu_torch.utils.params import (
    block_filter_from_numpy,
    meter_config_from_jax,
)

RATES = [8000, 44100, 48000, 96000, 192000]
REPO = Path(__file__).resolve().parents[1]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_constants_module_is_a_copy():
    names = [n for n in dir(JC) if not n.startswith("_")]
    assert names == [n for n in dir(TC) if not n.startswith("_")]
    for n in names:
        v = getattr(JC, n)
        if callable(v):
            for rate in RATES:
                assert v(rate) == getattr(TC, n)(rate), n
        else:
            assert v == getattr(TC, n), n


@pytest.mark.parametrize("rate", RATES)
def test_kweight_design_bit_identical(rate):
    for a, b in zip(jkw.design_kweight(rate), tkw.design_kweight(rate)):
        _same(a, b)
    for a, b in zip(jkw.kweight_cascade_ss(rate), tkw.kweight_cascade_ss(rate)):
        _same(a, b)
    for ch in (1, 2, 4, 5, 6, 8):
        _same(jkw.channel_weights(ch), tkw.channel_weights(ch))


@pytest.mark.parametrize("rate", RATES)
def test_modal_form_and_block_filter_bit_identical(rate):
    ss = jkw.kweight_cascade_ss(rate)
    for a, b in zip(jbq.modal_form(ss), tbq.modal_form(ss)):
        _same(a, b)
    A, Bv, Cv, D = jbq.modal_form(ss)
    key = (tuple(map(tuple, A)), tuple(Bv), tuple(Cv), float(D))
    for a, b in zip(jbq._build_block_filter_np(key, 128),
                    tbq._build_block_filter_np(key, 128)):
        _same(a, b)
    jf = jbq.make_block_filter(ss, 128)
    tf = tbq.make_block_filter(ss, 128)
    for name in ("Tt", "Wt", "Ot", "A_pows"):
        _same(np.asarray(getattr(jf, name)), getattr(tf, name).numpy())


@pytest.mark.parametrize("factor", [2, 4])
def test_polyphase_taps_bit_identical(factor):
    _same(jtp._polyphase_taps(factor), ttp._polyphase_taps(factor))


@pytest.mark.parametrize("rate", [44100, 48000, 96000])
def test_display_plans_bit_identical(rate):
    _same(jsp._hann_np(16384), tsp._hann_np(16384))
    for a, b in zip(jsp._bin_plan(16384, rate, 20.0, 20000.0),
                    tsp._bin_plan(16384, rate, 20.0, 20000.0)):
        _same(a, b)
    ja = jst._pooled_gain_plan(16384, rate, 128)
    ta = tst._pooled_gain_plan(16384, rate, 128)
    _same(ja[0], ta[0])
    assert ja[1] == ta[1]
    _same(ja[2], ta[2])


@pytest.mark.parametrize("rate", [44100, 48000])
def test_block_filter_from_numpy_round_trip(rate):
    """The converter keeps the JAX filter's tensors exactly and reads back
    the realisation K1 consumes: its A^L agrees with the blocked A^128."""
    jf = jbq.make_block_filter(jkw.kweight_cascade_ss(rate), 128)
    tf = block_filter_from_numpy(np.asarray(jf.Tt), np.asarray(jf.Wt),
                                 np.asarray(jf.Ot), np.asarray(jf.A_pows), 128,
                                 device="cpu")
    for name in ("Tt", "Wt", "Ot", "A_pows"):
        _same(np.asarray(getattr(jf, name)), getattr(tf, name).numpy())
    own = tbq.make_block_filter(jkw.kweight_cascade_ss(rate), 128)
    np.testing.assert_allclose(tf.A, own.A, rtol=0, atol=1e-7)
    np.testing.assert_allclose(tf.Bv, own.Bv, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(tf.Cv, own.Cv, rtol=1e-6, atol=1e-9)
    assert abs(tf.D - own.D) < 1e-6
    np.testing.assert_array_equal(tf.power(128), np.asarray(jf.A_pows[128]))
    np.testing.assert_allclose(tf.power(4096), own.power(4096), rtol=0,
                               atol=1e-6)
    # the converted filter runs the port's blocked filter like its own
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((2, 1000)).astype(np.float32))
    y1, _ = tbq.block_iir(tf, x, torch.zeros(2, 4))
    y2, _ = tbq.block_iir(own, x, torch.zeros(2, 4))
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=0, atol=2e-5)


def test_meter_config_from_jax():
    jc = JaxMeterConfig(channels=6, rate=44100, max_blocks=0, iir_impl="pallas")
    tc = meter_config_from_jax(jc)
    assert tc == MeterConfig(channels=6, rate=44100, max_blocks=0, block=128)
    assert (tc.subblock, tc.true_peak_factor) == (jc.subblock, jc.true_peak_factor)
    with pytest.raises(ValueError):
        MeterConfig(rate=5)
    with pytest.raises(ValueError):
        MeterConfig(channels=0)


def test_block_iir_matches_jax(rng):
    """The port's blocked filter (doubling scan, trailing partial block)
    against the JAX one on the same filter and input."""
    jf = jbq.make_block_filter(jkw.kweight_cascade_ss(48000), 128)
    tf = tbq.make_block_filter(jkw.kweight_cascade_ss(48000), 128)
    x = (rng.standard_normal((3, 128 * 37 + 51)) * 0.3).astype(np.float32)
    s0 = (rng.standard_normal((3, 4)) * 0.1).astype(np.float32)
    yj, sj = jbq.block_iir(jf, jnp.asarray(x), jnp.asarray(s0))
    yt, st = tbq.block_iir(tf, torch.from_numpy(x), torch.from_numpy(s0))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=2e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=2e-5)
    # and the per-sample float64 reference of the same system
    y64, _ = jbq.iir_reference(tbq.modal_form(jkw.kweight_cascade_ss(48000)),
                               x[1], s0[1])
    np.testing.assert_allclose(yt.numpy()[1], y64, rtol=0, atol=2e-5)


def test_package_imports_without_jax():
    """Every module of the port imports in a fresh interpreter without
    loading jax, flax or soundscope_tpu."""
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "soundscope_tpu_torch").rglob("*.py")
        if p.name != "__main__.py")
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'soundscope_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
