"""Checkpoints across the two packages: a meter or live state saved by
either package loads in the other, and pushing on from it gives what an
unbroken stream gives (state fields exact for the counters and histograms,
the queries at the meter pins)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soundscope_tpu.core.config import MeterConfig as JaxMeterConfig
from soundscope_tpu.core.state import init_meter_state as jax_init
from soundscope_tpu.models import meter as JM
from soundscope_tpu.models.live import LiveAnalyzer as JaxLive
from soundscope_tpu.utils import checkpoint as JCK
from soundscope_tpu.utils.synth import sine, stereo
from soundscope_tpu_torch.core.config import MeterConfig
from soundscope_tpu_torch.core.state import init_meter_state
from soundscope_tpu_torch.models import meter as TM
from soundscope_tpu_torch.models.live import LiveAnalyzer
from soundscope_tpu_torch.utils import checkpoint as TCK

RATE = 48000
INTS = ("z_pos", "frames_total", "subblock_fill", "subblocks_done", "block_count",
        "lra_count", "block_hist", "lra_hist")


def _track(seconds):
    x = stereo(sine(997.0, seconds, RATE, -20.0))
    x += np.random.default_rng(3).standard_normal(x.shape).astype(np.float32) * 0.01
    return x


def _same(js, ts):
    for f in dataclasses.fields(ts):
        got, want = getattr(ts, f.name).numpy(), np.asarray(getattr(js, f.name))
        assert got.dtype == want.dtype and got.shape == want.shape, f.name
        if f.name in INTS:
            np.testing.assert_array_equal(got, want, err_msg=f.name)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4,
                                       atol=1e-6 * max(float(np.abs(want).max()), 1e-30))


def _queries_close(jcfg, js, tcfg, ts):
    for q in ("integrated_lufs", "shortterm_lufs", "momentary_lufs", "loudness_range_lu"):
        a, b = float(getattr(JM, q)(jcfg, js)), float(getattr(TM, q)(tcfg, ts))
        assert a == b or abs(a - b) < 1e-3, q
    np.testing.assert_allclose(ts.true_peak.numpy(), np.asarray(js.true_peak), atol=1e-6)


@pytest.mark.parametrize("max_blocks", [500, 0])
def test_meter_checkpoint_jax_to_port_and_back(tmp_path, max_blocks):
    x = _track(6.0)
    half = x.shape[1] // 2 + 321
    jcfg = JaxMeterConfig(channels=2, rate=RATE, max_blocks=max_blocks)
    tcfg = MeterConfig(channels=2, rate=RATE, max_blocks=max_blocks)
    jstep, tstep = jax.jit(JM.meter_step(jcfg)), TM.meter_step(tcfg)
    js_half = jstep(jax_init(jcfg), jnp.asarray(x[:, :half]))
    js_all = jstep(js_half, jnp.asarray(x[:, half:]))
    ts_half = tstep(init_meter_state(tcfg, "cpu"), torch.from_numpy(x[:, :half]))
    ts_all = tstep(ts_half, torch.from_numpy(x[:, half:]))

    # JAX writes, the port reads (iir_impl dropped) and pushes on
    pj = str(tmp_path / "jax.npz")
    JCK.save_meter(pj, jcfg, js_half)
    cfg, loaded = TCK.load_meter(pj, "cpu")
    assert cfg == tcfg
    for f in dataclasses.fields(loaded):
        np.testing.assert_array_equal(getattr(loaded, f.name).numpy(),
                                      np.asarray(getattr(js_half, f.name)))
    resumed = tstep(loaded, torch.from_numpy(x[:, half:]))
    _same(js_all, resumed)
    _queries_close(jcfg, js_all, tcfg, resumed)

    # the port writes, JAX reads (iir_impl takes its default) and pushes on
    pt = str(tmp_path / "port.npz")
    TCK.save_meter(pt, tcfg, ts_half)
    jcfg2, jloaded = JCK.load_meter(pt)
    assert jcfg2 == jcfg
    for f in dataclasses.fields(ts_half):
        np.testing.assert_array_equal(np.asarray(getattr(jloaded, f.name)),
                                      getattr(ts_half, f.name).numpy())
    jresumed = jstep(jloaded, jnp.asarray(x[:, half:]))
    _same(jresumed, ts_all)
    _queries_close(jcfg, jresumed, tcfg, ts_all)

    # and the port's own round trip resumes bit for bit
    cfg3, mine = TCK.load_meter(pt, "cpu")
    again = tstep(mine, torch.from_numpy(x[:, half:]))
    for f in dataclasses.fields(again):
        np.testing.assert_array_equal(getattr(again, f.name).numpy(),
                                      getattr(ts_all, f.name).numpy())


def test_shape_mismatch_rejected(tmp_path):
    cfg = MeterConfig(channels=2, rate=RATE, max_blocks=100)
    p = str(tmp_path / "meter.npz")
    TCK.save_meter(p, cfg, init_meter_state(cfg, "cpu"))
    data = dict(np.load(p))
    meta = json.loads(bytes(data["__config__"]).decode())
    assert meta == dataclasses.asdict(cfg)
    meta["channels"] = 6
    data["__config__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(p, **data)
    with pytest.raises(ValueError, match="mismatch"):
        TCK.load_meter(p, "cpu")


def test_live_checkpoint_both_ways(tmp_path):
    x = _track(3.0)
    inter = np.ascontiguousarray(x.T).reshape(-1)
    half = len(inter) // 2
    ja = JaxLive(JaxMeterConfig(channels=2, rate=RATE, max_blocks=0), seconds=4)
    ta = LiveAnalyzer(MeterConfig(channels=2, rate=RATE, max_blocks=0), seconds=4,
                      device="cpu")
    ja.push(inter[:half])
    ta.push(inter[:half])
    pj, pt = str(tmp_path / "jax_live.npz"), str(tmp_path / "port_live.npz")
    ja.save(pj)
    ta.save(pt)

    from_jax = LiveAnalyzer.restore(pj, device="cpu")
    from_port = JaxLive.restore(pt)
    assert from_jax.seconds == from_port.seconds == 4
    assert from_jax.cfg == ta.cfg and from_port.cfg == ja.cfg
    np.testing.assert_array_equal(from_jax.state.ring.numpy(), np.asarray(ja.state.ring))
    np.testing.assert_array_equal(np.asarray(from_port.state.ring), ta.state.ring.numpy())
    assert int(from_jax.state.pos) == int(ja.state.pos)

    for la in (ja, ta, from_jax, from_port):
        la.push(inter[half:])
    _same(ja.state.meter, from_jax.state.meter)
    _same(from_port.state.meter, ta.state.meter)
    fa, fb = ta.frame(), from_jax.frame()
    assert abs(float(fa.shortterm) - float(fb.shortterm)) < 1e-3
    assert abs(float(fa.integrated) - float(fb.integrated)) < 1e-3
    np.testing.assert_array_equal(fa.wf_max, fb.wf_max)
    # the port's own round trip resumes bit for bit
    again = LiveAnalyzer.restore(pt, device="cpu")
    again.push(inter[half:])
    np.testing.assert_array_equal(again.frame().fft_mid, fa.fft_mid)
    assert float(again.frame().integrated) == float(fa.integrated)


def test_live_stream_begun_in_jax_finishes_in_port():
    """live_state_from_numpy carries a JAX LiveState into the port."""
    from soundscope_tpu_torch.utils.params import live_state_from_numpy

    x = _track(3.0)
    inter = np.ascontiguousarray(x.T).reshape(-1)
    cut = len(inter) // 3 + 1
    ja = JaxLive(JaxMeterConfig(channels=2, rate=RATE, max_blocks=0), seconds=2)
    ja.push(inter[:cut])
    fields = {
        "meter": {f.name: np.array(getattr(ja.state.meter, f.name))
                  for f in dataclasses.fields(ja.state.meter)},
        "ring": np.array(ja.state.ring), "pos": np.array(ja.state.pos)}
    ta = LiveAnalyzer(MeterConfig(channels=2, rate=RATE, max_blocks=0), seconds=2,
                      device="cpu")
    ta.state = live_state_from_numpy(fields, "cpu")
    ja.push(inter[cut:])
    ta.push(inter[cut:])
    _same(ja.state.meter, ta.state.meter)
    np.testing.assert_array_equal(ta.state.ring.numpy(), np.asarray(ja.state.ring))
    jf, tf = ja.frame(), ta.frame()
    np.testing.assert_array_equal(tf.wf_min, np.asarray(jf.wf_min))
    assert abs(float(tf.integrated) - float(jf.integrated)) < 1e-3
