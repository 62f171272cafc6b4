"""The port's data- and sequence-parallel analysis (parallel/) against the
JAX package, on the CPU.

The sharded analysis runs on gloo ranks spawned by
soundscope_tpu_torch.parallel.dryrun (fresh interpreters that import no
JAX; each rank and the launcher have their own time limits) on 2 x 4 and
4 x 2 meshes, and is held to the JAX package's sharded_analyze_fn on
8 virtual CPU devices and to the port's single-device engine at the pins
of tests/test_parallel.py: 5e-3 LU on integrated, LRA and the valid
momentary and short-term timelines, 1e-5 on true peak, sample peak exact.
composed_analyze, the one-process emulation the card runs, equals the
gloo run bit for bit. The data axis is held to one process within 1e-5
LU, the multi-host analog within 1e-4 (tools/multihost_worker.py's pin).

The small functions that came with this slice are held to their JAX
counterparts: block_iir_parts (y_zero and s_final0 within 2e-5 per unit
RMS, K7's pin; P and P_total within 1e-6), iir_reference,
kweight_response_db, energy_from_loudness, analyze_batch_fn and the K2
entry views.
"""

import contextlib
import datetime
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from soundscope_tpu.core.config import MeterConfig as JaxMeterConfig
from soundscope_tpu.models.engine import analyze_batch_fn as jax_analyze_batch_fn
from soundscope_tpu.ops import biquad as jbq
from soundscope_tpu.ops import kweight as jkw
from soundscope_tpu.ops import loudness as jl
from soundscope_tpu.ops.pallas_stft import stft_pooled_pallas_packed
from soundscope_tpu.parallel import make_mesh as jax_make_mesh
from soundscope_tpu.parallel import pad_for_mesh as jax_pad_for_mesh
from soundscope_tpu.parallel import seq_sharding as jax_seq_sharding
from soundscope_tpu.parallel import sharded_analyze_fn as jax_sharded_analyze_fn
from soundscope_tpu.parallel import shard_granularity as jax_shard_granularity
from soundscope_tpu_torch import parallel as P
from soundscope_tpu_torch.core.config import MeterConfig
from soundscope_tpu_torch.models.engine import analyze_batch_fn, analyze_batch_native
from soundscope_tpu_torch.ops import biquad as tbq
from soundscope_tpu_torch.ops import kweight as tkw
from soundscope_tpu_torch.ops import loudness as tl
from soundscope_tpu_torch.ops import stft_pooled as K2
from soundscope_tpu_torch.ops.iir import block_iir_stream
from soundscope_tpu_torch.ops.truepeak import true_peak_masked
from soundscope_tpu_torch.parallel import dryrun as D
from soundscope_tpu_torch.parallel import mesh as tmesh
from soundscope_tpu_torch.parallel import seqshard as S

# a spawned run's own limit (the launcher kills its ranks after it)
RANKS_TIMEOUT = 60.0


def _assert_pins(got, want, timeline_atol=5e-3):
    """tests/test_parallel.py's pins, on per-track results (numpy or
    tensors with the port's field names, or JAX results)."""
    def a(v):
        return np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v, np.float64)

    np.testing.assert_allclose(a(got.integrated_lufs), a(want.integrated_lufs), rtol=0, atol=5e-3)
    np.testing.assert_allclose(a(got.lra), a(want.lra), rtol=0, atol=5e-3)
    np.testing.assert_allclose(a(got.true_peak), a(want.true_peak), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(a(got.sample_peak), a(want.sample_peak))
    np.testing.assert_array_equal(a(got.n_momentary), a(want.n_momentary))
    np.testing.assert_array_equal(a(got.n_shortterm), a(want.n_shortterm))
    for tl_name, n_name in (("momentary", "n_momentary"), ("shortterm", "n_shortterm")):
        g, w, counts = a(getattr(got, tl_name)), a(getattr(want, tl_name)), a(getattr(want, n_name))
        for i, c in enumerate(counts.astype(int)):
            np.testing.assert_allclose(g[i, :c], w[i, :c], rtol=0, atol=timeline_atol)


class _Npz:
    """Results saved by a dryrun rank under a label, as attributes."""

    def __init__(self, data, label):
        for f in D.FIELDS:
            setattr(self, f, data[f"{label}.{f}"])


# --- the small functions -------------------------------------------------


@pytest.mark.parametrize("rate", [16000, 48000])
def test_block_iir_parts_matches_jax(rate):
    jf = jbq.make_block_filter(jkw.kweight_cascade_ss(rate), 128)
    tf = tbq.make_block_filter(jkw.kweight_cascade_ss(rate), 128)
    x = (np.random.default_rng(rate).standard_normal((3, 2, 128 * 300)) * 0.3
         ).astype(np.float32)
    yj, pj, fj, ptj = jbq.block_iir_parts(jf, jnp.asarray(x))
    yt, pt, ft, ptt = tbq.block_iir_parts(tf, torch.from_numpy(x))
    rms = float(np.sqrt(np.mean(x.astype(np.float64) ** 2)))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0, atol=2e-5 * rms)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=2e-5 * rms)
    assert pt.shape == (300, 4, 4) and ptt.shape == (4, 4)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ptt.numpy(), np.asarray(ptj), rtol=0, atol=1e-6)


def test_block_iir_parts_compose_to_block_iir():
    """y_zero + (s0 @ P[j]) @ Ot and s0 @ P_total + s_final0 are block_iir
    from s0."""
    filt = tbq.make_block_filter(jkw.kweight_cascade_ss(44100), 128)
    rng = np.random.default_rng(7)
    x = torch.from_numpy((rng.standard_normal((2, 128 * 40)) * 0.3).astype(np.float32))
    s0 = torch.from_numpy(rng.standard_normal((2, 4)))
    y_zero, pw, f0, p_total = tbq.block_iir_parts(filt, x)
    resp = torch.einsum("bn,jnm->bjm", s0, pw) @ filt.Ot.double()
    y = y_zero.double() + resp.reshape(2, -1)
    y_ref, s_ref = tbq.block_iir(filt, x, s0.float())
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), rtol=0, atol=2e-5 * 0.3)
    np.testing.assert_allclose((s0 @ p_total + f0.double()).numpy(), s_ref.numpy(),
                               rtol=0, atol=2e-5 * 0.3)
    with pytest.raises(ValueError):
        tbq.block_iir_parts(filt, x[:, :100])


def test_iir_reference_matches_jax():
    ss = tbq.modal_form(jkw.kweight_cascade_ss(48000))
    rng = np.random.default_rng(3)
    x, s0 = rng.standard_normal(500), rng.standard_normal(4)
    for args in ((x,), (x, s0)):
        yt, st = tbq.iir_reference(ss, *args)
        yj, sj = jbq.iir_reference(ss, *args)
        np.testing.assert_array_equal(yt, yj)
        np.testing.assert_array_equal(st, sj)


@pytest.mark.parametrize("rate", [44100, 48000, 96000])
def test_kweight_response_and_energy_match_jax(rate):
    f = np.geomspace(10.0, rate / 2 * 0.99, 64)
    np.testing.assert_array_equal(tkw.kweight_response_db(rate, f),
                                  jkw.kweight_response_db(rate, f))
    for lufs in (-70.0, -23.0, 0.0):
        assert tl.energy_from_loudness(lufs) == jl.energy_from_loudness(lufs)
        assert abs(float(tl.loudness_from_energy(torch.tensor(
            tl.energy_from_loudness(lufs), dtype=torch.float64))) - lufs) < 1e-9


def test_analyze_batch_fn_matches_jax():
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((2, 2, 128 * 256)) * 0.1).astype(np.float32)
    x[:, :, x.shape[-1] // 2:] *= 3.0
    nv = np.asarray([x.shape[-1], x.shape[-1] - 777])
    cfg = MeterConfig(channels=2, rate=48000, max_blocks=0)
    got = analyze_batch_fn(cfg)(torch.from_numpy(x), torch.from_numpy(nv))
    same = analyze_batch_native(cfg, torch.from_numpy(x), torch.from_numpy(nv))
    assert D.same(got, same)
    want = jax_analyze_batch_fn(JaxMeterConfig(channels=2, rate=48000, max_blocks=0))(
        jnp.asarray(x), jnp.asarray(nv.astype(np.int32)))
    _assert_pins(got, want, timeline_atol=2e-3)


def test_stft_pooled_entries_are_views_of_k2():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((1, 2, 2048 * 24 + 300)) * 0.3).astype(np.float32)
    frames = torch.from_numpy(np.ascontiguousarray(x[..., :2048 * 24])).reshape(1, 2, -1, 128)
    want = K2.stft_pooled_frames(frames, 48000)
    packed = K2.stft_pooled_packed(torch.from_numpy(x), 48000)
    split = K2.stft_pooled(torch.from_numpy(x[:, 0]), torch.from_numpy(x[:, 1]), 48000)
    for got in (packed, split):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    jm, js = stft_pooled_pallas_packed(jnp.asarray(x), 48000, interpret=True)
    nw = jm.shape[1]
    assert 0 < nw <= packed[0].shape[1]
    assert np.abs(packed[0].numpy()[:, :nw] - np.asarray(jm)).max() < 1e-3
    assert np.abs(packed[1].numpy()[:, :nw] - np.asarray(js)).max() < 1e-3
    with pytest.raises(ValueError):
        K2.stft_pooled_packed(torch.zeros(1, 3, 4096), 48000)


@pytest.mark.parametrize("rate", [16000, 44100, 48000, 96000])
def test_shard_granularity_and_padding_match_jax(rate):
    tc = MeterConfig(channels=2, rate=rate, max_blocks=0)
    jc = JaxMeterConfig(channels=2, rate=rate, max_blocks=0)
    assert P.shard_granularity(tc) == jax_shard_granularity(jc)
    for n in (1, 12_345, 2 * 3600 * rate - 1237):
        for s in (1, 2, 4, 8):
            assert P.pad_for_mesh(n, tc, s) == jax_pad_for_mesh(n, jc, s)


def test_window_means_hold_over_two_hours():
    """The gating and short-term windows of a 2-hour programme (72,000
    sub-blocks at -40 to -15 dBFS) against their float64 means: within
    float32 rounding of the window (a float32 running sum kept only
    eps32 * max|cumsum|, up to 0.45 LU on a quiet momentary window)."""
    rng = np.random.default_rng(146)
    lev = np.repeat(rng.uniform(-40.0, -15.0, 720), 100)
    e = 10 ** (lev / 10) * 9600 * (1 + 0.05 * rng.standard_normal(lev.size))
    sums = torch.tensor(e[None], dtype=torch.float32)
    c64 = np.cumsum(sums.double().numpy(), axis=-1)
    for fn, w in (("gating_energies", 4), ("shortterm_energies", 30)):
        got = getattr(tl, fn)(sums, 4800).double().numpy()
        exact = (c64[:, w - 1:] - np.concatenate([np.zeros((1, 1)), c64[:, :-w]], -1)) / (w * 4800)
        np.testing.assert_allclose(got, exact, rtol=2e-7, atol=0)


def test_shard_peaks_chunks_change_no_value(monkeypatch):
    cfg = MeterConfig(channels=2, rate=48000, max_blocks=0)
    x = torch.from_numpy((np.random.default_rng(9).standard_normal((2, 2, 9600 * 3)) * 0.2
                          ).astype(np.float32))
    nv = torch.tensor([9600 * 3, 9600 * 2 + 77])
    left = torch.zeros((2, 2, S._taps_per_phase(cfg) - 1))
    whole = true_peak_masked(x, nv[:, None, None], cfg.rate)
    monkeypatch.setattr(S, "PEAK_CHUNK", 1000)
    chunked = S.shard_peaks(cfg, x, left, nv, 0)
    np.testing.assert_allclose(chunked[0].numpy(), whole[0].numpy(), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(chunked[1].numpy(), whole[1].numpy())


def test_card_route_filters_from_the_composed_state():
    """The shard filter (K7 from zero state, then again from the composed
    state for every shard after the first: its plain version here) gives
    the whole row's output, as the JAX package's route (block_iir_parts
    and the P table's state response) does."""
    cfg = MeterConfig(channels=2, rate=48000, max_blocks=0)
    x = torch.from_numpy((np.random.default_rng(2).standard_normal((2, 2, 9600 * 8)) * 0.3
                          ).astype(np.float32))
    n_seq, nloc = 4, 9600 * 2
    shards = [x[..., k * nloc:(k + 1) * nloc].contiguous() for k in range(n_seq)]
    filt, p_total = S._setup(cfg, shards[0], nloc)
    passes = [block_iir_stream(filt, s, torch.zeros((2, 2, 4))) for s in shards]
    f0s = torch.stack([f.double() for _, f in passes])
    whole, _ = tbq.block_iir(filt, x, torch.zeros((2, 2, 4)))
    for k, (s, (y0, _)) in enumerate(zip(shards, passes)):
        s0 = S.incoming_state(f0s, k, p_total)
        card = S.exact_output(filt, s, y0, s0, k)
        y_zero, pw, _, _ = tbq.block_iir_parts(filt, s)
        resp = torch.einsum("bcn,jnm->bcjm", s0, pw) @ filt.Ot.double()
        table = (y_zero.double() + resp.reshape(y_zero.shape)).float()
        for y in (card, table):
            np.testing.assert_allclose(y.numpy(), whole[..., k * nloc:(k + 1) * nloc].numpy(),
                                       rtol=0, atol=2e-5 * 0.3)


# --- process groups in this process (world size 1) -----------------------


@pytest.fixture
def gloo_world_one():
    dev = P.init_distributed(f"tcp://127.0.0.1:{D.free_port()}", 1, 0, device="cpu",
                             timeout=datetime.timedelta(seconds=30))
    try:
        yield dev
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_init_distributed_raises_rather_than_fall_back(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError):
            P.init_distributed("tcp://127.0.0.1:1", 1, 0, device=device)
    with pytest.raises(ValueError):
        P.init_distributed("tcp://127.0.0.1:1", device="cpu")
    monkeypatch.setattr(dist, "is_gloo_available", lambda: False)
    with pytest.raises(RuntimeError, match="gloo"):
        P.init_distributed("tcp://127.0.0.1:1", 1, 0, device="cpu")
    assert not dist.is_initialized()


def test_sharded_fn_raises_without_a_process_group(gloo_world_one):
    cfg = MeterConfig(channels=2, rate=16000, max_blocks=0)
    fn = P.sharded_analyze_fn(cfg, P.make_mesh(1, seq=1, device="cpu"))
    dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="process group"):
        fn(torch.zeros((1, 2, 3200)), torch.tensor([3200]))
    with pytest.raises(RuntimeError, match="process group"):
        P.make_mesh(1)


def test_sharded_fn_raises_on_a_device_mismatch(gloo_world_one):
    cfg = MeterConfig(channels=2, rate=16000, max_blocks=0)
    fn = P.sharded_analyze_fn(cfg, P.make_mesh(1, seq=1, device="cpu"))
    with pytest.raises(ValueError, match="mesh device"):
        fn(torch.zeros((1, 2, 3200), device="meta"), torch.tensor([3200]))
    with pytest.raises(ValueError, match="mesh device"):
        fn(torch.zeros((1, 2, 3200)), torch.tensor([3200], device="meta"))
    with pytest.raises(ValueError):       # no multiple of the granularity
        fn(torch.zeros((1, 2, 3000)), torch.tensor([3000]))
    with pytest.raises(ValueError):       # a mesh across hosts it cannot take
        P.make_mesh(1, seq=2)
    with pytest.raises(ValueError):
        P.make_mesh(2)
    with pytest.raises(ValueError):
        P.make_multihost_mesh(seq=2)
    with pytest.raises(RuntimeError, match="already"):
        P.init_distributed(f"tcp://127.0.0.1:{D.free_port()}", 1, 0, device="cpu")


def test_world_one_equals_composition_and_engine(gloo_world_one):
    """At world size 1 (the card's case) the sharded callable, the
    composition at seq 1 and 4 and the engine agree; EBU Tech 3341 case 1
    reads -23.0 LUFS through it."""
    mesh = P.make_mesh(1, seq=1, device="cpu")
    assert mesh.shape == (1, 1) and mesh.mesh_dim_names == ("data", "seq")
    assert P.seq_sharding(mesh) == (tmesh.Shard(0), tmesh.Shard(2))
    assert P.data_sharding(mesh) == (tmesh.Shard(0), tmesh.Replicate())
    assert P.replicated(mesh) == (tmesh.Replicate(), tmesh.Replicate())
    (_, cfg, x, nv), _ = D.certify_inputs(1, 4)
    xs, nvs = P.global_batch(mesh, x, nv)
    assert xs.shape == x.shape and nvs.dtype == torch.int64
    fn = P.sharded_analyze_fn(cfg, mesh)
    with _one_thread():
        res = fn(xs, nvs)
        assert D.same(res, S.composed_analyze(cfg, torch.from_numpy(x), torch.from_numpy(nv), 1))
    _assert_pins(S.composed_analyze(cfg, torch.from_numpy(x), torch.from_numpy(nv), 4), res)
    _assert_pins(res, analyze_batch_native(cfg, torch.from_numpy(x), torch.from_numpy(nv)))
    n = 20 * 48000
    t = np.arange(n) / 48000
    tone = (10 ** (-23 / 20) * np.sin(2 * np.pi * 997.0 * t)).astype(np.float32)
    npad = P.pad_for_mesh(n, cfg, 1)
    ebu = np.zeros((1, 2, npad), np.float32)
    ebu[0, :, :n] = tone
    r = fn(*P.global_batch(mesh, ebu, np.asarray([n])))
    assert abs(float(r.integrated_lufs[0]) + 23.0) < 0.1
    assert np.all(np.abs(r.true_peak.numpy() - 0.0708) < 1e-3)


# --- gloo ranks -----------------------------------------------------------


@contextlib.contextmanager
def _one_thread():
    """The ranks' thread count, so that reductions add in their order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module", params=[2, 4], ids=["mesh4x2", "mesh2x4"])
def gloo_run(request, tmp_path_factory):
    """One dryrun over 8 gloo ranks at seq 2 or 4: (seq, rank outputs,
    saved results)."""
    seq = request.param
    out = str(tmp_path_factory.mktemp(f"dryrun_seq{seq}"))
    outs = D.launch(8, seq=seq, out=out, timeout=RANKS_TIMEOUT, device="cpu")
    with np.load(f"{out}/results.npz") as data:
        saved = dict(data)
    return seq, outs, saved


@pytest.mark.parametrize("label", ["48k_ragged", "16k"])
def test_sharded_gloo_matches_jax(gloo_run, label):
    seq, _, saved = gloo_run
    assert tuple(saved["mesh"]) == (8 // seq, seq)
    (_, cfg, x, nv), = [s for s in D.certify_inputs(8 // seq, seq) if s[0] == label]
    mesh = jax_make_mesh(8, seq=seq)
    jcfg = JaxMeterConfig(channels=2, rate=cfg.rate, max_blocks=0)
    want = jax.jit(jax_sharded_analyze_fn(jcfg, mesh))(
        jax.device_put(jnp.asarray(x), jax_seq_sharding(mesh)), jnp.asarray(nv.astype(np.int32)))
    _assert_pins(_Npz(saved, label), want)


@pytest.mark.parametrize("label", ["48k_ragged", "16k"])
def test_sharded_gloo_matches_engine(gloo_run, label):
    seq, _, saved = gloo_run
    (_, cfg, x, nv), = [s for s in D.certify_inputs(8 // seq, seq) if s[0] == label]
    want = analyze_batch_native(cfg, torch.from_numpy(x), torch.from_numpy(nv))
    _assert_pins(_Npz(saved, label), want)


def test_composition_equals_gloo_run_bit_for_bit(gloo_run):
    """composed_analyze on each data row's block, in this process, equals
    what the gloo ranks computed, bit for bit."""
    seq, _, saved = gloo_run
    for label, cfg, x, nv in D.certify_inputs(8 // seq, seq):
        ranks = _Npz(saved, label)
        for d in range(8 // seq):
            rows = slice(2 * d, 2 * d + 2)
            with _one_thread():
                got = S.composed_analyze(cfg, torch.from_numpy(x[rows]),
                                         torch.from_numpy(nv[rows]), seq)
            for f in D.FIELDS:
                np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(ranks, f)[rows])


def test_data_axis_matches_one_process(gloo_run):
    _, _, saved = gloo_run
    cfg, x, nv = D.data_parallel_inputs(8)
    want = analyze_batch_native(cfg, torch.from_numpy(x), torch.from_numpy(nv))
    np.testing.assert_allclose(saved["data_parallel.integrated_lufs"],
                               want.integrated_lufs.numpy(), rtol=0, atol=1e-5)
    _assert_pins(_Npz(saved, "data_parallel"), want)


def test_dryrun_certifies_within_the_jax_asserts(gloo_run):
    seq, outs, saved = gloo_run
    line = outs[0].strip().splitlines()[-1]
    assert line.startswith(f"dryrun_multichip ok: mesh=({8 // seq} data x {seq} seq)"), line
    assert "composed_analyze equals the gloo run bit for bit" in line
    deltas = {k: float(v) for k, v in re.findall(r"([\w.]+)=([0-9.e+-]+)", line)}
    comps = ("integrated_lufs", "lra_lu", "true_peak", "sample_peak", "momentary", "shortterm")
    assert set(deltas) == {f"{s}.{c}" for s in ("48k_ragged", "16k") for c in comps} | {
        "integrated_hist_overflow", "live_sharded", "data_parallel"}
    for k, v in deltas.items():
        assert v <= {"integrated_hist_overflow": 0.05, "data_parallel": 1e-5}.get(k, 5e-3), (k, v)
        assert v == pytest.approx(float(saved[f"delta.{k}"]), rel=1e-2, abs=1e-12)
    assert deltas["integrated_hist_overflow"] > 0.0    # the histogram quantises


def test_spawned_ranks_import_no_jax(gloo_run):
    _, outs, _ = gloo_run
    assert len(outs) == 8
    for r, out in enumerate(outs):
        assert f"rank {r}: no jax, jaxlib, flax or soundscope_tpu module loaded" in out, out


def test_multihost_analog():
    """4 ranks as 2 hosts of 2 (LOCAL_WORLD_SIZE), seq 2 inside a host,
    each host passing its own tracks: within 1e-4 LU of one process."""
    outs = D.launch(4, multihost=True, timeout=RANKS_TIMEOUT, device="cpu")
    for r, out in enumerate(outs):
        line = out.strip().splitlines()[-1]
        assert line.startswith(f"MULTIHOST_OK pid={r} mesh=(2x2) on cpu hosts=2 tracks=2"), line
        assert float(line.rsplit("max_err=", 1)[1]) < 1e-4
        assert f"rank {r}: no jax" in out


def test_dryrun_asks_for_the_card_and_never_falls_back(capsys):
    """The dryrun's ranks take a card each unless --device cpu is given;
    without the cards it raises before it spawns a rank."""
    assert D.rank_devices("cpu", 3) == ["cpu"] * 3
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a card")
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError):
            D.rank_devices(device, 2)
        with pytest.raises(RuntimeError):
            D.launch(2, device=device, timeout=1.0)
    assert D.main(["--world", "2"]) == 1
    assert "--device cpu" in capsys.readouterr().err


def test_launcher_kills_ranks_after_its_limit():
    """Ranks still running at the launcher's limit (here 1 s, less than
    a rank takes to start) are killed, and the launch raises."""
    with pytest.raises(RuntimeError, match="killed after"):
        D.launch(2, timeout=1.0, device="cpu")
