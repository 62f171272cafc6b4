"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and skip without one. They import neither
JAX nor the JAX package, so on a machine without JAX they run with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances are the CPU parity pins: K1 sub-block sums rtol 3e-4 / atol
2e-5, true peak rtol 2e-6 / atol 1e-7, sample peak exact; K2 1e-3 dB;
K3-K5 z per group rtol 1e-3 / atol 1e-6 * max|z| and sub-block sums as
K1's; K6 as K1's peaks; on non-finite input, non-finite exactly where the
plain version is; K7 y and s_final 2e-5 abs per unit RMS of x; the
streaming meter at the pins of tests/test_meter_stream.py (1e-3 LU, true
peak 1e-6). The TUI's App and the CLI on the card launch the kernels of
their paths (K3 to open a file, K7 per analysis frame and mic quantum, K1
and K2 per CLI bucket) and agree with the CPU at those pins.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from soundscope_tpu_torch.core.config import MeterConfig
from soundscope_tpu_torch.core.state import init_meter_state
from soundscope_tpu_torch.models import meter as M
from soundscope_tpu_torch.models.analyzer import Analyzer
from soundscope_tpu_torch.models.engine import analyze_array, analyze_batch_native, rows_plan
from soundscope_tpu_torch.models.live import LiveAnalyzer, init_live_state
from soundscope_tpu_torch.ops import decimate
from soundscope_tpu_torch.ops import iir as IIR
from soundscope_tpu_torch.ops import iir_chunked as K1
from soundscope_tpu_torch.ops import stft_pooled as K2
from soundscope_tpu_torch.ops import truepeak_stream as K6
from soundscope_tpu_torch.ops.biquad import make_block_filter
from soundscope_tpu_torch.ops.kweight import channel_weights, kweight_cascade_ss
from soundscope_tpu_torch.utils import checkpoint as CK
from soundscope_tpu_torch.utils.metrics import GLOBAL, launches

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _noise(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x * 0.1)


# 192 kHz takes steps and tiles of 16,384 samples: k1_tile's 512-thread CTAs
@pytest.mark.parametrize("rate,b,ragged", [(48000, 3, True), (44100, 3, True),
                                           (96000, 2, False), (192000, 1, False),
                                           (192000, 2, True)])
def test_k1_kernel_matches_plain(cuda, rate, b, ragged):
    n = 512 * 128
    h = (rate + 5) // 10
    x4 = _noise((b, 2, 512, 128), rate).to(cuda)
    nv = torch.tensor([n, n - 700, n // 2][:b] if ragged else [n] * b, device=cuda)
    filt = make_block_filter(kweight_cascade_ss(rate), 128, cuda)
    before = launches()["K1"]
    got = K1.kweight_energy_tp_chunked(filt, x4, nv, (1.0, 1.0), rate, h)
    assert launches()["K1"] == before + 1
    want = K1.kweight_energy_tp_chunked_plain(filt, x4, nv, (1.0, 1.0), rate, h)
    torch.cuda.synchronize()
    span = K1.step_length(n, h)
    sums = [K1.subblock_sums_from_steps(s, h, span, n).cpu().numpy()
            for s in (got[0], want[0])]
    np.testing.assert_allclose(sums[0], sums[1], rtol=3e-4, atol=2e-5)
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(),
                               rtol=2e-6, atol=1e-7)
    np.testing.assert_array_equal(got[2].cpu().numpy(), want[2].cpu().numpy())


# steps of 4,096 (warps in series per step), 2,048 (the CLI bucket's 240 s
# tracks) and 128 (4 threads a step); ragged, with a boundary in a thread
@pytest.mark.parametrize("nc", [512, 528, 703])
def test_k1_left_and_right_match_plain(cuda, nc):
    """K1's parts before and from each step's 100 ms boundary, one by one,
    against its plain version's."""
    n = nc * 128
    x4 = _noise((2, 2, nc, 128), nc).to(cuda)
    x4[:, :, : nc // 2] *= 30.0                 # a loud half beside a quiet one
    nv = torch.tensor([n, n - 4811], device=cuda)
    filt = make_block_filter(kweight_cascade_ss(48000), 128, cuda)
    got = K1.kweight_energy_tp_chunked(filt, x4, nv, (1.0, 1.0), 48000, 4800)[0]
    want = K1.kweight_energy_tp_chunked_plain(filt, x4, nv, (1.0, 1.0), 48000, 4800)[0]
    torch.cuda.synchronize()
    assert got.shape == want.shape == (4, n // K1.step_length(n, 4800), 2)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=3e-4, atol=2e-5)


def _k1_k5_inputs(cuda):
    n = 96 * 1024
    x = _noise((3, 2, n), 21).to(cuda)
    nv = torch.tensor([n, n - 8192 - 777, n // 2 + 5], device=cuda)
    filt = make_block_filter(kweight_cascade_ss(44100), 128, cuda)
    return n, x, nv, filt


def test_k1_k5_wrappers_do_not_sync_the_host(cuda):
    """K1, its glue (subblock_sums_from_steps), K3, K4 and K5 enqueue their
    work without waiting for the device: their constants are kernel
    parameters or cached device copies made without a host sync."""
    from soundscope_tpu_torch.ops import _build

    _build.library()
    n, x, nv, filt = _k1_k5_inputs(cuda)
    h = 4410
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            steps, _, _ = K1.kweight_energy_tp_chunked(
                filt, x.reshape(3, 2, -1, 128), nv, (1.0, 1.0), 44100, h)
            K1.subblock_sums_from_steps(steps, h, K1.step_length(n, h), n)
            IIR.kweight_energy_chain(filt, x.reshape(6, n), nv, (1.0, 1.0), 1)
            IIR.kweight_energy_tp_prefix(filt, x, nv, (1.0, 1.0), 44100, 1)
            IIR.kweight_energy_prefix(filt, x, nv, (1.0, 1.0), 1)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_k6_k7_wrappers_do_not_sync_the_host(cuda):
    """K6 (per-track and host-integer n_valid) and K7 (one segment, and
    rows of many that reset their records) enqueue without waiting."""
    from soundscope_tpu_torch.ops import _build

    _build.library()
    n, x, nv, filt = _k1_k5_inputs(cuda)
    s0 = torch.zeros((2, 4), device=cuda)
    view = x[0].T.contiguous().reshape(-1).reshape(n, 2).T
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            K6.true_peak_stream(x, nv, 44100)
            K6.true_peak_stream(x, n, 44100)
            IIR.block_iir_stream(filt, view[:, :800], s0)
            IIR.block_iir_stream(filt, view, s0)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("route,rate,b,ch", [("fused", 48000, 2, 2), ("prefix", 192000, 1, 6),
                                             ("chain", 48000, 512, 2)])
def test_rows_routes_do_not_sync_the_host(cuda, route, rate, b, ch):
    """analyze_batch_native on the rows layout, K3, K4 and K5 + K6 routes,
    enqueues everything without waiting for the device."""
    n = {"fused": 64 * 1024, "prefix": 256 * 1024, "chain": 30 * 4096}[route]
    cfg = MeterConfig(channels=ch, rate=rate, max_blocks=0)
    assert rows_plan(n, b, ch, rate, cfg.block)[0] == route
    x = _noise((b * ch, n), 12).to(cuda)
    nv = torch.full((b,), n, device=cuda)
    analyze_batch_native(cfg, x, nv)               # builds, fills the caches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        analyze_batch_native(cfg, x, nv)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_k1_k5_two_launches_bit_identical(cuda):
    """The chained scan and the look-back take each entry state by a fixed
    formula and add every sum in a fixed order, so two launches of K1, K3,
    K4 and K5 give the same bits."""
    n, x, nv, filt = _k1_k5_inputs(cuda)
    x4 = x.reshape(3, 2, -1, 128)
    a = K1.kweight_energy_tp_chunked(filt, x4, nv, (1.0, 1.0), 44100, 4410)
    b = K1.kweight_energy_tp_chunked(filt, x4, nv, (1.0, 1.0), 44100, 4410)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    for group in (1, 32):
        za = IIR.kweight_energy_chain(filt, x, nv, (1.0, 1.0), group)
        zb = IIR.kweight_energy_chain(filt, x, nv, (1.0, 1.0), group)
        assert torch.equal(za, zb)
        za = IIR.kweight_energy_prefix(filt, x, nv, (1.0, 1.0), group)
        zb = IIR.kweight_energy_prefix(filt, x, nv, (1.0, 1.0), group)
        assert torch.equal(za, zb)
        a = IIR.kweight_energy_tp_prefix(filt, x, nv, (1.0, 1.0), 44100, group)
        b = IIR.kweight_energy_tp_prefix(filt, x, nv, (1.0, 1.0), 44100, group)
        for u, v in zip(a, b):
            assert torch.equal(u, v)
    # a few long rows: the look-back's chain
    x = _noise((1, 2, 1 << 22), 22).to(cuda)
    nv = torch.tensor([(1 << 22) - 777], device=cuda)
    filt = make_block_filter(kweight_cascade_ss(48000), 128, cuda)
    a = IIR.kweight_energy_tp_prefix(filt, x, nv, (1.0, 1.0), 48000, 32)
    b = IIR.kweight_energy_tp_prefix(filt, x, nv, (1.0, 1.0), 48000, 32)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert torch.equal(IIR.kweight_energy_prefix(filt, x, nv, (1.0, 1.0), 32),
                       IIR.kweight_energy_prefix(filt, x, nv, (1.0, 1.0), 32))


def test_k1_k5_attributes(cuda):
    """Each kernel's two tiles: a halo row and a row of 32 samples a
    thread, K3's a halo row for each of two channels."""
    for attrs, threads, halos in ((K1.kernel_attributes(4, 8192), 256, 1),
                                  (K1.kernel_attributes(1, 16384), 512, 1),
                                  (IIR.rows_attributes(4, IIR.LOOKBACK), IIR.TP_TILE // 32, 2),
                                  (IIR.rows_attributes(2, IIR.LOOKBACK), IIR.TP_TILE // 32, 2),
                                  (IIR.rows_attributes(0, IIR.LOOKBACK), IIR.CHAIN_TILE // 32, 1),
                                  (IIR.rows_attributes(0, 0), IIR.CHAIN_TILE // 32, 1),
                                  (IIR.rows_attributes(0, 0, tracks=True),
                                   IIR.CHAIN_TILE // 32, 1)):
        assert attrs["threads"] == threads and attrs["blocks_per_sm"] >= 1
        assert attrs["dynamic_smem"] == 2 * 16 * 8 * (threads + halos)


@pytest.mark.parametrize("rate", [48000, 44100, 96000])
def test_k2_kernel_matches_plain(cuda, rate):
    fr = _noise((2, 2, 16 * 40, 128), rate).to(cuda) * 3.0
    before = launches()["K2"]
    got = K2.stft_pooled_frames(fr, rate)
    assert launches()["K2"] == before + 1
    want = K2.stft_pooled_frames_plain(fr, rate)
    assert got[0].shape == want[0].shape == (2, 33, 128)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) < 1e-3


def _k2_case(case, cuda):
    """(frames, rate) of K2's edge cases: one window (N = 16384), one
    track, 33 tracks, 44.1 kHz, silence, a full-scale sine at the centre
    bin of band 20 (left 1, right 0.5), and noise only in a track's first
    and last 300 samples, which the first and the last window see under
    the Hann window's edges (1e-8 to 3e-3)."""
    if case == "edges":
        x = np.zeros((1, 2, 2048 * 24), np.float32)
        noise = np.random.default_rng(7).standard_normal((2, 2, 300))
        x[0, :, :300], x[0, :, -300:] = noise
        return torch.from_numpy(x.reshape(1, 2, -1, 128)).to(cuda), 48000
    if case == "sine":
        t = np.arange(2048 * 24, dtype=np.float64)
        s = np.sin(2 * np.pi * (20 * 128 + 64) * t / 16384)
        x = np.stack([s, 0.5 * s]).astype(np.float32).reshape(1, 2, -1, 128)
        return torch.from_numpy(x).to(cuda), 48000
    if case == "silence":
        return torch.zeros((2, 2, 16 * 24, 128), device=cuda), 48000
    shape, rate = {"nw1": ((2, 2, 128, 128), 48000), "b1": ((1, 2, 16 * 40, 128), 48000),
                   "b33": ((33, 2, 16 * 24, 128), 48000),
                   "44k1": ((3, 2, 16 * 40, 128), 44100)}[case]
    return (_noise(shape, 11) * 3.0).to(cuda), rate


@pytest.mark.parametrize("case", ["nw1", "b1", "b33", "44k1", "silence", "sine", "edges"])
def test_k2_kernel_cases(cuda, case):
    """Within 1e-3 dB of the plain version. Silence reads -150 dB in every
    band. Beside a sine every bin is float32 rounding noise, whose dB value
    no two FFTs share: bands the plain version reads more than 100 dB
    below the sine's band must read so in the kernel too. Two launches on
    the same input agree bit for bit."""
    fr, rate = _k2_case(case, cuda)
    got = K2.stft_pooled_frames(fr, rate)
    again = K2.stft_pooled_frames(fr, rate)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    want = K2.stft_pooled_frames_plain(fr, rate)
    b, _, rows, _ = fr.shape
    for g, w in zip(got, want):
        assert g.shape == w.shape == (b, rows * 128 // 2048 - 7, 128)
        if case == "silence":
            assert bool((g == -150.0).all())
        if case == "sine":
            top = float(w.max())
            loud = w > top - 100.0
            assert bool((g.argmax(-1) == 20).all())
            assert bool((g[~loud] < top - 100.0).all())
            g, w = g[loud], w[loud]
        assert float((g - w).abs().max()) < 1e-3


def test_k2_kernel_attributes(cuda):
    """Two CTAs of 256 threads (one window's mid and side) share each SM:
    each at most half of the SM's shared memory, with no spills."""
    attrs = K2.kernel_attributes()
    assert attrs["threads"] == 256 and attrs["blocks_per_sm"] >= 2
    assert attrs["local_bytes"] == 0
    assert attrs["dynamic_smem"] == 8192 * 8
    per_sm = getattr(torch.cuda.get_device_properties(cuda),
                     "shared_memory_per_multiprocessor", 228 * 1024)
    assert attrs["dynamic_smem"] + attrs["static_smem"] <= per_sm // 2


def test_k2_side_overflow_leaves_mid(cuda):
    """Only the side's powers overflow float32: L = s + d, R = s - d with
    d = +-2^60 and s a noise of integer multiples of 2^37, all exact in
    float32. Mid matches the plain version band by band within 1e-3 dB;
    side reads the floor or +Inf wherever the plain version does. Mid and
    side are CTAs of their own, so nothing of one reaches the other."""
    rng = np.random.default_rng(29)
    n = 2048 * 24
    s = np.round(rng.standard_normal((2, n)) * 2.0 ** 17) * 2.0 ** 37
    d = np.where(rng.random((2, n)) < 0.5, -1.0, 1.0) * 2.0 ** 60
    x = np.stack([s + d, s - d], axis=1).astype(np.float32)
    assert (x.astype(np.float64) == np.stack([s + d, s - d], axis=1)).all()
    fr = torch.from_numpy(x.reshape(2, 2, -1, 128)).to(cuda)
    got = [a.cpu().numpy() for a in K2.stft_pooled_frames(fr, 48000)]
    want = [a.cpu().numpy() for a in K2.stft_pooled_frames_plain(fr, 48000)]
    assert np.isfinite(want[0]).all() and np.abs(got[0] - want[0]).max() < 1e-3
    assert np.isposinf(want[1]).any()
    assert (got[1][want[1] == -150.0] == -150.0).all()
    assert np.isposinf(got[1][np.isposinf(want[1])]).all()


def test_k2_mid_equals_side_on_a_silent_right_channel(cuda):
    """With the right channel at zero the side (l - r) / 2 equals the mid
    (l + r) / 2 sample for sample, and the mid and the side CTA of each
    window run the same arithmetic, thread 0's split included: their
    bands agree bit for bit, and the mid matches the plain version."""
    x = _noise((3, 2, 16 * 40, 128), 31) * 3.0
    x[:, 1] = 0.0
    fr = x.to(cuda)
    mid, side = K2.stft_pooled_frames(fr, 48000)
    assert mid.shape == (3, 33, 128) and torch.equal(mid, side)
    want = K2.stft_pooled_frames_plain(fr, 48000)[0]
    assert float((mid - want).abs().max()) < 1e-3


def test_engine_cuda_matches_cpu(cuda):
    cfg = MeterConfig(channels=2, rate=48000, max_blocks=0)
    x = _noise((2, 2, 2048, 128), 5)
    x[:, :, 1024:] *= 3.0
    nv = torch.tensor([2048 * 128, 2048 * 128 - 777])
    rg = analyze_batch_native(cfg, x.to(cuda), nv.to(cuda))
    rc = analyze_batch_native(cfg, x, nv)
    for f in ("integrated_lufs", "lra"):
        np.testing.assert_allclose(getattr(rg, f).cpu().numpy(),
                                   getattr(rc, f).numpy(), rtol=0, atol=2e-3)
    np.testing.assert_allclose(rg.true_peak.cpu().numpy(), rc.true_peak.numpy(),
                               rtol=2e-6, atol=1e-7)
    np.testing.assert_array_equal(rg.n_shortterm.cpu().numpy(), rc.n_shortterm.numpy())


def test_wrappers_raise_on_what_they_cannot_launch(cuda):
    x4 = torch.zeros((1, 2, 512, 128), device=cuda)
    filt = make_block_filter(kweight_cascade_ss(48000), 128, cuda)
    nv = torch.tensor([512 * 128], device=cuda)
    with pytest.raises(ValueError):
        K1.kweight_energy_tp_chunked(filt, x4.transpose(2, 3), nv, (1.0, 1.0),
                                     48000, 4800)
    with pytest.raises(ValueError):
        K2.stft_pooled_frames(x4.transpose(2, 3), 48000)
    with pytest.raises(ValueError):
        K2.stft_pooled_frames(x4, 32000)


def _energy_close(got, want, h, group):
    got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6 * np.abs(want).max())
    hg = h // group
    nb = got.shape[-1] // hg
    sums = [z[:, : nb * hg].reshape(z.shape[0], nb, hg).sum(-1) for z in (got, want)]
    np.testing.assert_allclose(sums[0], sums[1], rtol=3e-4, atol=2e-5)


def _k5_lengths(kind, b, n, seg):
    """n_valid of K5's cases, from its channel segment of `seg` samples:
    inside a segment, on segment boundaries, or many tracks of assorted
    lengths; every case leaves whole segments of padding, and "padded"
    has a track with no valid sample."""
    if kind == "inside":
        return [n, 20 * seg + 777, 3 * seg + 5]
    if kind == "boundary":
        return [n // seg * seg, 20 * seg, seg]
    if kind == "padded":
        return [n // 2, 2 * seg + 1, 0]
    if kind == "many":
        return [n - (997 * i) % (n // 2) for i in range(b)]
    return [n, n - 700, n // 2][:b]


def _rows_case(kernel, rate, b, ch, group, lengths=None):
    name = f"{kernel}-{rate}-{b}-{ch}-{group}"
    return pytest.param(kernel, rate, b, ch, group, lengths,
                        id=name if lengths is None else f"{name}-{lengths}")


# K5: mono (track tickets of 4,096), stereo (2,048) at 48 and 44.1 kHz,
# 5.1 at 192 kHz (5 weighted channels: a ticket per row); n_valid inside a
# segment, on its boundaries, a track with none; 3 tracks (fewer than the
# card's resident tickets) and 2,000 (more)
@pytest.mark.parametrize("kernel,rate,b,ch,group,lengths", [
    _rows_case("K3", 48000, 3, 2, 32), _rows_case("K3", 44100, 3, 2, 1),
    _rows_case("K3", 96000, 2, 6, 32),
    _rows_case("K4", 48000, 3, 2, 32), _rows_case("K4", 44100, 3, 2, 1),
    _rows_case("K4", 192000, 1, 6, 32),
    _rows_case("K5", 48000, 3, 2, 32), _rows_case("K5", 44100, 3, 2, 1),
    _rows_case("K5", 192000, 2, 6, 32),
    _rows_case("K5", 48000, 3, 1, 32, "inside"), _rows_case("K5", 48000, 3, 2, 32, "inside"),
    _rows_case("K5", 48000, 3, 2, 32, "boundary"), _rows_case("K5", 48000, 3, 2, 32, "padded"),
    _rows_case("K5", 44100, 3, 2, 1, "inside"), _rows_case("K5", 44100, 3, 2, 1, "padded"),
    _rows_case("K5", 192000, 3, 6, 32, "boundary"), _rows_case("K5", 192000, 3, 6, 32, "padded"),
    _rows_case("K5", 48000, 2000, 2, 32, "many"),
    # K3 on track tickets: stereo (4,096 a channel) and mono (8,192) at 48
    # kHz (g = 32), 44.1 kHz (g = 1) and 96 kHz (factor 2, g = 32 and 1,
    # where a thread's group sums meet the next row's FIR halo); rows of
    # 81 and 40 track segments, past the look-back's 33
    _rows_case("K3", 48000, 3, 2, 32, "inside"), _rows_case("K3", 48000, 3, 2, 32, "boundary"),
    _rows_case("K3", 48000, 3, 2, 32, "padded"), _rows_case("K3", 48000, 3, 1, 32, "inside"),
    _rows_case("K3", 48000, 3, 1, 32, "padded"),
    _rows_case("K3", 44100, 3, 2, 1, "inside"), _rows_case("K3", 44100, 3, 2, 1, "padded"),
    _rows_case("K3", 44100, 3, 1, 1, "boundary"),
    _rows_case("K3", 96000, 3, 2, 32, "inside"), _rows_case("K3", 96000, 3, 1, 32, "padded"),
    _rows_case("K3", 96000, 3, 2, 1, "boundary"),
    # K3 on tickets of a 5.1 file's rows (8,192 samples, channel_sum after);
    # groups of 2, 4 and 8, which take the kernel's run-time group
    _rows_case("K3", 48000, 3, 6, 32, "padded"), _rows_case("K3", 44100, 3, 6, 1, "inside"),
    _rows_case("K3", 48000, 3, 2, 4, "inside"), _rows_case("K3", 96000, 3, 1, 8, "boundary"),
    _rows_case("K3", 88200, 3, 6, 2, "padded"),
])
def test_rows_energy_kernels_match_plain(cuda, kernel, rate, b, ch, group, lengths):
    n = 1129 * 128 if kernel == "K5" else 512 * 128
    if lengths == "many":
        n = 16 * 2048 + 128
    elif kernel == "K3" and lengths is not None:
        n = 2600 * 128
    x = _noise((b, ch, n), rate + b).to(cuda)
    w = tuple(float(v) for v in channel_weights(ch))
    na = sum(1 for v in w if v != 0.0)
    seg = IIR.chain_segment(na) if na <= IIR.TRACK_CHANNELS else IIR.CHAIN_TILE
    if kernel == "K3":
        seg = IIR.k3_segment(ch) if ch <= IIR.K3_TRACK_CHANNELS else IIR.TP_TILE
    nv = torch.tensor(_k5_lengths(lengths, b, n, seg), device=cuda)
    filt = make_block_filter(kweight_cascade_ss(rate), 128, cuda)
    before = launches()
    if kernel == "K3":
        got = IIR.kweight_energy_tp_prefix(filt, x, nv, w, rate, group)
        want = IIR.kweight_energy_tp_prefix_plain(filt, x, nv, w, rate, group)
    elif kernel == "K4":
        got = (IIR.kweight_energy_prefix(filt, x, nv, w, group),)
        want = (IIR.kweight_energy_prefix_plain(filt, x, nv, w, group),)
    else:
        got = (IIR.kweight_energy_chain(filt, x.reshape(b * ch, n), nv, w, group),)
        want = (IIR.kweight_energy_chain_plain(filt, x, nv, w, group),)
    torch.cuda.synchronize()
    assert launches()[kernel] == before[kernel] + 1
    assert got[0].shape == (b, n // group)
    _energy_close(got[0], want[0], (rate + 5) // 10, group)
    if kernel == "K5" or lengths is not None:     # nothing past n_valid, zeros exactly
        past = torch.arange(n // group, device=cuda)[None] * group >= nv[:, None]
        assert bool((got[0][past] == 0).all())
    if kernel == "K3":
        np.testing.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(),
                                   rtol=2e-6, atol=1e-7)
        np.testing.assert_array_equal(got[2].cpu().numpy(), want[2].cpu().numpy())


def test_k5_is_one_k5_tile_launch_and_counts_the_segments_it_skips(cuda):
    """On the chain route K5 is one launch of `k5_tile` and no
    `channel_sum` (the profiler's device records), and a ragged batch adds
    its channel segments that start at or past n_valid to
    `k5.segments_skipped`, and every ticket's channels to `k5.segments`."""
    from torch.profiler import ProfilerActivity, profile

    cfg = MeterConfig(channels=2, rate=48000, max_blocks=0)
    b, n = 512, 30 * 4096
    assert rows_plan(n, b, 2, cfg.rate, cfg.block) == ("chain", True)
    x = _noise((2 * b, n), 13).to(cuda)
    seg = IIR.chain_segment(2)
    lengths = [n - (i % 7) * 3 * seg - (i % 5) * 100 for i in range(b)]
    nv = torch.tensor(lengths, device=cuda)
    nseg = -(-n // seg)
    skipped = 2 * sum(nseg - -(-v // seg) for v in lengths)
    assert skipped > 0
    analyze_batch_native(cfg, x, nv)                  # builds, fills the caches
    torch.cuda.synchronize()
    s0, k0 = GLOBAL.counter("k5.segments_skipped"), GLOBAL.counter("k5.segments")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pad = torch.zeros(1, device=cuda)             # the profiler's first records
        for _ in range(64):
            pad.add_(0.0)
        torch.cuda.synchronize()
        analyze_batch_native(cfg, x, nv)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("k5_tile" in m for m in names) == 1
    assert not any("channel_sum" in m for m in names)
    assert sum("k6_tile" in m for m in names) == 1
    assert GLOBAL.counter("k5.segments_skipped") - s0 == skipped
    assert GLOBAL.counter("k5.segments") - k0 == 2 * b * nseg
    report = GLOBAL.report()["counters"]
    assert report["k5.segments_skipped"] >= skipped and report["k5.segments"] >= 2 * b * nseg


def test_k3_launches_by_channel_count_and_counts_its_track_tickets(cuda):
    """The profiler's device records: a stereo K3 call is one
    `k3_tile_tracks` launch and `peaks_pass`, no `channel_sum`, and adds b
    ceil(N / 4,096) to `k3.track_tickets`; a 5.1 call is `k3_tile_tracks`
    on its rows, `channel_sum` and `peaks_pass`, and adds 0. Both add their
    rows times segments of 8,192 to `k3.segments`, and neither launches
    another kernel with `k3_tile` in its name."""
    from torch.profiler import ProfilerActivity, profile

    n = 100 * 1024
    filt = make_block_filter(kweight_cascade_ss(48000), 128, cuda)
    calls = {}
    for ch in (2, 6):
        x = _noise((3, ch, n), 41 + ch).to(cuda)
        nv = torch.tensor([n, n - 5000, n // 3], device=cuda)
        w = tuple(float(v) for v in channel_weights(ch))
        IIR.kweight_energy_tp_prefix(filt, x, nv, w, 48000, 32)     # builds
        torch.cuda.synchronize()
        t0, s0 = GLOBAL.counter("k3.track_tickets"), GLOBAL.counter("k3.segments")
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            pad = torch.zeros(1, device=cuda)         # the profiler's first records
            for _ in range(64):
                pad.add_(0.0)
            torch.cuda.synchronize()
            IIR.kweight_energy_tp_prefix(filt, x, nv, w, 48000, 32)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        calls[ch] = (sum("k3_tile_tracks" in m for m in names),
                     sum("k3_tile" in m and "k3_tile_tracks" not in m for m in names),
                     sum("channel_sum" in m for m in names), sum("peaks_pass" in m for m in names),
                     GLOBAL.counter("k3.track_tickets") - t0, GLOBAL.counter("k3.segments") - s0)
    nseg = -(-n // IIR.TP_TILE)
    assert calls[2] == (1, 0, 0, 1, 3 * -(-n // 4096), 6 * nseg)
    assert calls[6] == (1, 0, 1, 1, 0, 18 * nseg)
    assert GLOBAL.report()["counters"]["k3.track_tickets"] >= 3 * -(-n // 4096)


def test_k3_track_attributes(cuda):
    """K3's one kernel, `k3_tile_tracks`, whichever ticket it takes: CTAs of
    256 threads, 2 resident per SM, each buffer of its tile one row longer
    than the core's (two channels' halo rows)."""
    for factor in (4, 2):
        attrs = IIR.rows_attributes(factor, IIR.LOOKBACK, tracks=True)
        assert attrs["threads"] == IIR.TP_TILE // 32 and attrs["blocks_per_sm"] >= 2
        assert attrs["dynamic_smem"] == 2 * 16 * 8 * (attrs["threads"] + 2)
        assert attrs == IIR.rows_attributes(factor, IIR.LOOKBACK)


@pytest.mark.parametrize("kernel,rate,group", [("K3", 48000, 32), ("K3", 44100, 1),
                                               ("K4", 48000, 32), ("K4", 44100, 1)])
def test_rows_energy_kernels_on_few_long_rows(cuda, kernel, rate, group):
    """One stereo track of 2^22 samples, ragged: 512 of K3's segments a row
    (1,024 of K4's), past the look-back's depth (256, 128), so each row's
    chain runs through its inclusive states."""
    n = 1 << 22
    x = _noise((1, 2, n), 23).to(cuda)
    x[..., n // 2:] *= 3.0
    nv = torch.tensor([n - 48000 * 3 - 333], device=cuda)
    filt = make_block_filter(kweight_cascade_ss(rate), 128, cuda)
    w = (1.0, 1.0)
    if kernel == "K3":
        got = IIR.kweight_energy_tp_prefix(filt, x, nv, w, rate, group)
        want = IIR.kweight_energy_tp_prefix_plain(filt, x, nv, w, rate, group)
        np.testing.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(),
                                   rtol=2e-6, atol=1e-7)
        np.testing.assert_array_equal(got[2].cpu().numpy(), want[2].cpu().numpy())
    else:
        got = (IIR.kweight_energy_prefix(filt, x, nv, w, group),)
        want = (IIR.kweight_energy_prefix_plain(filt, x, nv, w, group),)
    _energy_close(got[0], want[0], (rate + 5) // 10, group)


def test_k3_batch_invariant_past_2_31_elements(cuda):
    """One stereo track of 2^27 samples (46.6 min at 48 kHz), ragged with
    signal in its padding, through K3 alone and then as the last of 9
    tracks, whose rows x N (18 x 2^27) pass 2^31 elements, so that its rows
    start at element 2^31: z, tp and sp are the same bits, and each launch
    adds its rows times its segments to `k3.segments`."""
    n, b, rate = 1 << 27, 9, 48000
    assert 2 * b * n > 2**31 and 2 * (b - 1) * n == 2**31
    g = torch.Generator(device=cuda)
    g.manual_seed(2**31 + 2201)
    x = torch.empty((b, 2, n), device=cuda).normal_(generator=g).mul_(0.1)
    x[:, :, n // 3: n // 2] *= 20.0                   # a loud stretch beside a quiet one
    nv = torch.tensor([n - 48000 * 7 * i - 333 for i in range(b)], device=cuda)
    filt = make_block_filter(kweight_cascade_ss(rate), 128, cuda)
    w = (1.0, 1.0)
    nseg = -(-n // IIR.TP_TILE)
    k0 = GLOBAL.counter("k3.segments")
    alone = IIR.kweight_energy_tp_prefix(filt, x[b - 1:], nv[b - 1:], w, rate, 32)
    assert GLOBAL.counter("k3.segments") - k0 == 2 * nseg
    batch = IIR.kweight_energy_tp_prefix(filt, x, nv, w, rate, 32)
    assert GLOBAL.counter("k3.segments") - k0 == 2 * nseg + 2 * b * nseg
    torch.cuda.synchronize()
    assert alone[0].shape == (1, n // 32) and batch[0].shape == (b, n // 32)
    for a, got in ((alone[0][0], batch[0][b - 1]), (alone[1], batch[1][-2:]),
                   (alone[2], batch[2][-2:])):
        assert torch.equal(a.view(torch.int32), got.view(torch.int32))
    assert float(alone[1].min()) > 0.0
    assert bool((alone[0][0, -(-int(nv[-1]) // 32):] == 0).all())    # nothing past n_valid


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4", "K5", "K6", "K7"])
def test_kernels_on_nonfinite_input(cuda, kernel):
    """NaN, +Inf, -Inf and the bit pattern 0xFFFFFFFF in the input: the
    launch returns (a child process with a time limit, so a launch that
    waits forever fails instead of stalling the run) and its outputs are
    non-finite exactly where the plain version's are (chip_smoke.py's
    nonfinite_child)."""
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, str(root / "chip_smoke.py"), "--nonfinite", kernel],
                         cwd=root, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert f"phase nonfinite: {kernel} returned" in out.stdout


@pytest.mark.parametrize("rate,n", [(48000, 512 * 20), (96000, 384 * 25),
                                    (44100, 128 * 73), (96000, 3 * 8192 + 1280)])
def test_k6_kernel_matches_plain(cuda, rate, n):
    x = _noise((3, 2, n), rate).to(cuda)
    nv = torch.tensor([n, n - 333, n // 2], device=cuda)
    before = launches()["K6"]
    got = K6.true_peak_stream(x, nv, rate)
    assert launches()["K6"] == before + 1
    want = K6.true_peak_stream_plain(x, nv, rate)
    again = K6.true_peak_stream(x, nv, rate)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                               rtol=2e-6, atol=1e-7)
    np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].cpu().numpy())
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    # factor 1 launches nothing
    K6.true_peak_stream(x, nv, 192000)
    assert launches()["K6"] == before + 2


def test_k6_on_a_library_slice(cuda):
    """32 stereo tracks at the library scan's length (15 s at 48 kHz:
    segments of 8,192 with a partial last one), every other track ending
    3 s early: the segments past its end are skipped."""
    n = 15 * 48000
    x = _noise((64, n), 31).to(cuda)
    x[:, n // 2:] *= 3.0
    nv = torch.full((32,), n, device=cuda)
    nv[1::2] -= 48000 * 3 + 333
    got = K6.true_peak_stream(x, nv, 48000)
    again = K6.true_peak_stream(x, nv, 48000)
    want = K6.true_peak_stream_plain(x, nv, 48000)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                               rtol=2e-6, atol=1e-7)
    np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].cpu().numpy())
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


def test_k6_k7_attributes(cuda):
    for factor in (4, 2):
        a = K6.kernel_attributes(factor)
        assert a["threads"] == K6.TILE // 32 and a["blocks_per_sm"] >= 1
        assert a["dynamic_smem"] == 2 * 16 * 8 * (a["threads"] + 1)
    a = IIR.stream_attributes()
    assert a["threads"] == IIR.CHAIN_TILE // 32 and a["blocks_per_sm"] >= 1
    assert a["dynamic_smem"] == 2 * 16 * 8 * (a["threads"] + 1)


@pytest.mark.parametrize("route,rate,b,ch,launched", [
    ("fused", 48000, 2, 2, {"K3"}),
    ("prefix", 192000, 1, 6, {"K4"}),
    ("chain", 48000, 512, 2, {"K5", "K6"}),
])
def test_rows_plan_routes_launch_their_kernels(cuda, route, rate, b, ch, launched):
    n = {"fused": 64 * 1024, "prefix": 256 * 1024, "chain": 30 * 4096}[route]
    cfg = MeterConfig(channels=ch, rate=rate, max_blocks=0)
    assert rows_plan(n, b, ch, rate, cfg.block)[0] == route
    x = _noise((b, ch, n), 9)
    x[..., n // 2:] *= 3.0
    nv = torch.full((b,), n)
    nv[1::2] -= 777
    base = launches()
    rg = analyze_batch_native(cfg, x.to(cuda).reshape(b * ch, n), nv.to(cuda))
    torch.cuda.synchronize()
    assert {k for k, v in launches(since=base).items() if v} == launched
    rc = analyze_batch_native(cfg, x[:2], nv[:2])
    np.testing.assert_allclose(rg.integrated_lufs[:2].cpu().numpy(),
                               rc.integrated_lufs.numpy(), rtol=0, atol=2e-3)
    np.testing.assert_allclose(rg.true_peak[:2].cpu().numpy(), rc.true_peak.numpy(),
                               rtol=2e-6, atol=1e-7)
    np.testing.assert_array_equal(rg.sample_peak[:2].cpu().numpy(),
                                  rc.sample_peak.numpy())


def test_h2d_counters_equal_the_bytes_one_call_copies(cuda):
    """`h2d.bytes` and `h2d.copies` rise by the host tensors one engine
    call uploads: after the first call at a (rate, block, device), which
    uploads the K-weighting filter once (ops/biquad.kweight_filter), only
    the valid lengths where they come from the host."""
    cfg = MeterConfig(channels=2, rate=48000, max_blocks=0)
    b, n = 4, 64 * 1024
    x = _noise((b, 2, n), 5).to(cuda)
    nv = np.full(b, n - 300, np.int64)
    analyze_batch_native(cfg, x, nv)                 # caches filled
    for lengths, extra in ((torch.from_numpy(nv).to(cuda), []), (nv, [nv.nbytes])):
        bytes0, copies0 = GLOBAL.counter("h2d.bytes"), GLOBAL.counter("h2d.copies")
        analyze_batch_native(cfg, x, lengths)
        torch.cuda.synchronize()
        assert GLOBAL.counter("h2d.bytes") - bytes0 == sum(extra)
        assert GLOBAL.counter("h2d.copies") - copies0 == len(extra)


def test_library_shaped_calls_count_one_k5_and_one_k6_each(cuda):
    """A call of library shape (the chain route: at least CHAIN_MIN_ROWS
    rows) adds one to `launch.K5` and one to `launch.K6`, and nothing to
    the other kernels."""
    cfg = MeterConfig(channels=2, rate=48000, max_blocks=0)
    b, n = 512, 30 * 4096
    x = _noise((2 * b, n), 11).to(cuda)
    nv = torch.full((b,), n, device=cuda)
    assert rows_plan(n, b, 2, cfg.rate, cfg.block) == ("chain", True)
    base = launches()
    for i in range(1, 3):
        analyze_batch_native(cfg, x, nv)
        assert launches(since=base) == {**dict.fromkeys(base, 0), "K5": i, "K6": i}
    torch.cuda.synchronize()


def test_rows_wrappers_raise_on_what_they_cannot_launch(cuda):
    filt = make_block_filter(kweight_cascade_ss(48000), 128, cuda)
    x = torch.zeros((1, 2, 1000), device=cuda)                  # N % 128
    nv = torch.tensor([1000], device=cuda)
    w = (1.0, 1.0)
    for fn in (IIR.kweight_energy_prefix, IIR.kweight_energy_chain):
        with pytest.raises(ValueError):
            fn(filt, x, nv, w)
    for fn in (IIR.kweight_energy_chain, IIR.kweight_energy_prefix):   # g must divide 32
        with pytest.raises(ValueError):
            fn(filt, torch.zeros((1, 2, 1024), device=cuda), nv, w, 64)
    with pytest.raises(ValueError):
        IIR.kweight_energy_tp_prefix(filt, torch.zeros((1, 2, 1024), device=cuda), nv, w,
                                     48000, 64)
    with pytest.raises(ValueError):
        IIR.kweight_energy_tp_prefix(filt, x, nv, w, 48000)
    xt = torch.zeros((1, 1024, 2), device=cuda).transpose(1, 2)  # not contiguous
    with pytest.raises(ValueError):
        IIR.kweight_energy_prefix(filt, xt, nv, w)
    with pytest.raises(ValueError):
        K6.true_peak_stream(xt, 1024, 48000)


@pytest.mark.parametrize("shape", [(2, 1), (2, 7), (2, 333), (2, 800), (1, 1024),
                                   (3, 2, 2048), (2, 44100), (6, 192000)])
def test_k7_kernel_matches_plain(cuda, shape):
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
    s0 = torch.from_numpy(
        (rng.standard_normal((*shape[:-1], 4)) * 0.5).astype(np.float32)).to(cuda)
    filt = make_block_filter(kweight_cascade_ss(48000), 128, cuda)
    before = launches()["K7"]
    y, s = IIR.block_iir_stream(filt, x, s0)
    assert launches()["K7"] == before + 1
    yp, sp = IIR.block_iir_stream_plain(filt, x, s0)
    torch.cuda.synchronize()
    assert y.shape == x.shape and s.shape == s0.shape
    assert float((y - yp).abs().max()) < 2e-5
    assert float((s - sp).abs().max()) < 2e-5
    # the zero-state entry is the Pallas kernel's counterpart
    yz = IIR.block_iir_zero(filt, x)
    yzp, _ = IIR.block_iir_stream_plain(filt, x, torch.zeros_like(s0))
    assert float((yz - yzp).abs().max()) < 2e-5


@pytest.mark.parametrize("rate,shape", [(48000, (2, 800)), (44100, (2, 44100)),
                                        (192000, (6, 192000))])
def test_k7_reads_a_strided_view(cuda, rate, shape):
    """The meter's channels of interleaved audio (sample stride C, channel c
    4c bytes in) from a random carried state: within the pin of the plain
    version, the same bits as the contiguous copy and as a second launch."""
    c, n = shape
    rng = np.random.default_rng(n + c)
    inter = torch.from_numpy(rng.standard_normal(c * n).astype(np.float32)).to(cuda)
    view = inter.reshape(n, c).T
    s0 = torch.from_numpy((rng.standard_normal((c, 4)) * 0.5).astype(np.float32)).to(cuda)
    filt = make_block_filter(kweight_cascade_ss(rate), 128, cuda)
    y1, s1 = IIR.block_iir_stream(filt, view, s0)
    y2, s2 = IIR.block_iir_stream(filt, view.contiguous(), s0)
    y3, s3 = IIR.block_iir_stream(filt, view, s0)
    yp, sp = IIR.block_iir_stream_plain(filt, view, s0)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(s1, s2)
    assert torch.equal(y1, y3) and torch.equal(s1, s3)
    rms = float(inter.pow(2).mean().sqrt())
    assert float((y1 - yp).abs().max()) < 2e-5 * rms
    assert float((s1 - sp).abs().max()) < 2e-5 * rms


@pytest.mark.parametrize("max_blocks", [1000, 0])
def test_meter_push_on_card_matches_cpu(cuda, max_blocks):
    """One stream of pushes on the card (each through K7, none waiting for
    the device) against the same pushes on the CPU."""
    cfg = MeterConfig(channels=2, rate=48000, max_blocks=max_blocks)
    x = _noise((2, 48000 * 5), 77)
    x[:, 48000 * 2:] *= 4.0
    step = M.meter_step(cfg)
    sc, sg = init_meter_state(cfg, "cpu"), init_meter_state(cfg, cuda)
    xg = x.to(cuda)
    before = launches()["K7"]
    pos, sizes, i = 0, [16384, 1000, 333, 4800, 48000], 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        while pos < x.shape[1]:
            size = min(sizes[i % len(sizes)], x.shape[1] - pos)
            sg = step(sg, xg[:, pos:pos + size])
            pos, i = pos + size, i + 1
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert launches()["K7"] == before + i
    pos = 0
    for k in range(i):
        size = min(sizes[k % len(sizes)], x.shape[1] - pos)
        sc = step(sc, x[:, pos:pos + size])
        pos += size
    for f in ("subblocks_done", "block_count", "lra_count", "block_hist", "lra_hist",
              "z_pos", "frames_total"):
        assert torch.equal(getattr(sg, f).cpu(), getattr(sc, f)), f
    for q in ("integrated_lufs", "shortterm_lufs", "momentary_lufs", "loudness_range_lu"):
        assert abs(float(getattr(M, q)(cfg, sg)) - float(getattr(M, q)(cfg, sc))) < 1e-3, q
    np.testing.assert_allclose(sg.true_peak.cpu().numpy(), sc.true_peak.numpy(), atol=1e-6)


def test_live_push_and_frame_on_card(cuda):
    cfg = MeterConfig(channels=2, rate=48000, max_blocks=0)
    lg = LiveAnalyzer(cfg, seconds=2, device=cuda)
    lc = LiveAnalyzer(cfg, seconds=2, device="cpu")
    x = _noise((2 * 48000 * 3,), 78)
    xg = x.to(cuda)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for lo in range(0, x.shape[0], 1600):
            lg.push(xg[lo:lo + 1600])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for lo in range(0, x.shape[0], 1600):
        lc.push(x[lo:lo + 1600])
    fg, fc = lg.frame(), lc.frame()
    np.testing.assert_array_equal(fg.wf_min, fc.wf_min)
    np.testing.assert_array_equal(fg.wf_max, fc.wf_max)
    assert abs(float(fg.shortterm) - float(fc.shortterm)) < 1e-3
    near = fc.fft_mid > fc.fft_mid.max() - 40.0
    np.testing.assert_allclose(fg.fft_mid[near], fc.fft_mid[near], atol=1e-3)


def test_states_default_to_the_card(cuda, tmp_path):
    """With no device given, states, checkpoints and the whole-file entry
    land on the card."""
    cfg = MeterConfig(channels=2, rate=48000, max_blocks=100)
    state = init_meter_state(cfg)
    live = init_live_state(cfg, 1)
    assert {t.device.type for t in vars(state).values()} == {"cuda"}
    assert live.ring.is_cuda and live.pos.is_cuda and live.meter.z_ring.is_cuda
    state = M.meter_step(cfg)(state, _noise((2, 4800), 80).to(cuda))
    CK.save_meter(str(tmp_path / "m.npz"), cfg, state)
    CK.save_live(str(tmp_path / "l.npz"), cfg, live, 1)
    _, loaded = CK.load_meter(str(tmp_path / "m.npz"))
    assert {t.device.type for t in vars(loaded).values()} == {"cuda"}
    assert torch.equal(loaded.z_ring, state.z_ring)
    _, _, lloaded = CK.load_live(str(tmp_path / "l.npz"))
    assert lloaded.ring.is_cuda and lloaded.meter.block_hist.is_cuda
    res = analyze_array(_noise((2, 48000), 81).numpy(), cfg)
    assert res.integrated_lufs.is_cuda


def test_get_waveform_decimates_on_the_card(cuda, monkeypatch):
    """A CUDA tensor is decimated where it lies, and a NumPy array on the
    card by default; the points equal the CPU's exactly."""
    seen = []
    plain = decimate.minmax_decimate

    def spy(samples, window_secs):
        seen.append(samples.device.type)
        return plain(samples, window_secs)

    monkeypatch.setattr(decimate, "minmax_decimate", spy)
    x = _noise((44100,), 82)
    on_card = Analyzer.get_waveform(x.to(cuda), 15.0)
    from_host = Analyzer.get_waveform(x.numpy(), 15.0)
    on_cpu = Analyzer.get_waveform(x.numpy(), 15.0, device="cpu")
    assert seen == ["cuda", "cuda", "cpu"]
    assert on_card.shape == (30000, 2)
    np.testing.assert_array_equal(on_card, on_cpu)
    np.testing.assert_array_equal(from_host, on_cpu)


def test_tui_file_mode_launches_k3_then_k7_per_frame(cuda, tmp_path):
    """The TUI's App on the card (device=None): opening a file runs the
    whole-file engine once (K3), each analysis frame one K7 push."""
    from soundscope_tpu_torch.apps.player import AudioPlayer
    from soundscope_tpu_torch.apps.tui import App
    from soundscope_tpu_torch.utils.io import write_wav

    t = np.arange(48000 * 4) / 48000
    tone = (10 ** (-23 / 20) * np.sin(2 * np.pi * 997.0 * t)).astype(np.float32)
    song = str(tmp_path / "tone.wav")
    write_wav(song, np.stack([tone, tone]), 48000, bits=32)
    app = App(player=AudioPlayer(sink_factory=None), config_dir=str(tmp_path / "cfg"))
    cpu = App(player=AudioPlayer(sink_factory=None), config_dir=str(tmp_path / "cfg"),
              device="cpu")
    try:
        assert app.device.type == "cuda" and app.file_analyzer.device.type == "cuda"
        base = launches()
        app.select_audio_file(song)
        assert launches(since=base)["K3"] == 1 and app.audio_file is not None
        cpu.select_audio_file(song)
        np.testing.assert_array_equal(app.file_waveform, cpu.file_waveform)
        assert abs(app.fft_gain_db - cpu.fft_gain_db) < 1e-3
        base = launches()
        start = 16384                                  # a full window exists
        for k in range(10):
            app.analyze_audio_file_samples(start + 2 + 2048 * k)
        assert launches(since=base)["K7"] == 10
        for k in range(10):
            cpu.analyze_audio_file_samples(start + 2 + 2048 * k)
        np.testing.assert_allclose(app.lufs, cpu.lufs, rtol=0, atol=1e-3)
        near = cpu.fft_mid[:, 1] > cpu.fft_mid[:, 1].max() - 40.0
        np.testing.assert_allclose(app.fft_mid[near], cpu.fft_mid[near], rtol=0, atol=1e-3)
    finally:
        app.handle_key("q")
        cpu.handle_key("q")


def test_tui_mic_mode_runs_the_live_pipeline_on_card(cuda, tmp_path):
    from soundscope_tpu_torch.apps.player import AudioPlayer
    from soundscope_tpu_torch.apps.tui import App, Mode

    app = App(player=AudioPlayer(sink_factory=None), config_dir=str(tmp_path / "cfg"))
    try:
        app.handle_key("m")
        assert app.mode == Mode.MICROPHONE and app.live is not None
        assert app.live_ready.wait(timeout=600) and app.live_error is None
        assert app.live.state.ring.is_cuda
        app.stream.stop()
        t = np.arange(44100 * 2) / 44100
        pseudo = np.zeros(2 * len(t), np.float32)
        pseudo[0::2] = 0.4 * np.sin(2 * np.pi * 700.0 * t)
        base = launches()
        app.ring.push(pseudo)
        consumed = app._live_consumed
        app.analyze_microphone_input()
        assert launches(since=base)["K7"] == (app._live_consumed - consumed) // 2048 > 0
        peak_x = app.fft_mid[np.argmax(app.fft_mid[:, 1]), 0]
        expect = (np.log10(700) - np.log10(20)) / (np.log10(20000) - np.log10(20)) * 100
        assert abs(peak_x - expect) < 2.0
    finally:
        app.handle_key("q")


def test_cli_analyze_flac_launches_k1_and_k2(cuda, tmp_path):
    import io
    import json
    from contextlib import redirect_stdout

    from soundscope_tpu_torch.apps import cli
    from soundscope_tpu_torch.utils.flacenc import write_flac

    rng = np.random.default_rng(90)
    files = []
    for i in range(3):
        files.append(str(tmp_path / f"n{i}.flac"))
        write_flac(files[-1], (rng.standard_normal((2, 48000 * 2)) * 0.1).astype(np.float32),
                   48000)
    base = launches()
    out = io.StringIO()
    with redirect_stdout(out):
        rc = cli.main(["analyze", *files, "--json", "--spectrogram", str(tmp_path / "spec")])
    rows = json.loads(out.getvalue())
    assert rc == 0 and [r["file"] for r in rows] == files
    assert launches(since=base)["K1"] == 1 and launches(since=base)["K2"] == 1   # one bucket
    for r in rows:
        assert r["integrated_lufs"] is not None and np.load(r["spectrogram"])["mid_db"].size


@pytest.mark.parametrize("rate", [48000, 44100])
def test_conformance_sweep_on_the_card(cuda, rate):
    """Every route of tools/conformance.py launches its kernels and meets
    the budgets against the float64 chain (0.1 LU, 0.1 dB true peak,
    0.1 dB display spectrum)."""
    from soundscope_tpu_torch.tools import conformance

    report = conformance.sweep(levels=4, rate=rate, device=cuda, stft_windows=2)
    assert report["pass"], report
    assert report["not_launched"] == []
    for route, kernels in conformance.ROUTES.items():
        assert all(report["routes"][route]["launches"].get(k, 0) >= 1 for k in kernels)


def test_library_scan_bench_on_the_card(cuda, capsys):
    """tools/library_scan_bench.py at 16 x 2 s on its default device, the
    card: one JSON line naming the card, finite positive figures, and the
    scan through the rows kernels (32 rows: K3)."""
    import json

    from soundscope_tpu_torch.tools import library_scan_bench

    base = launches()
    assert library_scan_bench.main(["16", "2", "--repeats", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == "library_scan_rt_factor" and line["tracks"] == 16
    assert line["device"] == torch.cuda.get_device_name(cuda)
    for k in ("scan_ms", "rt_factor", "tracks_per_sec"):
        assert np.isfinite(line[k]) and line[k] > 0
    assert sum(launches(since=base)[k] for k in ("K3", "K4", "K5", "K7")) >= 1
