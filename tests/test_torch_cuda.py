"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and skip without one. They import neither
JAX nor the JAX package, so on a machine without JAX they run with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances are the CPU parity pins: K1 sub-block sums rtol 3e-4 / atol
2e-5, true peak rtol 2e-6 / atol 1e-7, sample peak exact; K2 1e-3 dB;
K3-K5 z per group rtol 1e-3 / atol 1e-6 * max|z| and sub-block sums as
K1's; K6 as K1's peaks.
"""

import numpy as np
import pytest
import torch

from soundscope_tpu_torch.core.config import MeterConfig
from soundscope_tpu_torch.models.engine import analyze_batch_native, rows_plan
from soundscope_tpu_torch.ops import iir as IIR
from soundscope_tpu_torch.ops import iir_chunked as K1
from soundscope_tpu_torch.ops import stft_pooled as K2
from soundscope_tpu_torch.ops import truepeak_stream as K6
from soundscope_tpu_torch.ops.biquad import make_block_filter
from soundscope_tpu_torch.ops.kweight import channel_weights, kweight_cascade_ss


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


@pytest.mark.parametrize("rate,b,ragged", [(48000, 3, True), (44100, 3, True),
                                           (96000, 2, False), (192000, 1, False)])
def test_k1_kernel_matches_plain(cuda, rate, b, ragged):
    n = 512 * 128
    h = (rate + 5) // 10
    x4 = _noise((b, 2, 512, 128), rate).to(cuda)
    nv = torch.tensor([n, n - 700, n // 2][:b] if ragged else [n] * b, device=cuda)
    filt = make_block_filter(kweight_cascade_ss(rate), 128, cuda)
    before = K1.LAUNCHES
    got = K1.kweight_energy_tp_chunked(filt, x4, nv, (1.0, 1.0), rate, h)
    assert K1.LAUNCHES == before + 1
    want = K1.kweight_energy_tp_chunked_plain(filt, x4, nv, (1.0, 1.0), rate, h)
    torch.cuda.synchronize()
    span = K1.step_length(n, h)
    sums = [K1.subblock_sums_from_steps(s, h, span, n).cpu().numpy()
            for s in (got[0], want[0])]
    np.testing.assert_allclose(sums[0], sums[1], rtol=3e-4, atol=2e-5)
    np.testing.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(),
                               rtol=2e-6, atol=1e-7)
    np.testing.assert_array_equal(got[2].cpu().numpy(), want[2].cpu().numpy())


@pytest.mark.parametrize("rate", [48000, 44100, 96000])
def test_k2_kernel_matches_plain(cuda, rate):
    fr = _noise((2, 2, 16 * 40, 128), rate).to(cuda) * 3.0
    before = K2.LAUNCHES
    got = K2.stft_pooled_frames(fr, rate)
    assert K2.LAUNCHES == before + 1
    want = K2.stft_pooled_frames_plain(fr, rate)
    assert got[0].shape == want[0].shape == (2, 33, 128)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) < 1e-3


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


@pytest.mark.parametrize("kernel,rate,b,ch,group", [
    ("K3", 48000, 3, 2, 32), ("K3", 44100, 3, 2, 1), ("K3", 96000, 2, 6, 32),
    ("K4", 48000, 3, 2, 32), ("K4", 44100, 3, 2, 1), ("K4", 192000, 1, 6, 32),
    ("K5", 48000, 3, 2, 32), ("K5", 44100, 3, 2, 1), ("K5", 192000, 2, 6, 32),
])
def test_rows_energy_kernels_match_plain(cuda, kernel, rate, b, ch, group):
    n = 1129 * 128 if kernel == "K5" else 512 * 128
    x = _noise((b, ch, n), rate + b).to(cuda)
    nv = torch.tensor([n, n - 700, n // 2][:b], device=cuda)
    filt = make_block_filter(kweight_cascade_ss(rate), 128, cuda)
    w = tuple(float(v) for v in channel_weights(ch))
    before = dict(IIR.LAUNCHES)
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
    assert IIR.LAUNCHES[kernel] == before[kernel] + 1
    assert got[0].shape == (b, n // group)
    _energy_close(got[0], want[0], (rate + 5) // 10, group)
    if kernel == "K3":
        np.testing.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(),
                                   rtol=2e-6, atol=1e-7)
        np.testing.assert_array_equal(got[2].cpu().numpy(), want[2].cpu().numpy())


@pytest.mark.parametrize("rate,n", [(48000, 512 * 20), (96000, 384 * 25),
                                    (44100, 128 * 73)])
def test_k6_kernel_matches_plain(cuda, rate, n):
    x = _noise((3, 2, n), rate).to(cuda)
    nv = torch.tensor([n, n - 333, n // 2], device=cuda)
    before = K6.LAUNCHES
    got = K6.true_peak_stream(x, nv, rate)
    assert K6.LAUNCHES == before + 1
    want = K6.true_peak_stream_plain(x, nv, rate)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                               rtol=2e-6, atol=1e-7)
    np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].cpu().numpy())
    # factor 1 launches nothing
    K6.true_peak_stream(x, nv, 192000)
    assert K6.LAUNCHES == before + 1


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
    IIR.LAUNCHES.update(K3=0, K4=0, K5=0)
    K6.LAUNCHES = 0
    rg = analyze_batch_native(cfg, x.to(cuda).reshape(b * ch, n), nv.to(cuda))
    torch.cuda.synchronize()
    counts = {**IIR.LAUNCHES, "K6": K6.LAUNCHES}
    assert {k for k, v in counts.items() if v} == launched
    rc = analyze_batch_native(cfg, x[:2], nv[:2])
    np.testing.assert_allclose(rg.integrated_lufs[:2].cpu().numpy(),
                               rc.integrated_lufs.numpy(), rtol=0, atol=2e-3)
    np.testing.assert_allclose(rg.true_peak[:2].cpu().numpy(), rc.true_peak.numpy(),
                               rtol=2e-6, atol=1e-7)
    np.testing.assert_array_equal(rg.sample_peak[:2].cpu().numpy(),
                                  rc.sample_peak.numpy())


def test_rows_wrappers_raise_on_what_they_cannot_launch(cuda):
    filt = make_block_filter(kweight_cascade_ss(48000), 128, cuda)
    x = torch.zeros((1, 2, 1000), device=cuda)                  # N % 128
    nv = torch.tensor([1000], device=cuda)
    w = (1.0, 1.0)
    for fn in (IIR.kweight_energy_prefix, IIR.kweight_energy_chain):
        with pytest.raises(ValueError):
            fn(filt, x, nv, w)
    with pytest.raises(ValueError):
        IIR.kweight_energy_tp_prefix(filt, x, nv, w, 48000)
    xt = torch.zeros((1, 1024, 2), device=cuda).transpose(1, 2)  # not contiguous
    with pytest.raises(ValueError):
        IIR.kweight_energy_prefix(filt, xt, nv, w)
    with pytest.raises(ValueError):
        K6.true_peak_stream(xt, 1024, 48000)
