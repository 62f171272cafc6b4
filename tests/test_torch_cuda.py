"""The port's CUDA kernels against their plain versions, on the card.

These tests need an NVIDIA GPU and skip without one. They import neither
JAX nor the JAX package, so on a machine without JAX they run with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances are the CPU parity pins: K1 sub-block sums rtol 3e-4 / atol
2e-5, true peak rtol 2e-6 / atol 1e-7, sample peak exact; K2 1e-3 dB.
"""

import numpy as np
import pytest
import torch

from soundscope_tpu_torch.core.config import MeterConfig
from soundscope_tpu_torch.models.engine import analyze_batch_native
from soundscope_tpu_torch.ops import iir_chunked as K1
from soundscope_tpu_torch.ops import stft_pooled as K2
from soundscope_tpu_torch.ops.biquad import make_block_filter
from soundscope_tpu_torch.ops.kweight import kweight_cascade_ss


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
