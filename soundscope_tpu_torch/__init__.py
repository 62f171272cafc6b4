"""soundscope_tpu_torch — the PyTorch/CUDA port of ``soundscope_tpu``.

The whole-file analysis of the JAX package, written in PyTorch, with the
Pallas kernels it runs rewritten by hand in CUDA C++ for Hopper
(``sm_90a``):

* K1 ``ops/iir_chunked.py`` + ``csrc/iir_chunked.cu``: K-weighting IIR,
  channel-weighted energy split at the 100 ms boundaries, and the fused
  polyphase true peak and sample peak, on the frames view;
* K2 ``ops/stft_pooled.py`` + ``csrc/stft_pooled.cu``: the pooled
  128-band mid/side dB display spectrogram;
* K3, K4, K5 ``ops/iir.py`` + ``csrc/iir_rows.cu``: the channel-weighted
  K-weighted energy on the (b, ch, N) / rows layout, K3 with the peaks;
* K6 ``ops/truepeak_stream.py`` + ``csrc/truepeak_stream.cu``: the
  streaming true peak and sample peak.

Each kernel has a plain PyTorch version beside it. Which one runs is
decided by the input tensor's device alone: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel (built with ``nvcc`` at first
use, see ``ops/_build.py``) or raises.

Layout mirrors the reference package:
  core/    constants and the meter configuration
  ops/     DSP functions and the kernels' wrappers
  models/  the whole-file analysis engine
  apps/    the batch CLI (``analyze`` / ``scan``)
  utils/   conversion of the JAX package's parameters (tests)
  csrc/    CUDA sources

This package never imports ``jax``, ``flax`` or ``soundscope_tpu``.
"""

__version__ = "0.1.0"

from soundscope_tpu_torch.core.config import MeterConfig  # noqa: E402,F401
