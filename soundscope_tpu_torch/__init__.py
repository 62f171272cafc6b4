"""soundscope_tpu_torch — the PyTorch/CUDA port of ``soundscope_tpu``.

The whole-file analysis and the streaming meter of the JAX package,
written in PyTorch, with every Pallas kernel rewritten by hand in CUDA C++
for Hopper (``sm_90a``):

* K1 ``ops/iir_chunked.py`` + ``csrc/iir_chunked.cu``: K-weighting IIR,
  channel-weighted energy split at the 100 ms boundaries, and the fused
  polyphase true peak and sample peak, on the frames view;
* K2 ``ops/stft_pooled.py`` + ``csrc/stft_pooled.cu``: the pooled
  128-band mid/side dB display spectrogram;
* K3, K4, K5 ``ops/iir.py`` + ``csrc/iir_rows.cu``: the channel-weighted
  K-weighted energy on the (b, ch, N) / rows layout, K3 with the peaks;
* K6 ``ops/truepeak_stream.py`` + ``csrc/truepeak_stream.cu``: the
  streaming true peak and sample peak;
* K7 ``ops/iir.py:block_iir_stream`` + ``csrc/block_iir.cu``: the
  K-weighting filter with carried state, once per meter push.

K1, K3, K4, K5 and K7 run the tile-scan core ``csrc/iir_tile.cuh`` (host
side ``ops/iir_tile.py``); K6 walks the same shared-memory tiles without
the scan.

Each kernel has a plain PyTorch version beside it. Which one runs is
decided by the input tensor's device alone: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel (built with ``nvcc`` at first
use, see ``ops/_build.py``) or raises. The entry points that build
tensors (``Analyzer``, ``LiveAnalyzer``, ``init_meter_state``,
``analyze_array``, the checkpoint loaders) put them on the card when
there is one, unless the caller passes ``device="cpu"``.

Layout mirrors the reference package:
  core/    constants, the meter configuration and state, devices
  ops/     DSP functions and the kernels' wrappers
  models/  the whole-file engine (engine.py), the streaming meter
           (meter.py), the ``Analyzer`` facade (analyzer.py) and the live
           mic/player pipeline (live.py)
  apps/    the CLI (cli.py: ``analyze`` / ``scan`` through a pipelined
           decode pool, ``tui``, ``themes``; a bare path opens the TUI),
           the curses TUI (tui.py) on ``Analyzer`` and ``LiveAnalyzer``,
           its screen and charts (render.py), themes (themes.py), the
           player and its transport (player.py), capture (capture.py) and
           the PulseAudio binding (pulse.py)
  native/  the C++ decoders (WAV, FLAC, MPEG audio, ALAC, Vorbis, AAC, the
           libav codec bridge) and the capture ring, bound with ctypes;
           built with the host's C++ compiler at first use
  utils/   host audio decode dispatch (io.py), the FLAC encoder
           (flacenc.py), test signals (synth.py), RT-factor counters and
           torch.profiler traces (metrics.py), checkpoints (checkpoint.py),
           and conversion of the JAX package's parameters and states
           (params.py)
  csrc/    CUDA sources

This package never imports ``jax``, ``flax`` or ``soundscope_tpu``.
"""

__version__ = "0.1.0"

from soundscope_tpu_torch.core.config import MeterConfig  # noqa: E402,F401


def __getattr__(name):
    # lazy, to keep `import soundscope_tpu_torch` cheap and cycle-free
    if name == "Analyzer":
        from soundscope_tpu_torch.models.analyzer import Analyzer

        return Analyzer
    raise AttributeError(name)
