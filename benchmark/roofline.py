"""The least time the H100 could take for each kernel's work at the cells'
shapes: the yardstick of the `<kernel>_roofline` metrics.

Work is counted from the shapes, as soundscope_tpu_torch/bench.py
(`FILTER_OPS`, `ENERGY_OPS`, `FFT_WINDOW_OPS`, `fir_ops`, `main_path_work`,
lines 54-86) and chip_smoke.py's bounds (lines 2471-2481) count it, frozen
here: each input byte read once, each output byte written once, and the
float32 operations the function needs (an FMA counting two).

The peaks are split by the unit that could do the work (NVIDIA's H100 SXM
data sheet, dense, at the 700 W limit):

* bytes against the HBM's 3.35 TB/s;
* the K-filter's recurrence, the weighted square and the elementwise work
  against 67 TFLOP/s of float32 outside the tensor cores;
* the polyphase FIR and the FFT with its window, linear maps that a
  float32-accurate tensor-core build (three TF32 products each) could take
  at a third of 495 TFLOP/s: against 165 TFLOP/s.

The least time is the largest of the three: the units run side by side, so
no honest implementation can beat any one of them, and a share read above
100 % means the work is counted too high or the time misses part of it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TC_OPS_PER_S = 495e12 / 3

# float32 operations per sample (bench.py lines 54-62): the 4-state modal
# filter (advance: 4 multiplies + 8 FMAs; output: 1 multiply + 4 FMAs), the
# weighted square added to a sum, and the polyphase FIR over the phases
# other than phase 0 (a unit impulse) and their nonzero taps
FILTER_OPS = 29
ENERGY_OPS = 3
# one packed complex 16,384-point FFT (5 N log2 N) and the window
FFT_WINDOW_OPS = 5 * 16384 * 14 + 6 * 16384
WIN, HOP, BANDS = 16384, 2048, 128
FACTOR = 4          # true-peak oversampling below 96 kHz
GROUP = 32          # samples per entry of K5's z at 48 kHz


def fir_ops(factor: int) -> int:
    """bench.py line 65."""
    return {1: 0, 2: 2 * 1 * 24, 4: 2 * 3 * 12}[factor]


def least_s(nbytes: float, f32_ops: float = 0.0, tc_ops: float = 0.0) -> float:
    return max(nbytes / HBM_BYTES_PER_S, f32_ops / F32_OPS_PER_S, tc_ops / TC_OPS_PER_S)


def k1(b: int, n: int) -> float:
    """K1 on b stereo tracks of n samples (bench.py main_path_work)."""
    s = b * 2 * n
    return least_s(4 * s, s * (FILTER_OPS + ENERGY_OPS), s * fir_ops(FACTOR))


def k2(b: int, n: int) -> float:
    """K2 on b stereo tracks of n samples: the input read once, both dB
    spectrograms written once (bench.py main_path_work)."""
    nw = max(n // HOP - WIN // HOP + 1, 0)
    return least_s(4 * b * 2 * n + 4 * b * nw * BANDS * 2, 0.0, b * nw * FFT_WINDOW_OPS)


def k5(valid: int) -> float:
    """K5 on stereo tracks whose valid lengths sum to `valid` samples
    (chip_smoke.py line 2478: every valid sample read, z of one entry per
    32 valid samples of a track written)."""
    s = 2 * valid
    return least_s(4 * (s + valid // GROUP), s * (FILTER_OPS + ENERGY_OPS))


def k6(valid: int, tracks: int) -> float:
    """K6 on `tracks` stereo tracks whose valid lengths sum to `valid`
    samples (chip_smoke.py line 2479: every valid sample read, a true and a
    sample peak written per row)."""
    s = 2 * valid
    return least_s(4 * (s + 2 * 2 * tracks), 0.0, s * fir_ops(FACTOR))
