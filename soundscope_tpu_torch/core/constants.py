"""Constants of the BS.1770-4 / EBU R128 loudness standard and of the
reference display pipeline.

The filter prototypes below are the published ITU-R BS.1770-4 pre-filter
(stage 1 high-shelf) and RLB weighting (stage 2 high-pass) analog
parameters, as documented in the standard and in the libebur128 design
notes; they are re-discretised for arbitrary sample rates via the
bilinear transform in :mod:`soundscope_tpu.ops.kweight`.

Display-pipeline constants pin the reference's public behavior
(reference: src/analyzer.rs:11-104, src/tui.rs:49-51).
"""

# --- BS.1770-4 K-weighting analog prototypes -------------------------------
# Stage 1: high-shelf ("head" pre-filter).
KW_SHELF_F0_HZ = 1681.974450955533
KW_SHELF_GAIN_DB = 3.999843853973347
KW_SHELF_Q = 0.7071752369554196
# Exponent relating the band gain to the high-shelf gain in the standard
# discretisation of the shelf.
KW_SHELF_VB_EXP = 0.4996667741545416

# Stage 2: RLB high-pass.
KW_HIPASS_F0_HZ = 38.13547087602444
KW_HIPASS_Q = 0.5003270373238773

# Loudness offset: L = -0.691 + 10*log10(sum_ch w_ch * mean(y_ch^2))
LOUDNESS_OFFSET_DB = -0.691

# --- Gating (BS.1770-4 §4 / EBU R128) ---------------------------------------
ABSOLUTE_GATE_LUFS = -70.0
RELATIVE_GATE_LU = -10.0        # integrated loudness relative gate
LRA_RELATIVE_GATE_LU = -20.0    # EBU Tech 3342 loudness-range relative gate
LRA_LOW_PERCENTILE = 0.10
LRA_HIGH_PERCENTILE = 0.95

# --- Block structure ---------------------------------------------------------
# Gating blocks: 400 ms with 75% overlap => new block every 100 ms.
SUBBLOCK_MS = 100
MOMENTARY_SUBBLOCKS = 4     # 400 ms momentary window
SHORTTERM_SUBBLOCKS = 30    # 3 s short-term window
# LRA short-term blocks: 3 s window, 1 s hop (libebur128 behavior: the
# short-term history for the loudness range is appended once per second).
LRA_HOP_SUBBLOCKS = 10

# --- Channel weights ---------------------------------------------------------
# BS.1770-4 channel weights: L/R/C (and dual mono) = 1.0,
# surround (Ls/Rs) = 1.41, LFE excluded.
SURROUND_WEIGHT = 1.41

# --- True peak ----------------------------------------------------------------
# BS.1770-4 Annex 2: measure true peak over a signal oversampled to
# >= 192 kHz. Oversampling factor by input rate (matches the reference's
# ebur128 backend): 4x below 96 kHz, 2x below 192 kHz, none above.
TRUE_PEAK_TAPS = 49  # Hann-windowed-sinc interpolator length


def true_peak_factor(rate: int) -> int:
    if rate < 96000:
        return 4
    if rate < 192000:
        return 2
    return 1


# --- Histogram-mode gating (unbounded-duration streaming) --------------------
# Energy histogram over loudness in [-70, +10) LUFS. 0.08 LU per bin keeps
# the worst-case quantisation (<0.04 LU) far inside the 0.1 LU budget.
HIST_MIN_LUFS = -70.0
HIST_MAX_LUFS = 10.0
HIST_BINS = 1000

# --- Reference display pipeline (src/analyzer.rs:11-104, src/tui.rs:49-51) ---
SPECTRUM_FMIN_HZ = 20.0
SPECTRUM_FMAX_HZ = 20000.0
SPECTRUM_CHART_WIDTH = 100.0
SPECTRUM_FLOOR_DB = -150.0        # zero-magnitude bins
PINK_SLOPE_DB_PER_DECADE = 10.0   # +3 dB/octave pink-noise compensation
PINK_REF_FREQ_HZ = 1000.0
FFT_TARGET_LUFS = -13.0           # loudness-matched spectrum gain target
DEFAULT_FFT_SIZE = 16384          # reference feeds 2^14-sample windows

# --- Defaults -----------------------------------------------------------------
DEFAULT_RATE = 44100
DEFAULT_CHANNELS = 2
CAPTURE_RING_SECONDS = 30         # reference: 30 s microphone ring buffer


def samples_in_100ms(rate: int) -> int:
    """Sub-block length in samples (libebur128-compatible rounding)."""
    return (rate + 5) // 10
