#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --nonfinite K3     (one kernel on non-finite input)
    python3 chip_smoke.py --k2-times DIR     (K2's timings of the port in DIR)
    python3 chip_smoke.py --k7-times DIR     (K7's timings of the port in DIR)

Phases, in order (any failure exits non-zero before the result line):

1. CUDA present; build the kernels (K1-K7) from soundscope_tpu_torch/csrc.
2. K1's resources (registers, shared memory, spills, CTAs per SM), then
   K1 against its plain PyTorch version on the card: the CPU tests' cases
   (48 kHz and 44.1 kHz ragged, 96 kHz, 192 kHz ragged with its tiles of
   16,384 samples) and the bench shape (32 tracks x
   60 s of 48 kHz stereo): sub-block sums rtol 3e-4 / atol 2e-5, true peak
   rtol 2e-6 / atol 1e-7, sample peak exact; two launches at the bench
   shape bit-identical.
3. K2's resources (registers, shared memory, spills, CTAs per SM), then
   K2 against its plain version at 48 kHz and 44.1 kHz, one window,
   b = 1 and b = 33, silence, a full-scale sine at a band centre and the
   bench shape: at most 1e-3 dB, and two launches bit-identical.
4. The main path at full size (analyze_batch_native, then
   stft_pooled_frames, on (32, 2, N/128, 128) float32 made on the card
   from a seeded generator): both kernels launched, every output finite
   and of the expected shape; the same path on a small slice agrees with
   the plain versions on the CPU; EBU Tech 3341 case 1 reads -23.0 LUFS.
5. The CLI (`analyze --json --spectrogram`) in-process on WAV files this
   script writes: every row complete, K1 and K2 launched.
6. Timings with CUDA events: K1 and K2 against their plain versions at
   the bench shape, and the main path's audio-seconds per second; K2's
   share of the main path's device time (torch.profiler); torch.fft.fft
   (cuFFT) of the same windows as a yardstick for the FFT stage; the
   operations of the 4D engine path that synchronise the host
   (torch.cuda.set_sync_debug_mode("warn"), checked first on a read of a
   device value, which must show).
7. K3, K4, K5 (ops/iir.py) and K6 (ops/truepeak_stream.py) against their
   plain versions on the card: the CPU tests' cases, then each at its
   configuration's shape (K5 and K6 on a 64-row slice of the library scan
   at full length), and K3 and K4 on a few long rows (1, 2, 2^22), ragged,
   at 48 and 44.1 kHz. z per group rtol 1e-3 / atol 1e-6 * max|z|,
   sub-block sums rtol 3e-4 / atol 2e-5, true peak rtol 2e-6 / atol 1e-7,
   sample peak exact. K3's to K7's resources; two launches bit-identical
   (K6 in every case, K5 on the slice, K3 and K4 at their shapes). Then
   K1-K7 on rows holding NaN, +Inf, -Inf and the bit pattern
   0xFFFFFFFF, each launch in a child process that must end within 300 s:
   non-finite exactly where the plain version is, finite values within
   the pins, sample peaks equal; K2 on the same rows viewed as frames,
   and on finite samples whose powers overflow, band by band
   (nonfinite_k2).
8. The rows-layout engine path in three configurations at full size, each
   with the launch counts set to 0 just before and read just after:
   the 1,000-track library scan (rows (2000, 720000) through
   analyze_batch_native: K5 + K6), one 240 s 48 kHz stereo file through
   analyze_array (EBU Tech 3341 case 1, -23.0 LUFS: K3) and a 60 s 5.1
   track at 192 kHz through analyze_array (K4); shapes, finiteness, and a
   small slice against the plain path on the CPU.
9. Timings with CUDA events: K3-K6 against their plain versions, K4 and
   K5 both at the library shape, K5 at K4's 5.1 shape, the library scan
   in ms per scan and tracks per second, the single-file and 5.1 paths in
   ms, and for those two paths the device time, the kernel's share of it
   and the device's idle share (torch.profiler).
10. K7 (ops/iir.block_iir_stream) against its plain version on the card:
   the CPU tests' cases, then the 60 Hz tick (2, 800), the 1 s slab
   (2, 44100) and the 5.1 slab (6, 192000), each from a random carried
   state: y and s_final within 2e-5 per unit RMS of x; at those three
   shapes also the meter's strided view of interleaved audio, within the
   pin and bit-identical to its contiguous copy and to a second launch.
   Then, at those
   three shapes and 64 seeds each (x and the carried state drawn anew per
   seed), K7 and its plain version against a float64 evaluation of the
   same filter: the kernel within 2e-5 per unit RMS of x in y and s_final,
   each side's largest error printed.
11. The streaming path at full size, the launch counts set to 0 before
   each run and read after, every meter push of a device tensor under
   torch.cuda.set_sync_debug_mode("error"): the mic simulation
   (LiveAnalyzer, 48 kHz pseudo-stereo, 30 s ring, 3,600 pushes of 800
   frames with a frame() at every tick: K7 once per push, the tone at its
   chart x, the final state equal to the same pushes on the CPU); a 240 s
   44.1 kHz stereo track through Analyzer.add_samples in 1 s slabs
   (integrated within 1e-3 LU and true peak within 1e-6 of analyze_array
   on the card); EBU Tech 3341 case 1 through the Analyzer at 48 kHz.
12. Timings with CUDA events: K7 and its plain version at the tick, 1 s
   slab and 5.1 slab shapes, with K7's device time per call and its
   device operations (torch.profiler: the kernel and the reset of its
   records), ms per live push, per frame() and per 1 s slab of
   add_samples, audio seconds per wall second of each streaming path, and
   the device operations per push (torch.profiler).

13. The TUI in file mode at full size: a 240 s 48 kHz stereo EBU Tech
   3341 case 1 tone written as 16-bit FLAC (utils/flacenc.py) and as
   16-bit WAV, both decoded by the native decoders (the NumPy and ffmpeg
   paths refused) to equal samples; apps/tui.App on the card with a
   silent sink opens the FLAC (K3 once, the reference's 480,000 waveform
   points, fft_gain_db = -13 - analyze_array's loudness within 1e-3 LU,
   decode, waveform and loudness timed apart), then analyzes every
   playhead report of the first 60 s (2,812, each 2,048 interleaved
   samples on; K7 once each from the first full 16,384-sample window;
   short-term -23.0 +- 0.1 LUFS; the mid spectrum's peak at 997 Hz's
   chart x 56.6 +- 1), ms per frame (median, p99), one 200 x 60 draw
   every 64 frames (a draw walks all 480,000 points on the host, about
   half a second), the frame's device time, operations and idle share
   (torch.profiler, 50 frames), and K7 at the TUI's (2, 8192) strided
   push against its plain version.
14. The TUI in microphone mode: the live pipeline (not the snapshot path)
   on the card, a native ring fed 8 ms of a 700 Hz tone at 44.1 kHz
   before each of 3,600 ticks; K7 once per 2,048-sample quantum, the
   tone at its chart x +- 2, ms per tick (median, p99).
15. The CLI through its decode pool: 32 x 60 s of 48 kHz stereo seeded
   noise as FLAC and as WAV (written by a process pool); `analyze --json
   --spectrogram --metrics --profile` in-process on the FLACs (native
   decoders only): rows complete and equal to the WAV run's bit for bit,
   spectrograms too, K1 and K2 once (one bucket), the trace naming both;
   the pool's decode audio-seconds per second, files per second end to
   end and the decode thread count.
16. The sequence-sharded analysis (parallel/) on a world of one NCCL rank
   (a card takes one rank) and a (1 data x 1 seq) mesh: a 2-hour 48 kHz
   stereo programme made on the card (10 s sections at -40 to -15 dBFS,
   n_valid 1,237 short of 345,600,000, garbage past it, padded for 4
   shards) through the engine (the yardstick: K3 once), through
   sharded_analyze_fn (K7 once) and as a 4-shard composition in one
   process (parallel/seqshard.composed_parts, each rank's shard_steps
   driven in lockstep: K7 7 times). Each within 5e-3 LU of the yardstick on
   integrated, LRA and the valid timelines, 1e-5 on true peak, sample
   peak exact; the composition's sub-block sums within rtol 3e-4 / atol
   2e-5 of seq 1's, and at seq 1 equal to the NCCL run bit for bit. K7
   at the programme's and a shard's shapes against its plain version
   (2e-5 per unit RMS: y of the valid samples, the end state of the
   row's last 4,096 samples, which set it); EBU Tech 3341 case 1 through the sharded path;
   CUDA-event ms of the seq-1 call, the composition, the yardstick and
   K7 at both shapes.
17. The data axis on the same mesh: phase 8's library scan through
   global_batch, analyze_batch_native on the rank's rows (K5 and K6 once)
   and the per-track results gathered over "data": equal to phase 8's
   scan bit for bit. Then the process group is destroyed.
18. The dryrun entry point (python -m soundscope_tpu_torch.parallel.dryrun)
   on its default device, the card: one NCCL rank in a child process
   certifies every component (dryrun_multichip ok on cuda); two ranks on
   a one-card machine are refused before a rank is spawned.
19. The conformance sweep (soundscope_tpu_torch/tools/conformance.py) at
   48 kHz and at 44.1 kHz, 32 levels each: every route (K1, K3, K4 + K6,
   K5, K2, K7) against the float64 chain of tools/reference64.py, each
   route's errors printed; every route within 0.1 LU integrated, 0.1 dB
   true peak and 0.1 dB display spectrum, and K1-K7 each launched.
20. The bench (soundscope_tpu_torch/bench.py) at its default workload,
   32 x 60 s of 48 kHz stereo: its JSON line printed, its audio-s/s
   within 15 % of phase 6's main path (both time the same work).
21. The first `analyze` of a 10 s WAV in a fresh process from a copy of
   the package with nothing built (the kernels' and the decoders'
   builds on the way), then `cli warmup` in a child process from a
   second such copy (both libraries must be there after it; each child
   killed after 300 s) and the first `analyze` there after it; the
   three wall times printed.
22. The library-scan bench (soundscope_tpu_torch/tools/
   library_scan_bench.py) at its defaults, 1,000 x 15 s of 48 kHz stereo
   in the rows layout: its JSON line printed, K5 and K6 launched, its
   numbers and its scan's value finite, its ms per scan within 15 % of
   phase 9's library scan (the same scan, plus a reduction of three
   device operations and one read-back per run of 4).
23. The end-to-end scan bench (soundscope_tpu_torch/tools/e2e_scan_bench.py)
   at 128 x 15 s into a temporary directory: exit 0, no errors, a row for
   every file made, K1 launched once per bucket of 64 files in the timed
   scan (and as often in its warm-up, which takes the same files); its
   line, the corpus build time and its decode rate per thread beside
   phase 15's printed.

--k7-times DIR prints phase 12's K7 lines for the port in DIR, and
--k2-times DIR K2 at the bench shape three times, so that an earlier
commit unpacked there is timed in the same run on the same card.

The plain versions run with TF32 off. Prints one JSON line of per-kernel
numbers (each with its bound: the larger of its bytes over 3.35 TB/s and
its float32 operations over 67 TFLOP/s, the H100 SXM's published peaks),
the card's name and power limit, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 1234
RATE = 48000
TRACKS = 32
SECONDS = 60


class SmokeFailure(Exception):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def max_err(got, want) -> float:
    return float((got.double() - want.double()).abs().max()) if got.numel() else 0.0


def check_close(what, got, want, rtol, atol) -> float:
    import torch

    require(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    got, want = got.double().cpu(), want.double().cpu()
    bad = (got - want).abs() > atol + rtol * want.abs()
    bad |= torch.isnan(got) != torch.isnan(want)
    require(not bool(bad.any()),
            f"{what}: {int(bad.sum())} values outside rtol {rtol} atol {atol} "
            f"(max abs err {max_err(got, want):.3e})")
    return max_err(got, want)


def time_ms(fn, iters: int) -> float:
    """Mean milliseconds per call on the current stream (after one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def noise(gen, shape, dev):
    """Seeded noise with a louder second half (keeps gates and LRA busy)."""
    import torch

    x = torch.randn(shape, generator=gen, device=dev) * 0.1
    x[..., x.shape[-2] // 2:, :] *= 3.0
    return x


def rows_noise(gen, shape, dev):
    """Seeded noise over (..., N) with a louder second half in time."""
    import torch

    x = torch.randn(shape, generator=gen, device=dev) * 0.1
    x[..., x.shape[-1] // 2:] *= 3.0
    return x


def energy_close(what, got, want, h, group) -> float:
    """K3-K5 z against its plain version: per group and as 100 ms sums."""
    err = check_close(f"{what} z", got, want, 1e-3,
                      1e-6 * float(want.abs().max()))
    hg = h // group
    nb = got.shape[-1] // hg

    def sums(z):
        return z[:, : nb * hg].double().reshape(z.shape[0], nb, hg).sum(-1)

    check_close(f"{what} sub-block sums", sums(got), sums(want), 3e-4, 2e-5)
    return err


def rows_compare(IIR, K6, filt, x, nv, rate, group, kernels):
    """K3/K4/K5/K6 (those named) against their plain versions on x;
    returns {kernel: max abs error} (z for K3-K5, true peak for K6)."""
    import torch

    from soundscope_tpu_torch.core.constants import samples_in_100ms
    from soundscope_tpu_torch.ops.kweight import channel_weights

    ch = x.shape[1] if x.ndim == 3 else 2
    w = tuple(float(v) for v in channel_weights(ch))
    h = samples_in_100ms(rate)
    tag = f"rate {rate} shape {tuple(x.shape)} group {group}"
    errs = {}
    if "K3" in kernels:
        got = IIR.kweight_energy_tp_prefix(filt, x, nv, w, rate, group)
        want = IIR.kweight_energy_tp_prefix_plain(filt, x, nv, w, rate, group)
        torch.cuda.synchronize()
        errs["K3"] = energy_close(f"K3 {tag}", got[0], want[0], h, group)
        check_close(f"K3 {tag} true peak", got[1], want[1], 2e-6, 1e-7)
        check_close(f"K3 {tag} sample peak", got[2], want[2], 0.0, 0.0)
    for k, fn, plain in (("K4", IIR.kweight_energy_prefix, IIR.kweight_energy_prefix_plain),
                         ("K5", IIR.kweight_energy_chain, IIR.kweight_energy_chain_plain)):
        if k in kernels:
            got = fn(filt, x, nv, w, group)
            want = plain(filt, x, nv, w, group)
            torch.cuda.synchronize()
            errs[k] = energy_close(f"{k} {tag}", got, want, h, group)
    if "K6" in kernels:
        got = K6.true_peak_stream(x, nv, rate)
        again = K6.true_peak_stream(x, nv, rate)
        want = K6.true_peak_stream_plain(x, nv, rate)
        torch.cuda.synchronize()
        errs["K6"] = check_close(f"K6 {tag} true peak", got[0], want[0], 2e-6, 1e-7)
        check_close(f"K6 {tag} sample peak", got[1], want[1], 0.0, 0.0)
        require(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
                f"K6 {tag}: two launches differ")
    print(f"phase rows: {tag} " + " ".join(
        f"{k} max abs err {v:.3e}" for k, v in errs.items())
        + (", K6 two launches bit-identical" if "K6" in kernels else "") + " ok")
    return errs


def k1_compare(K1, filt_fn, x4, nv, rate):
    """K1 kernel against its plain version on the card; returns the max
    abs error of the sub-block energy sums."""
    import torch

    from soundscope_tpu_torch.core.constants import samples_in_100ms
    from soundscope_tpu_torch.ops.kweight import channel_weights

    b, ch, nc, _ = x4.shape
    n = nc * 128
    h = samples_in_100ms(rate)
    filt = filt_fn(rate)
    w = tuple(float(v) for v in channel_weights(ch))
    got = K1.kweight_energy_tp_chunked(filt, x4, nv, w, rate, h)
    want = K1.kweight_energy_tp_chunked_plain(filt, x4, nv, w, rate, h)
    torch.cuda.synchronize()
    span = K1.step_length(n, h)
    sg = K1.subblock_sums_from_steps(got[0], h, span, n).reshape(b, ch, -1).sum(1)
    sw = K1.subblock_sums_from_steps(want[0], h, span, n).reshape(b, ch, -1).sum(1)
    tag = f"K1 rate {rate} shape {tuple(x4.shape)}"
    err = check_close(f"{tag} sub-block sums", sg, sw, 3e-4, 2e-5)
    check_close(f"{tag} true peak", got[1], want[1], 2e-6, 1e-7)
    check_close(f"{tag} sample peak", got[2], want[2], 0.0, 0.0)
    print(f"phase k1: rate {rate} shape {tuple(x4.shape)} sub-block max abs err "
          f"{err:.3e} true-peak max abs err {max_err(got[1], want[1]):.3e} ok")
    return err


NONFINITE_KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7")


def nonfinite_input():
    """(x (3, 2, n) float32, n_valid (3,), first (3,)), host arrays: seeded
    noise with NaN, +Inf, -Inf and the bit pattern 0xFFFFFFFF in track 0's
    left channel, 0xFFFFFFFF early in track 1's left channel, +Inf past
    track 1's n_valid (masked: its outputs stay finite) and -Inf at a
    segment start in track 2's right channel. n is 16.5 of K3's segments.
    first[i] is track i's first non-finite valid sample (n if none)."""
    n = 16 * 8192 + 4096
    x = (np.random.default_rng(SEED + 5).standard_normal((3, 2, n)) * 0.1).astype(np.float32)
    bits = x.view(np.int32)
    x[0, 0, 40000], x[0, 0, 50000], x[0, 0, 60000] = np.nan, np.inf, -np.inf
    bits[0, 0, 70000] = -1
    bits[1, 0, 9000] = -1
    nv = np.array([n, n - 5000, n], np.int64)
    x[1, 1, n - 100] = np.inf
    x[2, 1, 3 * 8192] = -np.inf
    bad = [(~np.isfinite(x[i, :, : nv[i]])).any(0) for i in range(3)]
    first = np.array([(np.flatnonzero(m).tolist() + [n])[0] for m in bad], np.int64)
    return x, nv, first


def nonfinite_close(what, got, ref, rtol, atol) -> int:
    """got non-finite exactly where ref is, and within rtol / atol where
    ref is finite; returns the count of non-finite values."""
    import torch

    got, ref = got.double().cpu(), ref.double().cpu()
    require(got.shape == ref.shape, f"{what}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    fin = torch.isfinite(ref)
    diff = torch.isfinite(got) != fin
    if bool(diff.any()):
        raise SmokeFailure(f"{what}: {int(diff.sum())} values finite in one version and "
                           f"not in the other (first at {diff.nonzero()[0].tolist()})")
    bad = ((got - ref).abs() > atol + rtol * ref.abs()) & fin
    require(not bool(bad.any()), f"{what}: {int(bad.sum())} finite values outside rtol "
            f"{rtol} atol {atol}")
    return int((~fin).sum())


def nonfinite_child(kernel: str) -> int:
    """One launch of `kernel` (K1-K7) on nonfinite_input(),
    against its plain version on the same input. Output items that end
    before their track's first non-finite sample are held to the plain
    version on the input with the non-finite samples zeroed: the plain
    versions' blocked filter multiplies the whole 128-sample block by its
    Toeplitz matrix, so 0 x NaN spreads a NaN back to the block's start,
    while the filter's output before the sample does not depend on it.
    Run as a child process (python3 chip_smoke.py --nonfinite K3) so that
    a launch that hangs is killed and fails the check. K7 takes the six
    rows twice over (66 segments a row, past its look-back) from a finite
    carried state, with no n_valid: its y from each row's first non-finite
    sample on, and the end state of such a row, are non-finite as the
    plain version's, the rest within 2e-5 per unit RMS of x. K2 as
    nonfinite_k2 says."""
    import torch

    from soundscope_tpu_torch.ops import iir as IIR
    from soundscope_tpu_torch.ops import iir_chunked as K1
    from soundscope_tpu_torch.ops import truepeak_stream as K6
    from soundscope_tpu_torch.ops.biquad import kweight_filter

    dev = torch.device("cuda")
    x, nv, first = nonfinite_input()
    n = x.shape[-1]
    xg, nvg = torch.from_numpy(x).to(dev), torch.from_numpy(nv).to(dev)
    xc = torch.from_numpy(np.where(np.isfinite(x), x, 0.0).astype(np.float32)).to(dev)
    filt = kweight_filter(48000, 128, dev)
    w = (1.0, 1.0)
    peaks = None
    if kernel == "K7":
        return nonfinite_k7(IIR, filt, x, xc)
    if kernel == "K2":
        return nonfinite_k2(x)
    if kernel == "K6":
        got = K6.true_peak_stream(xg, nvg, 48000)
        torch.cuda.synchronize()
        peaks = got, K6.true_peak_stream_plain(xg, nvg, 48000)
        want = None
    elif kernel == "K1":
        h = 4800
        L = K1.step_length(n, h)

        def run(fn, inp):
            out = fn(filt, inp.reshape(3, 2, -1, 128), nvg, w, 48000, h)
            return (K1.subblock_sums_from_steps(out[0], h, L, n).reshape(3, 2, -1).sum(1),
                    *out[1:])

        got = run(K1.kweight_energy_tp_chunked, xg)
        torch.cuda.synchronize()
        want = run(K1.kweight_energy_tp_chunked_plain, xg)
        clean = run(K1.kweight_energy_tp_chunked_plain, xc)
        span, rtol, atol = h, 3e-4, 2e-5
        peaks = got[1:], want[1:]
    else:
        g = 32
        if kernel == "K3":
            got = IIR.kweight_energy_tp_prefix(filt, xg, nvg, w, 48000, g)
            torch.cuda.synchronize()
            want = IIR.kweight_energy_tp_prefix_plain(filt, xg, nvg, w, 48000, g)
            clean = IIR.kweight_energy_tp_prefix_plain(filt, xc, nvg, w, 48000, g)
            peaks = got[1:], want[1:]
        else:
            fn = IIR.kweight_energy_prefix if kernel == "K4" else IIR.kweight_energy_chain
            got = (fn(filt, xg, nvg, w, g),)
            torch.cuda.synchronize()
            want = (IIR.kweight_energy_prefix_plain(filt, xg, nvg, w, g),)
            clean = (IIR.kweight_energy_prefix_plain(filt, xc, nvg, w, g),)
        span, rtol = g, 1e-3
        atol = 1e-6 * float(clean[0].abs().max())
    msgs = []
    if want is not None:
        ends = (torch.arange(want[0].shape[-1]) + 1) * span
        before = ends[None] <= torch.from_numpy(first)[:, None]
        ref = torch.where(before, clean[0].cpu(), want[0].cpu())
        nz = nonfinite_close(f"non-finite {kernel} energy", got[0], ref, rtol, atol)
        require(nz > 0, f"non-finite {kernel}: the plain version's energy is finite throughout")
        msgs.append(f"{nz} of {ref.numel()} energy values non-finite as the plain version's")
    if peaks is not None:
        (tp, sp), (tpw, spw) = peaks
        ntp = nonfinite_close(f"non-finite {kernel} true peak", tp, tpw, 2e-6, 1e-7)
        require(ntp > 0, f"non-finite {kernel}: the plain version's true peak is finite")
        sp, spw = sp.cpu(), spw.cpu()
        nan = torch.isnan(spw)
        require(torch.equal(torch.isnan(sp), nan) and torch.equal(sp[~nan], spw[~nan]),
                f"non-finite {kernel} sample peak: {sp.tolist()} against {spw.tolist()}")
        msgs.append(f"true peak non-finite in {ntp} of {tp.numel()} rows, sample peak equal")
    print(f"phase nonfinite: {kernel} returned; {', '.join(msgs)} ok")
    return 0


def nonfinite_k7(IIR, filt, x, xc) -> int:
    """K7's part of nonfinite_child: x, xc the input and its clean copy."""
    import torch

    dev = torch.device("cuda")
    rows = np.concatenate([x.reshape(6, -1)] * 2, -1)
    clean = np.concatenate([xc.cpu().numpy().reshape(6, -1)] * 2, -1)
    n = rows.shape[-1]
    bad = ~np.isfinite(rows)
    first = np.array([(np.flatnonzero(m).tolist() + [n])[0] for m in bad], np.int64)
    xg, xcg = torch.from_numpy(rows).to(dev), torch.from_numpy(clean).to(dev)
    s0 = torch.from_numpy(
        (np.random.default_rng(SEED + 6).standard_normal((6, 4)) * 0.1).astype(np.float32)).to(dev)
    y, s = IIR.block_iir_stream(filt, xg, s0)
    torch.cuda.synchronize()
    yw, sw = IIR.block_iir_stream_plain(filt, xg, s0)
    yc, _ = IIR.block_iir_stream_plain(filt, xcg, s0)
    tol = 2e-5 * float(xcg.double().pow(2).mean().sqrt())
    before = torch.arange(n)[None] < torch.from_numpy(first)[:, None]
    ref = torch.where(before, yc.cpu(), yw.cpu())
    ny = nonfinite_close("non-finite K7 y", y, ref, 0.0, tol)
    ns = nonfinite_close("non-finite K7 s_final", s, sw, 0.0, tol)
    require(ny > 0 and ns > 0,
            f"non-finite K7: {ny} y values and {ns} state values non-finite")
    print(f"phase nonfinite: K7 returned; {ny} of {ref.numel()} y values and the end states "
          f"of {ns // 4} of 6 rows non-finite as the plain version's ok")
    return 0


def k2_against_plain(what, x):
    """K2 and its plain version on x (b, 2, n) host float32 viewed as
    frames, band by band: non-finite where the plain version is, with the
    same sign; exactly -150 where it is at the floor; within 1e-3 dB
    elsewhere. Returns the plain version's (mid, side) as float64 on the
    CPU and the largest dB error."""
    import torch

    from soundscope_tpu_torch.ops import stft_pooled as K2

    b, _, n = x.shape
    fr = torch.from_numpy(x).to("cuda").reshape(b, 2, n // 128, 128)
    got = K2.stft_pooled_frames(fr, RATE)
    torch.cuda.synchronize()
    want = K2.stft_pooled_frames_plain(fr, RATE)
    err, plain = 0.0, []
    for part, g, w in zip(("mid", "side"), got, want):
        where = f"{what} K2 {part}"
        g, w = g.double().cpu(), w.double().cpu()
        require(g.shape == w.shape == (b, n // 2048 - 7, 128), f"{where}: shape {tuple(g.shape)}")
        for cls in (torch.isnan, torch.isposinf, torch.isneginf):
            diff = cls(g) != cls(w)
            if bool(diff.any()):
                raise SmokeFailure(
                    f"{where}: {int(diff.sum())} bands {cls.__name__} in one version and not in "
                    f"the other (first (track, window, band) {diff.nonzero()[0].tolist()})")
        floor = w == -150.0
        off = floor & (g != -150.0)
        if bool(off.any()):
            first = off.nonzero()[0].tolist()
            raise SmokeFailure(f"{where}: {int(off.sum())} bands at the floor in the plain "
                               f"version read otherwise (first {first}: {g[tuple(first)]} dB)")
        rest = torch.isfinite(w) & ~floor
        if bool(rest.any()):
            err = max(err, float((g[rest] - w[rest]).abs().max()))
        require(err <= 1e-3, f"{where}: {err:.3e} dB from the plain version")
        plain.append(w)
    return plain, err


def windows_reached(x, mask):
    """(b, nw) bool: the windows of x (b, 2, n) that hold a sample of mask."""
    import torch

    n = x.shape[-1]
    return torch.tensor([[bool(m[:, 2048 * w: 2048 * w + 16384].any())
                          for w in range(n // 2048 - 7)] for m in mask])


def nonfinite_k2(x) -> int:
    """K2's part of nonfinite_child, through k2_against_plain, on two
    inputs. x (3, 2, n) viewed as frames (3, 2, 1056, 128), 59 windows a
    track; K2 takes no n_valid, so the +Inf past track 1's n_valid is a
    valid sample for it. A NaN or Inf sample leaves every bin of its
    windows NaN (Inf - Inf, Inf x 0) in both versions: each track must
    have a window at the floor in every band because of its bad samples,
    and the windows clear of them must be finite. Then one track of finite
    noise with one hop at 1e23 times full scale: the bins' powers overflow
    to +Inf, and times the zero gain outside 20 Hz-20 kHz to NaN: the
    bands within the range read +Inf, and band 0, which holds both, the
    floor (a max that drops the NaN reads +Inf there)."""
    import torch

    hit = windows_reached(x, ~np.isfinite(x))
    (mid, side), err = k2_against_plain("non-finite", x)
    floor_windows = (mid == -150.0).all(-1) & (side == -150.0).all(-1)
    for i in range(x.shape[0]):
        require(bool((floor_windows[i] & hit[i]).any()),
                f"non-finite K2: no window of track {i} reads the floor for its bad samples")
        require(bool(torch.isfinite(mid[i][~hit[i]]).all()
                     and torch.isfinite(side[i][~hit[i]]).all()),
                f"non-finite K2: a window of track {i} clear of the bad samples is not finite")

    big = (np.random.default_rng(SEED + 7).standard_normal((1, 2, 24 * 2048)) * 0.1
           ).astype(np.float32)
    big[..., 12 * 2048: 13 * 2048] *= 1e24
    loud = windows_reached(big, np.abs(big) > 1e10)[0]
    (bmid, bside), berr = k2_against_plain("overflowing", big)
    for part, w in (("mid", bmid[0][loud]), ("side", bside[0][loud])):
        require(bool((w[:, 0] == -150.0).all() and torch.isposinf(w[:, 1:53]).all()),
                f"overflowing K2 {part}: band 0 not at the floor or bands 1-52 not +Inf in the "
                "plain version")
    print(f"phase nonfinite: K2 returned; of {int(hit.sum())} windows a bad sample reaches, "
          f"{int((floor_windows & hit).sum())} read the floor in every band of mid and side in "
          f"both versions, the {int((~hit).sum())} clear windows finite; in "
          f"{int(loud.sum())} windows whose powers overflow, band 0 at the floor and bands "
          f"1-52 +Inf in both; max abs dB err {max(err, berr):.3e} elsewhere ok")
    return 0


def nonfinite_phase(on, limit_s: float = 300.0) -> None:
    """K1-K7 on non-finite input, each launch in a child process
    (all started together) that must end within limit_s."""
    procs = {k: subprocess.Popen([sys.executable, os.path.abspath(__file__), "--nonfinite", k],
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for k in NONFINITE_KERNELS}
    deadline = time.time() + limit_s
    try:
        for k, p in procs.items():
            try:
                out, err = p.communicate(timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                raise SmokeFailure(f"non-finite {k}: no result within {limit_s:.0f} s "
                                   "(a launch that does not return)")
            require(p.returncode == 0, f"non-finite {k}: exit {p.returncode}\n{err[-4000:]}")
            print(f"{out.strip()} {on}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def k7_phase(dev, gen, on) -> tuple[float, float]:
    """10. K7 against its plain version; returns the largest abs error of
    y at the configuration shapes, and the largest per unit RMS of x."""
    import torch

    from soundscope_tpu_torch.ops import iir as IIR
    from soundscope_tpu_torch.ops.biquad import kweight_filter
    from soundscope_tpu_torch.utils.metrics import launches

    worst, worst_rel = 0.0, 0.0
    cases = ([(48000, (2, n)) for n in (1, 7, 127, 333, 2048)]
             + [(48000, (1, 1024)), (48000, (3, 2, 2048)), (44100, (2, 7))]
             + [(48000, (2, 800)), (44100, (2, 44100)), (192000, (6, 192000))])
    for rate, shape in cases:
        filt = kweight_filter(rate, 128, dev)
        x = torch.randn(shape, generator=gen, device=dev) * 0.3
        s0 = torch.randn((*shape[:-1], 4), generator=gen, device=dev) * 0.1
        before = launches()["K7"]
        y, s = IIR.block_iir_stream(filt, x, s0)
        require(launches()["K7"] == before + 1, "K7 did not count its launch")
        yp, sp = IIR.block_iir_stream_plain(filt, x, s0)
        torch.cuda.synchronize()
        tol = 2e-5 * max(float(x.pow(2).mean().sqrt()), 1e-3)
        ey = check_close(f"K7 rate {rate} shape {shape} y", y, yp, 0.0, tol)
        es = check_close(f"K7 rate {rate} shape {shape} s_final", s, sp, 0.0, tol)
        extra = ""
        if shape in ((2, 800), (2, 44100), (6, 192000)):
            worst = max(worst, ey)
            worst_rel = max(worst_rel, ey / float(x.pow(2).mean().sqrt()))
            # the meter's view of interleaved audio: sample stride C, channel
            # c 4c bytes in; the same bits as its contiguous copy, and as a
            # second launch
            c, n = shape
            view = (torch.randn(c * n, generator=gen, device=dev) * 0.3).reshape(n, c).T
            yv, sv = IIR.block_iir_stream(filt, view, s0)
            yv2, sv2 = IIR.block_iir_stream(filt, view, s0)
            yc, sc = IIR.block_iir_stream(filt, view.contiguous(), s0)
            ypv, spv = IIR.block_iir_stream_plain(filt, view, s0)
            torch.cuda.synchronize()
            tolv = 2e-5 * float(view.pow(2).mean().sqrt())
            check_close(f"K7 strided {shape} y", yv, ypv, 0.0, tolv)
            check_close(f"K7 strided {shape} s_final", sv, spv, 0.0, tolv)
            require(torch.equal(yv, yv2) and torch.equal(sv, sv2),
                    f"K7 {shape}: two launches differ")
            require(torch.equal(yv, yc) and torch.equal(sv, sc),
                    f"K7 {shape}: the strided view and its copy differ")
            extra = ("; strided view within tol, equal to its copy and to a second "
                     "launch")
        print(f"phase k7: rate {rate} shape {shape} y max abs err {ey:.3e} "
              f"s_final {es:.3e} (tol {tol:.2e}){extra} ok {on}")
    return worst, worst_rel


def float64_filter(filt, dev):
    """The filter's blocked matrices (ops/biquad.BlockFilter's layout, block
    128) in float64, from its float64 modal realisation, on dev."""
    import dataclasses

    import torch

    A, B, C, n = filt.A, filt.Bv, filt.Cv, 128
    pows = [np.eye(4)]
    for _ in range(n):
        pows.append(pows[-1] @ A)
    h = np.array([filt.D] + [C @ pows[m - 1] @ B for m in range(1, n)])
    Tt = np.zeros((n, n))
    for k in range(n):
        Tt[k, k:] = h[: n - k]
    Wt = np.stack([pows[n - 1 - k] @ B for k in range(n)])
    Ot = np.stack([C @ pows[m] for m in range(n)], axis=1)

    def dev64(a):
        return torch.from_numpy(np.asarray(a, np.float64)).to(dev)

    return dataclasses.replace(filt, Tt=dev64(Tt), Wt=dev64(Wt), Ot=dev64(Ot),
                               A_pows=dev64(np.stack(pows)))


def k7_float64_check(dev, on, seeds: int = 64) -> dict:
    """10. K7 and its plain version against a float64 evaluation of the
    same filter (ops/biquad.block_iir on float64 block matrices) at the
    three configuration shapes, one draw of x (RMS 0.3) and of the carried
    state per seed; returns each side's largest error per unit RMS of x
    per shape."""
    import torch

    from soundscope_tpu_torch.ops import biquad
    from soundscope_tpu_torch.ops import iir as IIR

    out = {}
    for rate, shape in ((48000, (2, 800)), (44100, (2, 44100)), (192000, (6, 192000))):
        filt = biquad.kweight_filter(rate, 128, dev)
        xs, ss = [], []
        for seed in range(seeds):
            g = torch.Generator(device=dev)
            g.manual_seed(SEED + 100 + seed)
            xs.append(torch.randn(shape, generator=g, device=dev) * 0.3)
            ss.append(torch.randn((shape[0], 4), generator=g, device=dev) * 0.1)
        x, s0 = torch.stack(xs), torch.stack(ss)
        yk, sk = IIR.block_iir_stream(filt, x, s0)
        yp, sp = IIR.block_iir_stream_plain(filt, x, s0)
        yt, st = biquad.block_iir(float64_filter(filt, dev), x.double(), s0.double())
        rms = x.double().pow(2).mean(dim=(1, 2)).sqrt()

        def rel(a, b):
            return float(((a.double() - b).abs().amax(dim=(1, 2)) / rms).max())

        errs = {"kernel_y": rel(yk, yt), "kernel_s": rel(sk, st),
                "plain_y": rel(yp, yt), "plain_s": rel(sp, st)}
        out[f"{rate} {shape}"] = errs
        print(f"phase k7 float64: rate {rate} shape {shape} over {seeds} seeds, largest "
              f"error per unit RMS of x: kernel y {errs['kernel_y']:.3e} s_final "
              f"{errs['kernel_s']:.3e}, plain y {errs['plain_y']:.3e} s_final "
              f"{errs['plain_s']:.3e} (pin 2e-05) {on}")
        del x, s0, yk, sk, yp, sp, yt, st
    torch.cuda.empty_cache()
    return out


def sync_sources(fn) -> list:
    """The Python lines at which fn's operations synchronise the host with
    the device (torch.cuda.set_sync_debug_mode("warn")); [] when none do."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    here = os.path.dirname(os.path.abspath(__file__))
    return sorted({f"{os.path.relpath(w.filename, here)}:{w.lineno}" for w in caught
                   if "synchronizing CUDA operation" in str(w.message)})


def streaming_phase(dev, gen, on) -> dict:
    """11. the streaming path at full size; returns its launches and the
    walls of the runs."""
    import torch

    from soundscope_tpu_torch.core.config import MeterConfig
    from soundscope_tpu_torch.models import meter as M
    from soundscope_tpu_torch.models.analyzer import Analyzer
    from soundscope_tpu_torch.models.engine import analyze_array
    from soundscope_tpu_torch.models.live import LiveAnalyzer
    from soundscope_tpu_torch.utils.metrics import launches

    def pushing(fn):
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")

    out = {}
    queries = ("integrated_lufs", "shortterm_lufs", "momentary_lufs", "loudness_range_lu")

    # mic simulation (BASELINE.json config 3): 60 s at a 60 Hz tick
    rate, tick, ticks, tone = 48000, 800, 3600, 1000.0
    t = torch.arange(tick * ticks, device=dev, dtype=torch.float64) / rate
    mono = (10 ** (-12 / 20) * torch.sin(2 * torch.pi * tone * t)).float()
    mono += torch.randn(mono.shape, generator=gen, device=dev) * 0.003
    inter = torch.zeros(2 * mono.shape[0], device=dev)
    inter[0::2] = mono                          # pseudo-stereo [x, 0]
    cfg = MeterConfig(channels=2, rate=rate, max_blocks=0)
    live = LiveAnalyzer(cfg, device=dev)
    base = launches()
    t0 = time.time()
    for k in range(ticks):
        pushing(lambda: live.push(inter[2 * tick * k: 2 * tick * (k + 1)]))
        frame = live.frame()
    torch.cuda.synchronize()
    out["mic_wall_s"] = time.time() - t0
    out["mic"] = launches(since=base)
    require(out["mic"]["K7"] == ticks,
            f"mic simulation: K7 launched {out['mic']['K7']} times for {ticks} pushes")
    peak_x = live.spectrum_chart_x[int(np.argmax(frame.fft_mid))]
    want_x = (np.log10(tone) - np.log10(20)) / (np.log10(20000) - np.log10(20)) * 100
    require(abs(peak_x - want_x) < 2.0, f"mic spectrum peak at x {peak_x}, tone at {want_x}")
    for name in ("fft_mid", "fft_side", "wf_min", "wf_max", "true_peak"):
        require(np.isfinite(getattr(frame, name)).all(), f"mic frame {name} not finite")
    cpu = LiveAnalyzer(cfg, device="cpu")
    inter_cpu = inter.cpu()
    for k in range(ticks):
        cpu.push(inter_cpu[2 * tick * k: 2 * tick * (k + 1)])
    g, c = live.state.meter, cpu.state.meter
    for f in ("z_pos", "frames_total", "subblock_fill", "subblocks_done", "block_count",
              "lra_count", "block_hist", "lra_hist"):
        require(torch.equal(getattr(g, f).cpu(), getattr(c, f)), f"mic state {f} differs")
    require(torch.equal(live.state.ring.cpu(), cpu.state.ring), "mic ring differs")
    for q in queries:
        a, b = float(getattr(M, q)(cfg, g)), float(getattr(M, q)(cfg, c))
        require(a == b or abs(a - b) < 1e-3, f"mic {q}: card {a} cpu {b}")
    check_close("mic true peak", g.true_peak, c.true_peak, 0.0, 1e-6)
    print(f"phase mic: {ticks} pushes of {tick} frames + {ticks} frames in "
          f"{out['mic_wall_s']:.3f} s, launches {out['mic']}, spectrum peak x "
          f"{peak_x:.2f} (tone {want_x:.2f}), short-term {float(frame.shortterm):.4f} LUFS, "
          f"integrated {float(frame.integrated):.4f}; state equals the CPU's {on}")

    # 240 s of 44.1 kHz stereo through Analyzer.add_samples (BASELINE.json config 2)
    rate, secs = 44100, 240
    track = rows_noise(gen, (2, rate * secs), dev)
    track[:, : rate * 20] *= 0.05                     # a quiet intro
    inter = track.T.contiguous().reshape(-1)
    an = Analyzer(channels=2, rate=rate, device=dev)
    base = launches()
    t0 = time.time()
    pushing(lambda: an.add_samples(inter))
    torch.cuda.synchronize()
    out["slab_wall_s"] = time.time() - t0
    out["track"] = launches(since=base)
    require(out["track"]["K7"] == secs, f"240 s track: K7 launched {out['track']['K7']} "
            f"times for {secs} slabs")
    ref = analyze_array(track.cpu().numpy(), MeterConfig(channels=2, rate=rate, max_blocks=0),
                        device=dev)
    integ, ref_integ = an.get_integrated_lufs(), float(ref.integrated_lufs)
    require(np.isfinite(integ) and abs(integ - ref_integ) < 1e-3,
            f"240 s track integrated {integ} vs analyze_array {ref_integ}")
    check_close("240 s track true peak", an.state.true_peak, ref.true_peak, 0.0, 1e-6)
    for q in ("get_shortterm_lufs", "get_momentary_lufs", "get_loudness_range"):
        require(np.isfinite(getattr(an, q)()), f"240 s track {q} not finite")
    require(tuple(an.state.block_energy.shape) == (36000,) and
            int(an.state.block_count) == secs * 10 - 3, "240 s track block history")
    print(f"phase track: {secs} s at {rate} Hz in {secs} slabs, {out['slab_wall_s']:.3f} s, "
          f"launches {out['track']}, integrated {integ:.4f} LUFS (analyze_array "
          f"{ref_integ:.4f}), LRA {an.get_loudness_range():.4f} LU, true peak "
          f"{[round(v, 6) for v in an.get_true_peak()]} {on}")

    # EBU Tech 3341 case 1 through the Analyzer at 48 kHz
    t = torch.arange(20 * 48000, device=dev, dtype=torch.float64) / 48000
    tone = (10 ** (-23 / 20) * torch.sin(2 * torch.pi * 997.0 * t)).float()
    ebu = Analyzer(channels=2, rate=48000, device=dev)
    pushing(lambda: ebu.add_samples(torch.stack([tone, tone], 1).reshape(-1)))
    st, ig, tp = ebu.get_shortterm_lufs(), ebu.get_integrated_lufs(), ebu.get_true_peak()
    require(abs(st + 23.0) < 0.1 and abs(ig + 23.0) < 0.1,
            f"EBU 3341 case 1 through the Analyzer: short-term {st}, integrated {ig}")
    require(abs(tp[0] - 0.0708) < 1e-3 and abs(tp[1] - 0.0708) < 1e-3,
            f"EBU 3341 case 1 true peak {tp}")
    print(f"phase ebu: Analyzer short-term {st:.4f} integrated {ig:.4f} LUFS, "
          f"true peak {[round(v, 5) for v in tp]} {on}")
    return out


def device_ops_per_call(fn, calls: int):
    """Device operations (kernels, copies, memsets) per call of fn, counted
    by torch.profiler; None when the trace shows no device activity."""
    return device_profile(fn, calls, "").get("ops")


# K7 at the meter's shapes: the 60 Hz tick, the 1 s slab at 44.1 kHz and
# the 5.1 slab at 192 kHz (name, rate, shape, calls a timing)
K7_SHAPES = (("tick", 48000, (2, 800), 400), ("slab", 44100, (2, 44100), 200),
             ("5.1 slab", 192000, (6, 192000), 100))


def k7_timings(dev, gen, on) -> dict:
    """K7 at K7_SHAPES: the sustained CUDA-event time per call (kernel,
    plain, kernel), and its device time per call from torch.profiler, the
    sum of every device operation of the call (K7's kernels and the reset
    of its records), with their count. Times the soundscope_tpu_torch on
    sys.path."""
    import torch

    from soundscope_tpu_torch.ops import iir as IIR
    from soundscope_tpu_torch.ops.biquad import kweight_filter

    out = {}
    for name, rate, shape, iters in K7_SHAPES:
        filt = kweight_filter(rate, 128, dev)
        x = torch.randn(shape, generator=gen, device=dev) * 0.3
        s0 = torch.zeros((shape[0], 4), device=dev)

        def call():
            IIR.block_iir_stream(filt, x, s0)

        k = time_ms(call, iters)
        p = time_ms(lambda: IIR.block_iir_stream_plain(filt, x, s0), iters // 4)
        k = (k + time_ms(call, iters)) / 2
        prof = device_profile(call, 50, "")
        dev_ms, ops = prof.get("device_ms"), prof.get("ops")
        out[f"k7_{name}"] = (k, p, shape, dev_ms, ops)
        print(f"timing K7 kernel {k:.4f} ms plain {p:.4f} ms ({name} shape {shape}) {on}")
        print(f"profile K7 {name} shape {shape}: device "
              + ("not measured" if dev_ms is None else f"{dev_ms * 1000:.3f} us")
              + " per call in " + ("?" if ops is None else f"{ops:.1f}")
              + f" device operations (torch.profiler, 50 calls) {on}")
    return out


def streaming_timings(dev, gen, on) -> dict:
    """12. K7 and the streaming entry points, timed on the card."""
    import torch

    from soundscope_tpu_torch.core.config import MeterConfig
    from soundscope_tpu_torch.models.analyzer import Analyzer
    from soundscope_tpu_torch.models.live import LiveAnalyzer

    out = k7_timings(dev, gen, on)

    cfg = MeterConfig(channels=2, rate=48000, max_blocks=0)
    live = LiveAnalyzer(cfg, device=dev)
    chunk = torch.randn(1600, generator=gen, device=dev) * 0.1
    pushes = 1200
    push_ms = time_ms(lambda: live.push(chunk), pushes)
    t0 = time.time()
    for _ in range(pushes):
        live.push(chunk)
    torch.cuda.synchronize()
    push_wall_ms = (time.time() - t0) * 1000 / pushes
    frame_ms = time_ms(lambda: live.frame(), 100)
    out.update(push_ms=push_ms, push_wall_ms=push_wall_ms, frame_ms=frame_ms)
    out["ops_per_push"] = device_ops_per_call(lambda: live.push(chunk), 50)

    an = Analyzer(channels=2, rate=44100, device=dev)
    slab = torch.randn(2 * 44100, generator=gen, device=dev) * 0.1
    out["slab_ms"] = time_ms(lambda: an.add_samples(slab), 60)
    out["ops_per_slab"] = device_ops_per_call(lambda: an.add_samples(slab), 10)
    ops = {k: ("not measured" if out[k] is None else f"{out[k]:.1f}")
           for k in ("ops_per_push", "ops_per_slab")}
    print(f"timing live push {push_ms:.4f} ms (CUDA events), {push_wall_ms:.4f} ms wall; "
          f"frame() {frame_ms:.4f} ms; device ops per push {ops['ops_per_push']} {on}")
    print(f"timing Analyzer.add_samples {out['slab_ms']:.4f} ms per 1 s slab at 44.1 kHz "
          f"stereo = {1000 / out['slab_ms']:.1f} audio-s/s; device ops per slab "
          f"{ops['ops_per_slab']} {on}")
    print(f"timing mic pushes alone {800 / 48000 / (push_wall_ms / 1000):.1f} audio-s/s {on}")
    return out


def k2_cases(K2, dev) -> None:
    """3. K2's edge cases against its plain version, each within 1e-3 dB:
    one window (N = 16384), one track, 33 tracks, 44.1 kHz, silence (every
    band -150 dB) and a full-scale sine at the centre bin of band 20. A
    sine leaves every other bin at float32 rounding noise, whose dB value
    no two FFTs share: there, bands more than 100 dB below the sine's band
    must read so in both."""
    import torch

    gen = torch.Generator(device=dev)     # leaves the caller's stream as it was
    gen.manual_seed(SEED + 2)
    n = 16 * 24 * 128
    t = torch.arange(n, device=dev, dtype=torch.float64)
    k0 = 20 * 128 + 64
    sine = torch.sin(2 * torch.pi * k0 * t / 16384).float()
    cases = [("nw 1", noise(gen, (2, 2, 128, 128), dev), 48000),
             ("b 1", noise(gen, (1, 2, 16 * 40, 128), dev), 48000),
             ("b 33", noise(gen, (33, 2, 16 * 24, 128), dev), 48000),
             ("44.1 kHz", noise(gen, (3, 2, 16 * 40, 128), dev), 44100),
             ("silence", torch.zeros((2, 2, 16 * 24, 128), device=dev), 48000),
             ("sine", torch.stack([sine, 0.5 * sine]).reshape(1, 2, -1, 128), 48000)]
    for name, fr, rate in cases:
        got = K2.stft_pooled_frames(fr, rate)
        want = K2.stft_pooled_frames_plain(fr, rate)
        again = K2.stft_pooled_frames(fr, rate)
        torch.cuda.synchronize()
        b, _, rows, _ = fr.shape
        nw = rows * 128 // 2048 - 7
        err = 0.0
        for part, g, w in zip(("mid", "side"), got, want):
            require(g.shape == (b, nw, 128), f"K2 {name} {part}: shape {tuple(g.shape)}")
            if name == "silence":
                require(bool((g == -150.0).all()), f"K2 silence {part}: not all -150 dB")
            if name == "sine":
                top = float(w.max())
                loud = w > top - 100.0
                require(bool((g.argmax(-1) == 20).all() and (w.argmax(-1) == 20).all()),
                        f"K2 sine {part}: loudest band is not band 20")
                require(bool((g[~loud] < top - 100.0).all()),
                        f"K2 sine {part}: a band the plain version reads below "
                        f"{top - 100.0:.1f} dB reads above it")
                g, w = g[loud], w[loud]
            err = max(err, check_close(f"K2 {name} {part}", g, w, 0.0, 1e-3))
        require(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
                f"K2 {name}: two launches differ")
        print(f"phase k2: {name} shape {tuple(fr.shape)} rate {rate} max abs dB err "
              f"{err:.3e}, two launches bit-identical ok")


def cufft_yardstick(x, on) -> None:
    """torch.fft.fft (cuFFT) of the same packed windows, materialised as a
    (windows, 16384) complex64 tensor: a yardstick for K2's FFT stage alone
    (not K2's function, which no single torch call computes)."""
    import torch

    from soundscope_tpu_torch.ops.spectrum import hann_window

    b, _, rows, _ = x.shape
    x3 = x.reshape(b, 2, rows * 128)
    w = hann_window(16384, x.device) * 0.5
    l, r = x3[:, 0], x3[:, 1]
    z = torch.complex(((l + r).unfold(-1, 16384, 2048) * w).reshape(-1, 16384),
                      ((l - r).unfold(-1, 16384, 2048) * w).reshape(-1, 16384))
    ms = time_ms(lambda: torch.fft.fft(z), 3)
    print(f"timing cuFFT yardstick torch.fft.fft on {tuple(z.shape)} complex64: "
          f"{ms:.4f} ms {on}")
    del z
    torch.cuda.empty_cache()


def device_profile(fn, iters: int, match: str) -> dict:
    """torch.profiler over iters calls of fn: device time per call (every
    kernel, copy and memset), the share of it in operations whose name
    contains `match`, the host wall per call, the device's idle share of
    that wall and the device operations per call; {} when the trace shows
    no device activity after its marker."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # the profiler may drop a session's first device records: 64
        # one-element kernels take their place, and only device work after
        # the spin kernel that follows them counts
        pad = torch.zeros(1, device="cuda")
        for _ in range(64):
            pad.add_(0.0)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    marks = [b for _, b, name in spans if "spin_kernel" in name]
    spans = [s for s in spans if marks and s[0] >= marks[-1]]
    if not spans:
        return {}
    total = sum(b - a for a, b, _ in spans)
    ours = sum(b - a for a, b, name in spans if match in name)
    busy, end = 0, None
    for a, b, _ in spans:            # union of the device intervals
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    by_name = {}
    for a, b, name in spans:
        by_name[name] = by_name.get(name, 0) + b - a
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"device_ms": total / 1e3 / iters, "match_ms": ours / 1e3 / iters,
            "share": ours / total, "wall_ms": wall_us / 1e3 / iters,
            "idle_share": max(0.0, 1.0 - busy / wall_us), "ops": len(spans) / iters,
            "top": [(name[:60], us / 1e3 / iters) for name, us in top]}


# --------------------------------------------------------- the host surfaces

TUI_RATE, TUI_SECONDS = 48000, 240
TUI_POSITIONS = 2812            # playhead reports over the first 60 s
DRAW_EVERY = 64                 # frames between draws (one draw is ~0.5 s)
CLI_FILES, CLI_SECONDS = 32, 60


def write_pcm16_wav(path: str, ints: np.ndarray, rate: int) -> None:
    """Planar (C, N) int16 as a 16-bit PCM WAV (the FLAC encoder's grid)."""
    import struct

    ch, _ = ints.shape
    pcm = np.ascontiguousarray(ints.T).astype("<i2").tobytes()
    hdr = (b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE" + b"fmt "
           + struct.pack("<IHHIIHH", 16, 1, ch, rate, rate * ch * 2, ch * 2, 16)
           + b"data" + struct.pack("<I", len(pcm)))
    with open(path, "wb") as f:
        f.write(hdr + pcm)


def encode_noise_pair(args) -> float:
    """One seeded noise file of the CLI corpus as 16-bit FLAC and, the same
    samples, as 16-bit WAV (a process-pool worker); returns its seconds."""
    flac, wav, seed, rate, secs = args
    from soundscope_tpu_torch.utils.flacenc import write_flac

    t0 = time.time()
    x = np.random.default_rng(seed).standard_normal((2, rate * secs)) * 0.1
    x[:, x.shape[1] // 2:] *= 3.0
    ints = np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)
    write_flac(flac, ints.astype(np.float32) / 32768.0, rate)
    write_pcm16_wav(wav, ints, rate)
    return time.time() - t0


@contextlib.contextmanager
def native_decoders_only():
    """decode_file with its NumPy and ffmpeg paths refused: what decodes
    went through the port's native library."""
    from soundscope_tpu_torch.native import decoder
    from soundscope_tpu_torch.utils import io as sio

    require(decoder.available(), "the port's native decoders did not build")

    def refuse(path, *a, **k):
        raise SmokeFailure(f"{path} reached a non-native decoder")

    saved = {n: getattr(sio, n) for n in ("decode_wav", "decode_aiff", "decode_ffmpeg")}
    for n in saved:
        setattr(sio, n, refuse)
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(sio, n, f)


class SilentSink:
    """The transport-only playback sink: audio goes nowhere."""

    def __init__(self, rate: int):
        self.rate = rate

    def write(self, interleaved):
        pass

    def stop(self):
        pass


def pct(xs, q) -> float:
    return float(np.percentile(np.asarray(xs), q))


def chart_x(freq: float) -> float:
    return (np.log10(freq) - np.log10(20)) / (np.log10(20000) - np.log10(20)) * 100


def tui_file_phase(dev, tmp, on) -> dict:
    """13. the TUI in file mode at full size; returns K7's numbers at the
    TUI's (2, 8192) push."""
    import torch

    from soundscope_tpu_torch.apps import player as player_mod
    from soundscope_tpu_torch.apps import tui as tui_mod
    from soundscope_tpu_torch.apps.player import AudioPlayer
    from soundscope_tpu_torch.apps.render import Screen
    from soundscope_tpu_torch.core.config import MeterConfig
    from soundscope_tpu_torch.models.engine import analyze_array
    from soundscope_tpu_torch.ops import iir as IIR
    from soundscope_tpu_torch.ops.biquad import kweight_filter
    from soundscope_tpu_torch.utils import io as sio
    from soundscope_tpu_torch.utils.flacenc import write_flac
    from soundscope_tpu_torch.utils.metrics import launches

    t_phase = time.time()
    rate, secs = TUI_RATE, TUI_SECONDS
    t = np.arange(rate * secs) / rate                 # EBU Tech 3341 case 1
    ints = np.round(10 ** (-23 / 20) * 32768.0 * np.sin(2 * np.pi * 997.0 * t)).astype(np.int16)
    planar = np.stack([ints, ints]).astype(np.float32) / 32768.0
    flac, wav = os.path.join(tmp, "ebu3341.flac"), os.path.join(tmp, "ebu3341.wav")
    t0 = time.time()
    write_flac(flac, planar, rate)
    enc_s = time.time() - t0
    write_pcm16_wav(wav, np.stack([ints, ints]), rate)
    with native_decoders_only():
        t0 = time.time()
        d_flac = sio.decode_file(flac)
        dec_s = time.time() - t0
        d_wav = sio.decode_file(wav)
        require(d_flac.rate == d_wav.rate == rate, "decoded rates")
        require(np.array_equal(d_flac.samples, d_wav.samples)
                and np.array_equal(d_flac.samples, planar),
                "the FLAC and the WAV decode to different samples")
        print(f"phase tui file: 240 s EBU 3341 case 1 as FLAC ({os.path.getsize(flac)} "
              f"bytes, encoded in {enc_s:.2f} s) and 16-bit WAV; both through the native "
              f"decoders, equal samples; FLAC decode {dec_s * 1000:.1f} ms = "
              f"{secs / dec_s:.1f} audio-s/s {on}")

        # the open: decode (player thread), waveform, integrated loudness
        spans = {}

        def timed(name, fn):
            def run(*a, **k):
                t0 = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                spans[name] = (time.perf_counter() - t0) * 1000
                return out
            return run

        app = tui_mod.App(player=AudioPlayer(sink_factory=SilentSink),
                          config_dir=os.path.join(tmp, "cfg"), device=None)
        require(app.device.type == "cuda", f"the App computes on {app.device}")
        saved_wf, saved_dec = tui_mod.Analyzer.get_waveform, player_mod.decode_file
        tui_mod.Analyzer.get_waveform = staticmethod(timed("waveform", saved_wf))
        player_mod.decode_file = timed("decode", saved_dec)
        app.file_analyzer.calculate_integrated_lufs = timed(
            "integrated", app.file_analyzer.calculate_integrated_lufs)
        try:
            base = launches()
            t0 = time.perf_counter()
            app.select_audio_file(flac)
            open_ms = (time.perf_counter() - t0) * 1000
            opened = launches(since=base)
        finally:
            tui_mod.Analyzer.get_waveform = staticmethod(saved_wf)
            player_mod.decode_file = saved_dec
    try:
        require(app.audio_file is not None, f"the App did not open the file: {app.error_text}")
        require(opened["K3"] == 1 and sum(opened.values()) == 1,
                f"opening a file launched {opened}, not K3 once")
        want_pts = 2 * int(round(secs * 1000))
        require(app.file_waveform.shape == (want_pts, 2),
                f"waveform {app.file_waveform.shape}, the reference's {want_pts} points")
        ref = analyze_array(planar, MeterConfig(channels=2, rate=rate, max_blocks=0),
                            device=dev)
        want_gain = -13.0 - float(ref.integrated_lufs)
        require(abs(app.fft_gain_db - want_gain) <= 1e-3,
                f"fft_gain_db {app.fft_gain_db} against -13 - {float(ref.integrated_lufs)}")
        print(f"phase tui file: open {open_ms:.1f} ms (decode {spans['decode']:.1f}, "
              f"waveform {spans['waveform']:.1f}, integrated loudness "
              f"{spans['integrated']:.1f} ms), launches {opened}, {want_pts} waveform "
              f"points, fft_gain_db {app.fft_gain_db:.4f} (-13 - analyze_array's "
              f"{float(ref.integrated_lufs):.4f}) {on}")

        # every playhead report of the first 60 s, at the reference cadence
        frame_ms, draw_ms = [], []
        positions = [2048 * (k + 1) for k in range(TUI_POSITIONS)]
        base = launches()
        for k, pos in enumerate(positions):
            t0 = time.perf_counter()
            app.analyze_audio_file_samples(pos)
            frame_ms.append((time.perf_counter() - t0) * 1000)
            if k % DRAW_EVERY == DRAW_EVERY - 1 or k == len(positions) - 1:
                scr = Screen(200, 60)
                t0 = time.perf_counter()
                app.draw(scr)
                draw_ms.append((time.perf_counter() - t0) * 1000)
        ran = launches(since=base)
        want_k7 = sum(p > 16384 for p in positions)
        require(ran["K7"] == want_k7 and sum(ran.values()) == want_k7,
                f"{len(positions)} analysis frames launched {ran}, not K7 {want_k7} times")
        st = app.lufs[-1]
        require(abs(st + 23.0) <= 0.1, f"last short-term {st} LUFS, not -23.0")
        peak_x = float(app.fft_mid[np.argmax(app.fft_mid[:, 1]), 0])
        require(abs(peak_x - chart_x(997.0)) <= 1.0,
                f"mid spectrum peak at x {peak_x}, 997 Hz at {chart_x(997.0):.2f}")
        cur = positions[-1] // 2 // rate
        require("ebu3341" in scr.text() and f"{cur // 60:02d}:{cur % 60:02d}" in scr.text(),
                "the drawn frame lacks the title or the playhead time")
        print(f"phase tui file: {len(positions)} analysis frames (60 s), launches {ran}; "
              f"ms per frame median {pct(frame_ms, 50):.3f} p99 {pct(frame_ms, 99):.3f} "
              f"max {max(frame_ms):.3f} (wall, outputs on the host; the loop tick is 8 ms, "
              f"a report every 21.3 ms); {len(draw_ms)} draws of 200 x 60, ms per draw "
              f"median {pct(draw_ms, 50):.1f} p99 {pct(draw_ms, 99):.1f}; short-term "
              f"{st:.4f} LUFS, mid peak x {peak_x:.2f} (997 Hz at {chart_x(997.0):.2f}) {on}")

        more = iter(range(positions[-1] + 2048, 10 ** 9, 2048))
        prof = device_profile(lambda: app.analyze_audio_file_samples(next(more)), 50,
                              "k7_tile")
        if prof:
            print(f"profile tui frame: device {prof['device_ms'] * 1000:.3f} us per frame in "
                  f"{prof['ops']:.1f} device operations, K7 {prof['match_ms'] * 1000:.3f} us; "
                  f"wall {prof['wall_ms']:.4f} ms, idle share {prof['idle_share']:.4f} "
                  f"(torch.profiler, 50 frames) {on}")
        else:
            print("profile tui frame: the trace shows no device time (not measured)")

        # K7 at the TUI's push: the meter's strided view of 16,384
        # interleaved samples
        filt = kweight_filter(rate, 128, dev)
        inter = torch.from_numpy(app.audio_file.interleaved()[: 16384].copy()).to(dev)
        view = inter.reshape(-1, 2).T
        s0 = torch.zeros((2, 4), device=dev)
        y, s = IIR.block_iir_stream(filt, view, s0)
        yp, sp = IIR.block_iir_stream_plain(filt, view, s0)
        torch.cuda.synchronize()
        tol = 2e-5 * float(view.pow(2).mean().sqrt())
        err = max(check_close("K7 tui y", y, yp, 0.0, tol),
                  check_close("K7 tui s_final", s, sp, 0.0, tol))

        def call():
            IIR.block_iir_stream(filt, view, s0)

        k7_ms = time_ms(call, 400)
        plain_ms = time_ms(lambda: IIR.block_iir_stream_plain(filt, view, s0), 100)
        k7_ms = (k7_ms + time_ms(call, 400)) / 2
        kprof = device_profile(call, 50, "")
        dev_us = kprof["device_ms"] * 1000 if kprof else None
        print(f"timing K7 kernel {k7_ms:.4f} ms plain {plain_ms:.4f} ms (tui shape (2, 8192), "
              f"strided view; max abs err {err:.3e}); device "
              + ("not measured" if dev_us is None else f"{dev_us:.3f} us")
              + f" per call {on}")
        print(f"phase tui file: {time.time() - t_phase:.1f} s {on}")
        return {"k7_ms": k7_ms, "plain_ms": plain_ms, "err": err, "device_us": dev_us,
                "frame_ms": frame_ms, "launches": ran["K7"]}
    finally:
        app.handle_key("q")


def tui_mic_phase(tmp, on) -> None:
    """14. the TUI in microphone mode on the live pipeline."""
    from soundscope_tpu_torch.apps import tui as tui_mod
    from soundscope_tpu_torch.apps.capture import _pseudo_stereo, make_ring
    from soundscope_tpu_torch.apps.player import AudioPlayer
    from soundscope_tpu_torch.native import NativeRing
    from soundscope_tpu_torch.utils.metrics import launches

    t_phase = time.time()
    app = tui_mod.App(player=AudioPlayer(sink_factory=SilentSink),
                      config_dir=os.path.join(tmp, "cfg_mic"), device=None)
    try:
        app.handle_key("m")
        require(app.mode == tui_mod.Mode.MICROPHONE and app.live is not None,
                "microphone mode did not build the live pipeline")
        require(app.live_ready.wait(timeout=600), "the live pipeline did not warm up")
        require(app.live_error is None, f"the live pipeline failed: {app.live_error}")
        require(app.live.state.ring.is_cuda, "the live ring is not on the card")
        # the synthetic device stops; this phase feeds the ring itself, 8 ms
        # of a 700 Hz tone before each tick, as the device's callback would
        app.stream.stop()
        time.sleep(0.05)
        rate = 44100
        app.ring = make_ring(rate * 30)
        require(isinstance(app.ring, NativeRing), f"the ring is a {type(app.ring).__name__}")
        app._live_consumed = 0
        app.live.reset()
        ticks, tick_ms, pushed, fed = 3600, [], [], 0
        base = launches()
        for k in range(ticks):
            n = round((k + 1) * rate * 0.008) - round(k * rate * 0.008)
            i = np.arange(fed, fed + n)
            fed += n
            app.ring.push(_pseudo_stereo(
                (0.4 * np.sin(2 * np.pi * 700.0 * i / rate)).astype(np.float32)))
            before = app._live_consumed
            t0 = time.perf_counter()
            app.analyze_microphone_input()
            tick_ms.append((time.perf_counter() - t0) * 1000)
            if app._live_consumed != before:
                pushed.append(tick_ms[-1])
        ran = launches(since=base)
        quanta = app._live_consumed // app._live_quantum
        require(ran["K7"] == quanta and sum(ran.values()) == quanta,
                f"{quanta} quanta pushed, launches {ran}")
        peak_x = float(app.fft_mid[np.argmax(app.fft_mid[:, 1]), 0])
        require(abs(peak_x - chart_x(700.0)) <= 2.0,
                f"mic spectrum peak at x {peak_x}, 700 Hz at {chart_x(700.0):.2f}")
        print(f"phase tui mic: {ticks} ticks ({fed / rate:.2f} s of audio), {quanta} quanta "
              f"of 2,048, launches {ran}; ms per tick median {pct(tick_ms, 50):.3f} p99 "
              f"{pct(tick_ms, 99):.3f} max {max(tick_ms):.3f}; ticks that pushed and framed "
              f"({len(pushed)}) median {pct(pushed, 50):.3f} p99 {pct(pushed, 99):.3f} (the loop "
              f"tick 8 ms, the display period 16.7 ms); tone at x {peak_x:.2f} (700 Hz at "
              f"{chart_x(700.0):.2f}); {time.time() - t_phase:.1f} s {on}")
    finally:
        app.handle_key("q")


def cli_pool_phase(tmp, on) -> dict:
    """15. the CLI through the decode pool on a FLAC corpus; returns the
    pool's decode audio-s/s and the counters' per decode thread."""
    import multiprocessing
    from concurrent.futures import ThreadPoolExecutor

    from soundscope_tpu_torch.apps import cli
    from soundscope_tpu_torch.utils import io as sio
    from soundscope_tpu_torch.utils.metrics import GLOBAL as RT, launches

    t_phase = time.time()
    rate, secs = 48000, CLI_SECONDS
    flacs = [os.path.join(tmp, f"n{i:02d}.flac") for i in range(CLI_FILES)]
    wavs = [f[:-5] + ".wav" for f in flacs]
    jobs = [(f, w, SEED + 100 + i, rate, secs) for i, (f, w) in enumerate(zip(flacs, wavs))]
    t0 = time.time()
    with multiprocessing.get_context("spawn").Pool(min(os.cpu_count() or 4, 8)) as pool:
        enc = pool.map(encode_noise_pair, jobs)
    print(f"phase cli pool: {CLI_FILES} x {secs} s of 48 kHz stereo noise as FLAC and WAV in "
          f"{time.time() - t0:.1f} s ({sum(enc):.1f} s of encoding) {on}")
    threads = cli._decode_workers(CLI_FILES)
    audio_s = CLI_FILES * secs
    with native_decoders_only():
        t0 = time.time()
        with ThreadPoolExecutor(threads) as ex:
            decoded = list(ex.map(sio.decode_file, flacs))
        pool_s = time.time() - t0
        require(all(d.samples.shape == (2, rate * secs) for d in decoded), "decoded shapes")
        del decoded
        spec, prof = os.path.join(tmp, "spec"), os.path.join(tmp, "prof")
        runs = {}
        for name, files, extra in [("flac", flacs, ["--metrics", "--profile", prof]),
                                   ("wav", wavs, [])]:
            RT.reset()
            base = launches()
            out, err = io.StringIO(), io.StringIO()
            t0 = time.time()
            with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
                rc = cli.main(["analyze", *files, "--json", "--spectrogram",
                               os.path.join(spec, name), *extra])
            wall = time.time() - t0
            rows = json.loads(out.getvalue())
            ran = launches(since=base)
            require(rc == 0 and [r["file"] for r in rows] == files,
                    f"cli {name}: rc {rc}, {len(rows)} rows")
            for r in rows:
                for k in ("integrated_lufs", "lra_lu", "true_peak", "true_peak_dbtp",
                          "sample_peak", "spectrogram"):
                    require(r.get(k) is not None, f"cli {name} row {r['file']} lacks {k}")
            require(ran["K1"] == 1 and ran["K2"] == 1 and sum(ran.values()) == 2,
                    f"cli {name}: one bucket launched {ran}, not K1 and K2 once")
            runs[name] = (rows, wall, err.getvalue(), ran)
    rows_f, wall_f, err_f, ran_f = runs["flac"]
    for a, b in zip(rows_f, runs["wav"][0]):
        for k in a:
            if k not in ("file", "spectrogram"):
                require(a[k] == b[k], f"cli: {a['file']} {k} {a[k]} != the WAV's {b[k]}")
        sa, sb = np.load(a["spectrogram"]), np.load(b["spectrogram"])
        require(np.array_equal(sa["mid_db"], sb["mid_db"])
                and np.array_equal(sa["side_db"], sb["side_db"]),
                f"cli: {a['file']} spectrogram differs from the WAV's")
    rep = json.loads(err_f.strip().splitlines()[-1])["metrics"]
    traces = [os.path.join(prof, f) for f in os.listdir(prof) if f.endswith(".json")]
    require(len(traces) == 1, f"profile directory holds {os.listdir(prof)}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    gpu = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    for kernel in ("k1_tile", "k2_stft_pooled"):
        require(any(kernel in e.get("name", "") for e in gpu),
                f"the trace names no {kernel}: {len(events)} events, {len(gpu)} on the "
                f"device: {sorted({e.get('name', '')[:32] for e in gpu})[:12]}")
    print(f"phase cli pool: {CLI_FILES} FLAC files, rows equal to the WAV run's bit for "
          f"bit, launches {ran_f}; {threads} decode threads: the pool decodes "
          f"{audio_s / pool_s:.1f} audio-s/s ({pool_s:.3f} s for {audio_s} s), per decode "
          f"thread {rep['decode']['rt_factor']} audio-s/s; analyze end to end "
          f"{CLI_FILES / wall_f:.2f} files/s ({wall_f:.3f} s with --profile; the WAV run "
          f"{runs['wav'][1]:.3f} s = {CLI_FILES / runs['wav'][1]:.2f} files/s); metrics "
          f"{json.dumps(rep)}; the trace names K1 and K2; {time.time() - t_phase:.1f} s {on}")
    return {"pool": audio_s / pool_s, "per_thread": rep["decode"]["rt_factor"]}


# ------------------------------------- the sharded analysis (parallel/)

PROGRAMME_SECONDS, SECTION_SECONDS = 2 * 3600, 10
PROGRAMME_SHORT = 1237          # n_valid = N - 1,237, garbage past it
SHARDS = 4
STATE_TAIL = 4096               # the samples that set K7's end state


def programme(gen, n: int, nv: int, dev):
    """(1, 2, n) float32 on the card: seeded noise in 10 s sections at
    levels drawn between -40 and -15 dBFS, uniform garbage in [-1, 1)
    from sample nv on."""
    import torch

    sec = SECTION_SECONDS * RATE
    levels = torch.rand(-(-n // sec), generator=gen, device=dev) * 25.0 - 40.0
    x = torch.randn((1, 2, n), generator=gen, device=dev)
    gains = (10.0 ** (levels / 20.0)).repeat_interleave(sec)[:n]
    x.mul_(gains)
    del gains
    x[..., nv:] = torch.rand((1, 2, n - nv), generator=gen, device=dev) * 2.0 - 1.0
    return x


def sharded_deltas(what: str, got, ref) -> dict:
    """The largest delta of each component of the sharded path to the
    yardstick (parallel/dryrun.component_deltas), held to the JAX
    package's pins (tests/test_parallel.py): integrated, LRA and the
    valid timelines within 5e-3 LU, true peak within 1e-5, sample peak
    exact."""
    from soundscope_tpu_torch.parallel.dryrun import component_deltas

    d = component_deltas(got, ref)
    for f, pin in (("integrated_lufs", 5e-3), ("lra_lu", 5e-3), ("momentary", 5e-3),
                   ("shortterm", 5e-3), ("true_peak", 1e-5), ("sample_peak", 0.0)):
        require(d[f] <= pin, f"{what}: {f} off the yardstick by {d[f]:.3e} > {pin}")
    return d


def parallel_phases(dev, gen, on, lib) -> dict:
    """Phases 16-17 on a world of one NCCL rank (a card takes one rank).
    lib: phase 8's (cfg, rows, n_valid, result) of the library scan."""
    import datetime

    import torch
    import torch.distributed as dist

    from soundscope_tpu_torch.core.config import MeterConfig
    from soundscope_tpu_torch.models.engine import _finish, analyze_batch_native
    from soundscope_tpu_torch.ops import iir as IIR
    from soundscope_tpu_torch.ops.biquad import kweight_filter
    from soundscope_tpu_torch.parallel import (
        global_batch,
        init_distributed,
        make_mesh,
        pad_for_mesh,
        sharded_analyze_fn,
    )
    from soundscope_tpu_torch.parallel.dryrun import free_port, same
    from soundscope_tpu_torch.parallel.seqshard import composed_parts, gather_tracks
    from soundscope_tpu_torch.utils.metrics import launches

    out = {}
    t_phase = time.time()
    rank_dev = init_distributed(f"tcp://127.0.0.1:{free_port()}", 1, 0, device=dev,
                                timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh(1, seq=1)
        require(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
        print(f"phase sharded: backend {dist.get_backend()} world {dist.get_world_size()} "
              f"rank device {rank_dev} mesh {mesh.mesh_dim_names} {tuple(mesh.shape)} "
              f"on {mesh.device_type}")

        # 16. the 2-hour programme
        cfg = MeterConfig(channels=2, rate=RATE, max_blocks=0)
        n = PROGRAMME_SECONDS * RATE
        npad = pad_for_mesh(n, cfg, SHARDS)
        nv_n = n - PROGRAMME_SHORT
        x = programme(gen, npad, nv_n, dev)
        nv = torch.tensor([nv_n], device=dev)
        torch.cuda.synchronize()

        base = launches()
        ref = analyze_batch_native(cfg, x, nv)
        torch.cuda.synchronize()
        ran = launches(since=base)
        require(ran["K3"] == 1 and ran["K7"] == 0, f"yardstick launches {ran}")
        out["yardstick"] = ran

        fn = sharded_analyze_fn(cfg, mesh)
        xs, nvs = global_batch(mesh, x, nv)
        require(xs.data_ptr() == x.data_ptr(), "global_batch copied a world of one")
        base = launches()
        res1 = fn(xs, nvs)
        torch.cuda.synchronize()
        ran = launches(since=base)
        require(ran["K7"] == 1 and sum(ran.values()) == 1,
                f"seq 1 should launch K7 once and nothing else: {ran}")
        out["seq1"] = ran
        d1 = sharded_deltas("sharded seq 1", res1, ref)
        print(f"phase sharded: 2 h programme ({tuple(x.shape)}, n_valid {nv_n}), seq 1 "
              f"launches {ran}; largest delta to the yardstick (K3 {out['yardstick']}): "
              + ", ".join(f"{k} {v:.3e}" for k, v in d1.items()) + f" {on}")

        base = launches()
        sums4, tp4, sp4 = composed_parts(cfg, x, nv, SHARDS)
        torch.cuda.synchronize()
        ran = launches(since=base)
        require(ran["K7"] == 1 + 2 * (SHARDS - 1) and sum(ran.values()) == ran["K7"],
                f"the {SHARDS}-shard composition should launch K7 {1 + 2 * (SHARDS - 1)} "
                f"times and nothing else: {ran}")
        out["composed"] = ran
        res4 = _finish(cfg, sums4, nv, tp4, sp4)
        d4 = sharded_deltas(f"{SHARDS}-shard composition", res4, ref)
        sums1, tp1, sp1 = composed_parts(cfg, x, nv, 1)
        require(same(_finish(cfg, sums1, nv, tp1, sp1), res1),
                "the composition at seq 1 differs from the NCCL run")
        e_sums = check_close(f"{SHARDS}-shard sums vs seq 1", sums4, sums1, 3e-4, 2e-5)
        print(f"phase sharded: {SHARDS}-shard composition launches {ran}; largest delta to "
              "the yardstick: " + ", ".join(f"{k} {v:.3e}" for k, v in d4.items())
              + f"; sub-block sums vs seq 1 max abs err {e_sums:.3e}; the composition at "
              f"seq 1 equals the NCCL run bit for bit {on}")
        del sums4, sums1, res4

        # K7 at the path's shapes against its plain version: the whole
        # programme from zero state, a shard of 4 from its composed state
        filt = kweight_filter(RATE, cfg.block, dev)
        nloc = npad // SHARDS
        shard = x[0, :, nloc:2 * nloc].contiguous()
        s0 = torch.zeros((2, 4), device=dev)
        s1 = IIR.block_iir_stream(filt, x[0, :, :nloc].contiguous(), s0)[1]   # shard 0's end
        # y per unit RMS of the valid samples; the end state per unit RMS of
        # the row's last STATE_TAIL samples, which set it (the filter's
        # memory is a few hundred samples): at the programme's end these are
        # the garbage past n_valid, about 12x louder than the programme
        k7_errs = {}
        for name, xi, si in (("programme", x[0], s0), ("shard 1 of 4", shard, s1)):
            rms = float(xi[:, :nv_n].square().mean(dtype=torch.float64).sqrt())
            rms_end = float(xi[:, -STATE_TAIL:].square().mean(dtype=torch.float64).sqrt())
            y_k, s_k = IIR.block_iir_stream(filt, xi, si)
            y_p, s_p = IIR.block_iir_stream_plain(filt, xi, si)
            ey = max_err(y_k, y_p) / rms
            es = max_err(s_k, s_p) / rms_end
            del y_k, y_p
            require(ey <= 2e-5 and es <= 2e-5,
                    f"K7 at {name} {tuple(xi.shape)}: y {ey:.3e}, s_final {es:.3e} per unit RMS")
            k7_errs[name] = ey
            print(f"phase sharded: K7 at the {name} {tuple(xi.shape)} vs its plain version: "
                  f"y {ey:.3e} per unit RMS of the valid samples, s_final {es:.3e} per unit "
                  f"RMS of the last {STATE_TAIL} samples (RMS {rms_end:.4f}, valid {rms:.4f})")
        out["k7_err_rel"] = max(k7_errs.values())

        # EBU Tech 3341 case 1 through the sharded path
        ne = 20 * RATE
        t = torch.arange(pad_for_mesh(ne, cfg, 1), device=dev, dtype=torch.float64) / RATE
        tone = (10 ** (-23 / 20) * torch.sin(2 * torch.pi * 997.0 * t)).float()
        tone[ne:] = 0.0
        r_ebu = fn(*global_batch(mesh, tone.expand(1, 2, -1).contiguous(),
                                 torch.tensor([ne], device=dev)))
        ebu = float(r_ebu.integrated_lufs[0])
        require(abs(ebu + 23.0) < 0.1, f"sharded EBU 3341 case 1: {ebu} LUFS")
        print(f"phase sharded: EBU 3341 case 1 through sharded_analyze_fn {ebu:.4f} LUFS")

        # timings
        def composed():
            sums, tp, sp = composed_parts(cfg, x, nv, SHARDS)
            return _finish(cfg, sums, nv, tp, sp)

        out["seq1_ms"] = time_ms(lambda: fn(xs, nvs), 3)
        out["composed_ms"] = time_ms(composed, 3)
        out["yardstick_ms"] = time_ms(lambda: analyze_batch_native(cfg, x, nv), 5)
        full = x[0]
        out["k7_full_ms"] = time_ms(lambda: IIR.block_iir_stream(filt, full, s0), 5)
        out["k7_full_plain_ms"] = time_ms(lambda: IIR.block_iir_stream_plain(filt, full, s0), 2)
        out["k7_shard_ms"] = time_ms(lambda: IIR.block_iir_stream(filt, shard, s1), 10)
        out["k7_shard_plain_ms"] = time_ms(
            lambda: IIR.block_iir_stream_plain(filt, shard, s1), 2)
        out["k7_full_shape"], out["k7_shard_shape"] = tuple(full.shape), tuple(shard.shape)
        print(f"timing sharded: seq 1 {out['seq1_ms']:.4f} ms, {SHARDS}-shard composition "
              f"{out['composed_ms']:.4f} ms, yardstick (K3 fused) {out['yardstick_ms']:.4f} ms "
              f"per 2 h programme {on}")
        print(f"timing K7 kernel {out['k7_full_ms']:.4f} ms plain "
              f"{out['k7_full_plain_ms']:.4f} ms at {out['k7_full_shape']}; kernel "
              f"{out['k7_shard_ms']:.4f} ms plain {out['k7_shard_plain_ms']:.4f} ms at "
              f"{out['k7_shard_shape']} {on}")
        prof = device_profile(lambda: fn(xs, nvs), 2, "k7_tile")
        if prof:
            print(f"profile sharded seq 1: device {prof['device_ms']:.4f} ms per call in "
                  f"{prof['ops']:.1f} operations, K7 {prof['match_ms']:.4f} ms = "
                  f"{100 * prof['share']:.1f} %; wall {prof['wall_ms']:.4f} ms, idle share "
                  f"{prof['idle_share']:.4f}; most device time: "
                  + "; ".join(f"{n} {ms:.4f} ms" for n, ms in prof["top"])
                  + f" (torch.profiler, 2 calls) {on}")
        else:
            print("profile sharded seq 1: the trace shows no device time (not measured)")
        print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {on}")
        del x, xs, shard, full, ref, res1
        print(f"phase sharded: {time.time() - t_phase:.1f} s {on}")

        # 17. the data axis: the library scan through global_batch
        t_phase = time.time()
        cfg_lib, x_lib, nv_lib, res_lib = lib
        tracks = x_lib.view(nv_lib.shape[0], 2, x_lib.shape[-1])
        xb, nvb = global_batch(mesh, tracks, nv_lib)
        base = launches()
        got = gather_tracks(mesh, analyze_batch_native(cfg_lib, xb, nvb))
        torch.cuda.synchronize()
        ran = launches(since=base)
        require(ran["K5"] == 1 and ran["K6"] == 1 and sum(ran.values()) == 2,
                f"the data axis should launch K5 and K6 once each: {ran}")
        out["data"] = ran
        require(same(got, res_lib), "the data axis differs from phase 8's scan")
        print(f"phase data axis: {tuple(xb.shape)} through global_batch on the world-1 mesh, "
              f"launches {ran}, gathered over data: equal to phase 8's scan bit for bit; "
              f"{time.time() - t_phase:.1f} s {on}")
    finally:
        dist.destroy_process_group()
    return out


def dryrun_phase(on, limit_s: float = 240.0) -> None:
    """18. `python -m soundscope_tpu_torch.parallel.dryrun` on its default
    device, the card: one rank on card 0 (a child process, killed after
    limit_s) certifies every component; two ranks, on a machine with one
    card, are refused before a rank is spawned."""
    import torch

    from soundscope_tpu_torch.parallel.dryrun import launch

    outs = launch(1, timeout=limit_s)
    line = outs[0].strip().splitlines()[-1]
    require(line.startswith("dryrun_multichip ok: mesh=(1 data x 1 seq) on cuda"),
            f"the dryrun on the card: {line}")
    print(f"phase dryrun: one rank on the card: {line} {on}")
    if torch.cuda.device_count() < 2:
        try:
            launch(2, timeout=limit_s)
        except RuntimeError as e:
            require("2 ranks need 2 cards" in str(e), f"two ranks refused for another reason: {e}")
            print(f"phase dryrun: two ranks on one card refused: {e}")
        else:
            raise SmokeFailure("the dryrun ran two ranks on one card")


# ------------------- the conformance sweep, the bench and warmup (19-21)

CONF_LEVELS = 32


def conformance_phase(dev, on) -> None:
    """19. tools/conformance.py at 48 and 44.1 kHz, 32 levels each: every
    route within the budgets of the float64 chain and every kernel
    launched."""
    from soundscope_tpu_torch.tools import conformance

    for rate in (48000, 44100):
        t0 = time.time()
        rep = conformance.sweep(CONF_LEVELS, rate, dev)
        for route, r in rep["routes"].items():
            errs = ", ".join(f"{k} {r[k]:.6e}" for k in (
                "integrated_max_err_lu", "true_peak_max_err_db", "stft_pooled_max_err_db")
                if k in r)
            print(f"phase conformance: rate {rate} route {route}: {errs}; launches "
                  f"{r['launches']} {on}")
        ran = {k for r in rep["routes"].values() for k in r["launches"]}
        require(rep["pass"], f"conformance at {rate} Hz failed: {json.dumps(rep)}")
        require(ran >= {f"K{i}" for i in range(1, 8)},
                f"conformance at {rate} Hz launched only {sorted(ran)}")
        print(f"phase conformance: rate {rate}, {CONF_LEVELS} levels: worst integrated "
              f"{rep['integrated_max_err_lu']:.6e} LU, true peak "
              f"{rep['true_peak_max_err_db']:.6e} dB, spectrum "
              f"{rep['stft_pooled_max_err_db']:.6e} dB (budgets 0.1), pass; "
              f"{time.time() - t0:.1f} s {on}")


def bench_phase(main_rt: float, main_path, on) -> None:
    """20. soundscope_tpu_torch.bench at its default workload: its one JSON
    line, whose audio-s/s must agree with phase 6's within 15 %. Phase
    6's main path is timed again first, at this point of the run."""
    from soundscope_tpu_torch import bench

    t0 = time.time()
    print(f"phase bench: phase 6's main path again {time_ms(main_path, 5):.4f} ms per "
          f"batch {on}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main([])
    lines = buf.getvalue().strip().splitlines()
    require(rc == 0 and len(lines) == 1, f"bench rc {rc}, stdout {lines}")
    line = json.loads(lines[0])
    print(f"phase bench: {lines[0]}")
    ratio = line["value"] / main_rt
    require(abs(ratio - 1.0) <= 0.15,
            f"bench {line['value']:.1f} audio-s/s against phase 6's {main_rt:.1f}")
    print(f"phase bench: {line['value']:.1f} audio-s/s against phase 6's {main_rt:.1f} "
          f"(ratio {ratio:.4f}); {time.time() - t0:.1f} s {on}")


def library_scan_phase(scan_ms: float, on) -> None:
    """22. soundscope_tpu_torch.tools.library_scan_bench at its defaults:
    one JSON line, K5 and K6 launched, finite numbers, and ms per scan
    within 15 % of phase 9's `scan_ms` (the same scan of the same shape)."""
    import re

    from soundscope_tpu_torch.tools import library_scan_bench
    from soundscope_tpu_torch.utils.metrics import launches

    t0 = time.time()
    base = launches()
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = library_scan_bench.main([])
    ran = launches(since=base)
    lines = out.getvalue().strip().splitlines()
    for e in err.getvalue().strip().splitlines():
        print(f"phase library bench: {e}")
    require(rc == 0 and len(lines) == 1, f"library bench rc {rc}, stdout {lines}")
    print(f"phase library bench: {lines[0]}")
    line = json.loads(lines[0])
    require(ran["K5"] >= 1 and ran["K6"] >= 1, f"library bench launched {ran}, not K5 and K6")
    value = re.search(r"first scan .* value (\S+)", err.getvalue())
    require(value is not None and math.isfinite(float(value.group(1))),
            f"library bench: the scan's value is not finite: {err.getvalue()[:400]}")
    require(all(math.isfinite(line[k]) and line[k] > 0
                for k in ("scan_ms", "rt_factor", "tracks_per_sec")), f"library bench {line}")
    ratio = line["scan_ms"] / scan_ms
    require(abs(ratio - 1.0) <= 0.15,
            f"library bench {line['scan_ms']:.4f} ms per scan against phase 9's {scan_ms:.4f}")
    print(f"phase library bench: {line['scan_ms']:.4f} ms per scan against phase 9's "
          f"{scan_ms:.4f} ms (ratio {ratio:.4f}), launches {ran}; {time.time() - t0:.1f} s {on}")


E2E_TRACKS, E2E_SECONDS = 128, 15


def e2e_scan_phase(pool: dict, on) -> None:
    """23. soundscope_tpu_torch.tools.e2e_scan_bench at 128 x 15 s into a
    temporary directory: exit 0, no errors, a row for every file made,
    and K1 once per bucket of the timed scan. The warm-up takes one full
    bucket plus the last partial bucket's size, which is every file of a
    corpus of at most 128, so it launches K1 as often again. pool: phase
    15's decode figures, printed beside the bench's (context, not a gate:
    this corpus mixes kinds of file)."""
    from soundscope_tpu_torch.apps.cli import FLUSH_AT
    from soundscope_tpu_torch.tools import e2e_scan_bench
    from soundscope_tpu_torch.utils.metrics import launches

    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        base = launches()
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = e2e_scan_bench.main([str(E2E_TRACKS), str(E2E_SECONDS), "--keep", tmp])
        ran = launches(since=base)
        files = [f for f in os.listdir(tmp) if f.startswith("track")]
    lines = out.getvalue().strip().splitlines()
    for e in err.getvalue().strip().splitlines():
        print(f"phase e2e bench: {e}")
    require(rc == 0 and len(lines) == 1, f"e2e bench rc {rc}, stdout {lines}")
    print(f"phase e2e bench: {lines[0]}")
    line = json.loads(lines[0])
    require(line["errors"] == 0 and line["tracks"] == len(files) > 0,
            f"e2e bench: {line['tracks']} rows, {line['errors']} errors, {len(files)} files")
    buckets = -(-len(files) // FLUSH_AT)
    require(len(files) <= 2 * FLUSH_AT and ran["K1"] == 2 * buckets
            and sum(ran.values()) == ran["K1"],
            f"e2e bench: launches {ran} for {buckets} buckets of {len(files)} files")
    print(f"phase e2e bench: {len(files)} files of {line['kinds']}, K1 {buckets} times in the "
          f"timed scan ({ran['K1']} with the warm-up); decode {line['decode_rt']} audio-s/s "
          f"per thread on {line['decode_threads']} threads against phase 15's "
          f"{pool['per_thread']} per thread ({pool['pool']:.1f} for its pool of FLACs); "
          f"{time.time() - t0:.1f} s {on}")


def _package_copy(root: str) -> str:
    """A copy of the package under `root` without its built libraries (an
    empty build directory beside it), for fresh processes to build in."""
    import shutil

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "soundscope_tpu_torch")
    shutil.copytree(src, os.path.join(root, "soundscope_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__", "*.so", "*.so.*"))
    return root


def _child(args, cwd, limit_s: float = 300.0):
    """Run python with `args` from `cwd`, killed after limit_s; returns
    (wall s, rc, stdout, stderr)."""
    t0 = time.time()
    out = subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True,
                         text=True, timeout=limit_s)
    return time.time() - t0, out.returncode, out.stdout, out.stderr


def warmup_phase(tmp, on) -> None:
    """21. The first `analyze` of one file in a fresh process from a copy
    of the package with nothing built (both libraries built on the way),
    then `cli warmup` in a child process from another such copy (which
    must leave both libraries there) and the first `analyze` there after
    it."""
    from soundscope_tpu_torch.utils.io import write_wav

    t_phase = time.time()
    t = np.arange(10 * RATE) / RATE
    tone = (10 ** (-23 / 20) * np.sin(2 * np.pi * 997.0 * t)).astype(np.float32)
    wav = os.path.join(tmp, "tone.wav")
    write_wav(wav, np.stack([tone, tone]), RATE, bits=32)
    analyze = ["-m", "soundscope_tpu_torch.apps.cli", "analyze", wav, "--json",
               "--spectrogram", os.path.join(tmp, "spec")]
    libs = ("build/soundscope_tpu_torch", "soundscope_tpu_torch/native/libssnative_torch.so")

    def first_analyze(root, what):
        wall, rc, out, err = _child(analyze, root)
        require(rc == 0, f"analyze {what}: rc {rc}\n{err[-2000:]}")
        rows = json.loads(out)
        require(abs(rows[0]["integrated_lufs"] + 23.0) < 0.1, f"analyze {what}: {rows}")
        return wall

    cold = _package_copy(os.path.join(tmp, "cold"))
    cold_s = first_analyze(cold, "before warmup")
    for lib in libs:
        require(os.path.exists(os.path.join(cold, lib)), f"the cold analyze built no {lib}")

    warm = _package_copy(os.path.join(tmp, "warm"))
    require(not any(os.path.exists(os.path.join(warm, lib)) for lib in libs),
            "the package copy holds a built library")
    wall, rc, out, err = _child(["-m", "soundscope_tpu_torch.apps.cli", "warmup"], warm)
    require(rc == 0, f"warmup child rc {rc}\n{err[-2000:]}")
    for lib in libs:
        require(os.path.exists(os.path.join(warm, lib)), f"warmup built no {lib}")
    print(f"phase warmup: child {wall:.1f} s: {out.strip()} {on}")
    warm_s = first_analyze(warm, "after warmup")
    print(f"phase warmup: first analyze of one 10 s WAV in a fresh process "
          f"{cold_s:.1f} s with nothing built, {warm_s:.1f} s after warmup; "
          f"{time.time() - t_phase:.1f} s {on}")


def k2_timings(dev, gen, on) -> None:
    """K2 at the bench shape (32 x 60 s of 48 kHz stereo noise): CUDA-event
    ms per launch over 5 launches, three times. Times the
    soundscope_tpu_torch on sys.path."""
    from soundscope_tpu_torch.ops import stft_pooled as K2

    x = noise(gen, (TRACKS, 2, SECONDS * RATE // 2048 * 16, 128), dev)
    out = [time_ms(lambda: K2.stft_pooled_frames(x, RATE), 5) for _ in range(3)]
    print(f"timing K2 kernel {' '.join(f'{ms:.4f}' for ms in out)} ms, mean "
          f"{sum(out) / 3:.4f} ms (bench shape {tuple(x.shape)}) {on}")


def times_of(kernel: str, root: str) -> int:
    """--k2-times / --k7-times ROOT: k2_timings or k7_timings for the port
    under ROOT (a checkout, such as an unpacked earlier commit, to compare
    in one run on one card)."""
    import torch

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import soundscope_tpu_torch
    from soundscope_tpu_torch.ops import _build

    require(os.path.abspath(soundscope_tpu_torch.__file__).startswith(root + os.sep),
            f"soundscope_tpu_torch imported from {soundscope_tpu_torch.__file__}")
    _build.library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    print(f"{kernel} times of {root}")
    (k2_timings if kernel == "K2" else k7_timings)(dev, gen, f"[{card_line()}]")
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1:2] == ["--nonfinite"]:
        return nonfinite_child(sys.argv[2])
    if sys.argv[1:2] in (["--k2-times"], ["--k7-times"]):
        return times_of(sys.argv[1][2:4].upper(), sys.argv[2])
    from soundscope_tpu_torch.apps import cli
    from soundscope_tpu_torch.bench import (
        ENERGY_OPS,
        FILTER_OPS,
        bound,
        fir_ops,
        main_path_work,
    )
    from soundscope_tpu_torch.core.config import MeterConfig
    from soundscope_tpu_torch.models.engine import (
        analyze_array,
        analyze_batch_native,
        analyze_fn,
        pad_bucket,
        rows_plan,
    )
    from soundscope_tpu_torch.ops import _build
    from soundscope_tpu_torch.ops import iir as IIR
    from soundscope_tpu_torch.ops import iir_chunked as K1
    from soundscope_tpu_torch.ops import stft_pooled as K2
    from soundscope_tpu_torch.ops import truepeak_stream as K6
    from soundscope_tpu_torch.ops.biquad import kweight_filter
    from soundscope_tpu_torch.ops.kweight import channel_weights
    from soundscope_tpu_torch.utils.io import write_wav
    from soundscope_tpu_torch.utils.metrics import launches

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    on = f"[{card}]"
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # 1. build
    t_start = t0 = time.time()
    _build.library()
    print(f"phase build: {time.time() - t0:.2f} s (nvcc {_build.nvcc()})")

    def filt_fn(rate):
        return kweight_filter(rate, 128, dev)

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    n_bench = (SECONDS * RATE // 2048) * 2048
    nc_bench = n_bench // 128

    # 2. K1 against its plain version
    for factor, T in ((4, 8192), (2, 8192), (1, 16384)):
        print(f"k1 attributes (factor {factor}, T {T}): "
              f"{json.dumps(K1.kernel_attributes(factor, T))}")
    # 192 kHz: steps and tiles of 16,384 samples, 512 threads a CTA
    for rate, b, ragged in [(48000, 3, True), (44100, 3, True), (96000, 2, False),
                            (192000, 2, True)]:
        x4 = noise(gen, (b, 2, 512, 128), dev)
        n = 512 * 128
        nv = torch.tensor([n, n - 700, n // 2][:b] if ragged else [n] * b, device=dev)
        k1_compare(K1, filt_fn, x4, nv, rate)
    x_bench = noise(gen, (TRACKS, 2, nc_bench, 128), dev)
    nv_bench = torch.full((TRACKS,), n_bench, device=dev)
    nv_ragged = nv_bench.clone()
    nv_ragged[1::4] -= 48000 * 7 + 333
    k1_err = k1_compare(K1, filt_fn, x_bench, nv_ragged, RATE)
    f48 = filt_fn(RATE)
    a = K1.kweight_energy_tp_chunked(f48, x_bench, nv_ragged, (1.0, 1.0), RATE, 4800)
    b = K1.kweight_energy_tp_chunked(f48, x_bench, nv_ragged, (1.0, 1.0), RATE, 4800)
    torch.cuda.synchronize()
    require(all(torch.equal(u, v) for u, v in zip(a, b)), "K1 bench: two launches differ")
    del a, b
    print("phase k1: bench shape, two launches bit-identical ok")

    # 3. K2 against its plain version
    print(f"k2 attributes: {json.dumps(K2.kernel_attributes())}")
    for rate in (48000, 44100):
        fr = noise(gen, (3, 2, 16 * 240, 128), dev)    # 240 hops, 233 windows
        got = K2.stft_pooled_frames(fr, rate)
        want = K2.stft_pooled_frames_plain(fr, rate)
        torch.cuda.synchronize()
        for name, g, w in zip(("mid", "side"), got, want):
            check_close(f"K2 rate {rate} {name}", g, w, 0.0, 1e-3)
        print(f"phase k2: rate {rate} shape {tuple(fr.shape)} max abs dB err "
              f"{max(max_err(got[0], want[0]), max_err(got[1], want[1])):.3e} ok")
    k2_cases(K2, dev)
    got = K2.stft_pooled_frames(x_bench, RATE)
    want = K2.stft_pooled_frames_plain(x_bench, RATE)
    again = K2.stft_pooled_frames(x_bench, RATE)
    torch.cuda.synchronize()
    k2_err = max(check_close("K2 bench mid", got[0], want[0], 0.0, 1e-3),
                 check_close("K2 bench side", got[1], want[1], 0.0, 1e-3))
    require(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
            "K2 bench: two launches differ")
    print(f"phase k2: bench shape {tuple(x_bench.shape)} max abs dB err {k2_err:.3e}, "
          "two launches bit-identical ok")
    del got, want, again

    # 4. the main path at full size
    cfg = MeterConfig(channels=2, rate=RATE, max_blocks=0)
    base = launches()
    res = analyze_batch_native(cfg, x_bench, nv_bench)
    mid, side = K2.stft_pooled_frames(x_bench, RATE)
    torch.cuda.synchronize()
    launched = launches(since=base)
    require(launched["K1"] >= 1 and launched["K2"] >= 1,
            f"main path did not launch every kernel: {launched}")
    nw = n_bench // 2048 - 7
    require(res.integrated_lufs.shape == (TRACKS,) and res.true_peak.shape == (TRACKS, 2),
            "engine output shapes")
    require(mid.shape == side.shape == (TRACKS, nw, 128), "spectrogram shapes")
    valid_st = torch.arange(res.shortterm.shape[1], device=dev)[None] < res.n_shortterm[:, None]
    for name, v in [("integrated", res.integrated_lufs), ("lra", res.lra),
                    ("true_peak", res.true_peak), ("sample_peak", res.sample_peak),
                    ("shortterm", res.shortterm[valid_st]), ("mid_db", mid),
                    ("side_db", side)]:
        require(bool(torch.isfinite(v).all()), f"main path output {name} not finite")
    print(f"phase main: {TRACKS} x {n_bench / RATE:.3f} s at {RATE} Hz, launches {launched}, "
          f"integrated [{float(res.integrated_lufs.min()):.3f}, "
          f"{float(res.integrated_lufs.max()):.3f}] LUFS, all outputs finite")

    # the same path on a small slice, against the plain versions on the CPU
    xs = x_bench[:2, :, : 10 * RATE // 128].contiguous()
    nvs = torch.tensor([10 * RATE // 128 * 128, 8 * RATE], device=dev)
    r_gpu = analyze_batch_native(cfg, xs, nvs)
    r_cpu = analyze_batch_native(cfg, xs.cpu(), nvs.cpu())
    for f, rtol, atol in [("integrated_lufs", 0, 2e-3), ("lra", 0, 2e-3),
                          ("true_peak", 2e-6, 1e-7), ("sample_peak", 0, 0)]:
        check_close(f"engine cuda vs cpu {f}", getattr(r_gpu, f), getattr(r_cpu, f), rtol, atol)
    m = r_cpu.shortterm > -1e9
    check_close("engine cuda vs cpu shortterm", r_gpu.shortterm.cpu()[m], r_cpu.shortterm[m], 0, 2e-3)
    for g, c in zip(K2.stft_pooled_frames(xs, RATE), K2.stft_pooled_frames(xs.cpu(), RATE)):
        check_close("K2 cuda vs cpu", g, c, 0, 1e-3)
    print("phase main: small slice agrees with the plain versions on the CPU")

    t = torch.arange(20 * RATE, dtype=torch.float64) / RATE
    tone = (10 ** (-23 / 20) * torch.sin(2 * torch.pi * 997.0 * t)).float()
    ebu = analyze_array(torch.stack([tone, tone]).numpy(), cfg, device=dev)
    require(abs(float(ebu.integrated_lufs) + 23.0) < 0.1,
            f"EBU 3341 case 1 integrated {float(ebu.integrated_lufs)}")
    require(bool(((ebu.true_peak - 0.0708).abs() < 1e-3).all()),
            f"EBU 3341 case 1 true peak {ebu.true_peak.tolist()}")
    print(f"phase main: EBU 3341 case 1 integrated {float(ebu.integrated_lufs):.4f} LUFS "
          f"true peak {[round(v, 5) for v in ebu.true_peak.tolist()]}")

    # 5. the CLI in-process
    with tempfile.TemporaryDirectory() as tmp:
        wav = write_wav
        g = torch.Generator().manual_seed(SEED)
        files = []
        for name, secs in [("tone", 8), ("noise_a", 6), ("noise_b", 4)]:
            if name == "tone":
                x = torch.stack([tone[: secs * RATE]] * 2)
            else:
                x = torch.randn((2, secs * RATE), generator=g) * 0.05
            files.append(os.path.join(tmp, name + ".wav"))
            wav(files[-1], x.numpy(), RATE, bits=32)
        base = launches()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["analyze", *files, "--json", "--spectrogram",
                           os.path.join(tmp, "spec")])
        rows = json.loads(out.getvalue())
        require(rc == 0 and len(rows) == 3, f"cli rc {rc} rows {len(rows)}")
        for r in rows:
            for k in ("integrated_lufs", "lra_lu", "true_peak", "spectrogram"):
                require(r.get(k) is not None, f"cli row {r['file']} lacks {k}")
        require(abs(rows[0]["integrated_lufs"] + 23.0) < 0.1, "cli tone loudness")
        ran = launches(since=base)
        require(ran["K1"] >= 1 and ran["K2"] >= 1,
                f"cli launches K1 {ran['K1']} K2 {ran['K2']}")
        print(f"phase cli: {len(rows)} rows, launches K1 {ran['K1']} K2 {ran['K2']}, "
              f"integrated {[r['integrated_lufs'] for r in rows]}")

    # 6. timings at the bench shape (kernel, plain, kernel)
    f_bench = filt_fn(RATE)
    w2 = (1.0, 1.0)
    h = cfg.subblock

    def k1():
        K1.kweight_energy_tp_chunked(f_bench, x_bench, nv_bench, w2, RATE, h)

    def k1_plain():
        K1.kweight_energy_tp_chunked_plain(f_bench, x_bench, nv_bench, w2, RATE, h)

    def k2():
        K2.stft_pooled_frames(x_bench, RATE)

    def k2_plain():
        K2.stft_pooled_frames_plain(x_bench, RATE)

    def main_path():
        analyze_batch_native(cfg, x_bench, nv_bench)
        K2.stft_pooled_frames(x_bench, RATE)

    k1_ms = time_ms(k1, 5)
    k1_plain_ms = time_ms(k1_plain, 3)
    k1_ms = (k1_ms + time_ms(k1, 5)) / 2
    k2_ms = time_ms(k2, 5)
    k2_plain_ms = time_ms(k2_plain, 2)
    k2_ms = (k2_ms + time_ms(k2, 5)) / 2
    main_ms = time_ms(main_path, 5)
    audio_s = TRACKS * n_bench / RATE
    prof = device_profile(main_path, 3, "k2_stft_pooled")
    if prof:
        print(f"profile main path: device {prof['device_ms']:.4f} ms per batch, K2 "
              f"{prof['match_ms']:.4f} ms = {100 * prof['share']:.1f} % of device time; "
              f"wall {prof['wall_ms']:.4f} ms, idle share {prof['idle_share']:.4f} "
              f"(torch.profiler, 3 batches) {on}")
    else:
        print("profile main path: the trace shows no device time (not measured)")
    cufft_yardstick(x_bench, on)
    require(sync_sources(lambda: float(x_bench[0, 0, 0, 0])),
            "sync listing: a device-to-host read was not seen as a sync")
    syncs = sync_sources(lambda: analyze_batch_native(cfg, x_bench, nv_bench))
    print(f"sync main path: analyze_batch_native on the 4D bench input synchronises the "
          f"host at {syncs if syncs else 'no operation'}")
    print(f"timing K1 kernel {k1_ms:.4f} ms plain {k1_plain_ms:.4f} ms "
          f"(bench shape {tuple(x_bench.shape)}) {on}")
    print(f"timing K2 kernel {k2_ms:.4f} ms plain {k2_plain_ms:.4f} ms "
          f"(bench shape {tuple(x_bench.shape)}) {on}")
    print(f"timing main path {main_ms:.4f} ms per batch = "
          f"{audio_s / (main_ms / 1000):.1f} audio-seconds per second "
          f"({TRACKS} x {n_bench / RATE:.3f} s) {on}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {on}")

    # 7. K3-K6 against their plain versions: the CPU tests' cases ...
    for rate, b, ch, group, ks in [
            (48000, 3, 2, 32, "K3 K4 K5 K6"), (48000, 3, 2, 1, "K3 K4 K5"),
            (44100, 3, 2, 1, "K3 K4 K5 K6"), (96000, 3, 2, 32, "K3 K6"),
            (48000, 1, 2, 32, "K3 K4 K5 K6"), (192000, 1, 6, 32, "K4 K5"),
            (48000, 2, 6, 32, "K3"), (44100, 3, 6, 1, "K3"), (48000, 3, 1, 32, "K3")]:
        n = 226 * 128
        x = rows_noise(gen, (b, ch, n), dev)
        nv = torch.tensor([n, n - 700, n // 2][:b], device=dev)
        rows_compare(IIR, K6, filt_fn(rate), x, nv, rate, group, ks.split())
    for blk_n in (512 * 20, 384 * 25, 256 * 37, 128 * 73):
        x = rows_noise(gen, (3, 2, blk_n), dev)
        nv = torch.tensor([blk_n, blk_n - 333, blk_n // 2], device=dev)
        for rate in (48000, 96000):
            rows_compare(IIR, K6, None, x, nv, rate, 1, ["K6"])

    # ... and at each configuration's shape
    NPAD = pad_bucket(240 * 48000)                       # 2^24
    LIB_TRACKS, LIB_N = 1000, 15 * 48000                 # 720,000 = 5625 blocks
    NV_SINGLE = 240 * 48000
    NV_51 = 60 * 192000
    x_single = rows_noise(gen, (1, 2, NPAD), dev)
    nv_single = torch.tensor([NV_SINGLE], device=dev)
    x_51 = rows_noise(gen, (1, 6, NPAD), dev)
    nv_51 = torch.tensor([NV_51], device=dev)
    x_lib = rows_noise(gen, (2 * LIB_TRACKS, LIB_N), dev)
    nv_lib = torch.full((LIB_TRACKS,), LIB_N, device=dev)
    nv_lib[1::4] -= 48000 * 3 + 333
    x_slice, nv_slice = x_lib[:64], nv_lib[:32]         # 32 tracks, full length
    errs = {}
    errs.update(rows_compare(IIR, K6, filt_fn(48000), x_single, nv_single, 48000, 32, ["K3"]))
    # K3 on the tickets of a 5.1 file's rows, at 48 kHz
    k3_51 = rows_compare(IIR, K6, filt_fn(48000), x_51, nv_51, 48000, 32, ["K3"])
    errs["K3"] = max(errs["K3"], k3_51["K3"])
    errs.update(rows_compare(IIR, K6, filt_fn(192000), x_51, nv_51, 192000, 32,
                             ["K4", "K5"]))
    lib_errs = rows_compare(IIR, K6, filt_fn(48000), x_slice, nv_slice, 48000, 32,
                            ["K4", "K5", "K6"])
    errs["K5"], errs["K6"] = lib_errs["K5"], lib_errs["K6"]
    # a few long rows, ragged: past the look-back's depth in segments
    x_long = rows_noise(gen, (1, 2, 1 << 22), dev)
    nv_long = torch.tensor([(1 << 22) - 48000 * 3 - 333], device=dev)
    rows_compare(IIR, K6, filt_fn(48000), x_long, nv_long, 48000, 32, ["K3", "K4"])
    rows_compare(IIR, K6, filt_fn(44100), x_long, nv_long, 44100, 1, ["K3", "K4"])
    for factor in (4, 2):
        print(f"k3 attributes (k3_tile_tracks, factor {factor}, T {IIR.TP_TILE}): "
              f"{json.dumps(IIR.rows_attributes(factor, IIR.LOOKBACK, tracks=True))}")
    print(f"k4 attributes (k5_tile, T {IIR.CHAIN_TILE}, look-back {IIR.LOOKBACK}): "
          f"{json.dumps(IIR.rows_attributes(0, IIR.LOOKBACK))}")
    print(f"k5 attributes (k5_tile, row tickets, T {IIR.CHAIN_TILE}, look-back 0): "
          f"{json.dumps(IIR.rows_attributes(0, 0))}")
    print(f"k5 attributes (k5_tile_tracks, track tickets, T {IIR.CHAIN_TILE}): "
          f"{json.dumps(IIR.rows_attributes(0, 0, tracks=True))}")
    for factor in (4, 2):
        print(f"k6 attributes (factor {factor}, T {K6.TILE}): "
              f"{json.dumps(K6.kernel_attributes(factor))}")
    print(f"k7 attributes (T {IIR.CHAIN_TILE}): {json.dumps(IIR.stream_attributes())}")
    w2, w6 = (1.0, 1.0), tuple(float(v) for v in channel_weights(6))
    for what, fn in [
            ("K5 library slice", lambda: (IIR.kweight_energy_chain(
                filt_fn(48000), x_slice, nv_slice, w2, 32),)),
            ("K5 5.1 shape (row tickets)", lambda: (IIR.kweight_energy_chain(
                filt_fn(192000), x_51, nv_51, w6, 32),)),
            ("K3 single-file shape", lambda: IIR.kweight_energy_tp_prefix(
                filt_fn(48000), x_single, nv_single, w2, 48000, 32)),
            ("K3 5.1 shape at 48 kHz", lambda: IIR.kweight_energy_tp_prefix(
                filt_fn(48000), x_51, nv_51, w6, 48000, 32)),
            ("K4 5.1 shape", lambda: (IIR.kweight_energy_prefix(
                filt_fn(192000), x_51, nv_51, w6, 32),))]:
        a, b = fn(), fn()
        require(all(torch.equal(u, v) for u, v in zip(a, b)), f"{what}: two launches differ")
        print(f"phase rows: {what}, two launches bit-identical ok")
        del a, b
    nonfinite_phase(on)

    # 8. the rows-layout engine path in three configurations at full size
    def require_finite(what, res, lead, ch):
        """lead: the track axis, (b,) for a batch, () for one file."""
        require(tuple(res.integrated_lufs.shape) == lead and
                tuple(res.true_peak.shape) == (*lead, ch), f"{what}: output shapes")
        ok = (torch.arange(res.shortterm.shape[-1], device=dev)
              < res.n_shortterm.unsqueeze(-1))
        require(bool(ok.any()), f"{what}: no short-term value")
        for name, v in [("integrated", res.integrated_lufs), ("lra", res.lra),
                        ("true_peak", res.true_peak), ("sample_peak", res.sample_peak),
                        ("shortterm", res.shortterm[ok])]:
            require(bool(torch.isfinite(v).all()), f"{what}: {name} not finite")


    def agree(what, r_gpu, r_cpu):
        for f, rtol, atol in [("integrated_lufs", 0, 2e-3), ("lra", 0, 2e-3),
                              ("true_peak", 2e-6, 1e-7), ("sample_peak", 0, 0)]:
            check_close(f"{what} cuda vs cpu {f}", getattr(r_gpu, f), getattr(r_cpu, f),
                        rtol, atol)
        m = r_cpu.shortterm > -1e9
        check_close(f"{what} cuda vs cpu shortterm", r_gpu.shortterm.cpu()[m],
                    r_cpu.shortterm[m], 0, 2e-3)

    path_launches = {}
    cfg_lib = MeterConfig(channels=2, rate=48000, max_blocks=0)
    require(rows_plan(LIB_N, LIB_TRACKS, 2, 48000, 128) == ("chain", True), "library plan")
    base = launches()
    res_lib = analyze_batch_native(cfg_lib, x_lib, nv_lib)
    torch.cuda.synchronize()
    path_launches["library"] = launches(since=base)
    require(path_launches["library"]["K5"] >= 1 and path_launches["library"]["K6"] >= 1,
            f"library scan did not launch K5 and K6: {path_launches['library']}")
    require_finite("library scan", res_lib, (LIB_TRACKS,), 2)
    r_cpu = analyze_batch_native(cfg_lib, x_lib[:4].cpu(), nv_lib[:2].cpu())
    agree("library scan track 0", res_lib.track(0), r_cpu.track(0))
    agree("library scan track 1", res_lib.track(1), r_cpu.track(1))
    print(f"phase library: {LIB_TRACKS} x {LIB_N / 48000:.1f} s rows {tuple(x_lib.shape)}, "
          f"launches {path_launches['library']}, integrated "
          f"[{float(res_lib.integrated_lufs.min()):.3f}, "
          f"{float(res_lib.integrated_lufs.max()):.3f}] LUFS, finite, agrees with the CPU")

    t = np.arange(NV_SINGLE, dtype=np.float64) / 48000
    tone = (10 ** (-23 / 20) * np.sin(2 * np.pi * 997.0 * t)).astype(np.float32)
    track = np.stack([tone, tone])
    require(rows_plan(NPAD, 1, 2, 48000, 128) == ("fused", False), "single-file plan")
    base = launches()
    res_one = analyze_array(track, cfg, device=dev)
    torch.cuda.synchronize()
    path_launches["single"] = launches(since=base)
    require(path_launches["single"]["K3"] >= 1,
            f"single file did not launch K3: {path_launches['single']}")
    require_finite("single file", res_one, (), 2)
    st = res_one.shortterm[: int(res_one.n_shortterm)]
    require(abs(float(res_one.integrated_lufs) + 23.0) < 0.1 and
            float((st + 23.0).abs().max()) < 0.1,
            f"single file EBU 3341 case 1: {float(res_one.integrated_lufs)} LUFS")
    require(bool(((res_one.true_peak - 0.0708).abs() < 1e-3).all()),
            f"single file true peak {res_one.true_peak.tolist()}")
    short = track[:, : 20 * 48000]
    agree("single file first 20 s", analyze_array(short, cfg, device=dev),
          analyze_array(short, cfg, device="cpu"))
    print(f"phase single: 240 s EBU 3341 case 1 through analyze_array, launches "
          f"{path_launches['single']}, integrated {float(res_one.integrated_lufs):.4f} LUFS, "
          f"true peak {[round(v, 5) for v in res_one.true_peak.tolist()]}")

    cfg_51 = MeterConfig(channels=6, rate=192000, max_blocks=0)
    surround = x_51[0, :, :NV_51].cpu().numpy()
    require(rows_plan(NPAD, 1, 6, 192000, 128) == ("prefix", False), "5.1 plan")
    base = launches()
    res_51 = analyze_array(surround, cfg_51, device=dev)
    torch.cuda.synchronize()
    path_launches["5.1"] = launches(since=base)
    require(path_launches["5.1"]["K4"] >= 1,
            f"5.1 at 192 kHz did not launch K4: {path_launches['5.1']}")
    require_finite("5.1 at 192 kHz", res_51, (), 6)
    short = surround[:, : 8 * 192000]
    agree("5.1 first 8 s", analyze_array(short, cfg_51, device=dev),
          analyze_array(short, cfg_51, device="cpu"))
    print(f"phase 5.1: 60 s at 192 kHz through analyze_array, launches "
          f"{path_launches['5.1']}, integrated {float(res_51.integrated_lufs):.4f} LUFS")

    # 9. timings (kernel, plain, kernel), each pair at one shape
    w2, w6 = (1.0, 1.0), tuple(float(v) for v in channel_weights(6))
    f48, f192 = filt_fn(48000), filt_fn(192000)

    def pair(kernel, plain, iters, plain_iters):
        k = time_ms(kernel, iters)
        p = time_ms(plain, plain_iters)
        return (k + time_ms(kernel, iters)) / 2, p

    # K3 and K4 take a fraction of a millisecond: 20 calls a timing, so
    # that the host's start-up before the first launch weighs little
    k3_ms, k3_plain_ms = pair(
        lambda: IIR.kweight_energy_tp_prefix(f48, x_single, nv_single, w2, 48000, 32),
        lambda: IIR.kweight_energy_tp_prefix_plain(f48, x_single, nv_single, w2, 48000, 32),
        20, 2)
    k4_ms, k4_plain_ms = pair(
        lambda: IIR.kweight_energy_prefix(f192, x_51, nv_51, w6, 32),
        lambda: IIR.kweight_energy_prefix_plain(f192, x_51, nv_51, w6, 32), 20, 2)
    k5_at_k4_ms = time_ms(lambda: IIR.kweight_energy_chain(f192, x_51, nv_51, w6, 32), 5)
    k4_slice_ms, k4_slice_plain_ms = pair(
        lambda: IIR.kweight_energy_prefix(f48, x_slice, nv_slice, w2, 32),
        lambda: IIR.kweight_energy_prefix_plain(f48, x_slice, nv_slice, w2, 32), 5, 2)
    k5_ms, k5_plain_ms = pair(
        lambda: IIR.kweight_energy_chain(f48, x_slice, nv_slice, w2, 32),
        lambda: IIR.kweight_energy_chain_plain(f48, x_slice, nv_slice, w2, 32), 5, 2)
    k6_ms, k6_plain_ms = pair(
        lambda: K6.true_peak_stream(x_slice, nv_slice, 48000),
        lambda: K6.true_peak_stream_plain(x_slice, nv_slice, 48000), 5, 2)
    k4_lib_ms = time_ms(lambda: IIR.kweight_energy_prefix(f48, x_lib, nv_lib, w2, 32), 3)
    k5_lib_ms = time_ms(lambda: IIR.kweight_energy_chain(f48, x_lib, nv_lib, w2, 32), 3)
    k4_lib_ms = (k4_lib_ms + time_ms(
        lambda: IIR.kweight_energy_prefix(f48, x_lib, nv_lib, w2, 32), 3)) / 2
    k6_lib_ms = time_ms(lambda: K6.true_peak_stream(x_lib, nv_lib, 48000), 3)
    scan_ms = time_ms(lambda: analyze_batch_native(cfg_lib, x_lib, nv_lib), 3)
    x_one = torch.zeros((2, NPAD), device=dev)
    x_one[:, :NV_SINGLE] = torch.from_numpy(track).to(dev)
    single_ms = time_ms(lambda: analyze_fn(cfg, x_one, NV_SINGLE), 5)
    t0 = time.time()
    analyze_array(track, cfg, device=dev)
    torch.cuda.synchronize()
    single_wall_ms = (time.time() - t0) * 1000
    x_5 = torch.zeros((6, NPAD), device=dev)
    x_5[:, :NV_51] = x_51[0, :, :NV_51]
    surround_ms = time_ms(lambda: analyze_fn(cfg_51, x_5, NV_51), 5)
    lib_shape = f"library shape ({2 * LIB_TRACKS}, {LIB_N})"
    slice_shape = f"library slice {tuple(x_slice.shape)}"
    print(f"timing K3 kernel {k3_ms:.4f} ms plain {k3_plain_ms:.4f} ms "
          f"(single-file shape {tuple(x_single.shape)}) {on}")
    print(f"timing K4 kernel {k4_ms:.4f} ms plain {k4_plain_ms:.4f} ms "
          f"(5.1 shape {tuple(x_51.shape)}) {on}")
    print(f"timing K5 on row tickets (k5_tile + channel_sum) {k5_at_k4_ms:.4f} ms "
          f"at K4's 5.1 shape {tuple(x_51.shape)} {on}")
    print(f"timing K4 kernel {k4_slice_ms:.4f} ms plain {k4_slice_plain_ms:.4f} ms "
          f"({slice_shape}) {on}")
    print(f"timing K5 kernel {k5_ms:.4f} ms plain {k5_plain_ms:.4f} ms ({slice_shape}) {on}")
    print(f"timing K6 kernel {k6_ms:.4f} ms plain {k6_plain_ms:.4f} ms ({slice_shape}) {on}")
    print(f"timing K4 {k4_lib_ms:.4f} ms K5 {k5_lib_ms:.4f} ms K6 {k6_lib_ms:.4f} ms "
          f"({lib_shape}) {on}")
    print(f"timing library scan {scan_ms:.4f} ms per scan = "
          f"{LIB_TRACKS / (scan_ms / 1000):.1f} tracks per second "
          f"({LIB_TRACKS} x {LIB_N / 48000:.1f} s) {on}")
    print(f"timing single file (240 s, 48 kHz stereo) {single_ms:.4f} ms on the device "
          f"tensor, {single_wall_ms:.4f} ms through analyze_array from host memory {on}")
    print(f"timing 5.1 at 192 kHz (60 s) {surround_ms:.4f} ms on the device tensor {on}")
    for what, fn, kernel in [
            ("single file", lambda: analyze_fn(cfg, x_one, NV_SINGLE), "k3_tile"),
            ("5.1 at 192 kHz", lambda: analyze_fn(cfg_51, x_5, NV_51), "k5_tile")]:
        prof = device_profile(fn, 3, kernel)
        if prof:
            print(f"profile {what}: device {prof['device_ms']:.4f} ms per call, {kernel} "
                  f"{prof['match_ms']:.4f} ms = {100 * prof['share']:.1f} % of device time; "
                  f"wall {prof['wall_ms']:.4f} ms, idle share {prof['idle_share']:.4f} "
                  f"(torch.profiler, 3 calls) {on}")
        else:
            print(f"profile {what}: the trace shows no device time (not measured)")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {on}")

    # 10.-12. K7 and the streaming path
    k7_err, k7_err_rel = k7_phase(dev, gen, on)
    for shape, e in k7_float64_check(dev, on).items():
        require(e["kernel_y"] <= 2e-5 and e["kernel_s"] <= 2e-5,
                f"K7 at {shape} off the float64 evaluation: {e}")
    stream = streaming_phase(dev, gen, on)
    print(f"streaming: mic simulation {60 / stream['mic_wall_s']:.1f} audio-s/s with a "
          f"frame() every tick; 240 s track {240 / stream['slab_wall_s']:.1f} audio-s/s "
          f"through add_samples {on}")
    st = streaming_timings(dev, gen, on)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {on}")

    # 13.-15. the host surfaces: the TUI in file and microphone mode, the
    # CLI through its decode pool
    with tempfile.TemporaryDirectory() as tmp:
        tui = tui_file_phase(dev, tmp, on)
        tui_mic_phase(tmp, on)
        pool = cli_pool_phase(tmp, on)
    print(f"chip_smoke: phases 1-15 in {time.time() - t_start:.1f} s {on}")

    # 16.-17. the sharded analysis and the data axis on one NCCL rank
    t0 = time.time()
    par = parallel_phases(dev, gen, on, (cfg_lib, x_lib, nv_lib, res_lib))
    print(f"chip_smoke: phases 16-17 in {time.time() - t0:.1f} s, 1-17 in "
          f"{time.time() - t_start:.1f} s {on}")

    # 18. the sharded path's own entry point on its default device
    t0 = time.time()
    torch.cuda.empty_cache()
    dryrun_phase(on)
    print(f"chip_smoke: phase 18 in {time.time() - t0:.1f} s, 1-18 in "
          f"{time.time() - t_start:.1f} s {on}")

    # 19.-21. the conformance sweep, the bench and warmup
    t0 = time.time()
    conformance_phase(dev, on)
    bench_phase(audio_s / (main_ms / 1000), main_path, on)
    with tempfile.TemporaryDirectory() as tmp:
        warmup_phase(tmp, on)
    print(f"chip_smoke: phases 19-21 in {time.time() - t0:.1f} s, 1-21 in "
          f"{time.time() - t_start:.1f} s {on}")

    # 22.-23. the library-scan and end-to-end scan benches
    t0 = time.time()
    library_scan_phase(scan_ms, on)
    e2e_scan_phase(pool, on)
    print(f"chip_smoke: phases 22-23 in {time.time() - t0:.1f} s, 1-23 in "
          f"{time.time() - t_start:.1f} s {on}")

    # bounds at the timed shapes (bytes: inputs read once, outputs written once)
    n_slice = x_slice.numel()
    tick = 2 * 800
    bounds = {
        **{k: bound(*w) for k, w in main_path_work(TRACKS, n_bench, RATE).items()},
        # what this run's data needs: the valid samples (the function reads
        # nothing past n_valid, nor the LFE of weight 0), every output
        "K3": bound(4 * (2 * NV_SINGLE + NPAD // 32 + 4),
                    2 * NV_SINGLE * (FILTER_OPS + ENERGY_OPS + fir_ops(4))),
        "K4": bound(4 * (5 * NV_51 + NPAD // 32), 5 * NV_51 * (FILTER_OPS + ENERGY_OPS)),
        "K5": bound(4 * (n_slice + n_slice // 2 // 32), n_slice * (FILTER_OPS + ENERGY_OPS)),
        "K6": bound(4 * (n_slice + 2 * x_slice.shape[0]), n_slice * fir_ops(4)),
        "K7": bound(4 * (2 * tick + 2 * 8), tick * FILTER_OPS),
    }
    k7_ms, k7_plain_ms = st["k7_tick"][:2]
    rows = [
        ("K1 kweight_energy_tp_chunked", "iir_chunked.cu", "pallas_iir_chunked.py:383",
         launched["K1"], k1_err, k1_ms, k1_plain_ms),
        ("K2 stft_pooled_frames", "stft_pooled.cu", "pallas_stft.py:364",
         launched["K2"], k2_err, k2_ms, k2_plain_ms),
        ("K3 kweight_energy_tp_prefix", "iir_rows.cu", "pallas_iir.py:577",
         path_launches["single"]["K3"], errs["K3"], k3_ms, k3_plain_ms),
        ("K4 kweight_energy_prefix", "iir_rows.cu", "pallas_iir.py:500",
         path_launches["5.1"]["K4"], errs["K4"], k4_ms, k4_plain_ms),
        ("K5 kweight_energy_chain", "iir_rows.cu", "pallas_iir.py:308",
         path_launches["library"]["K5"], errs["K5"], k5_ms, k5_plain_ms),
        ("K6 true_peak_stream", "truepeak_stream.cu", "pallas_truepeak.py:166",
         path_launches["library"]["K6"], errs["K6"], k6_ms, k6_plain_ms),
        ("K7 block_iir_stream", "block_iir.cu", "pallas_iir.py:67",
         stream["mic"]["K7"], k7_err, k7_ms, k7_plain_ms),
    ]
    # no single PyTorch call computes any of these functions (a K-weighted
    # grouped energy, a pooled mid/side spectrogram, a polyphase true peak,
    # an IIR with carried state), so library_ms is null throughout
    kernels = [
        {"name": name, "route": "cuda", "source": f"soundscope_tpu_torch/csrc/{src}",
         "replaces": f"soundscope_tpu/ops/{rep}", "launches": n, "max_abs_err": err,
         "ms": ms, "plain_ms": plain, "bound_ms": bounds[name[:2]][0],
         "bound_by": bounds[name[:2]][1], "library_ms": None}
        for name, src, rep, n, err, ms, plain in rows]
    kernels[-1]["max_err_per_unit_rms"] = max(k7_err_rel, par["k7_err_rel"])
    # each path's own run, its counts set to 0 just before and read after
    by_path = {
        "K3": {"single file": path_launches["single"]["K3"],
               "2 h yardstick": par["yardstick"]["K3"]},
        "K5": {"library scan": path_launches["library"]["K5"], "data axis": par["data"]["K5"]},
        "K6": {"library scan": path_launches["library"]["K6"], "data axis": par["data"]["K6"]},
        "K7": {"mic": stream["mic"]["K7"], "sharded seq 1": par["seq1"]["K7"],
               f"sharded {SHARDS}-shard composition": par["composed"]["K7"]},
    }
    for k in kernels:
        if k["name"][:2] in by_path:
            k["launches_by_path"] = by_path[k["name"][:2]]
    n_lib = x_lib.numel()
    k7_slab_ms = st["k7_slab"][0]
    for name, (b_ms, by), ms in [
            *((k["name"], (k["bound_ms"], k["bound_by"]), k["ms"]) for k in kernels),
            ("K5 at the library shape", bound(4 * (n_lib + n_lib // 2 // 32),
                                              n_lib * (FILTER_OPS + ENERGY_OPS)), k5_lib_ms),
            ("K6 at the library shape", bound(4 * (n_lib + 2 * x_lib.shape[0]),
                                              n_lib * fir_ops(4)), k6_lib_ms),
            ("K7 at the slab shape", bound(4 * (2 * 2 * 44100 + 2 * 8), 2 * 44100 * FILTER_OPS),
             k7_slab_ms),
            ("K7 at the 5.1 slab shape", bound(4 * (2 * 6 * 192000 + 6 * 8),
                                               6 * 192000 * FILTER_OPS), st["k7_5.1 slab"][0]),
            ("K7 at the TUI shape (2, 8192)", bound(4 * (2 * 2 * 8192 + 2 * 8),
                                                   2 * 8192 * FILTER_OPS), tui["k7_ms"]),
            *((f"K7 at the sharded shape {par[f'k7_{w}_shape']}",
               bound(4 * (2 * math.prod(par[f"k7_{w}_shape"]) + 2 * 8),
                     math.prod(par[f"k7_{w}_shape"]) * FILTER_OPS), par[f"k7_{w}_ms"])
              for w in ("full", "shard"))]:
        print(f"bound {name}: {b_ms:.7f} ms by {by}, kernel {ms:.4f} ms = "
              f"{ms / b_ms:.1f} x bound {on}")
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
