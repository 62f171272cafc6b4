"""Benchmark of the port: batched real-time factor of the full LUFS + STFT
analysis on the card.

    python -m soundscope_tpu_torch.bench [--tracks 32] [--seconds 60]
        [--repeats 3] [--rate 48000] [--device cuda|cpu] [--profile DIR]
        [--check]
    python -m soundscope_tpu_torch.apps.cli bench [same flags]

The counterpart of the JAX package's root ``bench.py``. Workload: 32
tracks of 60 s of 48 kHz stereo noise (randn * 0.1 from a seeded
torch.Generator, made on the device in the frames view (b, 2, N/128,
128), N rounded down to 16 filter blocks). One iteration is the whole
BS.1770-4 chain (models/engine.analyze_batch_native: K1 on the card) and
the pooled mid/side display spectrogram (ops/stft_pooled.
stft_pooled_frames: K2), then a sum of every finite output, so that
nothing of either can be skipped. After a warm-up, `--repeats` runs of 8
iterations are timed with CUDA events, each ending in one read of the
sum; the metric is all the audio of all the runs over their summed
time, so that a stall in any run counts. Each run's time goes to stderr.

Stdout is one JSON line: {"metric": "rt_factor_lufs_stft", "value":
audio-seconds per second, "unit": "audio_sec/sec/chip", "device": ...};
on the card also "ms_per_iter" and "sol_frac", the sum of K1's and K2's
bounds over the iteration time: each the larger of its bytes over the
H100 SXM's published 3.35 TB/s and its float32 operations over its 67
TFLOP/s (`main_path_work`, the counts of chip_smoke.py's bounds). The
bytes and operations go to stderr with the other details. With
`--device cpu` the same iteration runs the kernels' plain versions and
the line carries no device figures.

`--check` then runs the conformance sweep (tools/conformance.py; 3 levels
and 2 windows on the CPU) and exits 1 when it fails. The JAX bench's RT
regression check against tools/bench_baseline.json is not made: that
file records a TPU figure.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

SEED = 0
INNER = 8          # iterations per timed run

# the H100 SXM's published peaks: HBM bytes and float32 operations
# (outside the tensor cores) per millisecond
HBM_BYTES_PER_MS = 3.35e12 / 1e3
F32_OPS_PER_MS = 67e12 / 1e3
# float32 operations per sample that the functions need, an FMA counting
# two: the 4-state modal filter, A two 2x2 blocks (advance: 4 multiplies +
# 8 FMAs; output: 1 multiply + 4 FMAs), the weighted square w*y*y added
# to a sum, and the polyphase FIR over the phases other than phase 0 (a
# unit impulse, whose outputs are the samples) and their nonzero taps
FILTER_OPS = 29
ENERGY_OPS = 3
# one packed complex 16,384-point FFT (5 N log2 N) and the window
FFT_WINDOW_OPS = 5 * 16384 * 14 + 6 * 16384


def fir_ops(factor: int) -> int:
    return {1: 0, 2: 2 * 1 * 24, 4: 2 * 3 * 12}[factor]


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations")."""
    b, o = nbytes / HBM_BYTES_PER_MS, ops / F32_OPS_PER_MS
    return (b, "bytes") if b >= o else (o, "operations")


def main_path_work(b: int, n: int, rate: int) -> dict:
    """(bytes, float32 operations) of K1 and K2 on b stereo tracks of n
    samples: each input read once, each output written once."""
    from soundscope_tpu_torch.core import constants as C

    samples = b * 2 * n
    nw = max(n // 2048 - 7, 0)
    return {
        "K1": (4 * samples, samples * (FILTER_OPS + ENERGY_OPS
                                       + fir_ops(C.true_peak_factor(rate)))),
        "K2": (4 * samples + 4 * b * nw * 128 * 2, b * nw * FFT_WINDOW_OPS),
    }


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def bench_length(seconds: float, rate: int) -> int:
    """Samples per track: seconds * rate rounded down to 16 filter blocks."""
    from soundscope_tpu_torch.core.config import MeterConfig

    step = MeterConfig(channels=2, rate=rate).block * 16
    return int(seconds * rate) // step * step


def make_input(b: int, n: int, dev: torch.device) -> torch.Tensor:
    """(b, 2, n/128, 128) float32 noise, randn * 0.1, made on `dev`."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    return torch.randn((b, 2, n // 128, 128), generator=gen, device=dev) * 0.1


def step(cfg, x: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """One iteration: the analysis, the spectrogram's per-track maxima of
    mid and side, and the sum of every finite value of them (a scalar on
    x's device)."""
    from soundscope_tpu_torch.models.engine import analyze_batch_native
    from soundscope_tpu_torch.ops.stft_pooled import stft_pooled_frames

    res = analyze_batch_native(cfg, x, n_valid)
    mid, side = stft_pooled_frames(x, cfg.rate)
    out = torch.cat([res.integrated_lufs, res.lra, res.true_peak.reshape(-1),
                     mid.amax(dim=(-2, -1)), side.amax(dim=(-2, -1))])
    # few operations: the main path is bound by the host's dispatch
    return out.nan_to_num(nan=0.0, posinf=0.0, neginf=0.0).sum()


def _timed_run(fn, cuda: bool) -> float:
    """Seconds per iteration over INNER iterations, ending in one read of
    their accumulated sum (CUDA events on the card)."""
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    acc = fn()
    for _ in range(INNER - 1):
        acc = acc + fn()
    if cuda:
        end.record()
    float(acc)
    if cuda:
        return start.elapsed_time(end) / 1e3 / INNER
    return (time.perf_counter() - t0) / INNER


def parse_args(argv):
    from soundscope_tpu_torch.ops.stft_pooled import rate_supported

    ap = argparse.ArgumentParser(
        prog="python -m soundscope_tpu_torch.bench",
        description="Real-time factor of the full LUFS + STFT analysis.")
    ap.add_argument("--tracks", type=int, default=32, help="tracks per batch (default 32)")
    ap.add_argument("--seconds", type=float, default=60.0,
                    help="seconds per track (default 60)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed runs of 8 iterations, all counted (default 3)")
    ap.add_argument("--rate", type=int, default=48000, help="sample rate (default 48000)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to compute (default: cuda)")
    ap.add_argument("--profile", metavar="DIR",
                    help="write a torch.profiler Chrome trace of 3 iterations to DIR")
    ap.add_argument("--check", action="store_true",
                    help="then run the conformance sweep; exit 1 when it fails")
    args = ap.parse_args(argv)
    if args.tracks < 1 or args.repeats < 1:
        ap.error("--tracks and --repeats must be at least 1")
    if not rate_supported(args.rate):
        ap.error(f"rate {args.rate}: K2 needs a rate above 40 kHz")
    if bench_length(args.seconds, args.rate) < 16384:
        ap.error("--seconds gives no spectrogram window (at least 16,384 samples)")
    return args


def run(args, dev: torch.device) -> dict:
    """Run the benchmark described by `args` on `dev`; returns the JSON
    line's object."""
    from soundscope_tpu_torch.core.config import MeterConfig

    cuda = dev.type == "cuda"
    b, rate = args.tracks, args.rate
    n = bench_length(args.seconds, rate)
    cfg = MeterConfig(channels=2, rate=rate, max_blocks=0)
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    log(f"device: {name}, tracks={b}, samples={n} ({n / rate:.3f} s) at {rate} Hz, "
        "layout 4D frames")

    t0 = time.perf_counter()
    x = make_input(b, n, dev)
    nv = torch.full((b,), n, dtype=torch.int64, device=dev)
    if cuda:
        torch.cuda.synchronize(dev)
    log(f"device input gen: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    first = float(step(cfg, x, nv))
    log(f"first iteration (kernel build and load included): "
        f"{time.perf_counter() - t0:.2f} s, sum {first:.3f}")
    t0 = time.perf_counter()
    float(step(cfg, x, nv))
    log(f"single synced iteration: {(time.perf_counter() - t0) * 1e3:.3f} ms")

    if args.profile:
        from soundscope_tpu_torch.utils.metrics import profile_trace

        with profile_trace(args.profile) as path:
            acc = step(cfg, x, nv)
            for _ in range(2):
                acc = acc + step(cfg, x, nv)
            float(acc)
        log(f"trace of 3 iterations written to {path}")

    total = 0.0
    for i in range(args.repeats):
        dt = _timed_run(lambda: step(cfg, x, nv), cuda)
        total += dt
        log(f"run {i}: {dt * 1e3:.4f} ms per iteration (sustained over {INNER})")

    per_iter = total / args.repeats
    audio_s = b * n / rate
    line = {"metric": "rt_factor_lufs_stft", "value": audio_s / per_iter,
            "unit": "audio_sec/sec/chip", "device": name}
    if cuda:
        work = main_path_work(b, n, rate)
        nbytes = sum(w[0] for w in work.values())
        ops = sum(w[1] for w in work.values())
        sol_ms = sum(bound(*w)[0] for w in work.values())
        ms = per_iter * 1e3
        line.update({"ms_per_iter": ms, "sol_frac": sol_ms / ms})
        log(f"work: {nbytes} bytes ({nbytes / HBM_BYTES_PER_MS / ms:.4f} of 3.35 TB/s), "
            f"{ops} float32 operations ({ops / F32_OPS_PER_MS / ms:.4f} of 67 TFLOP/s); "
            f"bound {sol_ms:.4f} ms")
    return line


def check(args) -> int:
    """The conformance sweep at the bench's rate on its device (3 levels
    and 2 windows on the CPU); its report goes to stderr. 0 on a pass."""
    from soundscope_tpu_torch.tools import conformance

    conf = ["--json", "--device", args.device, "--rate", str(args.rate)]
    if args.device == "cpu":
        conf += ["--levels", "3", "--stft-windows", "2"]
    with contextlib.redirect_stdout(sys.stderr):
        rc = conformance.main(conf)
    log(f"conformance: {'PASS' if rc == 0 else 'FAIL'}")
    log("rt check: skipped (tools/bench_baseline.json records a TPU figure, "
        "no baseline of the port)")
    return rc


def main(argv=None) -> int:
    from soundscope_tpu_torch.core.device import default_device

    args = parse_args(sys.argv[1:] if argv is None else argv)
    try:
        dev = default_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(json.dumps(run(args, dev)), flush=True)
    return check(args) if args.check else 0


if __name__ == "__main__":
    raise SystemExit(main())
