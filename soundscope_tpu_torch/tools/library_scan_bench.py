"""The library scan: 1,000 tracks of 15 s of 48 kHz stereo in one batch.

    python -m soundscope_tpu_torch.tools.library_scan_bench [tracks] [seconds]
        [--repeats 3] [--device cuda|cpu]

The counterpart of the JAX package's ``tools/library_scan_bench.py``
(its BASELINE config 4). Workload: `tracks` (default 1,000) stereo tracks
of `seconds` (default 15) at 48 kHz, n = seconds * 48,000 rounded down to
the 128-sample filter block, as float32 noise * 0.1 made on the device
from a seeded torch.Generator in the rows layout (2 * tracks, n), every
track valid to its end. One scan is models/engine.analyze_batch_native
on it (from 1,024 rows `rows_plan` takes the "chain" route: K5 and K6 on
the card), then the JAX tool's reduction of the results to one scalar:
the sum of the finite integrated loudness values, of the LRA and of the
true peaks (three device operations).

Timing: one untimed first scan pays for the kernels' build and first
launch (its time goes to stderr). Then `--repeats` runs of 4 scans each:
the scalars accumulate on the device and are read back once per run,
inside the timed region, so that no scan can be skipped or left queued.
Each run is timed with CUDA events and by the wall clock until after the
read-back, and the slower of the two counts. The figure is the audio of
every timed run over their summed time (the JAX tool reports its best
run; this is the port's bench.py convention, so that a stall in any run
counts).

Stdout is one JSON line with the JAX tool's keys: {"metric":
"library_scan_rt_factor", "tracks", "scan_ms", "rt_factor" (audio
seconds per second), "tracks_per_sec", "device"}; each run's time and
the other details go to stderr. `--device cpu` runs the kernels' plain
versions; without a card the default device is an error (exit 2).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

RATE = 48000
SEED = 0
SCANS = 4          # scans per timed run


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def make_input(tracks: int, n: int, dev: torch.device) -> torch.Tensor:
    """(2 * tracks, n) float32 noise, randn * 0.1, made on `dev`."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    return torch.randn((2 * tracks, n), generator=gen, device=dev) * 0.1


def scan(cfg, x: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """One scan: the analysis and its reduction to a scalar on x's device
    (the JAX tool's: finite integrated loudness + LRA + true peak)."""
    from soundscope_tpu_torch.models.engine import analyze_batch_native

    r = analyze_batch_native(cfg, x, n_valid)
    return torch.cat([r.integrated_lufs.nan_to_num(0.0, 0.0, 0.0), r.lra,
                      r.true_peak.reshape(-1)]).sum()


def _timed_run(fn, cuda: bool) -> float:
    """Seconds per scan over SCANS scans, ending in one read-back of their
    sum: the slower of the CUDA-event and the wall-clock time on the card."""
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    acc = fn()
    for _ in range(SCANS - 1):
        acc = acc + fn()
    if cuda:
        end.record()
    float(acc)
    wall = time.perf_counter() - t0
    if cuda:
        wall = max(wall, start.elapsed_time(end) / 1e3)
    return wall / SCANS


def parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="python -m soundscope_tpu_torch.tools.library_scan_bench",
        description="Tracks per second of the batched library scan.")
    ap.add_argument("tracks", type=int, nargs="?", default=1000,
                    help="stereo tracks in the batch (default 1000)")
    ap.add_argument("seconds", type=float, nargs="?", default=15.0,
                    help="seconds per track (default 15)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed runs of 4 scans, all counted (default 3)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where to compute (default: cuda)")
    args = ap.parse_args(argv)
    if args.tracks < 1 or args.repeats < 1:
        ap.error("tracks and --repeats must be at least 1")
    if int(args.seconds * RATE) < 128:
        ap.error("seconds gives no filter block of 128 samples")
    return args


def run(args, dev: torch.device) -> dict:
    """Run the bench described by `args` on `dev`; returns the JSON line."""
    from soundscope_tpu_torch.core.config import MeterConfig

    cuda = dev.type == "cuda"
    cfg = MeterConfig(channels=2, rate=RATE, max_blocks=0)
    n = int(args.seconds * RATE) // cfg.block * cfg.block
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    log(f"device: {name}, tracks={args.tracks}, {n / RATE:.3f} s each, rows layout")
    x = make_input(args.tracks, n, dev)
    nv = torch.full((args.tracks,), n, dtype=torch.int64, device=dev)

    t0 = time.perf_counter()
    first = float(scan(cfg, x, nv))
    log(f"first scan (kernel build and load included): "
        f"{time.perf_counter() - t0:.2f} s, value {first:.3f}")
    total = 0.0
    for i in range(args.repeats):
        dt = _timed_run(lambda: scan(cfg, x, nv), cuda)
        total += dt
        log(f"run {i}: {dt * 1e3:.4f} ms per scan (over {SCANS})")
    per_scan = total / args.repeats
    return {"metric": "library_scan_rt_factor", "tracks": args.tracks,
            "scan_ms": per_scan * 1e3, "rt_factor": args.tracks * n / RATE / per_scan,
            "tracks_per_sec": args.tracks / per_scan, "device": name}


def main(argv=None) -> int:
    from soundscope_tpu_torch.core.device import default_device

    args = parse_args(sys.argv[1:] if argv is None else argv)
    try:
        dev = default_device(args.device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(json.dumps(run(args, dev)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
