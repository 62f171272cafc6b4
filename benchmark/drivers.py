"""How a traffic mix drives the program, named by the mix's `driver` key.

* `batch`: a closed loop with two batches in flight. A device-resident batch
  of `tracks` tracks of the configuration's `channels` padded to `track_s`
  seconds (layout `frames` (b, ch, N/128, 128) or `rows` (ch * b, N))
  through the engine, with the pooled mid/side spectrogram where
  `spectrogram` is true (stereo only: another channel count with it is a
  ValueError); each step ends in the host copies of the per-track true
  and sample peaks, integrated loudness and LRA, as the CLI reads them,
  which the host waits for once the next step is queued. Where the mix
  gives `valid_s` [lo, hi], the tracks' valid lengths are whole seconds
  spread evenly from lo to hi, in an order drawn from the seed (the same
  work for every seed), and the padding behind them holds signal that no
  result may see; otherwise every track is valid to its end. The spectrogram takes no valid length: it
  covers the whole track. Metric: audio_s_per_s, of the valid audio.

The driver warms up the shapes of its traffic, measures for `seconds`,
then, once the window has closed and the memory peak has been read,
compares what the timed path produced with the float64 reference. It
prints the set-up's parts to stderr: process start to the driver's entry,
the CUDA context, the program's import, the traffic's generation and the
warm-up.
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time
import traceback

import numpy as np
import torch

from benchmark import generator, trace
from benchmark.check import Numbers, gap
from benchmark.reference import bs1770, display


@dataclasses.dataclass
class Ctx:
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    system: object
    t_start: float          # perf_counter at process start
    kernels: dict
    limits: dict            # the cell's limits file


@dataclasses.dataclass
class Run:
    attempted: int
    failed: int
    e2e: dict
    setup_s: float
    memory_peak_bytes: int
    numbers: Numbers
    reading: trace.Reading | None


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def pct(xs, q: float) -> float:
    """The q-th percentile (0-100) of xs, linear between order statistics."""
    return float(np.percentile(np.asarray(xs, np.float64), q))


def memory_peak(dev) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0


class Loop:
    """Steps in a window of `seconds`; in a traced run one stretch of
    `trace_steps` steps after `trace_skip` is profiled."""

    def __init__(self, ctx: Ctx, spans: trace.Spans):
        self.ctx, self.spans = ctx, spans
        self.stretch = self.done = None
        self.index = 0
        tr = ctx.traffic
        self.skip, self.count = tr["trace_skip"], tr["trace_steps"]
        if ctx.trace and ctx.device.type == "cuda":
            trace.warm_profiler()

    def before(self) -> None:
        if self.ctx.trace and self.index == self.skip and self.ctx.device.type == "cuda":
            self.stretch = trace.Stretch(self.spans).__enter__()

    def after(self, shape) -> None:
        self.index += 1
        if self.stretch is not None:
            self.stretch.step(shape)
            if self.stretch.steps >= self.count:
                self.close()

    def close(self) -> None:
        if self.stretch is not None:
            self.stretch.__exit__(None, None, None)
            self.done, self.stretch = self.stretch, None

    def read(self) -> trace.Reading | None:
        """The traced stretch's reading, taken once the window has closed."""
        self.close()
        return self.done.reading(self.ctx.kernels) if self.done is not None else None


def whole_result(res, i=None) -> dict:
    """Every field of an engine result on the host (track i of a batch)."""
    out = {}
    for k, v in (("integrated", "integrated_lufs"), ("lra", "lra"), ("true_peak", "true_peak"),
                 ("sample_peak", "sample_peak"), ("momentary", "momentary"),
                 ("shortterm", "shortterm"), ("n_momentary", "n_momentary"),
                 ("n_shortterm", "n_shortterm")):
        t = getattr(res, v)
        out[k] = (t if i is None else t[i]).cpu().numpy()
    return out


def guarded(fn, failures: list):
    """fn() or None where it raised (the traceback to stderr)."""
    try:
        return fn()
    except Exception:       # a failed call counts, and the window goes on
        failures.append(traceback.format_exc())
        log(failures[-1])
        return None


def valid_lengths(tr: dict, b: int, n: int, rate: int, seed: int) -> list[int]:
    """Each track's valid length in samples (at most n)."""
    if "valid_s" not in tr:
        return [n] * b
    lo, hi = tr["valid_s"]
    secs = [round(lo + (hi - lo) * i / max(b - 1, 1)) for i in range(b)]
    order = np.random.default_rng(seed).permutation(b)
    return [min(secs[j] * rate, n) for j in order]


def batch(ctx: Ctx) -> Run:
    t_entry = time.perf_counter()
    cfg, tr, dev, sysm = ctx.config, ctx.traffic, ctx.device, ctx.system
    rate, b, ch = cfg["rate"], tr["tracks"], cfg["channels"]
    if tr["spectrogram"] and ch != 2:
        raise ValueError(f"the traffic asks for the mid/side spectrogram, which needs 2 "
                         f"channels; the configuration has {ch}")
    unit = 2048 if tr["layout"] == "frames" else 128
    n = int(tr["track_s"] * rate) // unit * unit
    sync(dev)
    t_context = time.perf_counter()
    mc = sysm.meter_config(cfg)
    t_import = time.perf_counter()
    x = generator.tracks(ctx.seed, b, n, rate, tr["signal"], dev, channels=ch)
    x_in = x.view(b, ch, n // 128, 128) if tr["layout"] == "frames" else x.view(ch * b, n)
    lengths = valid_lengths(tr, b, n, rate, ctx.seed)
    nv = torch.as_tensor(lengths, dtype=torch.int64, device=dev)
    sync(dev)
    t_traffic = time.perf_counter()
    spans = trace.Spans()
    rng = np.random.default_rng(ctx.seed)
    idx = (np.arange(b) if tr.get("check_tracks") is None
           else np.sort(rng.choice(b, tr["check_tracks"], replace=False)))

    def launch():
        """Queue a scan and its results' host copies; the copies land in
        pinned memory behind the scan, so the host can queue the next."""
        t = time.perf_counter()
        with spans("engine.analyze_batch_native"):
            res = sysm.analyze_batch(mc, x_in, nv)
            spec = sysm.spectrogram(x_in, rate) if tr["spectrogram"] else None
        host = []
        for v in (res.true_peak, res.sample_peak, res.integrated_lufs, res.lra):
            h = torch.empty(v.shape, dtype=v.dtype, pin_memory=dev.type == "cuda")
            host.append(h.copy_(v, non_blocking=True))
        done = torch.cuda.Event() if dev.type == "cuda" else None
        if done is not None:
            done.record()
        return t, res, spec, host, done

    def finish(queued):
        t, res, spec, host, done = queued
        with spans("host.readback"):
            if done is not None:
                done.synchronize()
        scan_ms.append((time.perf_counter() - t) * 1e3)
        return res, spec, [h.numpy()[idx] for h in host]

    scan_ms: list[float] = []
    queued = None
    for _ in range(tr["warmup_steps"]):
        nxt = launch()
        if queued is not None:
            finish(queued)
        queued = nxt
    if queued is not None:
        finish(queued)
    sync(dev)
    spans.ms.clear()
    scan_ms.clear()
    loop = Loop(ctx, spans)
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_start
    log(f"set-up {setup_s:.4f} s: entry {t_entry - ctx.t_start:.4f}, cuda context "
        f"{t_context - t_entry:.4f}, program import {t_import - t_context:.4f}, traffic "
        f"{t_traffic - t_import:.4f}, warm-up {t0 - t_traffic:.4f}")
    keep = generator.Reservoir(tr["check_steps"], ctx.seed)
    host_all, failures = [], []

    def take(queued):
        out = guarded(lambda: finish(queued), failures)
        if out is not None:
            keep.offer(out)
            host_all.append(out[2])

    # a closed loop with two scans in flight: scan i + 1 is queued before
    # the host waits for scan i's results
    queued = None
    while True:
        loop.before()
        nxt = guarded(launch, failures)
        loop.after({"b": b, "n": n, "valid": sum(lengths)})
        if queued is not None:
            take(queued)
        queued = nxt
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    if queued is not None:
        take(queued)
    window = time.perf_counter() - t0
    del queued, nxt
    reading = loop.read()
    attempted = loop.index
    ok = attempted - len(failures)
    log(f"window {window:.4f} s: {ok} of {attempted} scans of {b} tracks, "
        f"{sum(lengths) / rate:.4f} audio-s in rows of {n / rate:.4f} s; queued to "
        f"results on the host ms p50 {pct(scan_ms, 50):.4f} p99 {pct(scan_ms, 99):.4f}")
    peak = memory_peak(dev)

    nums = Numbers()
    sampled = keep.items
    gc.collect()
    t_ref = time.perf_counter()
    x3 = x.view(b, ch, n)
    refs = bs1770.analyze(x3[torch.as_tensor(idx, device=dev)], [lengths[i] for i in idx], rate)
    if host_all:        # every step's host copies at once: (steps, tracks[, ch])
        got = dict(zip(("true_peak", "sample_peak", "integrated", "lra"),
                       (np.stack(c) for c in zip(*host_all))))
        nums.analysis(got, {k: np.broadcast_to(np.stack([r[k] for r in refs]), v.shape)
                            for k, v in got.items()})
    for res, spec, _ in sampled:
        for j, i in enumerate(idx):
            nums.analysis(whole_result(res, i), refs[j])
    if tr["spectrogram"]:
        for j, i in enumerate(idx):
            mid, side = display.pooled_spectrogram(x3[i], rate)
            for _, spec, _ in sampled:
                nums.add("spectrogram_db", max(gap(spec[0][i].cpu().numpy(), mid),
                                               gap(spec[1][i].cpu().numpy(), side)))
    log(f"reference: {len(idx)} tracks, {len(host_all)} steps' host results and "
        f"{len(sampled)} steps' whole results compared in {time.perf_counter() - t_ref:.2f} s")
    audio = ok * sum(lengths) / rate
    return Run(attempted, len(failures), {"audio_s_per_s": audio / window}, setup_s, peak,
               nums, reading)


DRIVERS = {"batch": batch}
