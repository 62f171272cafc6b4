"""Observability: the port's registry of spans and counters, and profiler
hooks.

`GLOBAL` (an `RTCounter`) is the one place the port records where its host
time goes and what it counts:

* `span(name, audio_seconds=0.0)` times a block on the host clock: calls,
  total wall, audio credited (the real-time factor), the first duration
  and a window of recent durations for medians. Inside `profile_trace`,
  while its profiler records, the span also opens
  `record_function("ss." + name)`, so the range sits on the clock of the
  device's records in the trace; elsewhere it opens nothing (an idle
  `record_function` costs about 13 us of host time, the flags' read about
  0.1 us), and a profiler that another program runs around the port sees
  no `ss.*` range.
* `count(name, n=1)` adds to a counter, for the life of the process
  (`reset()` clears the spans alone): `launch.K1` ... `launch.K7` (one per
  kernel launch), `h2d.bytes` and `h2d.copies` (core/device.upload),
  `kernels.builds` (nvcc runs of ops/_build.build), `k3.segments` (K3's
  rows times its segments of 8,192 samples), `k3.track_tickets` (K3's
  tickets of one file's segment of each of its one or two channels:
  files times segments of 8,192 / channels; 0 where a file has more
  channels and K3's tickets are its rows' segments) and
  `k5.segments` (K5's tickets times its weighted channels), all three on
  the card alone, from the shapes, `k1.steps` (K1's rows times its
  steps) and `k2.windows` (K2's tracks times its windows), the last two
  on either device, from the shapes. The pooled spectrogram's call is the
  span `stft.pooled`.
* `count_on_device(name, cell)` adds a one-element integer tensor that
  kernels add to (`k5.segments_skipped`, K5's channel segments past
  n_valid, one add per CTA): the host reads it, and waits for the device,
  only when the counter is read or reported.
* `report()` is what the CLI's `--metrics` prints: per span wall, audio,
  calls, RT factor (None where no audio is credited), first and median
  ms; the counters under "counters".

Besides: a tick-rate monitor for the UI loop, and a context manager around
torch.profiler that writes a Chrome trace (the JAX package's wraps
jax.profiler).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import statistics
import threading
import time

import torch.autograd.profiler as _autograd_profiler

# durations kept per span name for its median (the first call is kept apart)
RECENT = 1024

KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7")

# set by `profile_trace` alone, around its profiler: only then do spans
# open profiler ranges
_in_profile_trace = False


@dataclasses.dataclass
class SpanStats:
    calls: int = 0
    wall_s: float = 0.0
    audio_s: float = 0.0
    first_s: float | None = None
    recent: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=RECENT))

    def median_s(self) -> float | None:
        """Median duration of the recent calls after the first, or None."""
        return statistics.median(self.recent) if self.recent else None


class RTCounter:
    """Spans (host time, audio-seconds per wall-second) and counters, by
    name; safe to use from several threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self._spans: dict[str, SpanStats] = {}
        self._counters: collections.Counter = collections.Counter()
        self._cells: dict[str, list] = {}

    @contextlib.contextmanager
    def span(self, name: str, audio_seconds: float = 0.0):
        t0 = time.perf_counter()
        try:
            if _in_profile_trace and _autograd_profiler._is_profiler_enabled:
                with _autograd_profiler.record_function("ss." + name):
                    yield
            else:
                yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                s = self._spans.get(name)
                if s is None:
                    s = self._spans[name] = SpanStats()
                if s.first_s is None:
                    s.first_s = dt
                else:
                    s.recent.append(dt)
                s.calls += 1
                s.wall_s += dt
                s.audio_s += audio_seconds

    def add_audio(self, name: str, audio_seconds: float):
        """Credit audio-seconds after the fact (for ops whose audio length
        is only known once they finish, e.g. decode)."""
        with self._lock:
            self._spans.setdefault(name, SpanStats()).audio_s += audio_seconds

    def count(self, name: str, n: int = 1):
        with self._lock:
            self._counters[name] += n

    def count_on_device(self, name: str, cell):
        """Add the device integer `cell` (a one-element tensor) to counter
        `name`, read when the counter is."""
        with self._lock:
            self._cells.setdefault(name, []).append(cell)

    def counter(self, name: str) -> int:
        with self._lock:
            n = self._counters.get(name, 0)
            cells = list(self._cells.get(name, ()))
        return n + sum(int(c.item()) for c in cells)

    def span_stats(self, name: str) -> SpanStats | None:
        """A copy of span `name`'s record, or None where it never ran."""
        with self._lock:
            s = self._spans.get(name)
            if s is None or s.calls == 0:
                return None
            return dataclasses.replace(s, recent=collections.deque(s.recent, maxlen=RECENT))

    def report(self) -> dict:
        def ms(v):
            return None if v is None else round(1e3 * v, 4)

        with self._lock:
            cells = list(self._cells)
        on_device = {name: self.counter(name) for name in cells}
        with self._lock:
            out = {
                name: {
                    "wall_s": round(s.wall_s, 4),
                    "audio_s": round(s.audio_s, 2),
                    "calls": s.calls,
                    "rt_factor": (round(s.audio_s / s.wall_s, 1)
                                  if s.wall_s > 0 and s.audio_s > 0 else None),
                    "first_ms": ms(s.first_s),
                    "median_ms": ms(s.median_s()),
                }
                for name, s in self._spans.items()
            }
            out["counters"] = dict(sorted({**self._counters, **on_device}.items()))
            return out

    def reset(self):
        """Clear the spans; the counters count over the whole process, so
        that a count taken before a reset and one after still subtract."""
        with self._lock:
            self._spans.clear()


GLOBAL = RTCounter()


def launches(since: dict | None = None) -> dict:
    """Launches of each kernel, K1-K7, so far in this process, or since
    `since`, an earlier reading of `launches()`."""
    base = since or {}
    return {k: GLOBAL.counter("launch." + k) - base.get(k, 0) for k in KERNELS}


class TickMonitor:
    """UI loop cadence monitor (the 8 ms budget, reference tui.rs:1279)."""

    def __init__(self, window: int = 256):
        self._times = collections.deque(maxlen=window)
        self._last = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
        self._last = now

    @property
    def mean_ms(self) -> float:
        return 1000.0 * sum(self._times) / len(self._times) if self._times else 0.0

    @property
    def worst_ms(self) -> float:
        return 1000.0 * max(self._times) if self._times else 0.0


PADDING_RANGE = "profile_trace: padding, 64 kernels"


@contextlib.contextmanager
def profile_trace(logdir: str):
    """torch.profiler over the enclosed block: host activity, and the CUDA
    device's where there is one, written as a Chrome trace
    (`trace-<pid>.json`, open it in Perfetto or chrome://tracing) into
    `logdir`. Yields the trace's path. The registry's spans appear in it
    as `ss.<name>` ranges (and in no other profiler's trace). On the card the trace opens with 64
    one-element padding kernels under the range `PADDING_RANGE`, which
    are not part of the block."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    global _in_profile_trace
    os.makedirs(logdir, exist_ok=True)
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    path = os.path.join(logdir, f"trace-{os.getpid()}.json")
    with profile(activities=acts) as prof:
        if cuda:
            # On the card the profiler may drop the first device records of
            # a session, about ten (an H100 in a long-running process:
            # chip_smoke.py phase 15 lost K1 in a quarter of its runs). A
            # burst of 64 one-element kernels, finished before the block
            # runs, takes their place; the trace names it as padding.
            with record_function(PADDING_RANGE):
                x = torch.zeros(1, device="cuda")
                for _ in range(64):
                    x.add_(0.0)
                torch.cuda.synchronize()
        outer, _in_profile_trace = _in_profile_trace, True
        try:
            yield path
        finally:
            _in_profile_trace = outer
    prof.export_chrome_trace(path)
