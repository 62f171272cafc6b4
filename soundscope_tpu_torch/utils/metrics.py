"""Observability: real-time-factor counters and profiler hooks.

The port's copy of the JAX package's utils/metrics.py: per-op
wall/audio-time counters (RT factor), a tick-rate monitor for the UI
loop, and a context manager around torch.profiler that writes a Chrome
trace (the JAX package's wraps jax.profiler).
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time


class RTCounter:
    """Tracks audio-seconds processed per wall-second per op."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stats = collections.defaultdict(lambda: [0.0, 0.0, 0])  # wall, audio, calls

    @contextlib.contextmanager
    def measure(self, name: str, audio_seconds: float):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                s = self._stats[name]
                s[0] += dt
                s[1] += audio_seconds
                s[2] += 1

    def add_audio(self, name: str, audio_seconds: float):
        """Credit audio-seconds after the fact (for ops whose audio length
        is only known once they finish, e.g. decode)."""
        with self._lock:
            self._stats[name][1] += audio_seconds

    def report(self) -> dict:
        with self._lock:
            return {
                name: {
                    "wall_s": round(w, 4),
                    "audio_s": round(a, 2),
                    "calls": c,
                    "rt_factor": round(a / w, 1) if w > 0 else None,
                }
                for name, (w, a, c) in self._stats.items()
            }

    def reset(self):
        with self._lock:
            self._stats.clear()


GLOBAL = RTCounter()


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
    `logdir`. Yields the trace's path. On the card the trace opens with
    64 one-element padding kernels under the range `PADDING_RANGE`, which
    are not part of the block."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

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
        yield path
    prof.export_chrome_trace(path)
