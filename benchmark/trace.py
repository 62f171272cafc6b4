"""Spans around the benchmark's calls into the program, and the reading of
a torch.profiler trace of a steady stretch of the window.

`Spans` records the host time of each call (perf_counter) for the whole
window, and inside the traced stretch also a torch.profiler
record_function of the same name, so that the trace can say what the host
was doing in each idle gap of the device.

`Stretch` profiles a stretch of steps the way chip_smoke.py's
device_profile does (copied, with its reasoning): the profiler may drop a
session's first device records, so 64 one-element kernels take their place
and only device work after the spin kernel that follows them counts. Its
`reading()` gives the device intervals, the host spans and the stretch's
own interval on the profiler's clock, or None, saying on stderr which of
the spin kernel and the stretch's span the trace lacks.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import statistics
import sys
import time

import torch

WINDOW_SPAN = "bench.stretch"
NAME_CHARS = 160        # a kernel's name in the breakdown: its template arguments cut


class Spans:
    """Host durations in ms by span name."""

    def __init__(self):
        self.ms: dict[str, list[float]] = collections.defaultdict(list)
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        if self.profiling:
            with torch.profiler.record_function(name):
                yield
        else:
            yield
        self.ms[name].append((time.perf_counter() - t) * 1e3)

    def median(self, name: str):
        v = self.ms.get(name)
        return statistics.median(v) if v else None


@dataclasses.dataclass
class Reading:
    """What a traced stretch shows. Times in microseconds on the profiler's
    clock; `device` and `host` are (start, end, name) sorted by start."""

    device: list
    host: list
    start: float
    end: float
    steps: int
    shapes: list            # one entry per traced step: the shape it ran
    spans: Spans            # host durations over the whole window
    kernels: dict           # K-number -> kernel name parts (metrics/kernels.json)

    @property
    def window_us(self) -> float:
        return self.end - self.start

    def busy_us(self) -> float:
        """The union of the device's intervals inside the stretch."""
        busy, end = 0.0, None
        for a, b, _ in self.device:
            a, b = max(a, self.start), min(b, self.end)
            if b <= a:
                continue
            if end is None or a > end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        return busy

    def idle_share(self) -> float:
        return 1.0 - self.busy_us() / self.window_us

    def matching(self, parts) -> list:
        return [e for e in self.device if any(p in e[2] for p in parts)]

    def kernel(self, k: str):
        """(device us, launches) of kernel K-number k in the stretch, the
        launches counted by its first name part; None where it never ran."""
        parts = self.kernels[k]
        ev = self.matching(parts)
        launches = sum(1 for e in ev if parts[0] in e[2])
        if not launches:
            return None
        return sum(b - a for a, b, _ in ev), launches

    def top_ops(self, n: int = 10) -> list:
        by = collections.Counter()
        for a, b, name in self.device:
            by[name] += b - a
        return [[name[:NAME_CHARS], us / 1e6] for name, us in by.most_common(n)]

    def idle_gaps(self, n: int = 10) -> list:
        """The idle time of the device, by the innermost host span open at
        the middle of each gap, longest first."""
        gaps, end = [], self.start
        for a, b, _ in self.device:
            if a > end:
                gaps.append((end, min(a, self.end)))
            end = max(end, b)
        if end < self.end:
            gaps.append((end, self.end))
        by = collections.Counter()
        for a, b in gaps:
            if b <= a:
                continue
            mid = (a + b) / 2
            open_ = [s for s in self.host if s[0] <= mid <= s[1] and s[2] != WINDOW_SPAN]
            by[max(open_)[2] if open_ else "(between spans)"] += b - a
        return [[name, us / 1e6] for name, us in by.most_common(n)]


def warm_profiler() -> None:
    """Start and stop the profiler once, so that its first start (CUPTI's
    set-up, seconds) falls in the set-up and not in the window."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1.0)
        torch.cuda.synchronize()


class Stretch:
    """torch.profiler over a stretch of steps; `reading()` after exit."""

    def __init__(self, spans: Spans):
        self.spans = spans
        self.steps = 0
        self.shapes: list = []
        self._prof = None
        self._span = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        pad = torch.zeros(1, device="cuda")
        for _ in range(64):
            pad.add_(0.0)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        self.spans.profiling = True
        self._span = torch.profiler.record_function(WINDOW_SPAN)
        self._span.__enter__()
        return self

    def step(self, shape) -> None:
        self.steps += 1
        self.shapes.append(shape)

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self.spans.profiling = False
        self._prof.__exit__(*exc)
        return False

    def reading(self, kernels: dict) -> Reading | None:
        dev, host = [], []
        for e in self._prof.events():
            t = (e.time_range.start, e.time_range.end, e.name)
            ours = e.name in self.spans.ms or e.name == WINDOW_SPAN
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if not ours:        # the profiler mirrors annotations on the device
                    dev.append(t)
            elif ours:
                host.append(t)
        dev.sort()
        marks = [b for _, b, name in dev if "spin_kernel" in name]
        win = [s for s in host if s[2] == WINDOW_SPAN]
        if not marks or not win:
            missing = [what for what, found in (("the spin_kernel mark", marks),
                                                (f"the {WINDOW_SPAN} span", win)) if not found]
            print(f"trace: the stretch reads nothing: {' and '.join(missing)} missing from "
                  f"the profiler's {len(dev)} device and {len(host)} host events",
                  file=sys.stderr, flush=True)
            return None
        dev = [s for s in dev if s[0] >= marks[-1]]
        host.sort()
        return Reading(device=dev, host=host, start=win[0][0], end=win[0][1],
                       steps=self.steps, shapes=self.shapes, spans=self.spans,
                       kernels=kernels)
