"""The port's registry of spans and counters (utils/metrics.py) on the CPU:
what a span records, that it opens a profiler range only inside
profile_trace while its profiler records, where the engine's spans sit, and that nothing counts host-to-device
copies where there is no device."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from soundscope_tpu_torch.core.config import MeterConfig
from soundscope_tpu_torch.core.device import upload
from soundscope_tpu_torch.models.engine import analyze_array, analyze_batch_native, rows_plan
from soundscope_tpu_torch.models.live import LiveAnalyzer
from soundscope_tpu_torch.utils import metrics
from soundscope_tpu_torch.utils.metrics import GLOBAL, RTCounter


class _Clock:
    """A perf_counter that moves only when told to."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _ranges(prof) -> dict:
    """{name: [(start, end), ...]} of the profiler's host ranges named ss.*."""
    out = {}
    for e in prof.events():
        if e.name.startswith("ss."):
            out.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return out


def test_span_records_calls_first_duration_and_median(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(metrics.time, "perf_counter", clock)
    reg = RTCounter()
    for dt in (5.0, 1.0, 3.0, 2.0):
        with reg.span("work", audio_seconds=10.0):
            clock.t += dt
    s = reg.span_stats("work")
    assert (s.calls, s.first_s, s.wall_s, s.audio_s) == (4, 5.0, 11.0, 40.0)
    assert s.median_s() == 2.0                       # the first call left out
    assert reg.span_stats("never") is None
    with reg.span("work", 1.0):
        clock.t += 2.0
    rep = reg.report()
    assert rep["work"] == {"wall_s": 13.0, "audio_s": 41.0, "calls": 5,
                           "rt_factor": 3.2, "first_ms": 5000.0, "median_ms": 2000.0}
    reg.count("things", 3)
    reg.count("things")
    assert reg.counter("things") == 4 and reg.counter("none") == 0
    assert reg.report()["counters"] == {"things": 4}
    reg.reset()                                      # the spans go, the counts stay
    assert reg.report() == {"counters": {"things": 4}}


def test_span_window_keeps_the_recent_durations(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(metrics.time, "perf_counter", clock)
    reg = RTCounter()
    for i in range(metrics.RECENT + 11):
        with reg.span("w"):
            clock.t += float(i)
    s = reg.span_stats("w")
    assert s.calls == metrics.RECENT + 11 and len(s.recent) == metrics.RECENT
    assert s.first_s == 0.0 and min(s.recent) == 11.0


def test_span_opens_no_profiler_range_without_a_profiler(monkeypatch, tmp_path):
    """Only profile_trace's profiler gets ranges: none without a profiler,
    none under a profiler that another program runs (as the benchmark's
    traced stretch does)."""
    opened = []
    real = metrics._autograd_profiler.record_function

    def spy(name):
        opened.append(name)
        return real(name)

    monkeypatch.setattr(metrics._autograd_profiler, "record_function", spy)
    reg = RTCounter()
    with reg.span("quiet"):
        torch.ones(4).sum()
    assert opened == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with reg.span("foreign"):
            torch.ones(4).sum()
    assert opened == [] and _ranges(prof) == {}
    with metrics.profile_trace(str(tmp_path)) as path:
        with reg.span("loud"):
            torch.ones(4).sum()
    assert opened == ["ss.loud"] and not metrics._in_profile_trace
    names = [e.get("name") for e in json.load(open(path))["traceEvents"]]
    assert "ss.loud" in names and "ss.foreign" not in names


@pytest.fixture
def ranges_on(monkeypatch):
    """Spans open profiler ranges, as inside profile_trace."""
    monkeypatch.setattr(metrics, "_in_profile_trace", True)


def test_span_is_a_profiler_range_inside_its_parent(ranges_on):
    reg = RTCounter()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with reg.span("outer"):
            torch.ones(8).sum()
            with reg.span("inner"):
                torch.ones(8).cumsum(0)
    r = _ranges(prof)
    [(o0, o1)], [(i0, i1)] = r["ss.outer"], r["ss.inner"]
    assert o0 <= i0 < i1 <= o1


# rows at 192 kHz (factor 1: the masked peak), rows through the fused
# route (K3 takes the peaks), the frames view (K1 takes the peaks)
@pytest.mark.parametrize("layout,rate,phases", [
    ("rows", 192000, ("engine.plan", "engine.energy", "engine.peaks", "engine.tail")),
    ("fused", 48000, ("engine.plan", "engine.energy", "engine.tail")),
    ("frames", 48000, ("engine.plan", "engine.energy", "engine.tail")),
])
def test_engine_phases_are_spans_inside_the_call(layout, rate, phases, ranges_on):
    cfg = MeterConfig(channels=2, rate=rate, max_blocks=0)
    b, n = 2, 1 << 17
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((b, 2, n))
                         .astype(np.float32) * 0.1)
    if layout == "frames":
        x = x.reshape(b, 2, n // 128, 128)
    else:
        assert rows_plan(n, b, 2, rate, cfg.block)[0] == ("fused" if layout == "fused"
                                                          else "prefix")
    names = ("engine.analyze_batch", "engine.plan", "engine.energy", "engine.peaks",
             "engine.tail")

    def calls():
        return {k: (GLOBAL.span_stats(k) or metrics.SpanStats()).calls for k in names}

    before = calls()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        analyze_batch_native(cfg, x, torch.tensor([n, n - 5000]))
    ran = {k: v - before[k] for k, v in calls().items()}
    assert ran == {k: int(k == "engine.analyze_batch" or k in phases) for k in names}
    r = _ranges(prof)
    [(a0, a1)] = r["ss.engine.analyze_batch"]
    spans = [r["ss." + k][0] for k in phases]
    assert all(len(r["ss." + k]) == 1 for k in phases)
    assert all(a0 <= s0 < s1 <= a1 for s0, s1 in spans)
    assert all(p[1] <= q[0] for p, q in zip(spans, spans[1:]))   # in order, apart


def test_analyze_array_and_live_push_spans():
    def calls(k):
        return (GLOBAL.span_stats(k) or metrics.SpanStats()).calls

    names = ("engine.analyze_array", "array.pad", "array.upload", "engine.analyze_batch",
             "live.push")
    before = {k: calls(k) for k in names}
    audio = (GLOBAL.span_stats("engine.analyze_array") or metrics.SpanStats()).audio_s
    x = (np.random.default_rng(4).standard_normal((2, 48000)) * 0.1).astype(np.float32)
    analyze_array(x, MeterConfig(channels=2, rate=48000, max_blocks=0), device="cpu")
    live = LiveAnalyzer(MeterConfig(channels=2, rate=48000, max_blocks=0), device="cpu")
    live.push(np.zeros(1600, np.float32))
    assert {k: calls(k) - before[k] for k in names} == dict.fromkeys(names, 1)
    assert GLOBAL.span_stats("engine.analyze_array").audio_s - audio == pytest.approx(1.0)


def test_no_host_to_device_copies_are_counted_on_the_cpu():
    keys = ("h2d.bytes", "h2d.copies")
    before = {k: GLOBAL.counter(k) for k in keys}
    cfg = MeterConfig(channels=2, rate=48000, max_blocks=0)
    x = (np.random.default_rng(5).standard_normal((2, 48000)) * 0.1).astype(np.float32)
    analyze_array(x, cfg, device="cpu")
    analyze_batch_native(cfg, torch.from_numpy(x)[None], np.array([48000]))
    LiveAnalyzer(cfg, device="cpu").push(np.zeros(1600, np.float32))
    assert upload(np.ones(3, np.float32), "cpu").device.type == "cpu"
    assert {k: GLOBAL.counter(k) for k in keys} == before


def test_launches_reads_the_registry():
    before = metrics.launches()
    assert list(before) == ["K1", "K2", "K3", "K4", "K5", "K6", "K7"]
    GLOBAL.count("launch.K4")
    assert metrics.launches() == {**before, "K4": before["K4"] + 1}
    assert metrics.launches(since=before) == {**dict.fromkeys(before, 0), "K4": 1}


def test_frames_route_counts_k1_steps_and_k2_windows():
    """A frames batch with its spectrogram: `k1.steps` grows by rows times
    K1's steps, `k2.windows` by tracks times K2's windows, and the pooled
    spectrogram's call is one `stft.pooled` span, on the CPU as on a card."""
    from soundscope_tpu_torch.ops.iir_chunked import step_length
    from soundscope_tpu_torch.ops.stft_pooled import stft_pooled_frames

    cfg = MeterConfig(channels=2, rate=48000, max_blocks=0)
    b, n = 2, 1 << 17
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((b, 2, n // 128, 128))
                         .astype(np.float32) * 0.1)
    keys = ("k1.steps", "k2.windows")
    before = {k: GLOBAL.counter(k) for k in keys}
    calls = (GLOBAL.span_stats("stft.pooled") or metrics.SpanStats()).calls
    analyze_batch_native(cfg, x, torch.tensor([n, n - 5000]))
    mid, _ = stft_pooled_frames(x, 48000)
    assert mid.shape[:2] == (b, n // 2048 - 7)
    assert {k: GLOBAL.counter(k) - before[k] for k in keys} == {
        "k1.steps": b * 2 * (n // step_length(n, 4800)), "k2.windows": b * (n // 2048 - 7)}
    assert GLOBAL.span_stats("stft.pooled").calls == calls + 1
