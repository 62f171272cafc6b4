"""The readers of the program's own spans and counters: each reads a filled
registry, and reads None where the registry is empty, is a program's
without spans, or is not loaded at all."""

import types

import pytest

import soundscope_tpu_torch.utils.metrics as metrics
from benchmark import harness

READERS = ("engine_ms.batch", "plan_ms.batch", "tail_ms.batch", "h2d_bytes.batch",
           "first_call_s.batch")


def _filled(monkeypatch) -> metrics.RTCounter:
    """A registry of three engine calls of 9, 4 and 6 ms (plan 1, 0.5,
    0.7 ms; tail 2, 1, 3 ms) that copied 77,888 B each."""
    reg = metrics.RTCounter()
    clock = types.SimpleNamespace(t=0.0)
    monkeypatch.setattr(metrics.time, "perf_counter", lambda: clock.t)
    for total, plan, tail in ((9e-3, 1e-3, 2e-3), (4e-3, 0.5e-3, 1e-3), (6e-3, 0.7e-3, 3e-3)):
        with reg.span("engine.analyze_batch"):
            with reg.span("engine.plan"):
                clock.t += plan
                reg.count("h2d.bytes", 77888)
            with reg.span("engine.tail"):
                clock.t += tail
            clock.t += total - plan - tail
    monkeypatch.undo()
    return reg


def _read(name):
    return harness.reader(name).read(None)


def test_readers_read_a_filled_registry(monkeypatch):
    reg = _filled(monkeypatch)
    monkeypatch.setattr(metrics, "GLOBAL", reg)
    got = {n: _read(n) for n in READERS}
    want = {"engine_ms.batch": 5.0, "plan_ms.batch": 0.6, "tail_ms.batch": 2.0,
            "h2d_bytes.batch": 77888.0, "first_call_s.batch": 9e-3}
    assert got == pytest.approx(want)


@pytest.mark.parametrize("registry", ["empty", "without_spans", "not_loaded"])
def test_readers_read_none_without_the_spans(monkeypatch, registry):
    if registry == "not_loaded":
        monkeypatch.delitem(__import__("sys").modules, metrics.__name__)
    else:
        reg = (metrics.RTCounter() if registry == "empty"
               else types.SimpleNamespace(report=dict, counter=lambda name: 0))
        monkeypatch.setattr(metrics, "GLOBAL", reg)
    assert {n: _read(n) for n in READERS} == dict.fromkeys(READERS)
