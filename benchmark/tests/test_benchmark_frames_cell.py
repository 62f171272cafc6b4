"""The frames cell, `offline.frames_spectrogram`, as the repository's own
BENCHMARK.json declares it: its files resolve by name, a sound run is
correct on the CPU at tiny sizes, and the control (the reference in
bfloat16 in the program's place), half of the bucket left out and an
answer altered are not. Every track is valid to its end, so there is no
padding a fault could take in."""

import time

import pytest

from benchmark import harness, program_spans, systems
from benchmark.tests.test_benchmark_control import Altered, HalfBatch

CELL = "offline.frames_spectrogram"
TINY = {"traffic": {"tracks": 2, "track_s": 4, "check_tracks": 2, "warmup_steps": 1}}
SEED = 2**31 + 18
NUMBERS = {"integrated_lu", "lra_lu", "sample_peak", "spectrogram_db", "timeline_lu",
           "true_peak_db"}


def run(system):
    return harness.execute(CELL, SEED, 0.3, False, "cpu", time.perf_counter(),
                           system=system, overrides=TINY)


def test_cell_resolves_from_the_repositorys_benchmark():
    c = harness.resolve(harness.load_spec(), CELL)
    assert (c["workload"]["config"], c["workload"]["chips"]) == ("spectrogram_stereo48k", 1)
    tr = c["traffic"]
    assert (tr["driver"], tr["layout"], tr["tracks"], tr["track_s"], tr["spectrogram"],
            tr["check_tracks"]) == ("batch", "frames", 64, 240, True, 16)
    assert "valid_s" not in tr
    cfg = c["config"]
    assert (cfg["channels"], cfg["rate"], cfg["precision"], cfg["reduced"]) == (
        2, 48000, "float32", [])
    assert set(c["limits"]["limits"]) == NUMBERS
    assert [m["name"] for m in c["end_to_end"]] == ["audio_s_per_s", "setup_s"]
    assert [m["name"] for m in c["per_layer"]] == ["k1_roofline.batch", "k2_roofline.batch",
                                                   "spectrogram_ms.batch"]


def test_sound_run_is_correct_and_compares_every_number():
    line = run(systems.Program())
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == NUMBERS
    assert line["failed"] == 0 and line["attempted"] > 0


@pytest.mark.parametrize("system", [systems.Control, HalfBatch, Altered],
                         ids=["control", "half_batch", "altered"])
def test_control_and_faults_are_not_correct(system):
    line = run(system())
    assert not line["correct"], line["checks"]


def test_spectrogram_reader_reads_the_programs_span(monkeypatch):
    run(systems.Program())
    ms = harness.reader("spectrogram_ms.batch").read(None)
    assert ms is not None and ms > 0
    # a program without the span reads nothing and raises nothing
    monkeypatch.setattr(program_spans, "registry", lambda: None)
    assert harness.reader("spectrogram_ms.batch").read(None) is None
