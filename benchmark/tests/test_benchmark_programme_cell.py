"""The programme cell, `offline.programme_rows`, as the repository's own
BENCHMARK.json declares it: its files resolve by name, a sound run is
correct on the CPU at tiny sizes (rows of 40 s, valid for 30 and 40 s,
signal in the padding), the control (the reference in bfloat16 in the
program's place), half of the batch left out and an answer altered are
not, and K3's roofline reads the traced steps' K3 kernels by name."""

import time

import pytest

from benchmark import harness, roofline, systems, trace
from benchmark.tests.test_benchmark_control import Altered, HalfBatch

CELL = "offline.programme_rows"
TINY = {"traffic": {"tracks": 2, "track_s": 40, "valid_s": [30, 40], "check_tracks": 2,
                    "warmup_steps": 1}}
SEED = 2**31 + 22
NUMBERS = {"integrated_lu", "lra_lu", "sample_peak", "timeline_lu", "true_peak_db"}


def run(system):
    return harness.execute(CELL, SEED, 0.3, False, "cpu", time.perf_counter(),
                           system=system, overrides=TINY)


def test_cell_resolves_from_the_repositorys_benchmark():
    c = harness.resolve(harness.load_spec(), CELL)
    assert (c["workload"]["config"], c["workload"]["chips"]) == ("programme_stereo48k", 1)
    tr = c["traffic"]
    assert (tr["driver"], tr["layout"], tr["tracks"], tr["track_s"], tr["valid_s"],
            tr["spectrogram"]) == ("batch", "rows", 8, 7200, [5400, 7200], False)
    assert (tr["warmup_steps"], tr["check_steps"], tr["check_tracks"], tr["trace_skip"],
            tr["trace_steps"]) == (2, 3, 2, 3, 20)
    library = harness.resolve(harness.load_spec(), "offline.library_rows")["traffic"]
    assert tr["signal"] == library["signal"]
    cfg = c["config"]
    assert (cfg["channels"], cfg["rate"], cfg["precision"], cfg["reduced"]) == (
        2, 48000, "float32", ["programmes"])
    assert set(c["limits"]["limits"]) == NUMBERS
    assert [m["name"] for m in c["end_to_end"]] == ["audio_s_per_s", "setup_s"]
    assert [m["name"] for m in c["per_layer"]] == ["k3_roofline.batch"]


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


def _reading(device, steps, shapes):
    return trace.Reading(device=device, host=[], start=0.0, end=1e6, steps=steps,
                         shapes=shapes, spans=trace.Spans(), kernels={})


def test_k3_roofline_reads_k3s_kernels_by_name():
    read = harness.reader("k3_roofline.batch").read
    shape = {"b": 8, "n": 7200 * 48000, "valid": 50400 * 48000}
    # no k3_tile in the stretch (the parent's K5 route, or nothing traced)
    assert read(_reading([(0.0, 9000.0, "k5_tile_tracks<5>")], 1, [shape])) is None
    assert read(_reading([], 0, [])) is None
    # one k3_tile a step, with channel_sum and peaks_pass: 20 ms of K3
    dev = [(0.0, 19000.0, "void k3_tile<4, 13>(TileArgs)"),
           (19000.0, 19900.0, "channel_sum"), (19900.0, 20000.0, "peaks_pass"),
           (20000.0, 20500.0, "reduce_kernel")]
    # 8 programmes valid for 50,400 s: 19.65 GB read and written at 3.35 TB/s
    least = roofline.least_s(4 * (2 * shape["valid"] + shape["valid"] // 32))
    assert least == pytest.approx(5.867e-3, rel=1e-3)
    assert read(_reading(dev, 1, [shape])) == pytest.approx(100.0 * least / 20e-3)
    # a step whose k3_tile the stretch lacks reads nothing
    assert read(_reading(dev, 2, [shape, shape])) is None
