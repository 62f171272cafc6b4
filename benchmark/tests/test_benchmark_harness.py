"""The harness's pieces on the CPU: files found by name, the traffic's
seeding, the roofline's counts, the result's line, and no run without a card."""

import json
import shutil
import subprocess
import sys
import time
import types

import pytest
import torch

from benchmark import drivers, generator, harness, roofline
from benchmark.tests.conftest import REPO, TINY

SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
SIGNAL = {"section_s": [1, 10], "level_dbfs": [-45, -10], "silence": 0.1, "correlation": 0.8,
          "ceiling_dbfs": -1.0}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_its_files_by_name(cell):
    c = harness.resolve(SPEC, cell)
    assert c["traffic"]["driver"] in drivers.DRIVERS
    assert c["config"]["name"] == c["workload"]["config"]
    assert c["limits"]["limits"]
    names = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert c["per_layer"]
    for m in c["per_layer"]:
        assert callable(harness.reader(m["name"]).read)


def test_every_metric_and_config_is_used_by_a_cell():
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS), m["name"]
    assert {c["name"] for c in SPEC["configs"]} == {w["config"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert any(e["name"] == m["moves"] for e in SPEC["end_to_end"]), m["name"]


def test_bounds_and_names_keep_the_contract():
    import re

    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for e in SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"] + SPEC["per_layer"]:
        assert name.match(e["name"]), e["name"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_traffic_is_the_same_for_a_seed_and_differs_across_seeds():
    a = generator.tracks(2**31 + 5, 2, 48000, 48000, SIGNAL, "cpu")
    b = generator.tracks(2**31 + 5, 2, 48000, 48000, SIGNAL, "cpu")
    c = generator.tracks(2**31 + 6, 2, 48000, 48000, SIGNAL, "cpu")
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert a.abs().max() <= 10 ** (-1 / 20) + 1e-7


def test_reservoir_depends_on_the_seed_alone():
    def kept(seed):
        r = generator.Reservoir(3, seed)
        for i in range(100):
            r.offer(i)
        return r.items

    assert kept(7) == kept(7)
    assert kept(7) != kept(8)


def test_roofline_counts_at_the_cells_shapes():
    # frames: 32 x 2,879,488 samples; K1 bound by its 737 MB read
    s = 32 * 2 * 2879488
    assert roofline.k1(32, 2879488) == pytest.approx(4 * s / 3.35e12)
    # K2: 1,399 windows a track at 1,245,184 operations against 165 TFLOP/s
    assert roofline.k2(32, 2879488) == pytest.approx(32 * 1399 * 1245184 / 165e12)
    # library: 600 tracks valid for 180-240 s, 126,000 s in all (the lengths
    # pair off around 210 s); K5 reads them and writes one z entry per 32
    tr = harness.resolve(SPEC, "offline.library_rows")["traffic"]
    valid = drivers.valid_lengths(tr, 600, 240 * 48000, 48000, 2**31 + 9)
    assert sorted(valid) == sorted(drivers.valid_lengths(tr, 600, 240 * 48000, 48000, 5))
    assert sum(valid) == 126000 * 48000 and min(valid) == 180 * 48000
    assert roofline.k5(sum(valid)) == pytest.approx(4 * (2 * 6.048e9 + 6.048e9 / 32) / 3.35e12)
    # K6 reads them and writes a true and a sample peak for each of 1,200 rows
    assert roofline.k6(sum(valid), 600) == pytest.approx(4 * (2 * 6.048e9 + 2400) / 3.35e12)


def test_result_line_has_the_contract_keys():
    cell = "offline.library_rows"
    line = harness.execute(cell, 3, 0.2, False, "cpu", time.perf_counter(), overrides=TINY[cell])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert line["correct"] and line["failed"] == 0
    json.dumps(line, allow_nan=False)


def test_a_cell_added_from_new_files_alone(tmp_path):
    """The frames layout with the spectrogram (K1, K2), added as a cell by a
    traffic file, a limits file and entries alone."""
    root = tmp_path / "benchmark"
    for d in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(REPO / "benchmark" / d, root / d)
    traffic = json.loads((root / "traffic" / "frames_spectrogram.json").read_text())
    traffic.update(tracks=2, track_s=4, warmup_steps=1)
    (root / "traffic" / "frames_short.json").write_text(json.dumps(traffic))
    limits = json.loads((root / "limits" / "offline.library_rows.json").read_text())
    limits["limits"]["spectrogram_db"] = 5e-3
    (root / "limits" / "offline.frames_short.json").write_text(json.dumps(limits))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "offline.frames_short", "config": "offline_stereo48k",
                              "traffic": "frames_short", "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "offline.library_rows" in m.get("workloads", []):
            m["workloads"].append("offline.frames_short")
    line = harness.execute("offline.frames_short", 4, 0.2, False, "cpu", time.perf_counter(),
                           spec=spec, root=root)
    assert line["correct"], line["checks"]
    assert "spectrogram_db" in line["checks"]
    assert set(line["metrics"]) == {"audio_s_per_s", "setup_s"}


def test_run_exits_without_a_card():
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "offline.library_rows", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout == ""


@pytest.mark.parametrize("missing", ["mark", "span", "both"])
def test_an_empty_trace_reading_says_what_is_missing(missing, capsys):
    from benchmark import trace

    def event(name, device):
        return types.SimpleNamespace(
            name=name, time_range=types.SimpleNamespace(start=0.0, end=1.0),
            device_type=(torch.autograd.DeviceType.CUDA if device
                         else torch.autograd.DeviceType.CPU))

    events = [event("k5_tile_tracks", True)]
    if missing == "span":
        events.append(event("void spin_kernel(long)", True))
    if missing == "mark":
        events.append(event(trace.WINDOW_SPAN, False))
    stretch = trace.Stretch(trace.Spans())
    stretch._prof = types.SimpleNamespace(events=lambda: events)
    assert stretch.reading({}) is None
    err = capsys.readouterr().err
    assert ("spin_kernel mark" in err) == (missing != "span")
    assert (f"{trace.WINDOW_SPAN} span" in err) == (missing != "mark")
