"""The port's benchmark (soundscope_tpu_torch/bench.py) on the CPU: its
one JSON line, its reduction, `--check`, and the CLI's `bench`."""

import json

import numpy as np
import pytest
import torch

from soundscope_tpu_torch import bench
from soundscope_tpu_torch.apps import cli
from soundscope_tpu_torch.core.config import MeterConfig
from soundscope_tpu_torch.models.engine import analyze_batch_native
from soundscope_tpu_torch.ops.stft_pooled import stft_pooled_frames_plain

SMALL = ["--device", "cpu", "--tracks", "2", "--seconds", "2", "--repeats", "1"]


def test_bench_prints_one_json_line(capsys):
    assert bench.main(SMALL) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == "rt_factor_lufs_stft"
    assert line["unit"] == "audio_sec/sec/chip" and line["device"] == "cpu"
    assert np.isfinite(line["value"]) and line["value"] > 0
    # no device figure from a CPU run
    assert not {"ms_per_iter", "sol_frac"} & set(line)


def test_bench_value_counts_every_run(monkeypatch, capsys):
    # all the audio of all the runs over their summed time: a slow run
    # (a stall) lowers the figure instead of being dropped
    times = iter([0.1, 0.4, 0.1])
    monkeypatch.setattr(bench, "_timed_run", lambda fn, cuda: next(times))
    assert bench.main(SMALL[:-1] + ["3"]) == 0
    line = json.loads(capsys.readouterr().out)
    audio_s = 2 * bench.bench_length(2, 48000) / 48000
    assert line["value"] == pytest.approx(audio_s / 0.2, rel=1e-12)


def test_bench_length_rounds_to_16_blocks():
    assert bench.bench_length(60, 48000) == 2_879_488      # 1406 x 2048
    assert bench.bench_length(2, 44100) % 2048 == 0


def test_bench_reduction_is_the_finite_sum_of_the_outputs():
    b, n = 3, bench.bench_length(2, 48000)
    cfg = MeterConfig(channels=2, rate=48000, max_blocks=0)
    x = bench.make_input(b, n, torch.device("cpu"))
    x[1, :, n // 256:] *= 0.01        # a quieter second half keeps the gates busy
    x[2] = 0.0                         # silence: -inf loudness, left out of the sum
    nv = torch.full((b,), n, dtype=torch.int64)
    got = bench.step(cfg, x, nv)
    res = analyze_batch_native(cfg, x, nv)
    mid, side = stft_pooled_frames_plain(x, 48000)
    want = 0.0
    for v in (res.integrated_lufs, res.lra, res.true_peak,
              mid.amax(dim=(-2, -1)), side.amax(dim=(-2, -1))):
        v = v.double().numpy()
        want += v[np.isfinite(v)].sum()
    assert float(got) == pytest.approx(want, rel=1e-6)


def test_bench_main_path_work_counts_the_bounds():
    work = bench.main_path_work(32, 2_879_488, 48000)
    samples = 32 * 2 * 2_879_488
    assert work["K1"] == (4 * samples, samples * (29 + 3 + 72))
    nw = 2_879_488 // 2048 - 7
    assert work["K2"][1] == 32 * nw * (5 * 16384 * 14 + 6 * 16384)
    assert bench.bound(*work["K1"])[1] == "operations"


def test_bench_check_passes_on_the_cpu(capsys):
    assert bench.main(SMALL + ["--check"]) == 0
    out = capsys.readouterr()
    assert len(out.out.strip().splitlines()) == 1      # the report went to stderr
    assert "conformance: PASS" in out.err
    assert "rt check: skipped" in out.err


def test_cli_bench_reaches_bench_main(monkeypatch):
    seen = []
    monkeypatch.setattr(bench, "main", lambda argv: seen.append(argv) or 0)
    assert cli.main(["bench", "--device", "cpu", "--check"]) == 0
    assert seen == [["--device", "cpu", "--check"]]
