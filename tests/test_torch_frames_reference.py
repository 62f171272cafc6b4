"""The frames route of the CLI's spectrogram bucket on the CPU (K1's and
K2's plain versions): the engine on the frames view and the pooled mid/side
spectrogram, on two seeded 20 s tracks of the frames cell's traffic,
against the benchmark's float64 reference (benchmark/reference/bs1770.py,
display.py), on every number that cell's check compares and within the
cell's own limits (benchmark/limits/offline.frames_spectrogram.json)."""

import json
from pathlib import Path

import numpy as np
import torch

from benchmark import check, generator
from benchmark.drivers import whole_result
from benchmark.reference import bs1770, display
from soundscope_tpu_torch.core.config import MeterConfig
from soundscope_tpu_torch.models.engine import analyze_batch_native
from soundscope_tpu_torch.ops.stft_pooled import stft_pooled_frames

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
CELL = "offline.frames_spectrogram"


def test_frames_route_and_spectrogram_match_the_float64_reference():
    traffic = json.loads((BENCH / "traffic" / "frames_bucket64.json").read_text())
    limits = check.load_limits(BENCH, CELL)["limits"]
    rate, b = 48000, 2
    n = 20 * rate // 2048 * 2048
    x = generator.tracks(2**31 + 77, b, n, rate, traffic["signal"], "cpu")
    frames = x.view(b, 2, n // 128, 128)
    res = analyze_batch_native(MeterConfig(channels=2, rate=rate, max_blocks=0), frames,
                               torch.tensor([n] * b))
    mid, side = stft_pooled_frames(frames, rate)
    refs = bs1770.analyze(x, [n] * b, rate)
    nums = check.Numbers()
    for i in range(b):
        nums.analysis(whole_result(res, i), refs[i])
        want = display.pooled_spectrogram(x[i], rate)
        nums.add("spectrogram_db", max(check.gap(mid[i].numpy(), want[0]),
                                       check.gap(side[i].numpy(), want[1])))
    ok, checks = nums.verdict(limits)
    assert set(checks) == set(limits)
    assert ok, checks
    assert all(np.isfinite(c["value"]) for c in checks.values())
    # the tracks are loud enough to be gated in and have a range
    assert all(r["integrated"] > -70.0 and r["lra"] > 0.0 for r in refs)
