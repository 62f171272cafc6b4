"""The rows route of long programmes on the CPU (K3's plain version): the
engine on the rows layout, on two seeded tracks of the programme cell's
traffic in rows of 40 s, valid for 30 and 40 s with signal in the padding,
against the benchmark's float64 reference (benchmark/reference/bs1770.py),
on every number that cell's check compares and within the cell's own
limits (benchmark/limits/offline.programme_rows.json). At the traffic's
full shape the engine sends the batch to K3."""

import json
from pathlib import Path

import numpy as np
import torch

from benchmark import check, generator
from benchmark.drivers import whole_result
from benchmark.reference import bs1770
from soundscope_tpu_torch.core.config import MeterConfig
from soundscope_tpu_torch.models.engine import analyze_batch_native, rows_plan

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
CELL = "offline.programme_rows"


def test_full_shape_takes_the_fused_route():
    traffic = json.loads((BENCH / "traffic" / "programme_rows.json").read_text())
    cfg = MeterConfig(channels=2, rate=48000, max_blocks=0)
    n = traffic["track_s"] * cfg.rate
    assert n == 345_600_000
    assert rows_plan(n, traffic["tracks"], 2, cfg.rate, cfg.block) == ("fused", False)


def test_rows_route_matches_the_float64_reference():
    traffic = json.loads((BENCH / "traffic" / "programme_rows.json").read_text())
    limits = check.load_limits(BENCH, CELL)["limits"]
    cfg = MeterConfig(channels=2, rate=48000, max_blocks=0)
    b, n = 2, 40 * cfg.rate
    nv = [30 * cfg.rate, n]
    assert rows_plan(n, b, 2, cfg.rate, cfg.block) == ("fused", False)
    x = generator.tracks(2**31 + 2200, b, n, cfg.rate, traffic["signal"], "cpu")
    assert float(x[0, :, nv[0]:].abs().max()) > 0.0      # signal in the padding
    res = analyze_batch_native(cfg, x.view(2 * b, n), torch.tensor(nv))
    refs = bs1770.analyze(x, nv, cfg.rate)
    nums = check.Numbers()
    for i in range(b):
        nums.analysis(whole_result(res, i), refs[i])
    ok, checks = nums.verdict(limits)
    assert set(checks) == set(limits)
    assert ok, checks
    assert all(np.isfinite(c["value"]) for c in checks.values())
    # the tracks are loud enough to be gated in and have a range; the
    # masked timelines end at each track's valid length
    assert all(r["integrated"] > -70.0 and r["lra"] > 0.0 for r in refs)
    assert res.n_momentary.tolist() == [len(r["momentary"]) for r in refs]
