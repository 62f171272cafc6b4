"""`correct` comes out false for the control and for every fault a cell can
have, with the harness driven past its look for a card (on the CPU, at tiny
sizes) and the timed path broken underneath.

The control: the reference in bfloat16 in the program's place (the
configuration states float32). The faults: half of the batch left out,
the padding behind each track's valid length taken into its results, and an
answer altered where it is produced. The cells hold no state from step
to step, so none can return it unchanged, and they run on one chip, so no
exchange between chips can be left out.
"""

import dataclasses
import time
import types

import pytest
import torch

from benchmark import harness, systems
from benchmark.tests.conftest import TINY

SEED = 2**31 + 12


def run(cell, system):
    return harness.execute(cell, SEED, 0.3, False, "cpu", time.perf_counter(),
                           system=system, overrides=TINY[cell])


def _cat_halves(res, b):
    """A result whose track j >= b/2 is track j - b/2's."""
    return types.SimpleNamespace(**{
        k: v.repeat(-(-b // (v.shape[0])), *([1] * (v.dim() - 1)))[:b]
        for k, v in vars(res).items()})


class HalfBatch(systems.Program):
    def analyze_batch(self, mc, x, n_valid):
        b = n_valid.shape[0]
        h = max(b // 2, 1)
        xs = x[:h] if x.dim() == 4 else x[: h * mc.channels]
        res = super().analyze_batch(mc, xs, n_valid[:h])
        return _cat_halves(types.SimpleNamespace(**dataclasses.asdict(res)), b)


class Unmasked(systems.Program):
    """Every track taken as valid to its end: the padding reaches the results."""

    def analyze_batch(self, mc, x, n_valid):
        return super().analyze_batch(mc, x, torch.full_like(n_valid, x.shape[-1] * (
            x.shape[-2] if x.dim() == 4 else 1)))


class Altered(systems.Program):
    def analyze_batch(self, mc, x, n_valid):
        res = super().analyze_batch(mc, x, n_valid)
        res.integrated_lufs[0] += 0.01
        return res


@pytest.mark.parametrize("cell", list(TINY))
def test_sound_run_is_correct(cell):
    line = run(cell, systems.Program())
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("cell", list(TINY))
def test_control_is_not_correct(cell):
    line = run(cell, systems.Control())
    assert not line["correct"]
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


FAULTS = [(cell, fault) for cell in TINY for fault in (HalfBatch, Unmasked, Altered)]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_fault_is_not_correct(cell, fault):
    line = run(cell, fault())
    assert not line["correct"], line["checks"]


def test_control_runs_with_no_warmup_step():
    """calibrate.py runs the control with no warm-up step: the driver then
    finishes nothing before the window and the run completes."""
    cell = "offline.library_rows"
    over = {k: dict(v) for k, v in TINY[cell].items()}
    over["traffic"]["warmup_steps"] = 0
    line = harness.execute(cell, SEED, 0.3, False, "cpu", time.perf_counter(),
                           system=systems.Control(), overrides=over)
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert not line["correct"], line["checks"]
