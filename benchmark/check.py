"""The comparison that decides `correct`: numbers of the gap between what
the timed path produced and the float64 reference, each held to a limit of
its own (benchmark/limits/<cell>.json).

Every number is a widest gap over all that was compared: a loudness gap in
LU (-inf against -inf is no gap, -inf against a finite value an infinite
one), a peak gap in dB, a spectrum gap in dB, a linear gap in full scale.
Momentary and short-term loudness are compared as a meter shows them, at
or above its floor, the standard's absolute gate of -70 LUFS: both sides
are raised to the floor first, so a value read below it where the other
side is above still counts in full.
"""

from __future__ import annotations

import json
import math
import sys
from pathlib import Path

import numpy as np

FLOOR_LUFS = -70.0      # the meter's floor: the standard's absolute gate


def gap(a, b) -> float:
    """The widest |a - b|, where equal infinities are no gap and NaN or a
    shape that differs is an infinite one."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        return math.inf
    if a.size == 0:
        return 0.0
    same = (a == b) | (np.isneginf(a) & np.isneginf(b)) | (np.isposinf(a) & np.isposinf(b))
    with np.errstate(invalid="ignore"):
        d = np.where(same, 0.0, np.abs(a - b))
    return float(np.nan_to_num(d, nan=math.inf).max())


def db_gap(a, b) -> float:
    """The widest gap in dB of two linear magnitudes (0 against 0 is none)."""
    with np.errstate(divide="ignore"):
        return gap(20.0 * np.log10(np.asarray(a, np.float64)),
                   20.0 * np.log10(np.asarray(b, np.float64)))


def floored_gap(got, ref) -> float:
    """The gap of loudness values raised to the meter's floor on both sides."""
    with np.errstate(invalid="ignore"):
        return gap(np.maximum(np.asarray(got, np.float64), FLOOR_LUFS),
                   np.maximum(np.asarray(ref, np.float64), FLOOR_LUFS))


def timeline_gap(got, n_valid: int, ref) -> float:
    """The floored gap of a timeline's first n_valid entries against the
    reference's; a count that differs is an infinite gap."""
    got = np.asarray(got, np.float64)[:n_valid]
    ref = np.asarray(ref, np.float64)
    if got.shape != ref.shape:
        return math.inf
    return floored_gap(got, ref)


class Numbers:
    """The widest gap seen so far of each compared number."""

    def __init__(self):
        self.value: dict[str, float] = {}

    def add(self, name: str, v: float) -> None:
        v = float(v)
        self.value[name] = max(self.value.get(name, 0.0), v) if not math.isnan(v) else math.inf

    def analysis(self, got: dict, ref: dict) -> None:
        """One track's whole-file results against the reference's; `got`
        holds NumPy values of integrated, lra, true_peak, sample_peak and,
        where compared, momentary / shortterm with n_momentary /
        n_shortterm."""
        self.add("integrated_lu", gap(got["integrated"], ref["integrated"]))
        self.add("lra_lu", gap(got["lra"], ref["lra"]))
        self.add("true_peak_db", db_gap(got["true_peak"], ref["true_peak"]))
        self.add("sample_peak", gap(got["sample_peak"], ref["sample_peak"]))
        if "momentary" in got:
            self.add("timeline_lu", max(
                timeline_gap(got["momentary"], int(got["n_momentary"]), ref["momentary"]),
                timeline_gap(got["shortterm"], int(got["n_shortterm"]), ref["shortterm"])))

    def verdict(self, limits: dict) -> tuple[bool, dict]:
        """(correct, {name: {"value", "limit"}}): every limit's number is
        present and within its limit; a number with no limit fails."""
        out = {}
        ok = bool(self.value)
        for name, v in sorted(self.value.items()):
            lim = limits.get(name)
            out[name] = {"value": v, "limit": lim}
            ok = ok and lim is not None and v <= lim
        for name in limits:
            if name not in self.value:
                out[name] = {"value": None, "limit": limits[name]}
                ok = False
        return ok, out


def load_limits(root: Path, cell: str) -> dict:
    """The cell's limits file: {"limits": {number: limit}, "readings": ...}."""
    with open(root / "limits" / f"{cell}.json") as f:
        return json.load(f)


def print_checks(checks: dict) -> None:
    """The compared numbers beside their limits, as the last lines of stderr."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
