"""The port's float64 chain (tools/reference64.py) against the JAX
package's, and its conformance sweep (tools/conformance.py) on the CPU.

Both float64 chains run on bit-identical constants and design math, so
they agree to 1e-12. The sweep runs every route's plain version here; on
the card (tests/test_torch_cuda.py, chip_smoke.py) it launches the
kernels.
"""

import json
import os
import sys

import numpy as np
import pytest

import tests.reference_impl as jref
from soundscope_tpu_torch.tools import conformance
from soundscope_tpu_torch.tools import reference64 as tref

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
sys.path.insert(0, TOOLS)

import tpu_conformance  # noqa: E402


def _tracks(rate):
    """Three 1.2 s stereo tracks: a loud sine pair, a quiet one with the
    right channel inverted, and noise with a louder second half."""
    rng = np.random.default_rng(rate)
    n = int(1.2 * rate)
    t = np.arange(n) / rate
    a = 0.5 * np.sin(2 * np.pi * 997.0 * t)
    b = 0.01 * np.sin(2 * np.pi * 5000.0 * t)
    c = rng.standard_normal((2, n)) * 0.1
    c[:, n // 2:] *= 3.0
    return [np.stack([a, 0.8 * a]), np.stack([b, -0.8 * b]), c]


@pytest.mark.parametrize("rate", [48000, 44100])
def test_reference64_matches_the_jax_chain(rate, monkeypatch):
    for x in _tracks(rate):
        want = jref.analyze_reference(x, rate)
        got = tref.analyze_reference(x, rate)
        for key in ("integrated", "lra", "momentary", "shortterm", "true_peak"):
            np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-12,
                                       err_msg=key)
        monkeypatch.setattr(tpu_conformance, "RATE", rate)
        for g, w in zip(tref.f64_stft_pooled(x, 3, rate),
                        tpu_conformance.f64_stft_pooled(x, 3)):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
    x = _tracks(rate)[2]
    np.testing.assert_allclose(tref.k_filter(x, rate), jref.k_filter(x, rate),
                               rtol=0, atol=1e-12)


def test_make_sweep_matches_the_jax_tool():
    np.testing.assert_array_equal(conformance.make_sweep(5), tpu_conformance.make_sweep(5))


def test_conformance_tool_passes_on_the_cpu(capsys):
    rc = conformance.main(["--device", "cpu", "--levels", "3", "--stft-windows", "2",
                           "--json"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and report["pass"]
    assert set(report["routes"]) == {"K1", "K2", "K3", "K4+K6", "K5", "K7"}
    for name, r in report["routes"].items():
        if name != "K2":
            assert r["integrated_max_err_lu"] <= conformance.BUDGET_LU
        if name not in ("K2", "K5"):
            assert r["true_peak_max_err_db"] <= conformance.BUDGET_TP_DB
    assert report["routes"]["K2"]["stft_pooled_max_err_db"] <= conformance.BUDGET_STFT_DB
    assert report["device"] == "cpu" and report["not_launched"] == []


def test_conformance_tool_fails_a_route_off_by_0_2_lu(monkeypatch, capsys):
    chain = conformance.IIR.kweight_energy_chain

    def louder(*a, **k):            # +0.2 LU: the energy times 10^0.02
        return chain(*a, **k) * 10.0 ** 0.02

    monkeypatch.setattr(conformance.IIR, "kweight_energy_chain", louder)
    rc = conformance.main(["--device", "cpu", "--levels", "2", "--stft-windows", "1",
                           "--json"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and not report["pass"]
    assert report["routes"]["K5"]["integrated_max_err_lu"] == pytest.approx(0.2, abs=1e-3)
    assert report["routes"]["K1"]["integrated_max_err_lu"] < 1e-3
