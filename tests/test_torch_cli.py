"""The port's batch CLI against the JAX CLI, and its JAX-free run."""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

from soundscope_tpu.apps.cli import main as jax_main
from soundscope_tpu.utils.io import write_wav
from soundscope_tpu.utils.synth import sine, stereo
from soundscope_tpu_torch.apps.cli import main as torch_main

REPO = Path(__file__).resolve().parents[1]


def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(21)
    a = stereo(sine(997.0, 6.0, 48000, -23.0))
    noise = (rng.standard_normal((2, 48000 * 5)) * 0.05).astype(np.float32)
    noise[:, 48000 * 3:] *= 4.0
    paths = [str(d / "tone.wav"), str(d / "noise.wav")]
    write_wav(paths[0], a, 48000, bits=32)
    write_wav(paths[1], noise, 48000, bits=32)
    return paths


def test_analyze_json_matches_jax_cli(wavs, tmp_path):
    rc_j, out_j = _run(jax_main, ["analyze", *wavs, "--json"])
    rc_t, out_t = _run(torch_main, ["analyze", *wavs, "--json", "--spectrogram",
                                    str(tmp_path / "spec"), "--timeline",
                                    str(tmp_path / "tl")])
    assert rc_j == rc_t == 0
    rows_j, rows_t = json.loads(out_j), json.loads(out_t)
    assert [r["file"] for r in rows_t] == wavs
    for rj, rt in zip(rows_j, rows_t):
        for k in ("title", "channels", "rate", "duration_s"):
            assert rj[k] == rt[k]
        # the CLI rounds to 2 decimals: engine tolerance plus one rounding step
        assert abs(rj["integrated_lufs"] - rt["integrated_lufs"]) <= 0.01 + 2e-3
        assert abs(rj["lra_lu"] - rt["lra_lu"]) <= 0.01 + 2e-3
        np.testing.assert_allclose(rt["true_peak"], rj["true_peak"], atol=1e-4)
        np.testing.assert_allclose(rt["sample_peak"], rj["sample_peak"], atol=1e-4)
        assert abs(rj["true_peak_dbtp"] - rt["true_peak_dbtp"]) <= 0.011
        spec = np.load(rt["spectrogram"])
        assert spec["mid_db"].shape[1] == 128 and np.isfinite(spec["mid_db"]).all()
        tl = np.load(rt["timeline"])
        assert tl["shortterm_lufs"].size > 0
    assert abs(rows_t[0]["integrated_lufs"] + 23.0) < 0.1


def test_cli_table_scan_and_errors(wavs, tmp_path):
    rc, out = _run(torch_main, ["analyze", wavs[0]])
    assert rc == 0 and "LUFS-I" in out and "tone" in out
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not audio")
    rc, out = _run(torch_main, ["analyze", str(bad), "--json"])
    assert rc == 1 and "error" in json.loads(out)[0]
    rc, out = _run(torch_main, ["scan", os.path.dirname(wavs[0]), "--json",
                                "--compact"])
    assert rc == 0 and len(json.loads(out)) == 2
    assert _run(torch_main, ["scan", str(tmp_path / "empty")])[0] == 1


def test_cli_subprocess_loads_no_jax(wavs):
    """The port's CLI end to end in a fresh interpreter: it decodes through
    the reference's io.py loaded by path and never imports JAX."""
    code = (
        "import sys, json\n"
        "from soundscope_tpu_torch.apps.cli import main\n"
        f"rc = main(['analyze', {wavs[1]!r}, '--json', '--compact'])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'soundscope_tpu')]\n"
        "assert rc == 0 and not bad, (rc, bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    row = json.loads(out.stdout.strip().splitlines()[0])[0]
    assert row["integrated_lufs"] is not None and row["rate"] == 48000
