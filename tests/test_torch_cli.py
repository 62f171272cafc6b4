"""The port's batch CLI against the JAX CLI, its decoders against the JAX
package's, and its JAX-free run."""

import io
import json
import os
import shutil
import struct
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

import soundscope_tpu.utils.io as jio
import soundscope_tpu_torch.utils.io as tio
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
                                    str(tmp_path / "tl"), "--device", "cpu"])
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
    rc, out = _run(torch_main, ["analyze", wavs[0], "--device", "cpu"])
    assert rc == 0 and "LUFS-I" in out and "tone" in out
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not audio")
    rc, out = _run(torch_main, ["analyze", str(bad), "--json", "--device", "cpu"])
    assert rc == 1 and "error" in json.loads(out)[0]
    rc, out = _run(torch_main, ["scan", os.path.dirname(wavs[0]), "--json",
                                "--compact", "--device", "cpu"])
    assert rc == 0 and len(json.loads(out)) == 2
    assert _run(torch_main, ["scan", str(tmp_path / "empty"), "--device", "cpu"])[0] == 1


def test_cli_subprocess_loads_no_jax(wavs, tmp_path):
    """The port's CLI end to end in a fresh interpreter, from a tree that
    holds soundscope_tpu_torch/ and no soundscope_tpu/: it decodes with its
    own io.py, reads no file of the JAX package and never imports JAX."""
    shutil.copytree(REPO / "soundscope_tpu_torch", tmp_path / "soundscope_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = (
        "import sys, json\n"
        "from soundscope_tpu_torch.apps.cli import main\n"
        f"rc = main(['analyze', {wavs[1]!r}, '--json', '--compact', '--device', 'cpu'])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'soundscope_tpu')]\n"
        "assert rc == 0 and not bad, (rc, bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    row = json.loads(out.stdout.strip().splitlines()[0])[0]
    assert row["integrated_lufs"] is not None and row["rate"] == 48000


def _aiff(path, planar, rate_f80, bits, compression=None):
    """An AIFF (or AIFC with `compression`) file of 16/24-bit PCM."""
    inter = np.ascontiguousarray(planar.T).reshape(-1)
    full = float(2 ** (bits - 1) - 1)
    x = (np.clip(inter, -1, 1) * full).astype(np.int32)
    le = compression == b"sowt"
    if bits == 16:
        pcm = x.astype("<i2" if le else ">i2").tobytes()
    else:
        b = x.astype(">i4").view(np.uint8).reshape(-1, 4)[:, 1:]
        pcm = (b[:, ::-1] if le else b).tobytes()
    comm = struct.pack(">HIH", planar.shape[0], planar.shape[1], bits) + rate_f80
    form = b"AIFC" if compression else b"AIFF"
    if compression:
        comm += compression + b"\x00\x00"
    ssnd = struct.pack(">II", 0, 0) + pcm
    body = form + b"COMM" + struct.pack(">I", len(comm)) + comm
    body += b"SSND" + struct.pack(">I", len(ssnd)) + ssnd
    with open(path, "wb") as f:
        f.write(b"FORM" + struct.pack(">I", len(body)) + body)


@pytest.mark.parametrize("kind", ["wav16", "wav32", "aiff16", "aiff24", "aifc_sowt"])
def test_decoders_match_jax(tmp_path, kind):
    """The port's copy of the NumPy decoders reads every file as the JAX
    package's decoders do, bit for bit."""
    t = np.arange(4410) / 44100
    planar = np.stack([0.5 * np.sin(2 * np.pi * 440 * t),
                       0.25 * np.sin(2 * np.pi * 880 * t)]).astype(np.float32)
    f80 = bytes.fromhex("400EAC44000000000000")          # 44100.0
    p = str(tmp_path / ("x.wav" if kind.startswith("wav") else "x.aiff"))
    if kind == "wav16":
        tio.write_wav(p, planar, 44100, bits=16)
    elif kind == "wav32":
        tio.write_wav(p, planar, 44100, bits=32)
    elif kind == "aifc_sowt":
        _aiff(p, planar, f80, 16, b"sowt")
    else:
        _aiff(p, planar, f80, int(kind[4:]))
    got, want = tio.decode_file(p), jio.decode_file(p, prefer_native=False)
    assert (got.rate, got.title, got.channels) == (want.rate, want.title, want.channels)
    np.testing.assert_array_equal(got.samples, want.samples)
    np.testing.assert_array_equal(got.interleaved(), want.interleaved())
    for a, b in zip(got.mid_side(), want.mid_side()):
        np.testing.assert_array_equal(a, b)
    assert tio._read_f80(f80) == jio._read_f80(f80) == 44100.0
    assert tio.AUDIO_EXTENSIONS == jio.AUDIO_EXTENSIONS


def test_decoder_errors_match_jax(tmp_path):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFF\x00\x00\x00\x00WAVEjunk")
    for mod in (tio, jio):
        with pytest.raises(mod.DecodeError):
            mod.decode_wav(str(bad))
    raw = np.arange(12, dtype="<i2").tobytes()
    np.testing.assert_array_equal(tio._pcm_to_f32(raw, 16, 1), jio._pcm_to_f32(raw, 16, 1))
    with pytest.raises(tio.DecodeError):
        tio._pcm_to_f32(raw, 12, 1)


def test_warmup_runs_one_bucket():
    # the port's counterpart of the JAX CLI's warmup test (tests/test_cli.py):
    # the port keeps no per-shape cache, so its warmup is the builds alone;
    # on the CPU the native decoders', and no shape is analyzed
    from soundscope_tpu_torch import native

    rc, out = _run(torch_main, ["warmup", "--device", "cpu"])
    assert rc == 0
    lines = out.strip().splitlines()
    assert len(lines) == 1
    assert lines[0].startswith(f"warmup: built native decoders {native.build()} in ")
    assert "kernel library" not in out
    with pytest.raises(SystemExit):      # the bucket grid's flags are gone
        torch_main(["warmup", "--device", "cpu", "--rates", "44100"])
