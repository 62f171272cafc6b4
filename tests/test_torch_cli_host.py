"""The port's CLI host: the pipelined decode pool, --decode-threads,
--metrics, --profile, the themes and tui subcommands and the mapping of a
bare path to the TUI, against the JAX CLI where both have the surface."""

import io
import json
import os
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

import soundscope_tpu.apps.cli as jcli
import soundscope_tpu_torch.apps.cli as tcli
from soundscope_tpu_torch.ops.stft import spectrogram
from soundscope_tpu_torch.utils.flacenc import write_flac
from soundscope_tpu_torch.utils.io import decode_file, write_wav
from soundscope_tpu_torch.utils.metrics import GLOBAL


def _run(argv, main=tcli.main):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Seeded noise as 16-bit FLAC and, the same samples, as float WAV, at
    two rates and lengths (three buckets), and one file that does not
    decode."""
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(5)
    flacs, wavs = [], []
    for i, (rate, secs) in enumerate([(48000, 2.0), (44100, 1.5), (48000, 2.0), (48000, 0.5),
                                      (44100, 1.5), (48000, 2.0)]):
        x = rng.standard_normal((2, int(rate * secs))) * 0.1 * (1 + i % 3)
        x = (np.clip(np.round(x * 32768), -32768, 32767) / 32768).astype(np.float32)
        flacs.append(str(d / f"n{i}.flac"))
        wavs.append(str(d / f"n{i}.wav"))
        write_flac(flacs[-1], x, rate)
        write_wav(wavs[-1], x, rate, bits=32)
    bad = d / "bad.flac"
    bad.write_bytes(b"not audio")
    files = flacs[:3] + [str(bad)] + flacs[3:]
    return files, wavs, d


def _rows(files, threads, spec_dir=None):
    argv = ["analyze", *files, "--json", "--compact", "--device", "cpu",
            "--decode-threads", str(threads)]
    if spec_dir:
        argv += ["--spectrogram", spec_dir]
    rc, out, _ = _run(argv)
    return rc, json.loads(out)


def test_pool_gives_the_serial_rows_in_input_order(corpus, tmp_path):
    files, wavs, _ = corpus
    rc1, serial = _rows(files, 1, str(tmp_path / "s1"))
    rc4, pooled = _rows(files, 4, str(tmp_path / "s4"))
    assert rc1 == rc4 == 1                           # the bad file fails
    assert [r["file"] for r in pooled] == files
    assert "error" in pooled[3] and pooled[3]["file"].endswith("bad.flac")
    for a, b in zip(serial, pooled):
        for k in a:
            if k != "spectrogram":
                assert a[k] == b[k], k
        if "spectrogram" in a:
            sa, sb = np.load(a["spectrogram"]), np.load(b["spectrogram"])
            np.testing.assert_array_equal(sa["mid_db"], sb["mid_db"])
    # FLAC and WAV of the same samples give the same rows
    rc, wav_rows = _rows(wavs, 2)
    assert rc == 0
    ok = [r for r in pooled if "error" not in r]
    for a, b in zip(ok, wav_rows):
        assert {k: v for k, v in a.items() if k not in ("file", "spectrogram")} == \
               {k: v for k, v in b.items() if k != "file"}
    assert tcli._decode_workers(100, 0) == min(os.cpu_count() or 4, 16)
    assert tcli._decode_workers(3, 8) == 3 and tcli._decode_workers(100, 5) == 5


def test_bucket_spectrograms_match_per_file(corpus, tmp_path):
    """The bucket's one spectrogram pass gives each file what
    ops/stft.spectrogram gives it alone, within K2's pin of 1e-3 dB (above
    40 kHz through K2's plain version here, whose batched FFT rounds apart
    from a batch of one; below it the plain path per file)."""
    files, _, _ = corpus
    rc, rows = _rows(files, 2, str(tmp_path / "spec"))
    for r in rows:
        if "error" in r:
            continue
        d = decode_file(r["file"])
        want = spectrogram(d.samples, d.rate, "cpu")
        got = np.load(r["spectrogram"])
        assert got["mid_db"].shape == want["mid_db"].shape and want["mid_db"].shape[0] > 0
        for k in ("mid_db", "side_db"):
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-3)
        for k in ("chart_x", "hop", "win", "rate"):
            np.testing.assert_array_equal(got[k], want[k])


def test_rows_match_the_jax_cli(corpus):
    _, wavs, _ = corpus
    rc_j, out_j, _ = _run(["analyze", *wavs[:3], "--json"], main=jcli.main)
    rc_t, rows_t = _rows(wavs[:3], 3)
    assert rc_j == rc_t == 0
    for rj, rt in zip(json.loads(out_j), rows_t):
        assert (rj["file"], rj["rate"], rj["duration_s"]) == (rt["file"], rt["rate"],
                                                              rt["duration_s"])
        assert abs(rj["integrated_lufs"] - rt["integrated_lufs"]) <= 0.01 + 2e-3
        np.testing.assert_allclose(rt["true_peak"], rj["true_peak"], atol=1e-4)


def test_metrics_and_profile(corpus, tmp_path):
    _, wavs, _ = corpus
    GLOBAL.reset()
    prof = tmp_path / "prof"
    rc, out, err = _run(["analyze", *wavs[:2], "--json", "--compact", "--device", "cpu",
                         "--metrics", "--profile", str(prof)])
    assert rc == 0 and len(json.loads(out)) == 2     # stdout stays parseable
    rep = json.loads(err.strip().splitlines()[-1])["metrics"]
    assert rep["decode"]["calls"] == 2 and rep["decode"]["audio_s"] > 3.4
    assert rep["analyze"]["calls"] == 2 and rep["analyze"]["audio_s"] > 3.4
    for k in ("engine.analyze_batch", "engine.plan", "engine.energy", "engine.tail"):
        assert rep[k]["calls"] == 2 and rep[k]["first_ms"] > 0
    assert rep["counters"].get("h2d.bytes", 0) == 0  # no card, no copies
    traces = list(prof.glob("trace-*.json"))
    assert len(traces) == 1 and str(traces[0]) in err
    events = json.loads(traces[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("aten::" in n for n in names)         # CPU activities only here
    assert {"ss.engine.analyze_batch", "ss.engine.energy"} <= names


def test_themes_subcommand_matches_jax():
    rc_t, out_t, _ = _run(["themes"])
    rc_j, out_j, _ = _run(["themes"], main=jcli.main)
    assert rc_t == rc_j == 0 and out_t == out_j and len(out_t.split()) >= 17


def test_bare_path_and_no_arguments_map_to_the_tui():
    for argv in (["song.flac"], ["song.flac", "--device", "cpu"], [], ["analyze", "x.wav"],
                 ["themes"], ["-v"], ["scan", "d"], ["tui", "x.wav"]):
        assert tcli._normalize_argv(argv) == jcli._normalize_argv(argv)
    assert tcli._normalize_argv(["song.flac"]) == ["tui", "song.flac"]
    assert tcli._normalize_argv([]) == ["tui"]


def test_tui_without_device_raises_without_a_card(corpus):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, wavs, _ = corpus
    for argv in (["tui"], [wavs[0]], ["tui", wavs[0], "--metrics"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            tcli.main(argv)
