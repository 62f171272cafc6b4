"""The port's library-scan and end-to-end scan benches
(soundscope_tpu_torch/tools/library_scan_bench.py, e2e_scan_bench.py) on
the CPU, small: their JSON lines, the library scan's reduction against
the JAX package's engine, and the corpus against the JAX tool's."""

import contextlib
import importlib.util
import io
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soundscope_tpu.core.config import MeterConfig as JaxMeterConfig
from soundscope_tpu.models.engine import analyze_batch_native as jax_analyze_batch_native
from soundscope_tpu_torch.core.config import MeterConfig
from soundscope_tpu_torch.tools import e2e_scan_bench, library_scan_bench

REPO = Path(__file__).resolve().parents[1]
LIBRARY_KEYS = {"metric", "tracks", "scan_ms", "rt_factor", "tracks_per_sec", "device"}
E2E_KEYS = {"metric", "value", "unit", "tracks", "errors", "audio_sec", "rt_factor", "wall_s",
            "decode_rt", "analyze_rt", "decode_threads", "device", "kinds"}


def _run(main, argv):
    """(exit code, stdout lines) of main(argv)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue().strip().splitlines()


def test_library_scan_bench_prints_one_line():
    rc, lines = _run(library_scan_bench.main, ["2", "1", "--device", "cpu", "--repeats", "1"])
    assert rc == 0 and len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == LIBRARY_KEYS
    assert line["metric"] == "library_scan_rt_factor"
    assert line["tracks"] == 2 and line["device"] == "cpu"
    for k in ("scan_ms", "rt_factor", "tracks_per_sec"):
        assert np.isfinite(line[k]) and line[k] > 0


def test_library_scan_reduction_matches_jax():
    """The scan's scalar against the JAX tool's reduction of the JAX
    package's analyze_batch_native on the same rows."""
    n = 48000
    x = library_scan_bench.make_input(2, n, torch.device("cpu"))
    nv = torch.full((2,), n, dtype=torch.int64)
    got = float(library_scan_bench.scan(MeterConfig(channels=2, rate=48000, max_blocks=0),
                                        x, nv))
    r = jax.jit(jax_analyze_batch_native(JaxMeterConfig(channels=2, rate=48000, max_blocks=0)))(
        jnp.asarray(x.numpy()), jnp.asarray(nv.numpy().astype(np.int32)))
    want = float(jnp.sum(jnp.where(jnp.isfinite(r.integrated_lufs), r.integrated_lufs, 0.0))
                 + jnp.sum(r.lra) + jnp.sum(r.true_peak))
    assert np.isfinite(got) and got == pytest.approx(want, rel=1e-4)


@pytest.mark.parametrize("tool", [library_scan_bench, e2e_scan_bench])
def test_benches_refuse_without_a_card(monkeypatch, capsys, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main(["1", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_corpus_matches_the_jax_tool(tmp_path):
    """Same names, and the WAV and FLAC files equal byte for byte."""
    spec = importlib.util.spec_from_file_location("jax_e2e_scan_bench",
                                                  REPO / "tools" / "e2e_scan_bench.py")
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    ours.mkdir()
    theirs.mkdir()
    made = e2e_scan_bench.make_corpus(str(ours), 6, 0.5)
    want = jax_tool.make_corpus(str(theirs), 6, 0.5)
    assert [os.path.basename(p) for p in made] == [os.path.basename(p) for p in want]
    same = [p for p in made if p.endswith((".wav", ".flac"))]
    assert len(same) >= 2
    for p in same:
        assert Path(p).read_bytes() == (theirs / os.path.basename(p)).read_bytes(), p


def test_e2e_scan_bench_prints_one_line(tmp_path):
    keep = tmp_path / "corpus"
    rc, lines = _run(e2e_scan_bench.main, ["3", "0.5", "--device", "cpu", "--keep", str(keep)])
    assert rc == 0 and len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == E2E_KEYS
    files = sorted(os.listdir(keep))
    assert line["metric"] == "e2e_scan_tracks_per_sec" and line["device"] == "cpu"
    assert line["tracks"] == len(files) > 0 and line["errors"] == 0
    assert line["kinds"] == [f.rsplit(".", 1)[1] for f in files]
    assert line["audio_sec"] == pytest.approx(0.5 * len(files), abs=0.1)
