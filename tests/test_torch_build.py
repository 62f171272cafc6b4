"""Build plumbing of the port's CUDA library (ops/_build.py), on the CPU:
a missing or failing nvcc raises, and a finished build is reused by its
source key. A stand-in nvcc script takes the compiler's place."""

import os
import stat

import pytest

from soundscope_tpu_torch.ops import _build


def _fake_nvcc(path, body):
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    return tmp_path


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os, "access", lambda p, mode: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_failed_build_raises_with_compiler_output(build_dir, monkeypatch):
    nvcc = _fake_nvcc(build_dir / "nvcc", 'echo "error: bad kernel" >&2\nexit 3\n')
    monkeypatch.setattr(_build, "nvcc", lambda: nvcc)
    with pytest.raises(RuntimeError, match="bad kernel"):
        _build.build()
    assert not list((build_dir / "build").rglob("*.so"))


def test_build_compiles_every_source_once_per_key(build_dir, monkeypatch):
    log = build_dir / "calls.txt"
    # write the -o target and record the arguments
    nvcc = _fake_nvcc(build_dir / "nvcc", (
        f'echo "$@" >> {log}\n'
        'while [ "$1" != "-o" ]; do shift; done\n'
        'touch "$2"\n'))
    monkeypatch.setattr(_build, "nvcc", lambda: nvcc)
    out = _build.build()
    assert out.exists() and out.name == "libsstorch.so"
    assert out.parent.parent == build_dir / "build"
    calls = [c.split() for c in log.read_text().splitlines()]
    compiles = [c for c in calls if "-c" in c]
    links = [c for c in calls if "-shared" in c]
    # one nvcc per source, then one link of their objects
    assert len(compiles) == len(_build.sources()) and len(links) == 1
    assert len(calls) == len(compiles) + 1
    for c in calls:
        assert "arch=compute_90a,code=sm_90a" in c
    assert sorted(a for c in compiles for a in c if a.endswith(".cu")) == sorted(
        str(p) for p in _build.sources())
    assert {os.path.basename(a) for c in compiles for a in c if a.endswith(".cu")} >= {
        "iir_chunked.cu", "stft_pooled.cu", "iir_rows.cu", "truepeak_stream.cu"}
    assert sorted(a for a in links[0] if a.endswith(".o")) == sorted(
        c[c.index("-o") + 1] for c in compiles)
    assert not list(out.parent.glob("*.o"))          # objects removed
    assert _build.build() == out                  # same key: no second compile
    assert len(log.read_text().splitlines()) == len(calls)


def test_edited_header_changes_the_build_key(tmp_path, monkeypatch):
    """The key hashes every file nvcc reads: a source's included header
    as well as the sources, so an edited header rebuilds the library."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include "common.cuh"\n')
    (csrc / "common.cuh").write_text("// v1\n")
    (csrc / "extra.h").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert [p.name for p in _build.headers()] == ["common.cuh", "extra.h"]
    k1 = _build._key()
    assert _build._key() == k1
    (csrc / "common.cuh").write_text("// v2\n")
    k2 = _build._key()
    assert k2 != k1
    (csrc / "extra.h").write_text("// v2\n")
    assert _build._key() not in (k1, k2)
    # the real tree: every header under csrc/ is part of the key
    monkeypatch.setattr(_build, "CSRC", _build._PKG / "csrc")
    assert {p.name for p in _build.headers()} >= {"iir_common.cuh"}
