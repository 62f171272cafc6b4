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
    args = log.read_text().split()
    assert "arch=compute_90a,code=sm_90a" in args
    assert sorted(a for a in args if a.endswith(".cu")) == sorted(
        str(p) for p in _build.sources())
    assert {os.path.basename(p) for p in args if p.endswith(".cu")} >= {
        "iir_chunked.cu", "stft_pooled.cu"}
    assert _build.build() == out                  # same key: no second compile
    assert len(log.read_text().splitlines()) == 1
