"""Build and load the CUDA kernels (K1-K6) as one shared library.

`library()` compiles every ``soundscope_tpu_torch/csrc/*.cu`` with nvcc
for Hopper (``sm_90a``), one nvcc process per source, all started
together, links the objects into ``build/soundscope_tpu_torch/<key>/
libsstorch.so`` beside the package, and loads it with ctypes. <key> hashes
the flags and every file nvcc reads: the sources and the ``*.cuh``/``*.h``
headers they include, so an edited header rebuilds the library. The
sources have a plain C interface and include no PyTorch headers, so a
build takes seconds. A missing nvcc or a failed build raises; nothing
falls back.

Import this module only where a kernel is launched: the package itself
imports on machines without a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD = _PKG.parent / "build" / "soundscope_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
# C entries of csrc/*.cu: (name, argtypes); each returns a cudaError_t
_ENTRIES = (
    # x, n_valid, coef, weights, taps, factor, rows, ch, n, L, h,
    # s_final, s_entry, step_sums, tp_part, sp_part, tp, sp, stream
    ("ss_kweight_energy_tp",
     [_P] * 5 + [_INT, _I64, _INT, _I64, _I64, _I64] + [_P] * 8),
    # frames, tracks, n, nw, hann, g2, twiddles, mid, side, stream
    ("ss_stft_pooled", [_P, _I64, _I64, _I64] + [_P] * 6),
    # x, n_valid, coef, weights, taps, factor, b, ch, n, L, group,
    # s_final, s_entry, z, tp_part, sp_part, tp, sp, stream
    ("ss_kweight_energy_rows",
     [_P] * 5 + [_INT, _I64, _INT, _I64, _I64, _I64] + [_P] * 8),
    # x, n_valid, coef, weights, b, ch, n, group, zr, z, stream
    ("ss_kweight_energy_chain", [_P] * 4 + [_I64, _INT, _I64, _I64] + [_P] * 3),
    # x, n_valid_rows, taps, factor, rows, n, L, tp_part, sp_part, tp, sp,
    # stream
    ("ss_true_peak_stream", [_P] * 3 + [_INT, _I64, _I64, _I64] + [_P] * 5),
)


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of soundscope_tpu_torch are built "
        "from its csrc/ at first use (set CUDA_HOME or put nvcc on PATH)")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    return sorted([*CSRC.glob("*.cuh"), *CSRC.glob("*.h")])


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted([*sources(), *headers()]):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands concurrently; raise with the first failure's
    compiler output once every one has ended."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    errs = [p.communicate()[1] for p in procs]
    for c, p, err in zip(cmds, procs, errs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}): {' '.join(c)}\n{err}")


def build() -> Path:
    """Compile the library unless this exact build exists; return its path."""
    out = BUILD / _key() / "libsstorch.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    objs = [out.with_name(f"{s.stem}.{tag}.o") for s in sources()]
    exe = nvcc()
    _run_all([[exe, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
              for s, o in zip(sources(), objs)])
    tmp = out.with_name(f"libsstorch.{tag}.tmp.so")
    _run_all([[exe, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
    os.replace(tmp, out)
    for o in objs:
        o.unlink(missing_ok=True)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (at first use) and load the kernels' shared library."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.ss_error_string.argtypes = [ctypes.c_int]
    lib.ss_error_string.restype = ctypes.c_char_p
    return lib


def raise_on_error(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = lib.ss_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
