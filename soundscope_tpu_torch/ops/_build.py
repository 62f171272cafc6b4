"""Build and load the CUDA kernels (K1, K2) as one shared library.

`library()` compiles every ``soundscope_tpu_torch/csrc/*.cu`` with nvcc
for Hopper (``sm_90a``) into ``build/soundscope_tpu_torch/<key>/
libsstorch.so`` beside the package, where <key> hashes the sources and
flags, and loads it with ctypes. The sources have a plain C interface and
include no PyTorch headers, so a build takes seconds. A missing nvcc or a
failed build raises; nothing falls back.

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
              "-shared", "-Xcompiler", "-fPIC")

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


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library unless this exact build exists; return its path."""
    out = BUILD / _key() / "libsstorch.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"libsstorch.{os.getpid()}.tmp.so")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
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
