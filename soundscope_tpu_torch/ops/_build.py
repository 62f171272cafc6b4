"""Build and load the CUDA kernels (K1-K7) as one shared library.

`library()` compiles every ``soundscope_tpu_torch/csrc/*.cu`` with nvcc
for Hopper (``sm_90a``), one nvcc process per source, all started
together, links the objects into ``build/soundscope_tpu_torch/<key>/
libsstorch.so`` beside the package, and loads it with ctypes. <key> hashes
the flags and every file nvcc reads: the sources and the ``*.cuh``/``*.h``
headers they include, so an edited header rebuilds the library. The
sources have a plain C interface and include no PyTorch headers, so a
build takes seconds. A missing nvcc or a failed build raises; nothing
falls back.

`launch` and `attributes` are the one way the wrappers (K1-K7) call the
library: a launch on the device's current stream, its error raised and
its count `launch.<kernel>` taken; a kernel's resources as one dict.

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

import torch

from soundscope_tpu_torch.utils.metrics import GLOBAL

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
    # x, n_valid, consts, taps, weights (host), factor, rows, ch, n, L, h,
    # T, sync, step_sums, tp_part, sp_part, tp, sp, stream
    ("ss_kweight_energy_tp",
     [_P] * 5 + [_INT, _I64, _INT, _I64, _I64, _I64, _I64] + [_P] * 7),
    # factor, T, out[6]: K1's registers, smem, spills, threads, CTAs per SM
    ("ss_kweight_energy_tp_attrs", [_INT, _I64, _P]),
    # frames, tracks, n, nw, hann, g2, twiddles, mid, side, stream
    ("ss_stft_pooled", [_P, _I64, _I64, _I64] + [_P] * 6),
    # out[6]: K2's registers, smem, spills, threads, CTAs per SM
    ("ss_stft_pooled_attrs", [_P]),
    # x, n_valid, consts, weights (host), b, ch, n, group, T, lookback,
    # sync, zr, z, stream: K4, K5 over rows
    ("ss_kweight_energy_rows",
     [_P] * 4 + [_I64, _INT, _I64, _I64, _I64, _INT] + [_P] * 4),
    # x, n_valid, consts, lane powers, taps, weights (host), factor, b, ch,
    # n, group, Tc, sync, zr, z, tp_part, sp_part, tp, sp, stream: K3
    ("ss_kweight_energy_tp_tracks",
     [_P] * 6 + [_INT, _I64, _INT, _I64, _I64, _I64] + [_P] * 8),
    # x, n_valid, consts, lane powers, weights (host), b, ch, n, group, T,
    # Tc, sync, z, skipped, stream: K5 on track tickets
    ("ss_kweight_energy_chain", [_P] * 5 + [_I64, _INT, _I64, _I64, _I64, _I64] + [_P] * 4),
    # factor, T, lookback, tracks, out[6]: K3's (factor 2, 4) or K4's /
    # K5's (0) resources
    ("ss_kweight_energy_rows_attrs", [_INT, _I64, _INT, _INT, _P]),
    # x, n_valid, rows per length, taps (host), factor, rows, n, tp_part,
    # sp_part, tp, sp, stream: K6
    ("ss_true_peak_stream", [_P, _P, _I64, _P, _INT, _I64, _I64] + [_P] * 5),
    # factor, out[6]: K6's resources
    ("ss_true_peak_stream_attrs", [_INT, _P]),
    # x, row stride, sample stride, s0, consts, A^m (host), rows, n, T, sync,
    # y, s_out, stream: K7
    ("ss_block_iir_stream", [_P, _I64, _I64, _P, _P, _P, _I64, _I64, _I64] + [_P] * 4),
    # T, out[6]: K7's resources
    ("ss_block_iir_stream_attrs", [_I64, _P]),
)
# what each *_attrs entry writes to its out[6], in order
ATTRIBUTE_KEYS = ("registers", "static_smem", "dynamic_smem", "local_bytes",
                  "threads", "blocks_per_sm")


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
    GLOBAL.count("kernels.builds")
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
    """Build (at first use) and load the kernels' shared library, in the
    span `kernels.load`; `kernels.builds` counts the nvcc builds (0 where
    this exact build exists)."""
    GLOBAL.count("kernels.builds", 0)
    with GLOBAL.span("kernels.load"):
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


def launch(entry: str, what: str, device, *args) -> None:
    """Call the C entry `entry` with `args` and, last, `device`'s current
    stream; raise with `what` if it returns a CUDA error, else count a
    launch of the kernel `what` names first (`launch.K1` .. `launch.K7`)."""
    lib = library()
    with torch.cuda.device(device):
        err = getattr(lib, entry)(*args, torch.cuda.current_stream(device).cuda_stream)
    raise_on_error(lib, err, what)
    GLOBAL.count(f"launch.{what.split()[0]}")


def attributes(entry: str, *args) -> dict:
    """A kernel's resources as the CUDA runtime reports them (needs a card),
    from the C entry `entry` called with `args` and an out[6]: registers
    per thread, static and dynamic shared memory bytes per CTA, local
    (spill) bytes per thread, threads per CTA and CTAs resident per SM."""
    lib = library()
    out = (ctypes.c_int * len(ATTRIBUTE_KEYS))()
    raise_on_error(lib, getattr(lib, entry)(*args, out), entry)
    return dict(zip(ATTRIBUTE_KEYS, out))
