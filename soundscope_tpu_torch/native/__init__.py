"""ctypes bindings for the native C++ runtime (decoders + ring buffer).

The port's own copy of the JAX package's native runtime: the same C++
sources (the WAV decoder and capture ring in decoder.cpp, the first-party
FLAC, MPEG audio, ALAC with its MP4/CAF demux, Ogg Vorbis and AAC-LC
decoders, and the libav codec bridge, which compiles out where the libav
headers are absent), built into a library of the port's own,
`libssnative_torch.so` in this directory.

Build (also done automatically at first use):
    python -m soundscope_tpu_torch.native.build
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libssnative_torch.so")
_ARCH_STAMP = _SO + ".arch"
_LOCK = _SO + ".lock"
_lib = None
_load_lock = threading.Lock()


_SOURCES = ("decoder.cpp", "flac.cpp", "mp3.cpp", "codecs.cpp",
            "demux.cpp", "alac.cpp", "vorbis.cpp", "aac.cpp")
_HEADERS = ("demux.h", "imdct.h", "aac_tables.inc", "mp3_tables.inc")


def _libav_headers() -> bool:
    return any(
        os.path.exists(os.path.join(d, "libavformat", "avformat.h"))
        for d in ("/usr/include/x86_64-linux-gnu", "/usr/include",
                  "/usr/local/include")
    )


def _cxx() -> str | None:
    """The first of g++, c++ and clang++ on PATH (macOS has no real g++;
    Windows has none by default: there `available()` stays False and
    decode falls back to the NumPy WAV/AIFF path)."""
    import shutil

    for cand in ("g++", "c++", "clang++"):
        if shutil.which(cand):
            return cand
    return None


@contextlib.contextmanager
def _build_lock():
    """One build at a time across processes (pytest -n, the CLI and the
    TUI starting together): the others wait, then find the library built."""
    try:
        import fcntl
    except ImportError:        # no flock: the temp-dir-and-rename build alone
        yield
        return
    with open(_LOCK, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _arch_sig() -> str:
    """Fingerprint of this host's CPU, so a cached .so carried to a
    different machine (NFS home, container image) forces a rebuild
    instead of SIGILLing at load time. Reads /proc/cpuinfo (no
    subprocess: this runs on every native load)."""
    try:
        sig = []
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags")):
                    sig.append(line.strip())
                    if len(sig) == 2:
                        break
        return hashlib.sha1("\n".join(sig).encode()).hexdigest()[:16]
    except Exception:
        return "unknown"


def _stale() -> bool:
    srcs = [os.path.join(_DIR, s) for s in _SOURCES + _HEADERS]
    newest = max(os.path.getmtime(s) for s in srcs)
    try:
        with open(_ARCH_STAMP) as f:
            if f.read().strip() != _arch_sig():
                return True
    except OSError:
        return True
    return not os.path.exists(_SO) or os.path.getmtime(_SO) < newest


def _compile(cxx: str, cflags: list, defs: list, tmpd: str) -> list:
    """Compile every source into tmpd, all at once (one compiler process
    per source); returns the object paths or raises CalledProcessError."""
    jobs = []
    for s in _SOURCES:
        o = os.path.join(tmpd, os.path.splitext(s)[0] + ".o")
        cmd = [cxx, *cflags, *defs, "-c", os.path.join(_DIR, s), "-o", o]
        jobs.append((cmd, o, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.PIPE)))
    failed = None
    for cmd, _, proc in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = subprocess.CalledProcessError(proc.returncode, cmd, out, err)
    if failed is not None:
        raise failed
    return [o for _, o, _ in jobs]


def build(force: bool = False, cxx: str | None = None) -> str:
    """Build the library if it is missing or older than its sources (or
    built on another CPU), with `cxx` or else the first of g++, c++ and
    clang++ on PATH; returns its path."""
    if not force and not _stale():
        return _SO
    with _build_lock():
        if force or _stale():
            _build(cxx or _cxx())
    return _SO


def _build(cxx: str | None) -> None:
    # -ffast-math: the decode paths are FIR/IMDCT float chains with no
    # NaN/Inf semantics to preserve. It is applied at COMPILE only:
    # linking a shared object with -ffast-math on GCC<=12 pulls in
    # crtfastmath.o, whose constructor sets FTZ/DAZ process-wide the
    # moment ctypes dlopens the library.
    import platform
    import shutil
    import tempfile
    import time

    if cxx is None:
        raise RuntimeError("no C++ compiler found (pass build(cxx=...))")
    cflags = ["-O3", "-funroll-loops", "-ffast-math", "-fPIC", "-std=c++17"]
    # -march=native is an x86 flag spelling; AArch64 wants -mcpu=native
    mach = platform.machine().lower()
    if mach in ("x86_64", "amd64", "i686"):
        cflags.insert(1, "-march=native")
    elif mach in ("arm64", "aarch64"):
        cflags.insert(1, "-mcpu=native")
    # a build killed before its finally (SIGKILL, power loss) strands its
    # temp dir: sweep siblings older than a day first
    try:
        now = time.time()
        for st in os.listdir(_DIR):
            full = os.path.join(_DIR, st)
            if (st.startswith("ssnative-") and os.path.isdir(full)
                    and now - os.path.getmtime(full) > 86400):
                shutil.rmtree(full, ignore_errors=True)
    except OSError:
        pass
    for want_libav in ([True] if _libav_headers() else []) + [False]:
        defs = ["-DSS_HAVE_LIBAV"] if want_libav else []
        libs = (["-lavformat", "-lavcodec", "-lavutil", "-lswresample"]
                if want_libav else [])
        # objects live in a per-process temp dir on the package's own
        # filesystem, and the library is renamed into place, so a reader
        # never sees a partial file
        tmpd = tempfile.mkdtemp(prefix="ssnative-", dir=_DIR)
        try:
            objs = _compile(cxx, cflags, defs, tmpd)
            tmp_so = os.path.join(tmpd, os.path.basename(_SO))
            subprocess.run([cxx, "-shared", *objs, "-o", tmp_so, *libs],
                           check=True, capture_output=True)
            os.replace(tmp_so, _SO)
        except subprocess.CalledProcessError as e:
            if not want_libav:
                raise RuntimeError(
                    "native build failed:\n" + (e.stderr or b"").decode()) from e
            continue  # retry without the libav codec bridge
        finally:
            shutil.rmtree(tmpd, ignore_errors=True)
        with open(_ARCH_STAMP, "w") as f:
            f.write(_arch_sig())
        return


def _load():
    with _load_lock:       # the decode pool's threads all start here
        return _lib if _lib is not None else _load_locked()


def _load_locked():
    global _lib
    try:
        build()
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            # built elsewhere against libraries this machine lacks (libav)
            build(force=True)
            lib = ctypes.CDLL(_SO)
    except Exception:
        return None

    class DecodedWav(ctypes.Structure):
        _fields_ = [
            ("data", ctypes.POINTER(ctypes.c_float)),
            ("frames", ctypes.c_int64),
            ("channels", ctypes.c_int32),
            ("rate", ctypes.c_int32),
        ]

    lib.ss_decode_wav.argtypes = [ctypes.c_char_p, ctypes.POINTER(DecodedWav)]
    lib.ss_decode_wav.restype = ctypes.c_int
    lib.ss_decode_flac.argtypes = [ctypes.c_char_p, ctypes.POINTER(DecodedWav)]
    lib.ss_decode_flac.restype = ctypes.c_int
    lib.ss_decode_mp3.argtypes = [ctypes.c_char_p, ctypes.POINTER(DecodedWav)]
    lib.ss_decode_mp3.restype = ctypes.c_int
    lib.ss_decode_alac.argtypes = [ctypes.c_char_p, ctypes.POINTER(DecodedWav)]
    lib.ss_decode_alac.restype = ctypes.c_int
    lib.ss_decode_vorbis.argtypes = [ctypes.c_char_p, ctypes.POINTER(DecodedWav)]
    lib.ss_decode_vorbis.restype = ctypes.c_int
    lib.ss_decode_aac.argtypes = [ctypes.c_char_p, ctypes.POINTER(DecodedWav)]
    lib.ss_decode_aac.restype = ctypes.c_int
    lib.ss_decode_any.argtypes = [ctypes.c_char_p, ctypes.POINTER(DecodedWav)]
    lib.ss_decode_any.restype = ctypes.c_int
    lib.ss_decode_any_fmt.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(DecodedWav)]
    lib.ss_decode_any_fmt.restype = ctypes.c_int
    lib.ss_codecs_available.restype = ctypes.c_int
    lib.ss_encode_audio.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.ss_encode_audio.restype = ctypes.c_int
    lib.ss_free_decoded.argtypes = [ctypes.POINTER(DecodedWav)]
    lib.ss_ring_new.argtypes = [ctypes.c_int64]
    lib.ss_ring_new.restype = ctypes.c_void_p
    lib.ss_ring_free.argtypes = [ctypes.c_void_p]
    lib.ss_ring_push.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
    ]
    lib.ss_ring_snapshot.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    lib.ss_ring_snapshot_total.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)
    ]
    lib.ss_ring_snapshot_total.restype = ctypes.c_uint64
    lib.ss_ring_total.argtypes = [ctypes.c_void_p]
    lib.ss_ring_total.restype = ctypes.c_uint64
    lib._DecodedWav = DecodedWav
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _decode_with(fn_name: str, path: str, what: str, *args):
    """Decode through the library function `fn_name(path, *args, out)`."""
    from soundscope_tpu_torch.utils.io import DecodedAudio, DecodeError

    lib = _load()
    if lib is None:
        raise DecodeError("native decoder unavailable")
    out = lib._DecodedWav()
    rc = getattr(lib, fn_name)(path.encode(), *args, ctypes.byref(out))
    if rc != 0:
        raise DecodeError(f"native {what} decode failed (rc={rc})")
    try:
        n = out.frames * out.channels
        flat = np.ctypeslib.as_array(out.data, shape=(int(n),))
        planar = flat.reshape(out.channels, out.frames).copy()
    finally:
        lib.ss_free_decoded(ctypes.byref(out))
    title = os.path.splitext(os.path.basename(path))[0]
    return DecodedAudio(planar, int(out.rate), title)


class decoder:
    """Namespace mirroring utils.io's decode interface."""

    @staticmethod
    def available() -> bool:
        return available()

    @staticmethod
    def codecs_available() -> bool:
        """True when the libav compressed-codec bridge was compiled in."""
        lib = _load()
        return bool(lib) and bool(lib.ss_codecs_available())

    @staticmethod
    def decode(path: str):
        return _decode_with("ss_decode_wav", path, "WAV")

    @staticmethod
    def decode_flac(path: str):
        """First-party FLAC decoder (native/flac.cpp)."""
        return _decode_with("ss_decode_flac", path, "FLAC")

    @staticmethod
    def decode_mp3(path: str):
        """First-party MPEG audio decoder (native/mp3.cpp): Layers
        I/II/III at every MPEG-1/2/2.5 rate, including free-format,
        LSF intensity stereo, and 8 kHz mixed blocks."""
        return _decode_with("ss_decode_mp3", path, "MP3")

    @staticmethod
    def decode_alac(path: str):
        """First-party ALAC decoder + MP4/CAF demux (native/alac.cpp,
        demux.cpp); also unpacks CAF LPCM. AAC-in-MP4 returns an error
        so the caller can fall back to the bridge."""
        return _decode_with("ss_decode_alac", path, "ALAC/MP4/CAF")

    @staticmethod
    def decode_vorbis(path: str):
        """First-party Ogg Vorbis decoder (native/vorbis.cpp). Non-Vorbis
        Ogg payloads (opus/flac/speex) error out so the caller can fall
        back to the bridge."""
        return _decode_with("ss_decode_vorbis", path, "Ogg-Vorbis")

    @staticmethod
    def decode_aac(path: str):
        """First-party AAC-LC decoder (native/aac.cpp): ADTS and
        MP4/M4A containers, long+short windows, both window shapes,
        M/S + intensity stereo, TNS, PNS, pulses. Tables measured
        clean-room (tools/aac_extract)."""
        return _decode_with("ss_decode_aac", path, "AAC")

    @staticmethod
    def decode_any(path: str):
        """Compressed-codec bridge (mp3/aac/m4a/alac/ogg/caf/...)."""
        return _decode_with("ss_decode_any", path, "codec-bridge")

    @staticmethod
    def decode_any_fmt(path: str, fmt: str):
        """Bridge decode with a FORCED container format (bypasses the
        libav probe — crafted streams can embed fake sync words)."""
        from soundscope_tpu_torch.utils.io import DecodeError

        if not decoder.codecs_available():
            raise DecodeError("codec bridge unavailable")
        return _decode_with("ss_decode_any_fmt", path, "forced-format", fmt.encode())

    @staticmethod
    def encode(path: str, samples, rate: int, codec: str | None = None,
               bitrate: int = 0):
        """Encode planar (C, N) float32 via the codec bridge; container
        from the extension (ogg/m4a/caf/mp3/...), codec optionally forced
        (e.g. 'alac' inside .m4a), bitrate in bits/s (0 = default)."""
        from soundscope_tpu_torch.utils.io import DecodeError

        lib = _load()
        if lib is None or not lib.ss_codecs_available():
            raise DecodeError("codec bridge unavailable")
        x = np.ascontiguousarray(samples, np.float32)
        ch, n = x.shape
        rc = lib.ss_encode_audio(
            path.encode(), x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n, ch, rate, codec.encode() if codec else None, bitrate,
        )
        if rc != 0:
            raise DecodeError(f"native encode failed (rc={rc})")


class NativeRing:
    """Overwrite-oldest float ring buffer (capture feeder), C++-backed."""

    def __init__(self, capacity: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native runtime unavailable")
        self._lib = lib
        self._h = lib.ss_ring_new(capacity)
        self.capacity = capacity

    def push(self, x: np.ndarray) -> None:
        x = np.ascontiguousarray(x, np.float32)
        self._lib.ss_ring_push(
            self._h, x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), x.size
        )

    def snapshot(self) -> np.ndarray:
        out = np.empty(self.capacity, np.float32)
        self._lib.ss_ring_snapshot(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        )
        return out

    def snapshot_with_total(self):
        out = np.empty(self.capacity, np.float32)
        total = self._lib.ss_ring_snapshot_total(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        )
        return out, int(total)

    @property
    def total_pushed(self) -> int:
        return int(self._lib.ss_ring_total(self._h))

    def __del__(self):
        try:
            self._lib.ss_ring_free(self._h)
        except Exception:
            pass
