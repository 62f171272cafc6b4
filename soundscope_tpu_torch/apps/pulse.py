"""PulseAudio playback/capture via libpulse-simple (ctypes, gated).

The reference plays and captures through rodio/cpal, which on Linux
desktops reaches ALSA *or* PulseAudio/PipeWire (src/audio_player.rs:279-289,
src/audio_capture.rs:14-29). The primary backend here is the ALSA
subprocess pair (apps/player.py AlsaSink, apps/capture.py AlsaStream) —
right for headless servers — but a PulseAudio-only desktop (or a
PipeWire one, which ships pipewire-pulse) has no `aplay`/`arecord` route.

This module binds the *simple* synchronous API of libpulse
(pa_simple_new/write/read/free) with ctypes, so no Python package or
compiled extension is needed: if `libpulse-simple.so.0` is present and a
Pulse server socket is reachable, playback and the microphone work; on
any other machine `available()` is False and the existing gates choose
ALSA or the synthetic streams. The binding is intentionally minimal —
f32le, the server's default device, default buffer attributes — matching
what the reference asks of rodio/cpal (default host, default device,
default config).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

# pa_sample_spec.format — pulse/sample.h
_PA_SAMPLE_FLOAT32LE = 5
# pa_stream_direction_t — pulse/def.h
_PA_STREAM_PLAYBACK = 1
_PA_STREAM_RECORD = 2

_CLIENT_NAME = b"soundscope-tpu"


class _SampleSpec(ctypes.Structure):
    _fields_ = [
        ("format", ctypes.c_int),
        ("rate", ctypes.c_uint32),
        ("channels", ctypes.c_uint8),
    ]


def _load_lib():
    """dlopen libpulse-simple; None when absent. Split out so tests can
    monkeypatch in a fake implementation."""
    for name in ("libpulse-simple.so.0", "libpulse-simple.so"):
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.pa_simple_new.restype = ctypes.c_void_p
        lib.pa_simple_new.argtypes = [
            ctypes.c_char_p,  # server (NULL = default)
            ctypes.c_char_p,  # client name
            ctypes.c_int,     # direction
            ctypes.c_char_p,  # device (NULL = default)
            ctypes.c_char_p,  # stream name
            ctypes.POINTER(_SampleSpec),
            ctypes.c_void_p,  # channel map (NULL = default)
            ctypes.c_void_p,  # buffer attrs (NULL = default)
            ctypes.POINTER(ctypes.c_int),  # error out
        ]
        lib.pa_simple_write.restype = ctypes.c_int
        lib.pa_simple_write.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int)]
        lib.pa_simple_read.restype = ctypes.c_int
        lib.pa_simple_read.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int)]
        lib.pa_simple_free.restype = None
        lib.pa_simple_free.argtypes = [ctypes.c_void_p]
        return lib
    return None


_lib_cache: list = []  # [lib-or-None], filled on first use


def _lib():
    if not _lib_cache:
        _lib_cache.append(_load_lib())
    return _lib_cache[0]


def _server_reachable() -> bool:
    """A Pulse/PipeWire server looks reachable: explicit PULSE_SERVER, or
    the per-user native socket exists. pa_simple_new would discover this
    too, but the gate keeps the default sink choice from flapping through
    a connect timeout on server-less machines."""
    if os.environ.get("PULSE_SERVER"):
        return True
    run = os.environ.get("XDG_RUNTIME_DIR", "")
    return bool(run) and os.path.exists(os.path.join(run, "pulse", "native"))


def _connect(lib, direction: int, rate: int, channels: int, what: bytes):
    spec = _SampleSpec(_PA_SAMPLE_FLOAT32LE, rate, channels)
    err = ctypes.c_int(0)
    handle = lib.pa_simple_new(
        None, _CLIENT_NAME, direction, None, what, ctypes.byref(spec),
        None, None, ctypes.byref(err))
    if not handle:
        raise OSError(f"pa_simple_new failed (pulse error {err.value})")
    return handle


class PulseSink:
    """Playback sink with the AlsaSink surface (write/stop), so
    AudioPlayer's SinkFeeder can drive either interchangeably."""

    @staticmethod
    def available() -> bool:
        return _lib() is not None and _server_reachable()

    def __init__(self, rate: int):
        lib = _lib()
        if lib is None:
            raise OSError("libpulse-simple not present")
        self._lib = lib
        self._handle = _connect(lib, _PA_STREAM_PLAYBACK, rate, 2, b"playback")
        self._lock = threading.Lock()

    def write(self, interleaved_f32: np.ndarray):
        data = np.ascontiguousarray(interleaved_f32, "<f4").tobytes()
        err = ctypes.c_int(0)
        with self._lock:
            if self._handle:
                self._lib.pa_simple_write(
                    self._handle, data, len(data), ctypes.byref(err))

    def stop(self):
        with self._lock:
            if self._handle:
                self._lib.pa_simple_free(self._handle)
                self._handle = None


class PulseStream:
    """Capture stream with the AlsaStream surface (pause/play/stop):
    a reader thread pulls mono f32 blocks and pushes the reference's
    pseudo-stereo interleave into the shared ring."""

    @staticmethod
    def available() -> bool:
        return PulseSink.available()

    def __init__(self, ring, rate: int):
        lib = _lib()
        if lib is None:
            raise OSError("libpulse-simple not present")
        self._lib = lib
        self.ring = ring
        self.rate = rate
        self._handle = _connect(lib, _PA_STREAM_RECORD, rate, 1, b"capture")
        self._stop = threading.Event()
        self._pause = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        from soundscope_tpu_torch.apps.capture import _pseudo_stereo

        nbytes = self.rate // 100 * 4  # 10 ms mono f32 blocks
        buf = ctypes.create_string_buffer(nbytes)
        err = ctypes.c_int(0)
        while not self._stop.is_set():
            if self._lib.pa_simple_read(
                    self._handle, buf, nbytes, ctypes.byref(err)) < 0:
                break
            if not self._pause.is_set():
                mono = np.frombuffer(buf.raw, "<f4")
                self.ring.push(_pseudo_stereo(mono))
        h, self._handle = self._handle, None
        if h:
            self._lib.pa_simple_free(h)

    def pause(self):
        self._pause.set()

    def play(self):
        self._pause.clear()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
