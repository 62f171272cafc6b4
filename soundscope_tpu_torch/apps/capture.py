"""Microphone capture — the reference's cpal path (src/audio_capture.rs).

The reference opens the default input device and appends f32 samples to a
shared 30 s ring buffer, upmixing mono to pseudo-stereo [x, 0, x, 0...]
(src/audio_capture.rs:37-52). This host:

  * uses `arecord` (ALSA) when a capture device exists — gated;
  * otherwise exposes SYNTHETIC devices (sine / pink noise / file loop)
    so the microphone mode is fully exercisable on headless machines.

Samples land in the native C++ ring buffer (soundscope_tpu_torch/native) when
built, else a NumPy fallback ring.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import threading

import numpy as np



class PyRing:
    """NumPy fallback with the same surface as native.NativeRing."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._buf = np.zeros(capacity, np.float32)
        self._pos = 0
        self._total = 0
        self._lock = threading.Lock()

    def push(self, x: np.ndarray):
        x = np.asarray(x, np.float32).ravel()
        with self._lock:
            n = len(x)
            if n >= self.capacity:
                self._buf[:] = x[-self.capacity:]
                self._pos = 0
            else:
                first = min(n, self.capacity - self._pos)
                self._buf[self._pos: self._pos + first] = x[:first]
                self._buf[: n - first] = x[first:]
                self._pos = (self._pos + n) % self.capacity
            self._total += n

    def snapshot(self) -> np.ndarray:
        with self._lock:
            return np.concatenate([self._buf[self._pos:], self._buf[: self._pos]])

    def snapshot_with_total(self):
        """Atomic (snapshot, total_pushed) — consumers tracking a cursor
        need both from the same instant."""
        with self._lock:
            snap = np.concatenate([self._buf[self._pos:], self._buf[: self._pos]])
            return snap, self._total

    @property
    def total_pushed(self) -> int:
        with self._lock:
            return self._total


def make_ring(capacity: int):
    try:
        from soundscope_tpu_torch.native import NativeRing, available

        if available():
            return NativeRing(capacity)
    except Exception:
        pass
    return PyRing(capacity)


def _pseudo_stereo(mono: np.ndarray) -> np.ndarray:
    """mono -> [x, 0, x, 0, ...] interleave (reference upmix)."""
    out = np.zeros(2 * len(mono), np.float32)
    out[0::2] = mono
    return out


class SyntheticStream:
    """A fake input device producing audio in a callback thread."""

    def __init__(self, ring, rate: int, kind: str = "sine", path: str | None = None):
        self.ring = ring
        self.rate = rate
        self.kind = kind
        self._stop = threading.Event()
        self._pause = threading.Event()
        self._phase = 0
        self._rng = np.random.default_rng(0)
        self._file = None
        if kind == "file" and path:
            from soundscope_tpu_torch.utils.io import decode_file

            d = decode_file(path)
            self._file = d.mid_side()[0]
            self.rate = d.rate
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _block(self, n: int) -> np.ndarray:
        i = np.arange(self._phase, self._phase + n)
        self._phase += n
        if self.kind == "sine":
            return (0.25 * np.sin(2 * np.pi * 440.0 * i / self.rate)).astype(np.float32)
        if self.kind == "noise":
            return (0.1 * self._rng.standard_normal(n)).astype(np.float32)
        if self._file is not None:
            idx = i % len(self._file)
            return self._file[idx].astype(np.float32)
        return np.zeros(n, np.float32)

    def _run(self):
        import time

        chunk = max(self.rate // 100, 1)  # 10 ms callbacks
        period = chunk / self.rate
        nxt = time.monotonic()
        while not self._stop.is_set():
            if not self._pause.is_set():
                self.ring.push(_pseudo_stereo(self._block(chunk)))
            nxt += period
            time.sleep(max(0.0, nxt - time.monotonic()))

    def pause(self):
        self._pause.set()

    def play(self):
        self._pause.clear()

    def stop(self):
        self._stop.set()


class AlsaStream:
    """arecord-backed capture (gated on device presence)."""

    @staticmethod
    def available() -> bool:
        return shutil.which("arecord") is not None and os.path.exists("/dev/snd")

    def __init__(self, ring, rate: int, device: str = "default"):
        self.ring = ring
        self.rate = rate
        self._stop = threading.Event()
        self._pause = threading.Event()
        self.proc = subprocess.Popen(
            ["arecord", "-q", "-f", "FLOAT_LE", "-c", "1", "-r", str(rate),
             "-t", "raw", "-D", device],
            stdout=subprocess.PIPE,
        )
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        chunk = self.rate // 100 * 4
        while not self._stop.is_set():
            data = self.proc.stdout.read(chunk)
            if not data:
                break
            if not self._pause.is_set():
                # at EOF read() can return a partial sample; drop the tail
                mono = np.frombuffer(data[: len(data) // 4 * 4], "<f4")
                if len(mono):
                    self.ring.push(_pseudo_stereo(mono))

    def pause(self):
        self._pause.set()

    def play(self):
        self._pause.clear()

    def stop(self):
        self._stop.set()
        try:
            self.proc.terminate()
        except Exception:
            pass


def list_input_devices() -> list[str]:
    """Device names, sorted — real captures first when present (ALSA, then
    PulseAudio/PipeWire via apps/pulse.py), then the synthetic sources
    (reference: list_input_devs, src/audio_capture.rs:61-75)."""
    from soundscope_tpu_torch.apps.pulse import PulseStream

    devs = []
    if AlsaStream.available():
        devs.append("default (ALSA)")
    elif PulseStream.available():
        devs.append("default (PulseAudio)")
    devs += ["Synthetic: 440 Hz sine", "Synthetic: noise"]
    return devs


def build_input_stream(ring, rate: int, device_name: str):
    if device_name.startswith("default"):
        if AlsaStream.available():
            return AlsaStream(ring, rate)
        from soundscope_tpu_torch.apps.pulse import PulseStream

        if PulseStream.available():
            return PulseStream(ring, rate)
    kind = "noise" if "noise" in device_name else "sine"
    return SyntheticStream(ring, rate, kind)
