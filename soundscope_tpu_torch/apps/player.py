"""Audio player host — the reference's AudioPlayer/AudioFile analog.

The reference runs a rodio sink on the main thread with a 10 ms command
poll loop (src/audio_player.rs:270-397) and streams decoded samples,
reporting the playhead every 2048 samples (src/audio_player.rs:65).

This host has no guaranteed audio output device, so playback is driven by
a sample-accurate wall-clock transport (the analysis/UI behave
identically); when an ALSA `aplay` binary and device exist, audio is also
rendered to it (gated, best-effort). Commands and events flow over
queues — the channel fabric mirroring main.rs:35-44:

    PlayerCommand (bounded)  ->  player thread
    AudioFile (decoded)      <-  player thread
    PlaybackPosition (int)   <-  transport
    errors (str)             <-  player thread
"""

from __future__ import annotations

import enum
import os
import queue
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass

import numpy as np

from soundscope_tpu_torch.utils.io import DecodedAudio, DecodeError, decode_file

POSITION_EVERY = 2048  # frames between playhead reports (reference cadence)
SEEK_SECONDS = 5.0


class Command(enum.Enum):
    SELECT_FILE = "select_file"
    CHANGE_STATE = "change_state"   # play/pause toggle
    QUIT = "quit"
    MOVE_RIGHT = "move_right"
    MOVE_LEFT = "move_left"
    SHOW_TEST_ERROR = "show_test_error"


@dataclass
class PlayerCommand:
    kind: Command
    arg: object = None


class AudioFileHandle:
    """Decoded file + derived data (mid/side, duration) — AudioFile analog."""

    def __init__(self, decoded: DecodedAudio):
        self.decoded = decoded
        self.mid, self.side = decoded.mid_side()
        self.rate = decoded.rate
        self.title = decoded.title
        self.duration = decoded.duration
        self.channels = min(decoded.channels, 2) or 1
        self._interleaved = None

    def interleaved(self) -> np.ndarray:
        # cached: callers slice this ~21x/sec during playback, and a fresh
        # transpose+copy of an hour-long file per tick would stall the UI
        if self._interleaved is None:
            if self.decoded.channels >= 2:
                two = self.decoded.samples[:2]
            else:
                two = np.repeat(self.decoded.samples[:1], 2, axis=0)
            self._interleaved = np.ascontiguousarray(two.T).reshape(-1)
        return self._interleaved


class Transport:
    """Wall-clock sample transport with play/pause/seek (virtual sink)."""

    def __init__(self, position_q: queue.Queue):
        self._pos_q = position_q
        self._lock = threading.Lock()
        self._rate = 44100
        self._frames = 0
        self._base_frame = 0
        self._base_time = None  # None = paused
        self._last_report = -1

    def load(self, rate: int, frames: int):
        with self._lock:
            self._rate = rate
            self._frames = frames
            self._base_frame = 0
            self._base_time = None
            self._last_report = -1

    def playing(self) -> bool:
        with self._lock:
            return self._base_time is not None

    def position(self) -> int:
        with self._lock:
            return self._position_locked()

    def _position_locked(self) -> int:
        if self._base_time is None:
            return self._base_frame
        p = self._base_frame + int((time.monotonic() - self._base_time) * self._rate)
        return min(p, self._frames)

    def play(self):
        with self._lock:
            if self._base_time is None:
                if self._base_frame >= self._frames:
                    self._base_frame = 0  # re-append at EOF like the sink
                self._base_time = time.monotonic()

    def pause(self):
        with self._lock:
            if self._base_time is not None:
                self._base_frame = self._position_locked()
                self._base_time = None

    def seek(self, delta_s: float):
        with self._lock:
            p = self._position_locked()
            p += int(delta_s * self._rate)
            self._base_frame = max(0, min(p, self._frames))
            if self._base_time is not None:
                self._base_time = time.monotonic()
        self._report(force=True)

    def at_eof(self) -> bool:
        return self.position() >= self._frames > 0

    def tick(self):
        """Emit playhead positions at the reference cadence."""
        self._report()
        if self.at_eof() and self.playing():
            self.pause()

    def _report(self, force: bool = False):
        p = self.position()
        # the reference reports every 2048 INTERLEAVED samples (1024 stereo
        # frames, ~43 Hz at 44.1 kHz) — audio_player.rs:65
        step = (p * 2) // POSITION_EVERY
        if force or step != self._last_report:
            self._last_report = step
            try:
                self._pos_q.put_nowait(p * 2)
            except queue.Full:
                pass


class AlsaSink:
    """Best-effort real audio via `aplay` (gated; absent in CI images)."""

    @staticmethod
    def available() -> bool:
        return shutil.which("aplay") is not None and os.path.exists("/dev/snd")

    def __init__(self, rate: int):
        self.proc = subprocess.Popen(
            ["aplay", "-q", "-f", "FLOAT_LE", "-c", "2", "-r", str(rate), "-t", "raw"],
            stdin=subprocess.PIPE,
        )

    def write(self, interleaved_f32: np.ndarray):
        try:
            self.proc.stdin.write(interleaved_f32.astype("<f4").tobytes())
        except (BrokenPipeError, ValueError, OSError):
            pass  # sink died or stop() closed stdin from another thread

    def stop(self):
        try:
            self.proc.stdin.close()
            self.proc.terminate()
        except Exception:
            pass


class SinkFeeder:
    """Streams transport-paced PCM into an audio sink on its own thread.

    The reference's rodio sink pulls samples itself (audio_player.rs:55-73);
    here the transport is the clock, so the feeder pushes: it keeps the sink
    fed up to LEAD_S ahead of the wall-clock playhead, stops while paused,
    and resyncs after seeks. Writes may block on the sink's pipe — that is
    why this runs apart from the command loop."""

    LEAD_S = 0.15
    POLL_S = 0.02

    def __init__(self, transport: Transport, sink, handle: AudioFileHandle):
        self.transport = transport
        self.sink = sink
        self.handle = handle
        self._fed = 0  # frames written so far
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        inter = self.handle.interleaved()
        rate = self.handle.rate
        frames = len(inter) // 2
        lead = int(self.LEAD_S * rate)
        while not self._stop.is_set():
            if not self.transport.playing():
                time.sleep(self.POLL_S)
                continue
            pos = self.transport.position()
            # seek (either direction) leaves the fed cursor outside the
            # feed window — snap it back to the playhead. The small margin
            # beyond `lead` absorbs clock jitter right after a write
            # (where _fed == pos + lead exactly) without re-feeding.
            margin = rate // 20  # 50 ms
            if self._fed < pos or self._fed > pos + lead + margin:
                self._fed = pos
            target = min(pos + lead, frames)
            if target > self._fed:
                self.sink.write(inter[self._fed * 2: target * 2])
                self._fed = target
            time.sleep(self.POLL_S)

    def stop(self):
        self._stop.set()
        self.sink.stop()
        self._thread.join(timeout=2.0)


class AudioPlayer:
    """Command-loop player thread (reference: AudioPlayer::run,
    src/audio_player.rs:292-397).

    `sink_factory(rate) -> sink` builds the audible output for each loaded
    file (reference: rodio OutputStream, audio_player.rs:270-289). Defaults
    to AlsaSink when `aplay` and a sound device exist, then to PulseSink on
    PulseAudio/PipeWire desktops (apps/pulse.py), else playback stays
    silent (transport-only) exactly as before."""

    def __init__(self, sink_factory=None):
        self.command_q: queue.Queue = queue.Queue(maxsize=8)
        self.file_q: queue.Queue = queue.Queue(maxsize=1)
        self.position_q: queue.Queue = queue.Queue()
        self.error_q: queue.Queue = queue.Queue(maxsize=4)
        self.transport = Transport(self.position_q)
        self._quit = threading.Event()
        self._thread: threading.Thread | None = None
        if sink_factory is None:
            if AlsaSink.available():
                sink_factory = AlsaSink
            else:
                from soundscope_tpu_torch.apps.pulse import PulseSink

                if PulseSink.available():
                    sink_factory = PulseSink
        self._sink_factory = sink_factory
        self._feeder: SinkFeeder | None = None

    def start(self):
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()

    def send(self, cmd: PlayerCommand):
        try:
            self.command_q.put_nowait(cmd)
        except queue.Full:
            pass

    def stop(self):
        self.send(PlayerCommand(Command.QUIT))
        if self._thread:
            self._thread.join(timeout=2.0)

    def _error(self, msg: str):
        try:
            self.error_q.put_nowait(msg)
        except queue.Full:
            pass

    def run(self):
        while not self._quit.is_set():
            self.transport.tick()
            try:
                cmd = self.command_q.get(timeout=0.01)  # 10 ms poll
            except queue.Empty:
                continue
            if cmd.kind == Command.QUIT:
                self._quit.set()
                if self._feeder:
                    self._feeder.stop()
                    self._feeder = None
            elif cmd.kind == Command.SELECT_FILE:
                try:
                    decoded = decode_file(str(cmd.arg))
                    handle = AudioFileHandle(decoded)
                    # lets the TUI match a late-arriving handle to the
                    # select that requested it (slow-decode pickup)
                    handle.source_path = str(cmd.arg)
                except (DecodeError, OSError) as e:
                    self._error(f"Failed to open file: {e}")
                    continue
                self.transport.load(handle.rate, len(handle.mid))
                if self._feeder:
                    self._feeder.stop()
                    self._feeder = None
                if self._sink_factory is not None:
                    try:
                        self._feeder = SinkFeeder(
                            self.transport, self._sink_factory(handle.rate), handle
                        )
                    except Exception as e:
                        self._error(f"Audio output unavailable: {e}")
                try:
                    while not self.file_q.empty():
                        self.file_q.get_nowait()
                    self.file_q.put_nowait(handle)
                except queue.Full:
                    pass
                self.transport.play()
            elif cmd.kind == Command.CHANGE_STATE:
                if self.transport.playing():
                    self.transport.pause()
                else:
                    self.transport.play()
            elif cmd.kind == Command.MOVE_RIGHT:
                self.transport.seek(SEEK_SECONDS)
            elif cmd.kind == Command.MOVE_LEFT:
                self.transport.seek(-SEEK_SECONDS)
            elif cmd.kind == Command.SHOW_TEST_ERROR:
                self._error("This is a test error. As if something went wrong!")
