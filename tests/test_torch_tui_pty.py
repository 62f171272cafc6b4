"""The port's curses TUI end to end in a pty, as tests/test_tui_pty.py
drives the JAX package's: `python -m soundscope_tpu_torch.apps.cli FILE
--device cpu` (a bare path opens the TUI), a few keys, then `q`."""

import fcntl
import os
import pty
import re
import select
import struct
import subprocess
import sys
import termios
import time

import pytest

from soundscope_tpu_torch.utils.flacenc import write_flac
from soundscope_tpu_torch.utils.synth import sine, stereo

_ANSI = re.compile(rb"\x1b\[[0-9;?]*[a-zA-Z]|\x1b[()][0-9A-B]|\x1b[=>]")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pty_available() -> bool:
    try:
        m, s = os.openpty()
        os.close(m)
        os.close(s)
        return True
    except OSError:
        return False


def _drain(fd, seconds, until=()):
    """The screen output for `seconds`, or until every string of `until`
    has shown (curses repaints only the cells that change)."""
    out = b""
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        r, _, _ = select.select([fd], [], [], 0.2)
        if r:
            try:
                out += os.read(fd, 65536)
            except OSError:
                break
            text = _ANSI.sub(b"", out).decode(errors="replace")
            if until and all(u in text for u in until):
                break
    return _ANSI.sub(b"", out).decode(errors="replace")


def test_tui_end_to_end_pty(tmp_path):
    if not _pty_available():
        pytest.skip("no pty device available")
    song = str(tmp_path / "tone.flac")
    write_flac(song, stereo(sine(500.0, 2.0, 44100, -12.0)), 44100)
    master, slave = pty.openpty()
    cols, rows = 100, 30
    fcntl.ioctl(master, termios.TIOCSWINSZ, struct.pack("HHHH", rows, cols, 0, 0))
    env = dict(os.environ, TERM="xterm-256color", COLUMNS=str(cols), LINES=str(rows),
               HOME=str(tmp_path), XDG_CONFIG_HOME=str(tmp_path / "cfg"))
    # a fresh interpreter: pty.fork() from the threaded pytest process deadlocks
    proc = subprocess.Popen(
        [sys.executable, "-m", "soundscope_tpu_torch.apps.cli", song, "--device", "cpu"],
        stdin=slave, stdout=slave, stderr=subprocess.DEVNULL, env=env, cwd=REPO,
        start_new_session=True)
    os.close(slave)
    try:
        screen = _drain(master, 60.0, until=("tone", "spectrum", "lufs"))
        assert "tone" in screen, screen[-2000:]
        assert "spectrum" in screen and "lufs" in screen
        _drain(master, 1.5)                         # analysis frames while it plays
        os.write(master, b"h")                      # help popup
        assert "Play/pause" in _drain(master, 5.0, until=("Play/pause",))
        os.write(master, b"h")
        _drain(master, 0.5)
        os.write(master, b"t")                      # themes popup
        assert "themes" in _drain(master, 5.0, until=("themes",))
        os.write(master, b"\x1b")
        _drain(master, 0.5)
        os.write(master, b" ")                      # pause
        _drain(master, 0.5)
        os.write(master, b"q")
        assert proc.wait(timeout=15.0) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
        os.close(master)
