"""Interactive TUI — the reference's main surface, rebuilt.

Mirrors src/tui.rs: an App state machine on an 8 ms tick loop with
dirty-flag rendering; waveform / spectrum / LUFS panes (30/70 vertical
split, bottom split left/right — src/tui.rs:498-596); file explorer,
device list, theme list, help and error popups; the full keymap
(src/tui.rs:1554-1764); per-frame analysis glue (src/tui.rs:1427-1552);
loudness-matched FFT gain (-13 - LUFS_I, src/tui.rs:49,1229-1238).

The draw code targets the Screen/BrailleCanvas abstraction (render.py),
so the exact same frames render under curses (live) and into text
buffers (tests / headless screenshots).

The port's copy of the JAX package's apps/tui.py, on the port's Analyzer
(models/analyzer.py) and LiveAnalyzer (models/live.py), which compute on
`device`: the card unless the caller passes "cpu". Opening a file runs
the whole-file engine once (K3 on the card); every playhead report runs
two spectra and one meter push (K7); in microphone mode every
2,048-sample quantum is one LiveAnalyzer push (K7). A live pipeline that
fails to build or launch shows in the error popup and is re-raised from
analyze_microphone_input: the host-snapshot path never stands in for it.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from dataclasses import dataclass, field
from enum import Enum

import numpy as np

from soundscope_tpu_torch.apps import themes as T
from soundscope_tpu_torch.apps.capture import build_input_stream, list_input_devices, make_ring
from soundscope_tpu_torch.apps.player import AudioPlayer, Command, PlayerCommand
from soundscope_tpu_torch.apps.render import (
    BIG_GLYPH_H, Dataset, Rect, Screen, Span, big_text_width, draw_big_text,
    draw_block, draw_chart,
)
from soundscope_tpu_torch.core.config import MeterConfig
from soundscope_tpu_torch.models.analyzer import Analyzer
from soundscope_tpu_torch.models.live import LiveAnalyzer
from soundscope_tpu_torch.utils.io import AUDIO_EXTENSIONS
from soundscope_tpu_torch.utils.metrics import GLOBAL as RT, TickMonitor

FFT_SIZE = 16384            # src/tui.rs:1431,1488
FFT_TARGET_LUFS = -13.0     # src/tui.rs:49
FFT_LOWER_BOUND = -100.0    # src/tui.rs:50
FFT_UPPER_BOUND = 0.0       # src/tui.rs:51
LUFS_HISTORY = 300          # src/tui.rs:420
ERROR_SECONDS = 5.0         # src/tui.rs:575-579
FLASH_MS = 100              # src/tui.rs:752


class Mode(Enum):
    PLAYER = "Player"
    MICROPHONE = "Microphone"


HELP_BINDINGS = [  # src/tui.rs:1948-1994 (19 bindings)
    ("e", "Open file explorer"),
    ("Space", "Play/pause"),
    ("<-", "Seek 5s back"),
    ("->", "Seek 5s forward"),
    ("1", "Toggle waveform"),
    ("2", "Toggle spectrum"),
    ("3", "Toggle LUFS"),
    ("m", "Switch mode (player/microphone)"),
    ("d", "Open devices list"),
    ("t", "Open themes list"),
    ("M", "Toggle mid spectrum"),
    ("S", "Toggle side spectrum"),
    ("+", "Zoom waveform in"),
    ("-", "Zoom waveform out"),
    ("0-9", "Select device/theme"),
    ("Up/Down", "Navigate lists"),
    ("Enter", "Confirm selection"),
    ("h/?/F1", "Toggle this help"),
    ("q/Esc", "Close popup / quit"),
]


@dataclass
class ExplorerState:
    cwd: str = field(default_factory=os.getcwd)
    entries: list = field(default_factory=list)
    selected: int = 0

    def refresh(self):
        items = []
        try:
            names = sorted(os.listdir(self.cwd), key=str.lower)
        except OSError:
            names = []
        if os.path.dirname(self.cwd) != self.cwd:
            items.append("../")
        for nm in names:
            p = os.path.join(self.cwd, nm)
            if os.path.isdir(p):
                items.append(nm + "/")
            else:
                ext = nm.rsplit(".", 1)[-1].lower() if "." in nm else ""
                if ext in AUDIO_EXTENSIONS or ext == "theme":
                    items.append(nm)
        self.entries = items
        self.selected = min(self.selected, max(len(items) - 1, 0))


class App:
    """The application state machine (reference: struct App, tui.rs:387-429)."""

    # bounded wait for a decode before falling back to async pickup
    # (reference blocks indefinitely, tui.rs:1892)
    DECODE_WAIT_SECONDS = 10.0

    def __init__(self, player: AudioPlayer | None = None, start_file: str | None = None,
                 theme: T.Theme | None = None, config_dir: str | None = None,
                 device=None, show_metrics: bool = False):
        self.player = player or AudioPlayer()
        self.theme = theme or T.load_current_theme(config_dir)
        self.config_dir = config_dir
        self.mode = Mode.PLAYER
        self.show_waveform = True
        self.show_fft = True
        self.show_lufs = True
        self.show_mid_fft = True
        self.show_side_fft = True
        self.waveform_window = 15.0
        self.quit_requested = False

        # both analyzers, the waveform and the live pipeline compute on
        # `device` (None: the card; it raises when there is none)
        self.file_analyzer = Analyzer(device=device)
        self.device = self.file_analyzer.device
        self.device_analyzer = Analyzer(device=self.device)
        self.lufs = [-100.0] * LUFS_HISTORY
        self.fft_mid: np.ndarray | None = None
        self.fft_side: np.ndarray | None = None
        self.fft_gain_db = 0.0
        self.audio_file = None            # AudioFileHandle
        self.playhead = 0                 # frames
        self.file_waveform: np.ndarray | None = None  # (2*valid, 2)
        self.mic_waveform: np.ndarray | None = None

        # popups
        self.show_explorer = False
        self.show_devices = False
        self.show_themes = False
        self.show_help = False
        self.explorer = ExplorerState()
        self.devices = list_input_devices()
        self.device_selected = 0
        self.device_name = "None"
        self.themes_entries = (
            ["DEFAULT"]
            + [f"builtin:{n}" for n in T.list_themes()]
            + T.available_theme_files(config_dir)
        )
        self.theme_selected = 0

        self.error_text = ""
        self.error_at = None
        self._pending_decode = None  # path awaiting a slow decode, if any
        self.flash = {}  # key -> time of last press
        self.mouse = None  # (col, row)
        self.chart_rect: Rect | None = None
        self.needs_render = True

        # observability: UI cadence + per-op RT factors (utils/metrics);
        # readout shown with show_metrics (the CLI's `tui --metrics`)
        self.tick_monitor = TickMonitor()
        self.show_metrics = show_metrics

        # microphone: host capture ring + device-resident live pipeline
        # (models/live.py) fed in fixed quanta
        self.ring = make_ring(44100 * 30)
        self.stream = None
        self.live = None
        self.live_error: BaseException | None = None
        self.live_stats = None
        self.live_ready = threading.Event()
        self.live_ready.set()
        self._live_consumed = 0
        self._live_quantum = 2048

        self.player.start()
        if start_file:
            # reference canonicalizes the startup file and opens the
            # explorer at its folder (main.rs:52-61)
            start_file = os.path.abspath(start_file)
            self.explorer.cwd = os.path.dirname(start_file) or os.getcwd()
            self.select_audio_file(start_file)

    # ------------------------------------------------------------ actions --

    def select_audio_file(self, path: str):
        self.reset_charts()
        self._pending_decode = None
        self.player.send(PlayerCommand(Command.SELECT_FILE, path))
        # blocking receive like the reference (tui.rs:1892), but bounded:
        # past the bound the UI stays responsive, an info popup explains
        # the wait, and tick() picks the handle up when decode finishes
        # instead of silently discarding the late result
        try:
            handle = self.player.file_q.get(timeout=self.DECODE_WAIT_SECONDS)
        except queue.Empty:
            self._pending_decode = path
            self.handle_error(
                f"Still decoding {os.path.basename(path)} — "
                "it will load when ready"
            )
            return
        if getattr(handle, "source_path", path) != path:
            # stale handle from an earlier slow select; ours is still coming
            self._pending_decode = path
            return
        self.receive_audio_file(handle)

    def receive_audio_file(self, handle):
        self.audio_file = handle
        if handle.duration < 15.0:
            self.waveform_window = max(1.0, handle.duration)
        # reference decimates the INTERLEAVED buffer over the full duration
        # (min/max spans both channels; 1 ms buckets) — tui.rs:1213-1216
        self.file_waveform = Analyzer.get_waveform(
            handle.interleaved(), handle.duration, device=self.device
        )
        self.file_analyzer.create_loudness_meter(2, handle.rate)
        lufs_i = self.file_analyzer.calculate_integrated_lufs(
            2, handle.interleaved()
        )
        if lufs_i is not None and np.isfinite(lufs_i):
            self.fft_gain_db = FFT_TARGET_LUFS - lufs_i
        else:
            self.fft_gain_db = 0.0
        self.playhead = 0
        self.needs_render = True

    def reset_charts(self):
        self.lufs = [-100.0] * LUFS_HISTORY
        self.fft_mid = self.fft_side = None
        self.fft_gain_db = 0.0
        self.playhead = 0
        self.needs_render = True

    def handle_error(self, text: str):
        self.error_text = text
        self.error_at = time.monotonic()
        self.needs_render = True

    # ------------------------------------------------------ analysis glue --

    def analyze_audio_file_samples(self, pos_samples: int):
        """File-mode per-position analysis (src/tui.rs:1482-1552)."""
        if self.audio_file is None:
            return
        frames = pos_samples // 2
        self.playhead = frames
        mid, side = self.audio_file.mid, self.audio_file.side
        rate = self.audio_file.rate
        if frames >= FFT_SIZE and frames <= len(mid):
            with RT.span("fft", 2 * FFT_SIZE / rate):
                self.fft_mid = self.file_analyzer.get_fft(
                    mid[frames - FFT_SIZE: frames], gain_db=self.fft_gain_db
                )
                self.fft_side = self.file_analyzer.get_fft(
                    side[frames - FFT_SIZE: frames], gain_db=self.fft_gain_db
                )
        inter = self.audio_file.interleaved()
        hi = min(frames * 2, len(inter))
        lo = hi - FFT_SIZE
        # reference skips until a full 16384-sample window exists
        # (lufs_left_bound != 0, tui.rs:1530)
        if lo > 0:
            with RT.span("lufs_push", FFT_SIZE / 2 / rate):
                self.file_analyzer.add_samples(inter[lo:hi])
                st = self.file_analyzer.get_shortterm_lufs()
            self.lufs = self.lufs[1:] + [st if np.isfinite(st) else -100.0]
        self.needs_render = True

    def analyze_microphone_input(self):
        """Mic-mode per-tick analysis (src/tui.rs:1427-1480).

        Once a device is selected, the device-resident live pipeline
        (self.live) takes only the NEW capture samples each tick, one push
        (K7) per quantum, and one frame() (spectrum, waveform, LUFS). A
        pipeline that failed to build or launch raises RuntimeError here,
        with the error popup set. Before any device selection the
        reference-shaped host-snapshot path runs."""
        if self.live_error is not None:
            err = self.live_error
            self.handle_error(f"Live analysis failed: {err}")
            raise RuntimeError(f"live analysis pipeline failed: {err}") from err
        if self.live is not None:
            if not self.live_ready.is_set():
                return  # still warming up on its thread; keep the UI live
            q = self._live_quantum
            pushed = False
            # snapshot and total must come from the same instant, else the
            # capture thread races the cursor (dropped/duplicated samples)
            snap, total = self.ring.snapshot_with_total()
            behind = total - self._live_consumed
            if behind >= q:
                if behind > len(snap):  # fell behind the ring; skip ahead
                    self._live_consumed = total - len(snap) // q * q
                    behind = total - self._live_consumed
                while behind >= q:
                    lo = len(snap) - behind
                    self.live.push(snap[lo: lo + q])
                    self._live_consumed += q
                    behind -= q
                    pushed = True
            if pushed:
                # q interleaved pseudo-stereo samples = q/2 audio frames,
                # at the capture device's rate
                with RT.span("live_frame", q / 2 / self.live.cfg.rate):
                    f = self.live.frame()
                self.live_stats = f
                xs = self.live.spectrum_chart_x
                self.fft_mid = np.stack([xs, f.fft_mid], axis=-1)
                self.fft_side = np.stack([xs, f.fft_side], axis=-1)
                w = np.arange(len(f.wf_min), dtype=np.float64)
                pts = np.empty((2 * len(w), 2))
                pts[0::2, 0] = w
                pts[1::2, 0] = w
                pts[0::2, 1] = f.wf_min
                pts[1::2, 1] = f.wf_max
                self.mic_waveform = pts
                st = float(f.shortterm)
                self.lufs = self.lufs[1:] + [st if np.isfinite(st) else -100.0]
                self.needs_render = True
            return
        buf = self.ring.snapshot()
        rate = self.device_analyzer.sample_rate
        mid = (buf[0::2] + buf[1::2]) * 0.5
        side = (buf[0::2] - buf[1::2]) * 0.5
        half = 15 * rate
        if half <= len(mid) and half >= FFT_SIZE:
            self.fft_mid = self.device_analyzer.get_fft(mid[half - FFT_SIZE: half])
            self.fft_side = self.device_analyzer.get_fft(side[half - FFT_SIZE: half])
            self.mic_waveform = Analyzer.get_waveform(mid[:half], 15.0,
                                                      device=self.device)
        if len(buf) >= FFT_SIZE:
            self.device_analyzer.add_samples(buf[-FFT_SIZE:])
            st = self.device_analyzer.get_shortterm_lufs()
            self.lufs = self.lufs[1:] + [st if np.isfinite(st) else -100.0]
        self.needs_render = True

    def select_device(self, index: int):
        """src/tui.rs:1766-1811"""
        if not (0 <= index < len(self.devices)):
            return
        if self.stream:
            self.stream.stop()
        self.device_name = self.devices[index]
        rate = 44100
        self.ring = make_ring(rate * 30)
        self.device_analyzer.create_loudness_meter(2, rate)
        self.stream = build_input_stream(self.ring, rate, self.device_name)
        self.live = None
        self.live_error = None
        self.live_stats = None
        self._live_consumed = 0
        # A FRESH event per selection: a stale warm thread from a previous
        # device must not unblock the new, still-cold analyzer.
        ready = threading.Event()
        self.live_ready = ready
        try:
            self.live = LiveAnalyzer(MeterConfig(channels=2, rate=rate, max_blocks=0),
                                     device=self.device)
        except Exception as e:
            self._live_failed(e, ready)
        else:
            # The first push builds K7 at first use (nvcc) and the first
            # frame() runs; do both on a worker thread so the mode switch
            # does not freeze the UI loop (the live path stays idle until
            # warm — see analyze_microphone_input).
            def _warm(live=self.live, ready=ready):
                try:
                    live.push(np.zeros(self._live_quantum, np.float32))
                    live.frame()
                    live.reset()  # drop the warmup zeros from the meter
                except Exception as e:
                    self._live_failed(e, ready)
                else:
                    ready.set()

            threading.Thread(target=_warm, daemon=True).start()
        self.fft_gain_db = 0.0
        self.lufs = [-100.0] * LUFS_HISTORY
        self.show_devices = False
        self.needs_render = True

    def _live_failed(self, err: BaseException, ready: threading.Event) -> None:
        """Record a live pipeline failure (before `ready` is set, so a
        waiter never takes a failed warm-up for a ready one) and show it."""
        if ready is self.live_ready:
            self.live_error = err
            self.handle_error(f"Live analysis failed: {err}")
        ready.set()

    def apply_theme_selection(self, index: int):
        if not (0 <= index < len(self.themes_entries)):
            return
        sel = self.themes_entries[index]
        if sel == "DEFAULT":
            self.theme = T.default_theme()
        elif sel.startswith("builtin:"):
            self.theme = T.get_by_name(sel[len("builtin:"):]) or T.default_theme()
        else:
            try:
                self.theme = T.load_theme_file(
                    os.path.join(self.config_dir or T.config_dir(), sel)
                )
            except Exception as e:
                self.handle_error(f"Failed to load theme: {e}")
                return
        T.save_current_theme(sel, self.config_dir)
        self.show_themes = False
        self.needs_render = True

    # ------------------------------------------------------------- events --

    def tick(self):
        """One 8 ms loop iteration (src/tui.rs:1278-1424)."""
        self.tick_monitor.tick()
        # pick up a decode that outlived select_audio_file's bounded wait
        if self._pending_decode is not None:
            try:
                handle = self.player.file_q.get_nowait()
            except queue.Empty:
                pass
            else:
                want = self._pending_decode
                if getattr(handle, "source_path", want) == want:
                    self._pending_decode = None
                    self.receive_audio_file(handle)
        # drain error channel
        try:
            while True:
                self.handle_error(self.player.error_q.get_nowait())
        except queue.Empty:
            pass
        # drain playback positions, keep the last
        pos = None
        try:
            while True:
                pos = self.player.position_q.get_nowait()
        except queue.Empty:
            pass
        if pos is not None and self.mode == Mode.PLAYER:
            self.analyze_audio_file_samples(pos)
        if self.mode == Mode.MICROPHONE:
            self.analyze_microphone_input()
        if self.error_at and time.monotonic() - self.error_at > ERROR_SECONDS:
            self.error_at = None
            self.error_text = ""
            self.needs_render = True
        if self.flash and any(
            time.monotonic() - t < FLASH_MS / 1000 * 2 for t in self.flash.values()
        ):
            self.needs_render = True

    def _popup_list(self):
        if self.show_explorer:
            return self.explorer.entries, "explorer"
        if self.show_devices:
            return self.devices, "devices"
        if self.show_themes:
            return self.themes_entries, "themes"
        return None, None

    def handle_key(self, key: str):
        """Full keymap (src/tui.rs:1554-1764). `key` is a readable name:
        'a'..'z', '0'..'9', 'space', 'left', 'right', 'up', 'down',
        'enter', 'esc', 'F1', '+', '-', '?'."""
        self.needs_render = True
        entries, which = self._popup_list()

        if key in ("q", "esc"):
            if any([self.show_explorer, self.show_devices, self.show_themes,
                    self.show_help]):
                self.show_explorer = self.show_devices = False
                self.show_themes = self.show_help = False
            else:
                self.quit_requested = True
                self.player.stop()
                if self.stream:
                    self.stream.stop()
            return

        if entries is not None and key in ("up", "down"):
            n = max(len(entries), 1)
            delta = -1 if key == "up" else 1
            sel = {"explorer": self.explorer.selected,
                   "devices": self.device_selected,
                   "themes": self.theme_selected}[which]
            sel = (sel + delta) % n  # wrap-around (tui.rs:1673-1723)
            if which == "explorer":
                self.explorer.selected = sel
            elif which == "devices":
                self.device_selected = sel
            else:
                self.theme_selected = sel
            return

        if entries is not None and key == "enter":
            if which == "explorer":
                self._explorer_enter()
            elif which == "devices":
                self.select_device(self.device_selected)
            else:
                self.apply_theme_selection(self.theme_selected)
            return

        if key.isdigit() and (self.show_devices or self.show_themes):
            # digit-select only while a list popup is open; devices are
            # 1-based with '0' ignored, themes 0-based (tui.rs:1629-1671)
            if self.show_devices:
                if key != "0":
                    self.select_device(int(key) - 1)
            else:
                self.apply_theme_selection(int(key))
            return

        if key == "e":
            self.show_explorer = not self.show_explorer
            if self.show_explorer:
                self.explorer.refresh()
        elif key == "space":
            # play/pause; meter & history reset only on the transition TO
            # playing ("lufs update only on play, not pause",
            # tui.rs:1581-1591)
            will_play = not self.player.transport.playing()
            self.player.send(PlayerCommand(Command.CHANGE_STATE))
            if will_play:
                self.file_analyzer.reset()
                self.lufs = [-100.0] * LUFS_HISTORY
        elif key in ("right", "left"):
            # gated on Player mode with no list popup (tui.rs:1594-1619);
            # seek resets both the meter and the history
            if self.mode == Mode.PLAYER and not (
                self.show_devices or self.show_explorer or self.show_themes
            ):
                cmd = Command.MOVE_RIGHT if key == "right" else Command.MOVE_LEFT
                self.player.send(PlayerCommand(cmd))
                self.file_analyzer.reset()
                self.lufs = [-100.0] * LUFS_HISTORY
                self.flash[key] = time.monotonic()
        elif key == "1":
            self.show_waveform = not self.show_waveform
        elif key == "2":
            self.show_fft = not self.show_fft
        elif key == "3":
            self.show_lufs = not self.show_lufs
        elif key == "m" and not (
            self.show_devices or self.show_explorer or self.show_themes
        ):  # mode switch gated on popups (tui.rs:1647-1650)
            if self.mode == Mode.PLAYER:
                self.mode = Mode.MICROPHONE
                if self.stream is None and self.devices:
                    self.select_device(0)
                elif self.stream:
                    self.stream.play()
            else:
                self.mode = Mode.PLAYER
                if self.stream:
                    self.stream.pause()
            self.reset_charts()
        elif key == "d":
            # devices list only in Microphone mode, not under help
            # (tui.rs:1641-1645)
            if self.mode == Mode.MICROPHONE and not self.show_help:
                self.show_devices = not self.show_devices
        elif key == "t":
            self.show_themes = not self.show_themes
        elif key == "M":
            self.show_mid_fft = not self.show_mid_fft
        elif key == "S":
            self.show_side_fft = not self.show_side_fft
        elif key == "+":
            self.waveform_window = max(1.0, self.waveform_window - 1.0)
            self.flash["plus"] = time.monotonic()
        elif key == "-":
            cap = min(self.audio_file.duration, 15.0) if self.audio_file else 15.0
            self.waveform_window = min(cap, self.waveform_window + 1.0)
            self.flash["minus"] = time.monotonic()
        elif key in ("h", "?", "F1"):
            self.show_help = not self.show_help
        elif key == "y":
            self.player.send(PlayerCommand(Command.SHOW_TEST_ERROR))

    def _explorer_enter(self):
        ex = self.explorer
        if not ex.entries:
            return
        name = ex.entries[ex.selected]
        if name == "../":
            ex.cwd = os.path.dirname(ex.cwd)
            ex.selected = 0
            ex.refresh()
            return
        path = os.path.join(ex.cwd, name)
        if name.endswith("/"):
            ex.cwd = path.rstrip("/")
            ex.selected = 0
            ex.refresh()
            return
        self.show_explorer = False
        if name.endswith(".theme"):
            try:
                self.theme = T.load_theme_file(path)
                T.save_current_theme(name, self.config_dir)
            except Exception as e:
                self.handle_error(f"Failed to load theme: {e}")
        else:
            self.select_audio_file(path)

    def handle_mouse(self, col: int, row: int):
        self.mouse = (col, row)
        self.needs_render = True

    # --------------------------------------------------------------- draw --

    def draw(self, scr: Screen):
        th = self.theme
        scr.fill(th.background)
        w, h = scr.width, scr.height
        top_h = 0
        if self.show_waveform:
            top_h = h if not (self.show_fft or self.show_lufs) else round(h * 0.30)
        bottom = Rect(0, top_h, w, h - top_h)

        if self.show_waveform:
            self._draw_waveform(scr, Rect(0, 0, w, top_h))
        if self.show_fft or self.show_lufs:
            if self.show_fft and self.show_lufs:
                lw = bottom.w // 2
                self.chart_rect = Rect(bottom.x, bottom.y, lw, bottom.h)
                self._draw_fft(scr, self.chart_rect)
                self._draw_lufs(scr, Rect(bottom.x + lw, bottom.y, bottom.w - lw, bottom.h))
            elif self.show_fft:
                self.chart_rect = bottom
                self._draw_fft(scr, bottom)
            else:
                self._draw_lufs(scr, bottom)
        if not (self.show_waveform or self.show_fft or self.show_lufs):
            self._draw_empty(scr)

        if self.show_fft and self.mouse and self.chart_rect:
            self._draw_fft_tooltip(scr)
        if self.error_text and self.error_at:
            self._draw_error(scr)
        if self.show_explorer:
            self._draw_list_popup(scr, "explorer  (Enter: open)",
                                  self.explorer.entries, self.explorer.selected,
                                  th.explorer.borders, th.explorer.background,
                                  th.explorer.item_foreground,
                                  th.explorer.highlight_item_foreground,
                                  dir_fg=th.explorer.dir_foreground,
                                  dir_hl=th.explorer.highlight_dir_foreground)
        if self.show_devices:
            self._draw_list_popup(scr, "devices  (digit or Enter)",
                                  self.devices, self.device_selected,
                                  th.devices.borders, th.devices.background,
                                  th.devices.foreground, th.devices.highlight)
        if self.show_themes:
            self._draw_list_popup(scr, "themes  (digit or Enter)",
                                  self.themes_entries, self.theme_selected,
                                  th.help.borders, th.help.background,
                                  th.help.foreground, th.help.highlight)
        if self.show_help:
            self._draw_help(scr)
        if self.show_metrics:
            self._draw_metrics(scr)
        self.needs_render = False

    def _draw_metrics(self, scr: Screen):
        """Top-right cadence/RT readout (rebuild-only observability;
        SURVEY.md §5 — the reference has none): the RT factor of each span
        that credits audio, then the median ms of each that credits none
        (`live.push`, `array.pad`, ...)."""
        tm = self.tick_monitor
        parts = [f"tick {tm.mean_ms:.1f}ms"]
        spans = sorted(RT.report().items())
        for name, s in spans:
            if name != "counters" and s["rt_factor"] is not None:
                parts.append(f"{name} {s['rt_factor']:g}x")
        for name, s in spans:
            if name != "counters" and s["rt_factor"] is None and s["median_ms"] is not None:
                parts.append(f"{name} {s['median_ms']:g}ms")
        text = " | ".join(parts)
        scr.put_str(max(scr.width - len(text) - 1, 0), 0, text,
                    self.theme.highlight, self.theme.background, True)

    def _flashing(self, key: str) -> bool:
        t = self.flash.get(key)
        return t is not None and (time.monotonic() - t) * 1000 < FLASH_MS

    def _draw_waveform(self, scr: Screen, rect: Rect):
        th = self.theme.waveform
        bg = th.background
        rate = self.audio_file.rate if self.audio_file else 44100
        dur = self.audio_file.duration if self.audio_file else 0.0
        playhead_ms = self.playhead / rate * 1000.0

        if self.mode == Mode.PLAYER:
            points = self.file_waveform
            half = self.waveform_window * 500.0
            max_x = (len(points) / 2.0) if points is not None else 0.0
            x_min = max(min(playhead_ms - half, max_x - self.waveform_window * 1000.0), 0.0)
            x_max = max(min(playhead_ms + half, max_x), self.waveform_window * 1000.0)
        else:
            points = self.mic_waveform
            x_min = 15000.0 - self.waveform_window * 1000.0
            x_max = 15000.0

        cur = int(playhead_ms // 1000)
        title = self.audio_file.title if self.audio_file else "Select an audio file"
        mode_spans = [Span("m", th.controls_highlight, True), Span("ode: ", th.labels),
                      Span(self.mode.value, th.labels)]
        if self.mode != Mode.PLAYER:
            mode_spans = [Span("d", th.controls_highlight, True), Span("evice: ", th.labels),
                          Span(self.device_name + " ", th.labels)] + mode_spans
        ctl = [
            Span("<- ", th.controls_highlight if self._flashing("left") else th.controls),
            Span("- ", th.controls_highlight if self._flashing("minus") else th.controls),
            Span(f"{int(self.waveform_window):0>2}s ", th.controls),
            Span("+ ", th.controls_highlight if self._flashing("plus") else th.controls),
            Span("->", th.controls_highlight if self._flashing("right") else th.controls),
        ]
        draw_block(
            scr, rect, th.borders, bg,
            title=[Span("¹", th.highlight, True), Span(title, th.labels)],
            title_right=mode_spans,
            bottom_left=ctl,
            bottom_center=[Span(f"{cur // 60:02d}:{cur % 60:02d}", th.current_time)],
            bottom_right=[Span(f"{int(dur) // 60:02d}:{int(dur) % 60:02d}", th.total_duration)],
        )
        data = []
        if points is not None and len(points):
            data.append(Dataset(points.tolist(), th.waveform))
        if self.mode == Mode.PLAYER and self.audio_file:
            px = playhead_ms  # 1 ms buckets => x == ms
            data.append(Dataset([(px, 1.0), (px, -1.0)], th.playhead))
        draw_chart(scr, rect.inner(), data, (x_min, x_max), (-1.0, 1.0), bg)

    def _draw_fft(self, scr: Screen, rect: Rect):
        th = self.theme.fft
        bg = th.background
        mid_t = [Span("M", th.highlight, self.show_mid_fft),
                 Span("id", th.labels, self.show_mid_fft), Span("/", th.labels),
                 Span("S", th.highlight, self.show_side_fft),
                 Span("ide", th.labels, self.show_side_fft)]
        draw_block(
            scr, rect, th.borders, bg,
            title=[Span("²", th.highlight, True), Span("spectrum", th.labels, True)],
            title_right=mid_t,
        )
        data = []
        if self.show_mid_fft and self.fft_mid is not None:
            data.append(Dataset(self.fft_mid.tolist(), th.mid_fft))
        if self.show_side_fft and self.fft_side is not None:
            data.append(Dataset(self.fft_side.tolist(), th.side_fft))
        draw_chart(
            scr, rect.inner(), data, (0.0, 100.0),
            (FFT_LOWER_BOUND, FFT_UPPER_BOUND), bg,
            x_labels=[Span("20Hz", th.axes_labels), Span("632.46Hz", th.axes_labels),
                      Span("20kHz", th.axes_labels)],
            y_labels=[Span("-100", th.axes_labels), Span("-50", th.axes_labels),
                      Span("0", th.axes_labels)],
        )

    def _draw_lufs(self, scr: Screen, rect: Rect):
        th = self.theme.lufs
        bg = th.background
        chart_w = round(rect.w * 0.8)
        chart_rect = Rect(rect.x, rect.y, chart_w, rect.h)
        stats_rect = Rect(rect.x + chart_w, rect.y, rect.w - chart_w, rect.h)
        draw_block(scr, chart_rect, th.borders, bg,
                   title=[Span("³", th.highlight, True), Span("lufs", th.labels, True)])
        pts = [(float(i), v) for i, v in enumerate(self.lufs)]
        draw_chart(scr, chart_rect.inner(), [Dataset(pts, th.chart)],
                   (0.0, 300.0), (-50.0, 0.0), bg,
                   y_labels=[Span("-50", th.axis), Span("0", th.axis)])

        if self.mode == Mode.MICROPHONE and self.live_stats is not None:
            f = self.live_stats
            integrated = float(f.integrated)
            rng = float(f.lra)
            tp = np.asarray(f.true_peak)
            tp_l = float(tp[0])
            tp_r = float(tp[1]) if tp.shape[0] > 1 else tp_l
        else:
            analyzer = (self.file_analyzer if self.mode == Mode.PLAYER
                        else self.device_analyzer)
            integrated = analyzer.get_integrated_lufs()
            rng = analyzer.get_loudness_range()
            tp_l, tp_r = analyzer.get_true_peak()
        if not np.isfinite(integrated):
            integrated = -50.0  # -inf guard (src/tui.rs:926-930)
        boxes = [
            ("Short term", [f"{self.lufs[-1]:05.1f} LUFS"]),
            ("Integrated", [f"{integrated:05.1f} LUFS"]),
            ("Range", [f"{rng:.1f} LU"]),
            # displayed as linear value labeled Db — reference quirk
            # (src/tui.rs:963-966)
            ("True Peak", [f"L: {tp_l:.1f} Db", f"R: {tp_r:.1f} Db"]),
        ]
        bh = stats_rect.h // 4
        for i, (title, lines) in enumerate(boxes):
            r = Rect(stats_rect.x, stats_rect.y + i * bh, stats_rect.w,
                     bh if i < 3 else stats_rect.h - 3 * bh)
            draw_block(scr, r, th.borders, bg,
                       title=[Span(titles_center(title, r.w), th.foreground, True)])
            for j, line in enumerate(lines):
                line = line[: max(r.w - 2, 0)]
                scr.put_str(r.x + max((r.w - len(line)) // 2, 1), r.y + 1 + j,
                            line, th.numbers, bg)

    def _draw_empty(self, scr: Screen):
        # reference renders a big "Soundscope" banner behind the hint box
        # with tui-big-text (src/tui.rs:598-630)
        th = self.theme
        bt_w = big_text_width("Soundscope")
        if scr.width >= bt_w + 2 and scr.height >= BIG_GLYPH_H + 8:
            draw_big_text(scr, (scr.width - bt_w) // 2,
                          max((scr.height - BIG_GLYPH_H) // 2 - 5, 0),
                          "Soundscope", th.foreground, th.background)
        lines = ["No open windows!", "1 | Toggle waveform",
                 "2 | Toggle spectrum", "3 | Toggle LUFS   "]
        bw, bh = 30, 6
        r = Rect((scr.width - bw) // 2, (scr.height - bh) // 2, bw, bh)
        for yy in range(r.y, r.y + r.h):
            for xx in range(r.x, r.x + r.w):
                scr.put(xx, yy, " ", th.foreground, th.background)
        draw_block(scr, r, th.foreground, th.background)
        for i, ln in enumerate(lines):
            scr.put_str(r.x + (bw - len(ln)) // 2, r.y + 1 + i, ln,
                        th.foreground, th.background)

    def _draw_error(self, scr: Screen):
        th = self.theme.error
        msg = self.error_text[: scr.width - 6]
        bw = len(msg) + 4
        r = Rect((scr.width - bw) // 2, scr.height - 5, bw, 3)
        draw_block(scr, r, th.borders, th.background,
                   title=[Span("error", th.foreground, True)])
        scr.put_str(r.x + 2, r.y + 1, msg, th.foreground, th.background)

    def _draw_list_popup(self, scr, title, entries, selected, bd, bg, fg, hl,
                         dir_fg=None, dir_hl=None):
        """dir_fg/dir_hl color entries ending in '/' (the explorer's
        dir_foreground/highlight_dir_foreground theme fields; reference
        ratatui-explorer renders directories distinctly)."""
        bw = max(scr.width // 2, 20)
        bh = max(int(scr.height * 0.7), 6)
        r = Rect((scr.width - bw) // 2, (scr.height - bh) // 2, bw, bh)
        for yy in range(r.y, r.y + r.h):
            for xx in range(r.x, r.x + r.w):
                scr.put(xx, yy, " ", fg, bg)
        draw_block(scr, r, bd, bg, title=[Span(title, fg, True)])
        vis = r.h - 2
        top = max(0, min(selected - vis // 2, len(entries) - vis))
        for i, name in enumerate(entries[top: top + vis]):
            idx = top + i
            prefix = f"{idx} " if idx < 10 else "  "
            sel = idx == selected
            is_dir = str(name).endswith("/")
            if is_dir and dir_fg is not None:
                color = (dir_hl or hl) if sel else dir_fg
            else:
                color = hl if sel else fg
            scr.put_str(r.x + 2, r.y + 1 + i,
                        ("> " if sel else "  ") + prefix + str(name)[: bw - 8],
                        color, bg, sel)

    def _draw_help(self, scr: Screen):
        th = self.theme.help
        bw = min(44, scr.width - 2)
        bh = min(len(HELP_BINDINGS) + 2, scr.height - 2)
        r = Rect((scr.width - bw) // 2, (scr.height - bh) // 2, bw, bh)
        for yy in range(r.y, r.y + r.h):
            for xx in range(r.x, r.x + r.w):
                scr.put(xx, yy, " ", th.foreground, th.background)
        draw_block(scr, r, th.borders, th.background,
                   title=[Span("help", th.highlight, True)])
        for i, (k, desc) in enumerate(HELP_BINDINGS[: bh - 2]):
            scr.put_str(r.x + 2, r.y + 1 + i, f"{k:>7}", th.highlight, th.background, True)
            scr.put_str(r.x + 10, r.y + 1 + i, desc[: bw - 12], th.foreground, th.background)

    def _draw_fft_tooltip(self, scr: Screen):
        """Mouse hover frequency/dB readout with inverse log mapping
        (src/tui.rs:1166-1205, 2111-2146)."""
        col, row = self.mouse
        cr = self.chart_rect
        inner = cr.inner()
        if not (inner.x <= col < inner.x + inner.w and inner.y <= row < inner.y + inner.h):
            return
        frac = (col - inner.x) / max(inner.w - 1, 1)
        freq = 10 ** (np.log10(20.0) + frac * (np.log10(20000.0) - np.log10(20.0)))
        db = FFT_UPPER_BOUND - (row - inner.y) / max(inner.h - 1, 1) * (
            FFT_UPPER_BOUND - FFT_LOWER_BOUND
        )
        text = (f"{freq / 1000:.2f}kHz" if freq >= 1000 else f"{freq:.1f}Hz")
        text += f" {db:.1f}dB"
        th = self.theme.fft
        scr.put_str(min(col + 2, scr.width - len(text) - 1), max(row - 1, 0),
                    text, th.highlight, th.background, True)


def titles_center(text: str, width: int) -> str:
    return text[: max(width - 2, 0)]


# ---------------------------------------------------------------- curses --

_KEYMAP_SPECIAL = {
    " ": "space", "\n": "enter", "\r": "enter", "\x1b": "esc",
}


def run_tui(start_file: str | None = None, device=None, show_metrics: bool = False) -> int:
    """Curses host: 8 ms tick loop with dirty-flag rendering
    (reference loop: src/tui.rs:1244-1425). Analysis runs on `device`
    (None: the card; without one this raises)."""
    import curses

    def _main(stdscr):
        curses.curs_set(0)
        curses.mousemask(curses.ALL_MOUSE_EVENTS | curses.REPORT_MOUSE_POSITION)
        stdscr.nodelay(True)
        curses.start_color()
        curses.use_default_colors()
        pair_cache: dict[tuple, int] = {}

        def color_pair(fg: T.Color | None, bg: T.Color | None) -> int:
            if not curses.has_colors():
                return 0
            fgi = _to_256(fg) if fg else -1
            bgi = _to_256(bg) if bg else -1
            key = (fgi, bgi)
            if key not in pair_cache:
                idx = len(pair_cache) + 1
                if idx >= curses.COLOR_PAIRS:
                    return 0
                try:
                    curses.init_pair(idx, fgi, bgi)
                except curses.error:
                    return 0
                pair_cache[key] = idx
            return curses.color_pair(pair_cache[key])

        app = App(start_file=start_file, device=device, show_metrics=show_metrics)
        last_draw = 0.0
        while not app.quit_requested:
            app.tick()
            try:
                ch = stdscr.get_wch()
            except curses.error:
                ch = None
            if ch is not None:
                if ch == curses.KEY_MOUSE:
                    try:
                        _, mx, my, _, _ = curses.getmouse()
                        app.handle_mouse(mx, my)
                    except curses.error:
                        pass
                else:
                    name = _key_name(ch, curses)
                    if name:
                        app.handle_key(name)
            now = time.monotonic()
            # The reference renders on-dirty inside its 8 ms tick
            # (tui.rs:1279,1421-1423). Curses repaints are far costlier than
            # ratatui's diffed draws, so this host keeps the 8 ms tick for
            # analysis/input but floors redraws at 30 ms (~33 fps) — the
            # position cadence is ~21.5 Hz, so no analysis frame is skipped.
            if app.needs_render and now - last_draw > 0.03:
                last_draw = now
                hh, ww = stdscr.getmaxyx()
                scr = Screen(ww - 1, hh)
                app.draw(scr)
                for y, rowcells in enumerate(scr.cells):
                    for x, cell in enumerate(rowcells):
                        attr = color_pair(cell.fg, cell.bg)
                        if cell.bold:
                            attr |= curses.A_BOLD
                        try:
                            stdscr.addstr(y, x, cell.ch, attr)
                        except curses.error:
                            pass
                stdscr.refresh()
            time.sleep(0.008)
        return 0

    return curses.wrapper(_main)


def _key_name(ch, curses) -> str | None:
    if isinstance(ch, str):
        if ch in _KEYMAP_SPECIAL:
            return _KEYMAP_SPECIAL[ch]
        if ch.isprintable() and len(ch) == 1:
            return ch
        return None
    return {
        curses.KEY_LEFT: "left", curses.KEY_RIGHT: "right",
        curses.KEY_UP: "up", curses.KEY_DOWN: "down",
        curses.KEY_ENTER: "enter", curses.KEY_F1: "F1",
    }.get(ch)


def _to_256(c: T.Color) -> int:
    if c.index is not None:
        return c.index
    # nearest xterm-256 cube/gray
    def cube(v):
        steps = [0, 95, 135, 175, 215, 255]
        return min(range(6), key=lambda i: abs(steps[i] - v))

    r, g, b = cube(c.r), cube(c.g), cube(c.b)
    cube_idx = 16 + 36 * r + 6 * g + b
    gray = round((c.r + c.g + c.b) / 3)
    gray_idx = 232 + min(max((gray - 8) // 10, 0), 23)
    steps = [0, 95, 135, 175, 215, 255]
    cube_rgb = (steps[r], steps[g], steps[b])
    gray_v = 8 + (gray_idx - 232) * 10
    d_cube = sum((a - b) ** 2 for a, b in zip(cube_rgb, (c.r, c.g, c.b)))
    d_gray = sum((gray_v - v) ** 2 for v in (c.r, c.g, c.b))
    return gray_idx if d_gray < d_cube else cube_idx
