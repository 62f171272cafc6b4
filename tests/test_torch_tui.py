"""The port's TUI App against the JAX package's, and its own behaviours.

Both Apps take the same song and the same playhead positions straight into
`analyze_audio_file_samples` (no wall clock involved), and the same ring
pushes in microphone mode: waveform exact, loudness within 1e-3 LU,
spectra within 1e-3 dB plus float32 FFT rounding. Popups render the same
Screen text in both. The behaviours of tests/test_tui.py are held on the
port's App on the CPU."""

import os
import time

import numpy as np
import pytest

import soundscope_tpu.apps.tui as jtui
import soundscope_tpu_torch.apps.tui as ttui
from soundscope_tpu_torch.apps import player as player_mod
from soundscope_tpu_torch.apps import themes as T
from soundscope_tpu_torch.apps import tui as tui_module
from soundscope_tpu_torch.apps.player import AudioPlayer
from soundscope_tpu_torch.apps.render import Screen
from soundscope_tpu_torch.apps.tui import App, Mode
from soundscope_tpu_torch.core.config import MeterConfig
from soundscope_tpu_torch.models.live import LiveAnalyzer
from soundscope_tpu_torch.utils.io import write_wav
from soundscope_tpu_torch.utils import metrics as metrics_module
from soundscope_tpu_torch.utils.metrics import GLOBAL as RT, RTCounter, SpanStats
from soundscope_tpu_torch.utils.synth import pink_noise, sine, stereo

RATE = 44100


def _song(path, seconds=3.0):
    """500 Hz over pink noise, the channels apart (side is not silent):
    every display band sits far above float32 rounding noise."""
    tone = sine(500.0, seconds, RATE, -14.0)
    pink = 0.1 * pink_noise(seconds, RATE, np.random.default_rng(7))
    write_wav(path, np.stack([tone + pink, 0.5 * tone + 0.8 * pink]), RATE, bits=32)
    return path


def _frame(app, w=100, h=30):
    scr = Screen(w, h)
    app.draw(scr)
    return scr.text()


def _close(a, b, atol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=what)


def _spectra_close(t, j, what):
    """Chart x as in tests/test_torch_analyzer.py; dB within 1e-3 plus the
    rounding of a float32 FFT, about 1e-6 of the largest bin's magnitude
    (torch and XLA call different FFT libraries)."""
    _close(t[:, 0], j[:, 0], 1e-5, what + " chart x")
    below = j[:, 1].max() - j[:, 1]
    bound = 1e-3 + 20 * np.log10(1 + 1e-6 * 10 ** (below / 20))
    err = np.abs(t[:, 1] - j[:, 1])
    assert np.all(err <= bound), (what, float((err - bound).max()))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("tui")
    j = jtui.App(config_dir=str(d / "jcfg"))
    t = App(player=AudioPlayer(sink_factory=None), config_dir=str(d / "tcfg"),
            device="cpu")
    yield j, t, d
    j.handle_key("q")
    t.handle_key("q")


def test_file_mode_frames_match_jax(pair):
    j, t, d = pair
    song = _song(str(d / "song.wav"))
    j.select_audio_file(song)
    t.select_audio_file(song)
    np.testing.assert_array_equal(t.file_waveform, j.file_waveform)
    assert abs(t.fft_gain_db - j.fft_gain_db) <= 1e-3
    assert t.waveform_window == j.waveform_window == 3.0
    # every report the transport would make over the song, and a few past
    # its end, then a rewind
    positions = list(range(2048, 3 * RATE * 2 + 8192, 2048 * 5)) + [RATE * 2]
    for pos in positions:
        j.analyze_audio_file_samples(pos)
        t.analyze_audio_file_samples(pos)
        assert t.playhead == j.playhead
        _close(t.lufs, j.lufs, 1e-3, f"lufs history at {pos}")
    _spectra_close(t.fft_mid, j.fft_mid, "mid")
    _spectra_close(t.fft_side, j.fft_side, "side")
    assert t.lufs[-1] > -100.0
    for q in ("get_integrated_lufs", "get_shortterm_lufs", "get_loudness_range"):
        _close(getattr(t.file_analyzer, q)(), getattr(j.file_analyzer, q)(), 1e-3, q)
    txt = _frame(t)
    assert "song" in txt and "00:01" in txt and "00:03" in txt


def test_mic_mode_frames_match_jax(pair):
    j, t, _ = pair
    for app, capture in ((j, jtui), (t, ttui)):
        app.handle_key("m")
        assert app.mode.value == "Microphone"
        assert app.live is not None
        assert app.live_ready.wait(timeout=300)
        app.stream.stop()                  # the synthetic device stops feeding
        app.ring = capture.make_ring(RATE * 30)
        app._live_consumed = 0
    assert t.live_error is None
    t_ = np.arange(RATE * 4) / RATE
    mono = (0.4 * np.sin(2 * np.pi * 700.0 * t_)
            + 0.05 * np.random.default_rng(3).standard_normal(len(t_))).astype(np.float32)
    pseudo = np.zeros(2 * len(mono), np.float32)
    pseudo[0::2] = mono
    for lo, hi in ((0, 4096), (4096, 4096 + 6000), (10096, 2 * RATE * 3), (2 * RATE * 3, None)):
        for app in (j, t):
            app.ring.push(pseudo[lo:hi])
            app.analyze_microphone_input()
        _spectra_close(t.fft_mid, j.fft_mid, f"mic mid after {hi}")
        _spectra_close(t.fft_side, j.fft_side, f"mic side after {hi}")
        _close(t.mic_waveform, j.mic_waveform, 1e-6, f"mic waveform after {hi}")
        _close(t.lufs, j.lufs, 1e-3, f"mic lufs after {hi}")
        for f in ("integrated", "lra"):
            _close(getattr(t.live_stats, f), getattr(j.live_stats, f), 1e-3, f)
        _close(t.live_stats.true_peak, j.live_stats.true_peak, 1e-6, "true peak")
    assert t._live_consumed == j._live_consumed == len(pseudo) // 2048 * 2048
    peak_x = t.fft_mid[np.argmax(t.fft_mid[:, 1]), 0]
    expect = (np.log10(700) - np.log10(20)) / (np.log10(20000) - np.log10(20)) * 100
    assert abs(peak_x - expect) < 2.0
    for app in (j, t):
        app.handle_key("m")
    assert t.mode == Mode.PLAYER


def _cells(scr):
    def col(c):
        return None if c is None else (c.r, c.g, c.b, c.index)

    return [[(c.ch, col(c.fg), col(c.bg), c.bold) for c in row] for row in scr.cells]


@pytest.mark.parametrize("popup", ["empty", "help", "themes", "explorer"])
def test_popups_render_identical_screens(pair, popup, tmp_path):
    j, t, _ = pair
    (tmp_path / "sub").mkdir()
    (tmp_path / "a.flac").write_bytes(b"")
    (tmp_path / "b.theme").write_text("[global]\n")
    screens = []
    for app in (j, t):
        app.show_waveform = app.show_fft = app.show_lufs = popup != "empty"
        app.audio_file = None
        app.mouse = None
        app.explorer.cwd = str(tmp_path)
        app.explorer.selected = 0
        key = {"help": "h", "themes": "t", "explorer": "e"}.get(popup)
        if key:
            app.handle_key(key)
            if popup != "help":
                app.handle_key("down")
        scr = Screen(100, 30)
        app.draw(scr)
        screens.append(scr)
        if key:
            app.handle_key("esc")
        app.show_waveform = app.show_fft = app.show_lufs = True
    assert screens[1].text() == screens[0].text()
    assert _cells(screens[1]) == _cells(screens[0])


# ---------------------------------------------------------------- the port --

@pytest.fixture
def song(tmp_path):
    p = str(tmp_path / "song.wav")
    write_wav(p, stereo(sine(500.0, 3.0, RATE, -12.0)), RATE)
    return p


@pytest.fixture
def app(tmp_path):
    a = App(config_dir=str(tmp_path / "cfg"), device="cpu")
    yield a
    a.handle_key("q")


def test_app_without_a_card_raises(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        App(player=AudioPlayer(sink_factory=None), config_dir=str(tmp_path), device=None)


def test_panes_toggle_and_empty_state(app):
    txt = _frame(app)
    assert "spectrum" in txt and "lufs" in txt
    app.handle_key("2")
    app.handle_key("3")
    txt = _frame(app)
    assert "spectrum" not in txt and "lufs" not in txt
    app.handle_key("1")
    txt = _frame(app)
    assert "No open windows!" in txt and "1 | Toggle waveform" in txt
    assert "█" in txt                                  # the big banner
    small = _frame(app, w=40, h=12)
    assert "No open windows!" in small and "█" not in small


def test_load_file_and_analyze(app, song):
    app.select_audio_file(song)
    assert app.audio_file is not None and abs(app.audio_file.duration - 3.0) < 0.01
    lufs_i = app.file_analyzer.calculate_integrated_lufs(2, app.audio_file.interleaved())
    assert abs(app.fft_gain_db - (-13.0 - lufs_i)) < 1e-6
    app.analyze_audio_file_samples(2 * RATE * 2)
    peak_x = app.fft_mid[np.argmax(app.fft_mid[:, 1]), 0]
    expect = (np.log10(500) - np.log10(20)) / (np.log10(20000) - np.log10(20)) * 100
    assert abs(peak_x - expect) < 2.0
    assert app.lufs[-1] > -100.0


def test_keymap_popups_and_navigation(app):
    app.handle_key("h")
    assert "Play/pause" in _frame(app)
    app.handle_key("esc")
    assert "Play/pause" not in _frame(app)
    app.handle_key("t")
    app.handle_key("down")
    app.handle_key("down")
    assert app.theme_selected == 2
    app.handle_key("up")
    for _ in range(len(app.themes_entries)):
        app.handle_key("down")
    assert app.theme_selected == 1                    # wrap-around
    app.handle_key("enter")
    assert not app.show_themes and app.theme.name in app.themes_entries[1]


def test_theme_persistence(tmp_path):
    cfg = str(tmp_path / "cfg")
    a = App(config_dir=cfg, device="cpu")
    a.handle_key("t")
    a.theme_selected = 1 + sorted(T.list_themes()).index("Nord")
    a.handle_key("enter")
    a.handle_key("q")
    b = App(config_dir=cfg, device="cpu")
    assert b.theme.name == "Nord"
    b.handle_key("q")


def test_zoom_bounds(app, song):
    app.select_audio_file(song)
    assert app.waveform_window == 3.0
    for _ in range(3):
        app.handle_key("+")
    assert app.waveform_window == 1.0
    for _ in range(20):
        app.handle_key("-")
    assert app.waveform_window == 3.0


def test_seek_and_playpause_reset_meter(app, song):
    app.select_audio_file(song)                      # auto-plays
    app.analyze_audio_file_samples(RATE * 2)
    assert app.lufs[-1] > -100.0
    app.handle_key("space")                          # pause: chart frozen
    assert app.lufs[-1] > -100.0
    time.sleep(0.05)
    app.handle_key("space")                          # resume: reset
    assert app.lufs[-1] == -100.0
    app.analyze_audio_file_samples(RATE * 2)
    app.handle_key("right")
    assert app.lufs[-1] == -100.0
    assert app.file_analyzer.get_integrated_lufs() == -np.inf
    app.analyze_audio_file_samples(RATE * 2)
    app.show_themes = True
    app.handle_key("right")                          # ignored under a popup
    assert app.lufs[-1] > -100.0


def test_error_popups_and_explorer(app, tmp_path, song):
    app.handle_error("Boom!")
    assert "Boom!" in _frame(app)
    app.error_at -= 6.0
    app.tick()
    assert "Boom!" not in _frame(app)
    app.handle_key("y")
    time.sleep(0.15)
    app.tick()
    assert "test error" in _frame(app)
    os.makedirs(tmp_path / "sub")
    (tmp_path / "notes.txt").write_text("x")
    app.explorer.cwd = str(tmp_path)
    app.handle_key("e")
    names = app.explorer.entries
    assert "sub/" in names and "song.wav" in names and "notes.txt" not in names
    app.explorer.selected = names.index("song.wav")
    app.handle_key("enter")
    assert app.audio_file is not None and app.audio_file.title == "song"


def test_devices_key_gated_and_mouse_tooltip(app, song):
    app.handle_key("d")
    assert not app.show_devices
    app.select_audio_file(song)
    app.analyze_audio_file_samples(RATE)
    app.draw(Screen(100, 30))
    cr = app.chart_rect.inner()
    app.handle_mouse(cr.x + cr.w // 2, cr.y + cr.h // 2)
    txt = _frame(app)
    assert "Hz" in txt and "dB" in txt


def test_metrics_readout(tmp_path, song):
    a = App(config_dir=str(tmp_path / "cfg"), device="cpu", show_metrics=True)
    try:
        a.select_audio_file(song)
        a.tick()
        time.sleep(0.01)
        a.tick()
        a.analyze_audio_file_samples(RATE * 2)
        txt = _frame(a, w=120)
        assert "tick" in txt and "ms" in txt and "lufs_push" in txt
    finally:
        a.handle_key("q")
    b = App(config_dir=str(tmp_path / "cfg"), device="cpu")
    assert not b.show_metrics
    b.handle_key("q")


def test_metrics_readout_shows_spans_without_audio_in_ms(tmp_path, monkeypatch):
    """Spans that credit no audio (live.push, array.pad, array.upload) read
    as their median ms, after the RT factors of those that do."""
    reg = RTCounter()
    monkeypatch.setattr(tui_module, "RT", reg)
    clock = iter(np.arange(100.0, 101.0, 0.001))
    with monkeypatch.context() as m:             # each span lasts 1 ms
        m.setattr(metrics_module.time, "perf_counter", lambda: next(clock))
        for _ in range(3):
            with reg.span("live.push"):
                pass
        with reg.span("lufs_push", 1.0):
            pass
        with reg.span("array.pad"):              # one call: no median yet
            pass
    a = App(config_dir=str(tmp_path / "cfg"), device="cpu", show_metrics=True)
    try:
        txt = _frame(a, w=120)
        assert "lufs_push 1000x | live.push 1ms" in txt and "array.pad" not in txt
    finally:
        a.handle_key("q")


def test_slow_decode_surfaces_popup_then_loads(app, song, monkeypatch):
    real_decode = player_mod.decode_file

    def slow_decode(path):
        time.sleep(0.6)
        return real_decode(path)

    monkeypatch.setattr(player_mod, "decode_file", slow_decode)
    app.DECODE_WAIT_SECONDS = 0.1
    app.select_audio_file(song)
    assert app.audio_file is None and "Still decoding" in app.error_text
    deadline = time.monotonic() + 10.0
    while app.audio_file is None and time.monotonic() < deadline:
        app.tick()
        time.sleep(0.02)
    assert app.audio_file is not None


def test_mic_mode_runs_the_live_pipeline(app):
    app.handle_key("m")
    assert app.mode == Mode.MICROPHONE and app.live is not None
    assert app.live_ready.wait(timeout=120) and app.live_error is None
    assert app.live.device.type == "cpu"
    t = np.arange(RATE * 4) / RATE
    pseudo = np.zeros(2 * len(t), np.float32)
    pseudo[0::2] = 0.4 * np.sin(2 * np.pi * 700.0 * t)
    app.ring.push(pseudo)
    app.analyze_microphone_input()
    assert app.live_stats is not None and app.mic_waveform is not None
    assert "Microphone" in _frame(app)


def test_live_frame_credits_audio_at_the_live_analyzers_rate(app):
    """The metrics readout credits a live frame with the q / 2 frames of a
    quantum at the live analyzer's own rate."""
    app.handle_key("m")
    assert app.live_ready.wait(timeout=120) and app.live_error is None
    app.live = LiveAnalyzer(MeterConfig(channels=2, rate=48000, max_blocks=0), device="cpu")
    q = app._live_quantum
    app.ring.push(np.zeros(q, np.float32))
    before = RT.span_stats("live_frame") or SpanStats()
    app.analyze_microphone_input()
    after = RT.span_stats("live_frame")
    assert after.calls == before.calls + 1
    assert after.audio_s - before.audio_s == pytest.approx(q / 2 / 48000)


def test_live_pipeline_failure_shows_and_is_not_replaced(app, monkeypatch):
    """A live pipeline that fails to warm up shows its error, and the next
    analysis raises: the host-snapshot path does not stand in for it."""
    from soundscope_tpu_torch.models.live import LiveAnalyzer

    def broken(self, interleaved):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(LiveAnalyzer, "push", broken)
    app.handle_key("m")
    assert app.live_ready.wait(timeout=60)
    assert isinstance(app.live_error, RuntimeError)
    app.ring.push(np.zeros(RATE * 2 * 2, np.float32))
    with pytest.raises(RuntimeError, match="live analysis pipeline failed: kernel launch failed"):
        app.analyze_microphone_input()
    assert "Live analysis failed: kernel launch failed" in _frame(app)
    assert app.fft_mid is None and app.mic_waveform is None and app.live_stats is None
