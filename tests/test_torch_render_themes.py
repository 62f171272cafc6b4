"""The port's copies of apps/render.py and apps/themes.py against the JAX
package's: the same datasets draw the same cells, every theme parses to
the same colors, and the theme engine's own behaviours (tests/test_themes.py)
hold on the port's copy."""

import numpy as np
import pytest

import soundscope_tpu.apps.render as JR
import soundscope_tpu.apps.themes as JT
import soundscope_tpu_torch.apps.render as TR
import soundscope_tpu_torch.apps.themes as TT


def _col(c):
    return None if c is None else (c.r, c.g, c.b, c.index)


def _cells(scr):
    return [[(c.ch, _col(c.fg), _col(c.bg), c.bold) for c in row] for row in scr.cells]


def _theme(th):
    return (th.name, _col(th.background), _col(th.foreground), _col(th.highlight),
            {s: {f: _col(v) for f, v in sec.colors.items()} for s, sec in th.sections.items()})


def _draw(R, T, seed, w, h):
    rng = np.random.default_rng(seed)
    scr = R.Screen(w, h)
    bg = T.Color.parse("#101820")
    scr.fill(bg)
    x = np.sort(rng.uniform(-5, 105, 300))
    sets = [
        R.Dataset(list(zip(x.tolist(), rng.uniform(-110, 5, 300).tolist())),
                  T.Color.parse(160)),
        R.Dataset([(float(i), float(v)) for i, v in enumerate(rng.uniform(-60, 0, 100))],
                  T.Color.parse("cyan"), connect=False),
        R.Dataset([(50.0, 1.0), (50.0, -1.0)], T.Color.parse((1, 2, 3))),
    ]
    R.draw_block(scr, R.Rect(0, 0, w, h), T.Color.parse("white"), bg,
                 title=[R.Span("²", T.Color.parse(160), True), R.Span("spectrum")],
                 title_right=[R.Span("M"), R.Span("id")],
                 bottom_left=[R.Span("<- ")], bottom_center=[R.Span("00:01")],
                 bottom_right=[R.Span("00:03")])
    R.draw_chart(scr, R.Rect(1, 1, w - 2, h // 2), sets, (0.0, 100.0), (-100.0, 0.0), bg,
                 x_labels=[R.Span("20Hz"), R.Span("632.46Hz"), R.Span("20kHz")],
                 y_labels=[R.Span("-100"), R.Span("-50"), R.Span("0")])
    R.draw_chart(scr, R.Rect(1, 1 + h // 2, w - 2, h - h // 2 - 2), sets[1:],
                 (0.0, 99.0), (-1.5, 1.5), bg)
    if w >= R.big_text_width("Soundscope") and h >= R.BIG_GLYPH_H:
        R.draw_big_text(scr, 0, h - R.BIG_GLYPH_H, "Soundscope", T.Color.parse(221), bg)
    return scr


@pytest.mark.parametrize("seed,w,h", [(0, 100, 30), (1, 40, 12), (2, 200, 60), (3, 7, 5)])
def test_charts_and_big_text_draw_identical_cells(seed, w, h):
    a, b = _draw(JR, JT, seed, w, h), _draw(TR, TT, seed, w, h)
    assert _cells(b) == _cells(a)
    assert b.text() == a.text()
    assert TR.big_text_width("Soundscope 123") == JR.big_text_width("Soundscope 123")


def test_every_theme_parses_identically(tmp_path):
    assert TT.list_themes() == JT.list_themes() and len(TT.list_themes()) == 17
    for name in TT.list_themes():
        assert _theme(TT.get_by_name(name)) == _theme(JT.get_by_name(name)), name
    assert _theme(TT.default_theme()) == _theme(JT.default_theme())
    p = tmp_path / "custom.theme"
    p.write_text('[global]\nbackground = "#222222"\nforeground = "Light Blue"\n'
                 'highlight = 160\n\n[waveform]\nplayhead = "#ff0000"\n\n'
                 '[explorer]\ndir_foreground = "33"\n')
    assert _theme(TT.load_theme_file(str(p))) == _theme(JT.load_theme_file(str(p)))
    for v in ("#ff8000", "Light Blue", 160, 7, 250, (1, 2, 3), "dark_gray"):
        assert _col(TT.Color.parse(v)) == _col(JT.Color.parse(v))
    with pytest.raises(ValueError):
        TT.Color.parse("not-a-color")


def test_theme_persistence_and_file_listing(tmp_path):
    d = str(tmp_path)
    (tmp_path / "b.theme").write_text("[global]\n")
    (tmp_path / "a.theme").write_text("[global]\n")
    assert TT.available_theme_files(d) == JT.available_theme_files(d) == ["a.theme", "b.theme"]
    TT.save_current_theme("builtin:Nord", d)
    assert TT.load_current_theme(d).name == JT.load_current_theme(d).name == "Nord"
    TT.save_current_theme("a.theme", d)
    assert TT.load_current_theme(d).name == "a.theme"
    TT.save_current_theme("missing.theme", d)
    assert TT.load_current_theme(d).name == "DEFAULT"
    assert TT.config_dir() == JT.config_dir()
