"""Theme engine — reference parity.

Replicates the reference's theme model (src/tui.rs:137-355):
8 sections (global/waveform/fft/lufs/devices/explorer/error/help), every
field an optional color, with `apply_global_as_default` filling unset
fields from global fg/bg/highlight; 17 built-in palettes
(src/builtin_themes.rs:18-341); TOML `.theme` files loaded from the
config dir; the current selection persisted in `.current_theme` as
`DEFAULT` / `builtin:<name>` / `<filename>` (src/tui.rs:1813-1872,
2005-2108; macOS forces ~/.config, src/tui.rs:2149-2157).

Colors accept "#rrggbb", named ANSI colors, or 0-255 indexed ints —
the same surface the reference's serde Color accepts in .theme files.
"""

from __future__ import annotations

import os
import sys
import tomllib
from dataclasses import dataclass, field

# --- colors -------------------------------------------------------------------

_NAMED = {
    "black": (0, 0, 0), "red": (205, 0, 0), "green": (0, 205, 0),
    "yellow": (205, 205, 0), "blue": (0, 0, 238), "magenta": (205, 0, 205),
    "cyan": (0, 205, 205), "gray": (229, 229, 229), "grey": (229, 229, 229),
    "darkgray": (127, 127, 127), "darkgrey": (127, 127, 127),
    "lightred": (255, 0, 0), "lightgreen": (0, 255, 0),
    "lightyellow": (255, 255, 0), "lightblue": (92, 92, 255),
    "lightmagenta": (255, 0, 255), "lightcyan": (0, 255, 255),
    "white": (255, 255, 255),
}


@dataclass(frozen=True)
class Color:
    r: int
    g: int
    b: int
    index: int | None = None  # 256-color index when specified that way

    @staticmethod
    def parse(v) -> "Color":
        if isinstance(v, Color):
            return v
        if isinstance(v, int):
            return Color(*_index_to_rgb(v), index=v)
        if isinstance(v, (tuple, list)) and len(v) == 3:
            return Color(int(v[0]), int(v[1]), int(v[2]))
        if isinstance(v, str):
            s = v.strip()
            if s.startswith("#") and len(s) == 7:
                return Color(int(s[1:3], 16), int(s[3:5], 16), int(s[5:7], 16))
            key = s.replace(" ", "").replace("_", "").lower()
            if key in _NAMED:
                return Color(*_NAMED[key])
            if s.isdigit():
                return Color.parse(int(s))
        raise ValueError(f"unparseable color {v!r}")

    def hex(self) -> str:
        return f"#{self.r:02x}{self.g:02x}{self.b:02x}"


def _index_to_rgb(i: int) -> tuple[int, int, int]:
    """xterm-256 palette to RGB."""
    i = int(i) % 256
    if i < 16:
        base = [
            (0, 0, 0), (128, 0, 0), (0, 128, 0), (128, 128, 0),
            (0, 0, 128), (128, 0, 128), (0, 128, 128), (192, 192, 192),
            (128, 128, 128), (255, 0, 0), (0, 255, 0), (255, 255, 0),
            (0, 0, 255), (255, 0, 255), (0, 255, 255), (255, 255, 255),
        ]
        return base[i]
    if i < 232:
        i -= 16
        steps = [0, 95, 135, 175, 215, 255]
        return steps[i // 36], steps[(i // 6) % 6], steps[i % 6]
    v = 8 + (i - 232) * 10
    return v, v, v


def rgb(r: int, g: int, b: int) -> Color:
    return Color(r, g, b)


# --- theme model ---------------------------------------------------------------

_SECTION_FIELDS = {
    "waveform": ["borders", "waveform", "playhead", "current_time",
                 "total_duration", "controls", "controls_highlight",
                 "labels", "background", "highlight"],
    "fft": ["borders", "labels", "axes", "axes_labels", "mid_fft",
            "side_fft", "background", "highlight"],
    "lufs": ["axis", "chart", "labels", "foreground", "numbers",
             "borders", "background", "highlight"],
    "devices": ["background", "foreground", "borders", "highlight"],
    "explorer": ["background", "borders", "item_foreground",
                 "highlight_item_foreground", "dir_foreground",
                 "highlight_dir_foreground"],
    "error": ["background", "foreground", "borders"],
    "help": ["background", "foreground", "borders", "highlight"],
}

# Which global color fills each unset field (mirrors fill_fields! calls,
# src/tui.rs:172-234): highlight-ish fields get hl, backgrounds bg, rest fg.
_HL_FIELDS = {
    ("waveform", "controls_highlight"), ("waveform", "playhead"),
    ("waveform", "highlight"), ("lufs", "highlight"), ("fft", "side_fft"),
    ("fft", "highlight"), ("explorer", "highlight_dir_foreground"),
    ("explorer", "highlight_item_foreground"), ("devices", "highlight"),
    ("help", "highlight"),
}
_BG_FIELDS = {(s, "background") for s in _SECTION_FIELDS}


@dataclass
class Section:
    name: str
    colors: dict = field(default_factory=dict)  # field -> Color | None

    def __getattr__(self, item):
        try:
            return self.__dict__["colors"].get(item)
        except KeyError:
            raise AttributeError(item)


@dataclass
class Theme:
    name: str = "DEFAULT"
    background: Color = field(default_factory=lambda: Color.parse("black"))
    foreground: Color = field(default_factory=lambda: Color.parse(221))
    highlight: Color | None = field(default_factory=lambda: Color.parse(160))
    sections: dict = field(default_factory=dict)

    def __post_init__(self):
        for sec, fields_ in _SECTION_FIELDS.items():
            self.sections.setdefault(sec, Section(sec, {f: None for f in fields_}))

    def apply_global_as_default(self) -> "Theme":
        hl = self.highlight or self.foreground
        self.highlight = hl
        for sec_name, sec in self.sections.items():
            for f, v in sec.colors.items():
                if v is None:
                    if (sec_name, f) in _BG_FIELDS:
                        sec.colors[f] = self.background
                    elif (sec_name, f) in _HL_FIELDS:
                        sec.colors[f] = hl
                    else:
                        sec.colors[f] = self.foreground
        return self

    def __getattr__(self, item):
        try:
            return self.__dict__["sections"][item]
        except KeyError:
            raise AttributeError(item)


def _builtin(name: str, bg, fg, hl) -> Theme:
    return Theme(
        name=name,
        background=Color.parse(bg),
        foreground=Color.parse(fg),
        highlight=Color.parse(hl),
    ).apply_global_as_default()


# 17 built-ins — same palettes as src/builtin_themes.rs:18-341.
_BUILTINS = {
    "Ayu Dark": ("#0f1419", "#e6e1cf", "#ffb454"),
    "Black & White": ("#000000", "#ffffff", "#808080"),
    "Catppuccin Frappé": ("#303446", "#c6d0f5", "#ca9ee6"),
    "Catppuccin Latte": ("#eff1f5", "#4c4f69", "#8839ef"),
    "Catppuccin Macchiato": ("#24273a", "#cad3f5", "#b7bdf8"),
    "Catppuccin Mocha": ("#1e1e2e", "#cdd6f4", "#cba6f7"),
    "Dracula": ("#282a36", "#f8f8f2", "#bd93f9"),
    "Gruvbox Dark": ("#282828", "#ebdbb2", "#fe8019"),
    "Material Dark": ("#263238", "#eceff1", "#03a9f4"),
    "Monokai": ("#272822", "#f8f8f2", "#f92672"),
    "Nord": ("#2e3440", "#d8dee9", "#88c0d0"),
    "One Dark": ("#282c34", "#abb2bf", "#c678dd"),
    "One Light": ("#eff1f5", "#505765", "#9828b7"),
    "Solarized Dark": ("#002b36", "#839496", "#2aa198"),
    "Solarized Light": ("#fdf6e3", "#657b83", "#268bd2"),
    "Tokyo Night": ("#1a1b26", "#c0caf5", "#bb9af7"),
    "White & Black": ("#ffffff", "#000000", "#808080"),
}


def list_themes() -> list[str]:
    return sorted(_BUILTINS)


def get_by_name(name: str) -> Theme | None:
    spec = _BUILTINS.get(name)
    return _builtin(name, *spec) if spec else None


def default_theme() -> Theme:
    return Theme().apply_global_as_default()


# --- TOML .theme files + persistence -------------------------------------------

def config_dir() -> str:
    # macOS forces ~/.config like the reference (src/tui.rs:2149-2157).
    if sys.platform == "darwin":
        base = os.path.expanduser("~/.config")
    else:
        base = os.environ.get(
            "XDG_CONFIG_HOME", os.path.expanduser("~/.config")
        )
    return os.path.join(base, "soundscope")


def load_theme_file(path: str) -> Theme:
    with open(path, "rb") as f:
        data = tomllib.load(f)
    g = data.get("global", {})
    t = Theme(
        name=os.path.basename(path),
        background=Color.parse(g.get("background", "black")),
        foreground=Color.parse(g.get("foreground", 221)),
        highlight=Color.parse(g["highlight"]) if "highlight" in g else None,
    )
    for sec_name, fields_ in _SECTION_FIELDS.items():
        src = data.get(sec_name, {})
        for f in fields_:
            if f in src:
                t.sections[sec_name].colors[f] = Color.parse(src[f])
    return t.apply_global_as_default()


def available_theme_files(cfg_dir: str | None = None) -> list[str]:
    d = cfg_dir or config_dir()
    if not os.path.isdir(d):
        return []
    return sorted(f for f in os.listdir(d) if f.endswith(".theme"))


def save_current_theme(selection: str, cfg_dir: str | None = None) -> None:
    """selection: 'DEFAULT' | 'builtin:<name>' | '<file>.theme'."""
    d = cfg_dir or config_dir()
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, ".current_theme"), "w") as f:
        f.write(selection)


def load_current_theme(cfg_dir: str | None = None) -> Theme:
    d = cfg_dir or config_dir()
    sel_path = os.path.join(d, ".current_theme")
    if not os.path.exists(sel_path):
        return default_theme()
    sel = open(sel_path).read().strip()
    if sel == "DEFAULT" or not sel:
        return default_theme()
    if sel.startswith("builtin:"):
        return get_by_name(sel[len("builtin:"):]) or default_theme()
    path = os.path.join(d, sel)
    if os.path.exists(path):
        try:
            return load_theme_file(path)
        except (OSError, tomllib.TOMLDecodeError, ValueError):
            return default_theme()
    return default_theme()
