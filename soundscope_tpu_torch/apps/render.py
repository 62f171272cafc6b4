"""Terminal rendering primitives: screen buffer, braille canvas, chart.

Replicates the reference's ratatui widgets (braille line charts with
bordered blocks and titled axes, src/tui.rs:632-1055) on a plain
cell-grid abstraction so the same draw code runs under curses (live TUI)
and under a text backend (tests, headless screenshots).
"""

from __future__ import annotations

from dataclasses import dataclass

from soundscope_tpu_torch.apps.themes import Color

# braille dot bit layout (2x4 per cell)
_DOT_BITS = ((0x01, 0x08), (0x02, 0x10), (0x04, 0x20), (0x40, 0x80))


@dataclass
class Cell:
    ch: str = " "
    fg: Color | None = None
    bg: Color | None = None
    bold: bool = False


class Screen:
    """A W x H grid of styled cells."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.cells = [[Cell() for _ in range(width)] for _ in range(height)]

    def fill(self, bg: Color):
        for row in self.cells:
            for c in row:
                c.ch, c.fg, c.bg, c.bold = " ", None, bg, False

    def put(self, x: int, y: int, ch: str, fg=None, bg=None, bold=False):
        if 0 <= x < self.width and 0 <= y < self.height:
            c = self.cells[y][x]
            c.ch = ch
            if fg is not None:
                c.fg = fg
            if bg is not None:
                c.bg = bg
            c.bold = bold

    def put_str(self, x: int, y: int, s: str, fg=None, bg=None, bold=False):
        for i, ch in enumerate(s):
            self.put(x + i, y, ch, fg, bg, bold)

    def text(self) -> str:
        """Plain-text dump (tests / screenshots)."""
        return "\n".join("".join(c.ch for c in row).rstrip() for row in self.cells)


@dataclass
class Rect:
    x: int
    y: int
    w: int
    h: int

    def inner(self) -> "Rect":
        return Rect(self.x + 1, self.y + 1, max(self.w - 2, 0), max(self.h - 2, 0))


@dataclass
class Span:
    text: str
    fg: Color | None = None
    bold: bool = False


def draw_block(
    scr: Screen,
    rect: Rect,
    border_fg: Color,
    bg: Color,
    title: list[Span] | None = None,
    title_right: list[Span] | None = None,
    bottom_left: list[Span] | None = None,
    bottom_center: list[Span] | None = None,
    bottom_right: list[Span] | None = None,
):
    """Rounded bordered block with ratatui-style title slots."""
    x, y, w, h = rect.x, rect.y, rect.w, rect.h
    if w < 2 or h < 2:
        return
    scr.put(x, y, "╭", border_fg, bg)
    scr.put(x + w - 1, y, "╮", border_fg, bg)
    scr.put(x, y + h - 1, "╰", border_fg, bg)
    scr.put(x + w - 1, y + h - 1, "╯", border_fg, bg)
    for i in range(1, w - 1):
        scr.put(x + i, y, "─", border_fg, bg)
        scr.put(x + i, y + h - 1, "─", border_fg, bg)
    for j in range(1, h - 1):
        scr.put(x, y + j, "│", border_fg, bg)
        scr.put(x + w - 1, y + j, "│", border_fg, bg)

    def put_spans(px, py, spans):
        cx = px
        for sp in spans:
            scr.put_str(cx, py, sp.text, sp.fg, bg, sp.bold)
            cx += len(sp.text)
        return cx

    if title:
        put_spans(x + 1, y, title)
    if title_right:
        total = sum(len(s.text) for s in title_right)
        put_spans(x + w - 1 - total, y, title_right)
    if bottom_left:
        put_spans(x + 1, y + h - 1, bottom_left)
    if bottom_center:
        total = sum(len(s.text) for s in bottom_center)
        put_spans(x + (w - total) // 2, y + h - 1, bottom_center)
    if bottom_right:
        total = sum(len(s.text) for s in bottom_right)
        put_spans(x + w - 1 - total, y + h - 1, bottom_right)


class BrailleCanvas:
    """Braille dot canvas over a cell rect (2x4 dots per cell), with a
    per-cell color (last writer wins, like ratatui's braille grid)."""

    def __init__(self, rect: Rect):
        self.rect = rect
        self.cols = rect.w
        self.rows = rect.h
        self.grid = [[0] * self.cols for _ in range(self.rows)]
        self.color = [[None] * self.cols for _ in range(self.rows)]

    @property
    def dots_x(self) -> int:
        return self.cols * 2

    @property
    def dots_y(self) -> int:
        return self.rows * 4

    def set_dot(self, dx: int, dy: int, color: Color):
        if 0 <= dx < self.dots_x and 0 <= dy < self.dots_y:
            cy, ry = divmod(dy, 4)
            cx, rx = divmod(dx, 2)
            self.grid[cy][cx] |= _DOT_BITS[ry][rx]
            self.color[cy][cx] = color

    def line(self, x0: float, y0: float, x1: float, y1: float, color: Color):
        """Dot-space line (floats, already scaled)."""
        steps = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
        for i in range(steps + 1):
            t = i / max(steps, 1)
            self.set_dot(round(x0 + (x1 - x0) * t), round(y0 + (y1 - y0) * t), color)

    def blit(self, scr: Screen, bg: Color):
        for r in range(self.rows):
            for c in range(self.cols):
                bits = self.grid[r][c]
                if bits:
                    scr.put(
                        self.rect.x + c, self.rect.y + r,
                        chr(0x2800 + bits), self.color[r][c], bg,
                    )


# 5x7 block-glyph font for the big-text empty state (the reference renders
# "Soundscope" with tui-big-text, src/tui.rs:598-630). Original glyph art —
# only the letters the app needs, extend on demand.
_BIG_FONT = {
    "S": (".███.", "█...█", "█....", ".███.", "....█", "█...█", ".███."),
    "o": (".....", ".....", ".███.", "█...█", "█...█", "█...█", ".███."),
    "u": (".....", ".....", "█...█", "█...█", "█...█", "█..██", ".██.█"),
    "n": (".....", ".....", "█.██.", "██..█", "█...█", "█...█", "█...█"),
    "d": ("....█", "....█", ".████", "█...█", "█...█", "█...█", ".████"),
    "s": (".....", ".....", ".████", "█....", ".███.", "....█", "████."),
    "c": (".....", ".....", ".███.", "█....", "█....", "█...█", ".███."),
    "p": (".....", ".....", "████.", "█...█", "████.", "█....", "█...."),
    "e": (".....", ".....", ".███.", "█...█", "█████", "█....", ".███."),
    " ": (".....",) * 7,
}
BIG_GLYPH_W, BIG_GLYPH_H = 6, 7  # 5 columns + 1 spacing


def big_text_width(text: str) -> int:
    return len(text) * BIG_GLYPH_W - 1


def draw_big_text(scr: Screen, x: int, y: int, text: str, fg: Color, bg: Color):
    """Render `text` in block glyphs at cell (x, y); unknown chars skipped."""
    for i, ch in enumerate(text):
        glyph = _BIG_FONT.get(ch) or _BIG_FONT.get(ch.lower())
        if glyph is None:
            continue
        gx = x + i * BIG_GLYPH_W
        for row, bits in enumerate(glyph):
            for col, bit in enumerate(bits):
                if bit != ".":
                    scr.put(gx + col, y + row, "█", fg, bg)


@dataclass
class Dataset:
    points: list  # [(x, y), ...]
    color: Color
    connect: bool = True  # GraphType::Line


def draw_chart(
    scr: Screen,
    rect: Rect,
    datasets: list[Dataset],
    x_bounds: tuple[float, float],
    y_bounds: tuple[float, float],
    bg: Color,
    x_labels: list[Span] | None = None,
    y_labels: list[Span] | None = None,
    axis_fg: Color | None = None,
):
    """Braille line chart inside `rect` (which EXCLUDES the block border).

    Mirrors ratatui Chart: optional labeled x axis at the bottom and
    y labels on the left; data clipped to bounds.
    """
    area = rect
    y_label_w = max((len(s.text) for s in (y_labels or [])), default=0)
    x_axis_h = 1 if x_labels else 0
    plot = Rect(area.x + y_label_w, area.y, area.w - y_label_w, area.h - x_axis_h)
    if plot.w <= 0 or plot.h <= 0:
        return
    if y_labels:
        # bottom label at the lowest row, top label at the top row
        scr.put_str(area.x, plot.y + plot.h - 1, y_labels[0].text, y_labels[0].fg, bg)
        if len(y_labels) > 2:
            scr.put_str(area.x, plot.y + plot.h // 2, y_labels[1].text, y_labels[1].fg, bg)
        if len(y_labels) > 1:
            scr.put_str(area.x, plot.y, y_labels[-1].text, y_labels[-1].fg, bg)
    if x_labels:
        yrow = area.y + area.h - 1
        scr.put_str(plot.x, yrow, x_labels[0].text, x_labels[0].fg, bg)
        if len(x_labels) > 2:
            mid = x_labels[1]
            scr.put_str(plot.x + (plot.w - len(mid.text)) // 2, yrow, mid.text, mid.fg, bg)
        if len(x_labels) > 1:
            last = x_labels[-1]
            scr.put_str(plot.x + plot.w - len(last.text), yrow, last.text, last.fg, bg)

    cv = BrailleCanvas(plot)
    (x0, x1), (y0, y1) = x_bounds, y_bounds
    if x1 <= x0 or y1 <= y0:
        return

    def to_dots(px, py):
        dx = (px - x0) / (x1 - x0) * (cv.dots_x - 1)
        dy = (1.0 - (py - y0) / (y1 - y0)) * (cv.dots_y - 1)
        return dx, dy

    for ds in datasets:
        prev = None
        for (px, py) in ds.points:
            inside = x0 <= px <= x1 and y0 <= py <= y1
            if not inside:
                prev = None
                continue
            dx, dy = to_dots(px, py)
            if ds.connect and prev is not None:
                cv.line(prev[0], prev[1], dx, dy, ds.color)
            else:
                cv.set_dot(round(dx), round(dy), ds.color)
            prev = (dx, dy)
    cv.blit(scr, bg)
