"""Minimal dependency-free PNG writers + telemetry plot renderer.

The port's own copy of
``project_desert_tortoise_tpu/utils/png.py``: numpy only, as
the port imports nothing of the JAX package.

Covers the MATLAB prototype's image/figure products without matplotlib:
``imwrite(..., 'HIRS<n>.png')`` grayscale images (POES.m:855) and the
analog-telemetry / SEM / SBUV line plots (POES.m:513, 1314-1779, 1780-1972)
rendered as RGB PNGs by :func:`render_series_png`."""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Sequence, Tuple

import numpy as np


def _png_bytes(img: np.ndarray, color_type: int) -> bytes:
    h, w = img.shape[:2]

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 9)) + chunk(b"IEND", b""))


def write_gray_png(path: str, img: np.ndarray):
    """img: (h, w) uint8."""
    with open(path, "wb") as f:
        f.write(_png_bytes(np.asarray(img, np.uint8), 0))


def write_rgb_png(path: str, img: np.ndarray):
    """img: (h, w, 3) uint8."""
    with open(path, "wb") as f:
        f.write(_png_bytes(np.ascontiguousarray(img, np.uint8), 2))


# ---------------------------------------------------------------------------
# line-plot renderer (telemetry figure products)
# ---------------------------------------------------------------------------

# classic 5x7 column-encoded glyphs (LSB = top row); lowercase maps to upper
_FONT = {
    "0": (0x3E, 0x51, 0x49, 0x45, 0x3E), "1": (0x00, 0x42, 0x7F, 0x40, 0x00),
    "2": (0x42, 0x61, 0x51, 0x49, 0x46), "3": (0x21, 0x41, 0x45, 0x4B, 0x31),
    "4": (0x18, 0x14, 0x12, 0x7F, 0x10), "5": (0x27, 0x45, 0x45, 0x45, 0x39),
    "6": (0x3C, 0x4A, 0x49, 0x49, 0x30), "7": (0x01, 0x71, 0x09, 0x05, 0x03),
    "8": (0x36, 0x49, 0x49, 0x49, 0x36), "9": (0x06, 0x49, 0x49, 0x29, 0x1E),
    "A": (0x7E, 0x11, 0x11, 0x11, 0x7E), "B": (0x7F, 0x49, 0x49, 0x49, 0x36),
    "C": (0x3E, 0x41, 0x41, 0x41, 0x22), "D": (0x7F, 0x41, 0x41, 0x22, 0x1C),
    "E": (0x7F, 0x49, 0x49, 0x49, 0x41), "F": (0x7F, 0x09, 0x09, 0x09, 0x01),
    "G": (0x3E, 0x41, 0x49, 0x49, 0x7A), "H": (0x7F, 0x08, 0x08, 0x08, 0x7F),
    "I": (0x00, 0x41, 0x7F, 0x41, 0x00), "J": (0x20, 0x40, 0x41, 0x3F, 0x01),
    "K": (0x7F, 0x08, 0x14, 0x22, 0x41), "L": (0x7F, 0x40, 0x40, 0x40, 0x40),
    "M": (0x7F, 0x02, 0x0C, 0x02, 0x7F), "N": (0x7F, 0x04, 0x08, 0x10, 0x7F),
    "O": (0x3E, 0x41, 0x41, 0x41, 0x3E), "P": (0x7F, 0x09, 0x09, 0x09, 0x06),
    "Q": (0x3E, 0x41, 0x51, 0x21, 0x5E), "R": (0x7F, 0x09, 0x19, 0x29, 0x46),
    "S": (0x46, 0x49, 0x49, 0x49, 0x31), "T": (0x01, 0x01, 0x7F, 0x01, 0x01),
    "U": (0x3F, 0x40, 0x40, 0x40, 0x3F), "V": (0x1F, 0x20, 0x40, 0x20, 0x1F),
    "W": (0x3F, 0x40, 0x38, 0x40, 0x3F), "X": (0x63, 0x14, 0x08, 0x14, 0x63),
    "Y": (0x07, 0x08, 0x70, 0x08, 0x07), "Z": (0x61, 0x51, 0x49, 0x45, 0x43),
    " ": (0, 0, 0, 0, 0), "-": (0x08, 0x08, 0x08, 0x08, 0x08),
    ".": (0x00, 0x60, 0x60, 0x00, 0x00), ":": (0x00, 0x36, 0x36, 0x00, 0x00),
    "/": (0x20, 0x10, 0x08, 0x04, 0x02), "+": (0x08, 0x08, 0x3E, 0x08, 0x08),
    "_": (0x40, 0x40, 0x40, 0x40, 0x40), ",": (0x00, 0x50, 0x30, 0x00, 0x00),
    "(": (0x00, 0x1C, 0x22, 0x41, 0x00), ")": (0x00, 0x41, 0x22, 0x1C, 0x00),
    "=": (0x14, 0x14, 0x14, 0x14, 0x14), "[": (0x00, 0x7F, 0x41, 0x41, 0x00),
    "]": (0x00, 0x41, 0x41, 0x7F, 0x00), "*": (0x14, 0x08, 0x3E, 0x08, 0x14),
    "%": (0x23, 0x13, 0x08, 0x64, 0x62), "'": (0x00, 0x05, 0x03, 0x00, 0x00),
}

# fixed-order categorical palette (Okabe-Ito subset); order chosen so every
# adjacent pair keeps OKLab dE*100 >= 10.7 under protan/deutan/tritan
# simulation (computed, not eyeballed) — identity is never color-alone anyway:
# each series also gets a direct label at its last point
SERIES_COLORS = [(0x00, 0x72, 0xB2), (0xE6, 0x9F, 0x00), (0x00, 0x9E, 0x73),
                 (0x56, 0xB4, 0xE9), (0xD5, 0x5E, 0x00), (0xCC, 0x79, 0xA7)]
_INK = (40, 40, 40)          # text / axes
_GRID = (225, 225, 225)      # recessive gridlines
_BG = (255, 255, 255)


class Canvas:
    """A tiny raster canvas: lines, dots, 5x7 text — enough for the MATLAB
    figure twins without a plotting dependency."""

    def __init__(self, w: int, h: int):
        self.img = np.full((h, w, 3), _BG, np.uint8)
        self.h, self.w = h, w

    def text(self, x: int, y: int, s: str, color=_INK, scale: int = 1):
        for ch in str(s).upper():
            cols = _FONT.get(ch, _FONT[" "])
            for cx, bits in enumerate(cols):
                for cy in range(7):
                    if (bits >> cy) & 1:
                        self.img[y + cy * scale:y + (cy + 1) * scale,
                                 x + cx * scale:x + (cx + 1) * scale] = color
            x += 6 * scale

    @staticmethod
    def text_w(s: str, scale: int = 1) -> int:
        return 6 * scale * len(str(s))

    def hline(self, y: int, x0: int, x1: int, color=_INK):
        if 0 <= y < self.h:
            self.img[y, max(x0, 0):min(x1, self.w)] = color

    def vline(self, x: int, y0: int, y1: int, color=_INK):
        if 0 <= x < self.w:
            self.img[max(y0, 0):min(y1, self.h), x] = color

    def dot(self, x: int, y: int, color, r: int = 2):
        self.img[max(y - r, 0):y + r + 1, max(x - r, 0):x + r + 1] = color

    def line(self, x0: int, y0: int, x1: int, y1: int, color, width: int = 2):
        n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) + 1
        xs = np.linspace(x0, x1, n).round().astype(int)
        ys = np.linspace(y0, y1, n).round().astype(int)
        m = (xs >= 0) & (xs < self.w) & (ys >= 0) & (ys < self.h)
        for dx in range(width):
            for dy in range(width):
                xm = np.clip(xs[m] + dx, 0, self.w - 1)
                ym = np.clip(ys[m] + dy, 0, self.h - 1)
                self.img[ym, xm] = color


def _nice_ticks(lo: float, hi: float, n: int = 5):
    if not np.isfinite(lo) or not np.isfinite(hi) or hi <= lo:
        return [lo], lo, (lo + 1.0)
    span = hi - lo
    step = 10.0 ** np.floor(np.log10(span / n))
    for mult in (1, 2, 5, 10):
        if span / (step * mult) <= n:
            step *= mult
            break
    t0 = np.ceil(lo / step) * step
    ticks = list(np.arange(t0, hi + step * 0.01, step))
    return ticks, lo, hi


def _fmt(v: float) -> str:
    if v == int(v) and abs(v) < 1e7:
        return str(int(v))
    return f"{v:.4g}"


def render_series_png(path: str,
                      series: Dict[str, Tuple[Sequence, Sequence]],
                      title: str = "", xlabel: str = "", ylabel: str = "",
                      size: Tuple[int, int] = (900, 420),
                      markers: bool = True):
    """Render named (x, y) series as a line plot PNG.

    The figure-product twin of the MATLAB prototype's analog/SEM/SBUV plots
    (``POES.m:513,1314-1972``): one y-axis, recessive grid, fixed-order
    colorblind-validated series colors, a legend plus direct labels at each
    series' last point (identity is never color-alone)."""
    w, h = size
    ml, mr, mt, mb = 70, 110, 28, 44          # margins: legend lives right
    cv = Canvas(w, h)
    items = [(k, np.asarray(x, float), np.asarray(y, float))
             for k, (x, y) in series.items()
             if len(np.asarray(x)) and len(np.asarray(x)) == len(np.asarray(y))]
    if title:
        cv.text((w - cv.text_w(title)) // 2, 8, title)
    if not items:
        cv.text(ml, h // 2, "NO DATA")
        write_rgb_png(path, cv.img)
        return

    all_x = np.concatenate([x for _, x, _ in items])
    all_y = np.concatenate([y for _, _, y in items])
    fin = np.isfinite(all_x) & np.isfinite(all_y)
    if not fin.any():
        cv.text(ml, h // 2, "NO FINITE DATA")
        write_rgb_png(path, cv.img)
        return
    x_lo, x_hi = float(all_x[fin].min()), float(all_x[fin].max())
    y_lo, y_hi = float(all_y[fin].min()), float(all_y[fin].max())
    if x_hi <= x_lo:
        x_hi = x_lo + 1.0
    if y_hi <= y_lo:
        y_hi = y_lo + 1.0
    pad = 0.05 * (y_hi - y_lo)
    y_lo, y_hi = y_lo - pad, y_hi + pad

    px = lambda x: int(ml + (x - x_lo) / (x_hi - x_lo) * (w - ml - mr))
    py = lambda y: int(h - mb - (y - y_lo) / (y_hi - y_lo) * (h - mt - mb))

    xt, _, _ = _nice_ticks(x_lo, x_hi)
    yt, _, _ = _nice_ticks(y_lo, y_hi)
    for t in xt:
        cv.vline(px(t), mt, h - mb, _GRID)
        lbl = _fmt(t)
        cv.text(px(t) - cv.text_w(lbl) // 2, h - mb + 6, lbl)
    for t in yt:
        cv.hline(py(t), ml, w - mr, _GRID)
        lbl = _fmt(t)
        cv.text(ml - 6 - cv.text_w(lbl), py(t) - 3, lbl)
    cv.hline(h - mb, ml, w - mr)              # axes on top of grid
    cv.vline(ml, mt, h - mb + 1)
    if xlabel:
        cv.text((w - cv.text_w(xlabel)) // 2, h - 14, xlabel)
    if ylabel:
        cv.text(4, mt - 16 if mt >= 24 else 4, ylabel)

    for i, (name, x, y) in enumerate(items):
        color = SERIES_COLORS[i % len(SERIES_COLORS)]
        pts = [(px(a), py(b)) for a, b in zip(x, y)
               if np.isfinite(a) and np.isfinite(b)]
        for (a0, b0), (a1, b1) in zip(pts[:-1], pts[1:]):
            cv.line(a0, b0, a1, b1, color)
        if markers or len(pts) == 1:
            for a, b in pts:
                cv.dot(a, b, color)
        # legend row (swatch + name) and a direct label at the last point;
        # rows beyond the plot height are dropped (the direct point label
        # still identifies the series) instead of silently clipping
        ly = mt + 4 + i * 14
        if ly + 8 <= h - mb:
            cv.img[ly:ly + 8, w - mr + 8:w - mr + 16] = color
            cv.text(w - mr + 20, ly, name[:14])
        if pts:
            cv.text(min(pts[-1][0] + 6, w - cv.text_w(name[:8]) - 2),
                    max(pts[-1][1] - 8, 0), name[:8], color)
    write_rgb_png(path, cv.img)


def autoscale_u8(img: np.ndarray, clip_sigma: float = 2.0) -> np.ndarray:
    """Robust 0-255 scaling like the MATLAB HIRS display path
    (mean +/- k*std windowing, POES.m:829-848)."""
    x = np.asarray(img, np.float64)
    vals = x[x != 0]
    if len(vals) == 0:
        return np.zeros(x.shape, np.uint8)
    lo = vals.mean() - clip_sigma * vals.std()
    hi = vals.mean() + clip_sigma * vals.std()
    if hi <= lo:
        hi = lo + 1
    return np.clip((x - lo) / (hi - lo) * 255.0, 0, 255).astype(np.uint8)
