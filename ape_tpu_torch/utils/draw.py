"""Drawing without PIL: what JAX's ``VisualizationDemo.draw``
(``demo/predictor_lazy.py``) and ``tools/visualize_json_results.py`` do with
``PIL.ImageDraw`` and ``Image.alpha_composite``, in NumPy, bit for bit with
Pillow 12.1 except the label text:

* ``palette``: the per-class colours (HSV hues at saturation 0.8, value
  0.95, each channel truncated to an integer).
* ``draw_rectangle``: ``ImageDraw.rectangle(xy, outline=ink, width=w)``: the
  corners truncated toward zero (``int()``), x1 < x0 or y1 < y0 raise as
  Pillow raises; ``w`` rows of horizontal lines (each clipped to the image)
  inset from the top and bottom, and ``w`` columns of vertical lines from
  ``y0 + w`` up to, not including, ``y1 - w + 1`` (Pillow's line drawing
  steps from its first end and stops before its last, downward or upward).
  The ink replaces the pixel, alpha included, as ``ImageDraw.Draw`` of an
  image in its own mode does.
* ``alpha_composite``: Pillow's integer formula (7 extra bits of precision,
  divisions by 255 rounded by shifts), RGBA over RGBA.
* ``draw_label``: the one difference from JAX's image. Pillow's default font
  is FreeType's (Aileron Regular at 10 px, placed to sub-pixels and
  anti-aliased), which cannot be reproduced without FreeType; the port draws
  the same font from ``GLYPHS``, a 1-bit table of it (printable ASCII,
  coverage at least half, advances rounded to whole pixels), with its top at
  the anchor JAX passes, in the ink given.
"""

from __future__ import annotations

import colorsys
import math
from typing import List, Sequence, Tuple

import numpy as np

# GLYPHS: for each printable ASCII character from " " to "~", one hex entry:
# its advance, its width w, then GLYPH_ROWS rows of ceil(w / 4) hex digits
# each, most significant bit leftmost. Aileron Regular (CC0), rasterised by
# FreeType at 10 px with the top of the text at row 0; row GLYPH_TOP is the
# first row that any glyph inks.
GLYPH_TOP, GLYPH_ROWS = 1, 11
GLYPHS = """
    20 3201111110100 3303330000000 65000104040f020f0a080000 76000415141c0605150e0400
    7700225054280a1505220000 77001c20221f2222221e0000 1101110000000 4301022222110
    3202011111220 750000000002020205000000 7600000004041f0404000000 2100000000100
    3200000300000 2100000000100 3301102200400 65000e1111111111110e0000 6403511111100
    6500060901010204080f0000 65000e0101060111110e0000 660002060a0a121f02020000
    65000f00001e1101110e0000 65000e0910161111110e0000 65001f010202040408080000
    65000e11110e1111110e0000 65000e1111110d01120e0000 2100010000100 2100010001000
    6500000000030c0802000000 65000000000f000f00000000 65000000000c030104000000 4406911220200
    a900001c06205d0a50a50a9096040038000 6600040c0a021e1111210000 66001e1111101f11111e0000
    76000e1121202021110e0000 77003c2221212121223c0000 66001e1010101e10101f0000
    65000f0808080f0808080000 76000e1121202321111d0000 8700212121213f2121210000 3201111111100
    650001010101010909060000 6600111214141c1412110000 6600101010101010101f0000
    980063636341555549490000 870031312929252523230000 77001c2241414141221c0000
    66001e1111111e1010100000 77001c2241414141221e0000 66001e1111111e1011110000
    66000e11100c0301110e0000 66001f040404040404040000 7600111111111111110e0000
    6600211111120a0a0c040000 a90001190990990890a0026066046000000 660011120a0c0c0a12110000
    660011110a0e040404040000 76001f0102040408101f0000 3332222222230 3304402200100
    3231111111130 650000000602080900000000 5400000000070 30 5400069399f00
    660010101e111111111e0000 550000000e111010110e0000 650001010f111111110f0000
    650000000e111f10110e0000 3302232222200 650000000f111111110f110e 760010101e11111111110000
    3200011111100 3200011111113 65000808090a0c0e0a090000 3201111111100
    980000007649494949490000 760000001e11111111110000 550000000e111111110e0000
    660000001e111111111e1010 650000000f111111110f0101 4300032222200 4400069c39600
    3300272222300 7600000011111111110f0000 5500000011010a0a06040000 8800000099985a4a66240000
    5400095225900 5500000011010a0a04040408 650000000f010204040f0000 3211111111110
    3211111111111 3211111111110 6500000000000c0b00000000
""".split()


def _parse_glyphs():
    out = {}
    for code, entry in zip(range(32, 127), GLYPHS):
        advance, width = int(entry[0], 16), int(entry[1], 16)
        digits = -(-width // 4)
        rows = [int(entry[2 + r * digits:2 + (r + 1) * digits] or "0", 16)
                for r in range(GLYPH_ROWS)]
        bits = np.array([[(row >> (width - 1 - x)) & 1 for x in range(width)] for row in rows],
                        bool).reshape(GLYPH_ROWS, width)
        out[chr(code)] = (advance, bits)
    return out


_GLYPHS = _parse_glyphs()


def palette(n: int) -> List[Tuple[int, int, int]]:
    """JAX's ``_colors``: n hues at saturation 0.8, value 0.95."""
    return [tuple(int(255 * c) for c in colorsys.hsv_to_rgb(i / max(n, 1), 0.8, 0.95))
            for i in range(n)]


def _hline(canvas: np.ndarray, x0: int, y: int, x1: int, ink) -> None:
    h, w = canvas.shape[:2]
    if not 0 <= y < h:
        return
    x0, x1 = min(x0, x1), max(x0, x1)
    if x0 >= w or x1 < 0:
        return
    canvas[y, max(x0, 0):min(x1, w - 1) + 1] = ink


def _vline(canvas: np.ndarray, x: int, y0: int, y1: int, ink) -> None:
    """Pillow's line from (x, y0) to (x, y1): |y1 - y0| points from y0
    toward y1, y1 itself left out, each clipped to the image."""
    h, w = canvas.shape[:2]
    if not 0 <= x < w or y0 == y1:
        return
    step = 1 if y1 > y0 else -1
    ys = np.arange(y0, y1, step)
    ys = ys[(ys >= 0) & (ys < h)]
    canvas[ys, x] = ink


def draw_rectangle(canvas: np.ndarray, xy: Sequence[float], ink, width: int = 1) -> None:
    """``ImageDraw.rectangle(xy, outline=ink, width=width)`` on a uint8 (H, W,
    C) canvas, in place; ``ink`` has C channels."""
    if xy[2] < xy[0]:
        raise ValueError("x1 must be greater than or equal to x0")
    if xy[3] < xy[1]:
        raise ValueError("y1 must be greater than or equal to y0")
    x0, y0, x1, y1 = (int(v) for v in xy)  # a C cast: toward zero
    ink = np.asarray(ink, canvas.dtype)
    for i in range(width):
        _hline(canvas, x0, y0 + i, x1, ink)
        _hline(canvas, x0, y1 - i, x1, ink)
        _vline(canvas, x1 - i, y0 + width, y1 - width + 1, ink)
        _vline(canvas, x0 + i, y0 + width, y1 - width + 1, ink)


def alpha_composite(dst: np.ndarray, src: np.ndarray) -> np.ndarray:
    """``Image.alpha_composite(dst, src)`` of two uint8 (H, W, 4) arrays."""
    d = dst.astype(np.uint32)
    s = src.astype(np.uint32)
    sa, da = s[..., 3], d[..., 3]
    blend = da * (255 - sa)
    outa255 = sa * 255 + blend
    # outa255 is 0 only where both alphas are, pixels the last line takes from dst
    coef1 = sa * 255 * 255 * (1 << 7) // np.maximum(outa255, 1)
    coef2 = 255 * (1 << 7) - coef1

    def div255(x):
        return ((x >> 8) + x) >> 8

    out = np.empty_like(dst)
    for c in range(3):
        tmp = s[..., c] * coef1 + d[..., c] * coef2 + (0x80 << 7)
        out[..., c] = (div255(tmp) >> 7).astype(np.uint8)
    out[..., 3] = div255(outa255 + 0x80).astype(np.uint8)
    return np.where((sa == 0)[..., None], dst, out)


def draw_label(canvas: np.ndarray, xy: Sequence[float], text: str, ink) -> None:
    """``text`` from ``GLYPHS`` on a uint8 (H, W, C) canvas, in place: the
    text's top-left at ``xy`` (floored to pixels), each inked pixel set to
    ``ink``. A character outside printable ASCII draws as "?"."""
    h, w = canvas.shape[:2]
    x, y = math.floor(xy[0]), math.floor(xy[1]) + GLYPH_TOP
    ink = np.asarray(ink, canvas.dtype)
    for ch in text:
        advance, bits = _GLYPHS.get(ch, _GLYPHS["?"])
        ys, xs = np.nonzero(bits)
        ys, xs = ys + y, xs + x
        keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        canvas[ys[keep], xs[keep]] = ink
        x += advance
