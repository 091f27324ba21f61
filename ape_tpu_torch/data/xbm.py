"""X bitmap (XBM) reading without PIL, as PIL 12.1's ``XbmImagePlugin``
reads it, for ``image_io``.

``decode_xbm`` gives what ``Image.open(f)`` holds: ((H, W) bool, "1",
None), a set bit white. The header is PIL's regular expression on the
first 512 bytes (the width and height defines, an optional hotspot, then
anything up to the last ``_bits[]``); the data is read as PIL's XbmDecode.c
reads it: from each "x" the next two characters as a hexadecimal byte (any
other character as 0), then on to the next "x", the bits of a byte least
significant first, rows padded to whole bytes. So the X10 form's 16-bit
words ("0x1234") give their high byte only, as in PIL. Data that ends
before the image is full raises ``CorruptImage``.

PIL writes XBM only from mode "1" images, so ``image_io.write_image``,
which takes uint8 gray or RGB, has no XBM writer: ``.xbm`` raises, as
PIL's "cannot write mode RGB as XBM".
"""

from __future__ import annotations

import re

import numpy as np

from ape_tpu_torch.data.image_io import CorruptImage, bomb_check

# XbmImagePlugin.xbm_head
HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]"
)
_HEX = np.zeros(256, np.uint8)
for _c in b"0123456789":
    _HEX[_c] = _c - ord("0")
for _c in b"abcdef":
    _HEX[_c] = _HEX[_c - 32] = _c - ord("a") + 10


def accept(data: bytes) -> bool:
    """XbmImagePlugin._accept, on the 16 bytes ``Image.open`` hands it."""
    return data[:16].lstrip().startswith(b"#define")


def claims(data: bytes):
    """False where XBM's _accept refuses ``data``, a reason where its _open
    raises a SyntaxError (no header match, a size of zero), else True."""
    if not accept(data):
        return False
    m = HEAD.match(data[:512])
    if not m:
        return "not a XBM file"
    return "an XBM image of size zero" if not int(m["width"]) or not int(m["height"]) else True


def decode_xbm(data: bytes):
    """XBM bytes -> ((H, W) bool, "1", None)."""
    m = HEAD.match(data[:512]) if accept(data) else None
    if not m:
        raise CorruptImage("not a XBM file")
    width, height = int(m["width"]), int(m["height"])
    bomb_check(width, height)
    stride = (width + 7) // 8
    need = stride * height
    buf = np.frombuffer(data, np.uint8)
    xs = np.flatnonzero(buf[m.end():] == ord("x")) + m.end()
    if len(xs) and np.diff(xs).min(initial=3) < 3:  # an "x" inside a byte's digits: skip it
        kept, last = [], -3
        for x in xs.tolist():
            if x >= last + 3:
                kept.append(x)
                last = x
        xs = np.array(kept, np.int64)
    xs = xs[:need]
    if len(xs) < need or xs[-1] + 2 >= len(data):
        raise CorruptImage("image file is truncated")
    values = (_HEX[buf[xs + 1]] << 4) | _HEX[buf[xs + 2]]
    bits = np.unpackbits(values.reshape(height, stride), axis=1, bitorder="little")
    return bits[:, :width].astype(bool), "1", None
