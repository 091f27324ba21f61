"""Sun raster reading without PIL, as PIL 12.1's ``SunImagePlugin`` reads
it, for ``image_io``. PIL registers no Sun writer, so neither does the port.

``decode_sun`` gives what ``Image.open(f)`` holds: (samples, mode,
palette):

* depth 1 (mode "1", a set bit black: PIL's "1;I"), 4 (mode "L", each
  nibble times 17) and 8 (mode "L"); with a colour map (type 1, RGB planes
  of at most 1024 bytes) the 4- and 8-bit images are mode "P" (indices,
  the palette (N, 3));
* depth 24 and 32 (mode "RGB"): blue first, unless the file type is 3
  (RGB order); the fourth byte of a 32-bit pixel skipped;
* file types 0, 1, 3, 4 and 5 stored raw, rows padded to 16 bits; type 2
  run-length coded (0x80 n v: n + 1 bytes v; 0x80 0: one 0x80), decoded by
  the host library (``csrc/raster_host.cpp``, PIL's SunRleDecode.c: rows
  not padded, a run going on into the rows below).

A header PIL's _open refuses (another depth, file type or colour map type,
a map past 1024 bytes, a size of zero) is no Sun file to
``image_io.sniff``: ``Image.open`` then finds no plugin and raises, so the
port raises ``CorruptImage``, as it does for data cut short and for a
colour map on a 1-, 24- or 32-bit image (PIL opens the file and fails to
put the map on the image).
"""

from __future__ import annotations

import struct

import numpy as np

from ape_tpu_torch.data.image_io import CorruptImage, bomb_check

MAGIC = 0x59A66A95


def _header(data: bytes):
    """(width, height, depth, file type, palette bytes, mode, raw mode), or
    a reason where ``SunImageFile._open`` raises a SyntaxError."""
    if len(data) < 4 or struct.unpack_from(">I", data)[0] != MAGIC:
        return "not an SUN raster file"
    if len(data) < 32:
        return "truncated Sun raster header"
    _, width, height, depth, _, file_type, map_type, map_length = struct.unpack_from(">8I", data)
    modes = {1: ("1", "1;I"), 4: ("L", "L;4"), 8: ("L", "L"),
             24: ("RGB", "RGB" if file_type == 3 else "BGR"),
             32: ("RGB", "RGBX" if file_type == 3 else "BGRX")}
    if depth not in modes:
        return "Unsupported Mode/Bit Depth"
    mode, rawmode = modes[depth]
    if map_length:
        if map_length > 1024:
            return "Unsupported Color Palette Length"
        if map_type != 1:
            return "Unsupported Palette Type"
        if mode == "L":
            mode, rawmode = "P", rawmode.replace("L", "P")
    if file_type not in (0, 1, 2, 3, 4, 5):
        return "Unsupported Sun Raster file type"
    if not width or not height:
        return "a Sun raster image of size zero"
    return width, height, depth, file_type, map_length, mode, rawmode


def claims(data: bytes):
    """False where Sun's _accept refuses ``data``, a reason where its _open
    raises a SyntaxError, else True."""
    if len(data) < 4 or struct.unpack_from(">I", data)[0] != MAGIC:
        return False
    got = _header(data)
    return got if isinstance(got, str) else True


def decode_sun(data: bytes):
    """Sun raster bytes -> (samples, mode, palette): (H, W) bool for "1",
    uint8 for "L" and "P" (palette (N, 3)), (H, W, 3) for "RGB"."""
    got = _header(data)
    if isinstance(got, str):
        raise CorruptImage(got)
    width, height, depth, file_type, map_length, mode, rawmode = got
    bomb_check(width, height)
    palette = None
    if map_length:
        if mode != "P":
            raise CorruptImage(f"unrecognized image mode (a colour map on a {depth}-bit Sun "
                               "raster file)")
        table = np.frombuffer(data, np.uint8, min(map_length, len(data) - 32), 32)
        n = len(table) // 3  # PIL's "RGB;L": the red, green and blue planes
        palette = np.stack([table[:n], table[n:2 * n], table[2 * n:3 * n]], -1)
    offset = 32 + map_length
    if file_type == 2:
        from ape_tpu_torch.ops._build import host_library

        stride = (width * depth + 7) // 8
        rows = np.zeros((height, stride), np.uint8)
        if host_library().ape_sun_rle(data, len(data), offset, stride, height, rows.ctypes.data):
            raise CorruptImage("image file is truncated")
    else:
        stride = ((width * depth + 15) // 16) * 2
        if len(data) < offset + stride * height:
            raise CorruptImage("image file is truncated")
        rows = np.frombuffer(data, np.uint8, stride * height, offset).reshape(height, stride)
    if depth == 1:
        samples = np.unpackbits(rows, axis=1)[:, :width] == 0
    elif depth == 4:
        nibbles = np.stack([rows >> 4, rows & 15], -1).reshape(height, -1)[:, :width]
        samples = nibbles * np.uint8(17) if mode == "L" else nibbles
    elif depth == 8:
        samples = rows[:, :width]
    else:
        px = rows[:, :width * depth // 8].reshape(height, width, depth // 8)
        samples = px[..., :3] if rawmode.startswith("RGB") else px[..., 2::-1]
    return np.ascontiguousarray(samples), mode, palette
