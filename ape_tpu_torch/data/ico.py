"""ICO reading without PIL, as PIL 12.1's ``IcoImagePlugin`` reads it, for
``image_io``.

``decode_ico`` gives what ``Image.open(f)`` holds: (samples, mode, palette)
of the entry PIL loads: the directory's entries sorted by color depth (the
bits, else the log2 of the color count, else 256), then by area, largest
first, and the first of them taken;

* a PNG entry: its samples as ``image_io._png_samples`` reads them, in
  PIL's PNG modes;
* a DIB entry: ``data.bmp`` on the bitmap header (height halved: the XOR
  image above the AND mask), then PIL's mask: at 32 bits per pixel the
  fourth byte of each pixel, else the AND mask (1 transparent), bottom-up,
  rows padded to 32 bits; either makes the image "RGBA" with that alpha.

A file PIL raises on (an empty directory, an entry past the file, a mask
cut short, a bitmap PIL's BMP reader refuses) raises ``CorruptImage``.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from ape_tpu_torch.data.bmp import decode_bmp
from ape_tpu_torch.data.image_io import PNG_MAGIC, CorruptImage, bomb_check, convert_rgb, png_image

ICO_MAGIC = b"\0\0\1\0"  # IcoImagePlugin._MAGIC


def _entries(data: bytes):
    if len(data) < 6 or not data.startswith(ICO_MAGIC):
        raise CorruptImage("not an ICO file")
    count = struct.unpack_from("<H", data, 4)[0]
    entries = []
    for i in range(count):
        s = data[6 + 16 * i:22 + 16 * i]
        if len(s) < 16:
            raise CorruptImage("truncated ICO directory")
        width, height = s[0] or 256, s[1] or 256
        nb_color, bpp = s[2], struct.unpack_from("<H", s, 6)[0]
        size, offset = struct.unpack_from("<II", s, 8)
        depth = bpp or (nb_color != 0 and math.ceil(math.log(nb_color, 2))) or 256
        entries.append(dict(dim=(width, height), square=width * height, depth=depth, bpp=bpp,
                            size=size, offset=offset))
    entries.sort(key=lambda e: e["depth"])
    entries.sort(key=lambda e: e["square"], reverse=True)
    if not entries:
        raise CorruptImage("an ICO file without entries")
    return entries


def decode_ico(data: bytes):
    """ICO bytes -> (samples, mode, palette) of the entry PIL opens."""
    entry = _entries(data)[0]
    at = entry["offset"]
    if data[at:at + 8] == PNG_MAGIC:
        return png_image(data[at:])
    return _dib(data, entry)


def _dib(data: bytes, entry):
    """PIL's DibImageFile of the entry, halved, with its mask."""
    at = entry["offset"]
    if len(data) < at + 16:
        raise CorruptImage("truncated ICO bitmap")
    header_size = struct.unpack_from("<I", data, at)[0]
    dib = bytearray(data[at:])
    if header_size == 12:
        width, height, _, bits = struct.unpack_from("<HHHH", dib, 4)
        half = int(height / 2)
        struct.pack_into("<H", dib, 6, half)
        colors, padding, compression = 1 << bits, 3, 0
    else:
        width, height = struct.unpack_from("<Ii", dib, 4)
        bits, compression, used = (struct.unpack_from("<H", dib, 14)[0],
                                   struct.unpack_from("<I", dib, 16)[0],
                                   struct.unpack_from("<I", dib, 32)[0])
        bomb_check(width, abs(height))
        half = int(height / 2)
        struct.pack_into("<i", dib, 8, half)
        colors, padding = used or 1 << bits, 4
    # the pixels start after the header, the bitfield masks and the palette,
    # where PIL's DibImageFile finds them
    start = 14 + header_size
    if header_size == 40 and compression == 3:
        start += 12
    if bits <= 8:
        start += padding * colors
    bmp = b"BM" + struct.pack("<IHHI", 14 + len(dib), 0, 0, start) + bytes(dib)
    samples, mode, palette = decode_bmp(bmp)
    height = abs(half)
    pixel_start = at + start - 14
    if entry["bpp"] == 32:
        alpha_bytes = data[pixel_start:pixel_start + width * height * 4][3::4]
        if len(alpha_bytes) < width * height:
            raise CorruptImage("not enough image data for the ICO alpha")
        alpha = np.frombuffer(alpha_bytes, np.uint8).reshape(height, width)[::-1]
    else:
        w = width + (-width % 32)
        total = w * height // 8
        mask_at = at + entry["size"] - total
        mask = data[mask_at:mask_at + total] if mask_at >= 0 else b""
        if len(mask) < total:
            raise CorruptImage("not enough image data for the ICO mask")
        mask_bits = np.unpackbits(np.frombuffer(mask, np.uint8).reshape(height, w // 8), axis=1)
        alpha = np.where(mask_bits[::-1, :width] == 1, 0, 255).astype(np.uint8)
    rgb = convert_rgb(samples, mode, palette)
    return np.concatenate([rgb, alpha[..., None]], -1), "RGBA", None
