"""GIF reading without PIL: the first frame as PIL 12.1's ``Image.open(f)``
presents it (``GifImagePlugin.py``), for ``image_io``. The blocks are parsed
here; the LZW image data is decoded by the host library's ``ape_gif_lzw``
(``csrc/gif_host.cpp``).

PIL's frame-0 rules, as ``_open``, ``_seek(0)`` and ``load_prepare`` apply
them:

* the logical screen sets the size, grown to hold the first frame where
  its extent passes the screen;
* a palette (the frame's local one, else the global one) that is not the
  identity gray ramp (entry i = (i, i, i)) gives mode "P"; none, or an
  identity ramp, gives mode "L", whose samples are the indices (and which
  ``convert("RGB")`` still looks up in a global palette that is no ramp,
  as PIL keeps that palette on the image);
* outside the frame the image holds the transparency index of the graphic
  control extension before the frame, else 0; ``convert("RGB")`` ignores
  transparency;
* bytes that start no block are skipped; an extension's first sub-block is
  read for the graphic control extension's flags and transparency;
* an empty frame raises, except one at x 0 and 0 wide, which PIL's decoder
  takes as the whole image.

``decode_gif`` returns (samples (H, W) uint8, palette (N, 3) uint8 or None);
``image_io`` looks the palette up. A file PIL raises on raises
``CorruptImage``.
"""

from __future__ import annotations

import struct

import numpy as np

from ape_tpu_torch.data.image_io import CorruptImage, bomb_check

GIF_MAGICS = (b"GIF87a", b"GIF89a")  # PIL's GifImagePlugin._accept


class _Reader:
    """A file object's ``read`` over bytes: short reads at the end."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        self.pos += len(out)
        return out

    def sub_block(self):
        """GifImageFile.data: one sub-block, or None at its terminator."""
        s = self.read(1)
        return self.read(s[0]) if s and s[0] else None


def decode_gif(data: bytes):
    """GIF bytes -> (the first frame's samples (H, W) uint8, its palette
    (N, 3) uint8, or None in mode "L")."""
    if len(data) < 13 or not data.startswith(GIF_MAGICS):
        raise CorruptImage("not a GIF file")
    width, height = struct.unpack("<HH", data[6:10])
    flags = data[10]
    f = _Reader(data, 13)
    global_palette = None
    if flags & 128:
        p = f.read(3 << ((flags & 7) + 1))
        if _palette_needed(p):
            global_palette = p
    transparency, frame = None, None
    while True:
        s = f.read(1)
        if not s or s == b";":
            break
        if s == b"!":
            label = f.read(1)
            block = f.sub_block()
            if not label:
                raise CorruptImage("truncated GIF extension")
            if label[0] == 249 and block is not None:  # graphic control extension
                if len(block) < 3 or (block[0] & 1 and len(block) < 4):
                    raise CorruptImage("truncated graphic control extension")
                if block[0] & 1:
                    transparency = block[3]
            elif label[0] == 254:  # comment: the loop reads its sub-blocks
                while block:
                    block = f.sub_block()
                continue
            elif label[0] == 255 and block is not None and block.startswith(b"NETSCAPE2.0"):
                f.sub_block()  # the loop count, read before the skip below
            while f.sub_block():
                pass
        elif s == b",":
            s = f.read(9)
            if len(s) < 9:
                raise CorruptImage("truncated GIF image descriptor")
            x0, y0, fw, fh, fflags = struct.unpack("<HHHHB", s)
            local = None
            if fflags & 128:
                p = f.read(3 << ((fflags & 7) + 1))
                local = p if _palette_needed(p) else False
            bits = f.read(1)
            if not bits:
                raise CorruptImage("truncated GIF image data")
            frame = (x0, y0, x0 + fw, y0 + fh, bool(fflags & 64), bits[0], f.pos, local)
            break
    if frame is None:
        raise CorruptImage("image not found in GIF frame")
    x0, y0, x1, y1, interlace, bits, offset, local = frame
    width, height = max(width, x1), max(height, y1)
    if width == 0 or height == 0:
        raise CorruptImage("an empty GIF image")  # PIL's ImageFile identifies no such image
    bomb_check(width, height)
    # an identity local palette leaves the frame in mode "L", but PIL keeps
    # the global palette on the image, which its convert("RGB") applies
    palette = local if local else global_palette
    samples = np.full((height, width), transparency or 0, np.uint8)
    if x0 == 0 and x1 == 0:  # PIL's setimage reads the extent (0, y0, 0, y1) as the whole image
        y0, x1, y1 = 0, width, height
    fw, fh = x1 - x0, y1 - y0
    if fw <= 0 or fh <= 0:
        raise CorruptImage("tile cannot extend outside image")  # an empty frame
    from ape_tpu_torch.ops._build import host_library

    pixels = np.empty((fh, fw), np.uint8)
    rc = host_library().ape_gif_lzw(data, len(data), offset, bits, int(interlace), fw, fh,
                                    pixels.ctypes.data)
    if rc:
        raise CorruptImage({1: "broken GIF image data", 2: "image file is truncated",
                            3: f"GIF code size {bits}"}[rc])
    samples[y0:y1, x0:x1] = pixels
    if not palette:
        return samples, None
    return samples, _palette_array(palette)


def _palette_needed(p: bytes) -> bool:
    """GifImageFile._is_palette_needed: anything but the identity gray ramp
    (entry i = (i, i, i)); a palette cut inside an entry raises there."""
    for i in range(0, len(p), 3):
        if i + 2 >= len(p):
            raise CorruptImage("truncated GIF palette")
        if not (i // 3 == p[i] == p[i + 1] == p[i + 2]):
            return True
    return False


def _palette_array(p: bytes) -> np.ndarray:
    return np.frombuffer(p[:len(p) // 3 * 3], np.uint8).reshape(-1, 3)
