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

import math
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


# --- writing: PIL 12.1's GifImagePlugin._save of one frame

def quantize(image: np.ndarray):
    """RGB uint8 (H, W, 3) -> (indices (H, W) uint8, palette (N, 3) uint8):
    PIL's ``convert("P", palette=ADAPTIVE)``, Pillow's median cut
    (``csrc/gif_host.cpp``)."""
    from ape_tpu_torch.ops._build import host_library

    rgb = np.ascontiguousarray(image, np.uint8)
    height, width = rgb.shape[:2]
    palette = np.zeros((256, 3), np.uint8)
    indices = np.empty((height, width), np.uint8)
    n = host_library().ape_gif_quantize(rgb.ctypes.data, height * width, palette.ctypes.data,
                                        indices.ctypes.data)
    return indices, palette[:n]


def _optimized(indices: np.ndarray, n_palette: int, gray: bool):
    """GifImagePlugin._get_optimize: the palette entries in use, where PIL
    remaps the palette to them (always for "L"; for "P" below 512 x 512
    pixels, where an entry is unused or the used ones fit half the
    power-of-two table), else None."""
    height, width = indices.shape
    if not gray and width * height >= 512 * 512:
        return None
    used = np.flatnonzero(np.bincount(indices.ravel(), minlength=256))
    if gray or used.max() >= len(used):
        return used
    current = 1 << (n_palette - 1).bit_length()
    if len(used) <= current // 2 and current > 2:
        return used
    return None


def _color_table_size(n: int) -> int:
    """GifImagePlugin._get_color_table_size of n entries."""
    return 0 if n == 0 else 1 if n < 3 else math.ceil(math.log(n, 2)) - 1


def encode_gif(image: np.ndarray) -> bytes:
    """uint8 (H, W) or (H, W, 3) -> the bytes of PIL's
    ``Image.fromarray(image).save(f, "GIF")``: RGB quantised to an adaptive
    palette (``quantize``), "L" given the gray ramp; the palette remapped to
    the used entries where ``_get_optimize`` says so, padded to a power of
    two (at least 4); GIF87a, one frame, interlaced unless a side is below
    16; LZW of code size 8 (``csrc/gif_host.cpp``)."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim not in (2, 3) or (
            image.ndim == 3 and image.shape[2] != 3):
        raise ValueError(f"encode_gif takes uint8 (H, W) or (H, W, 3), not {image.dtype} "
                         f"{image.shape}")
    height, width = image.shape[:2]
    if height == 0 or width == 0:
        raise ValueError("encode_gif: an empty image")
    gray = image.ndim == 2
    if gray:
        indices = np.ascontiguousarray(image)
        palette = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    else:
        indices, palette = quantize(image)
    used = _optimized(indices, len(palette), gray)
    if used is not None:  # Image.remap_palette
        positions = np.zeros(256, np.uint8)
        positions[used] = np.arange(len(used), dtype=np.uint8)
        indices, palette = positions[indices], palette[used]
    size = _color_table_size(len(palette))
    table = np.zeros((2 << size, 3), np.uint8)
    table[:len(palette)] = palette
    interlace = 0 if min(width, height) < 16 else 1
    from ape_tpu_torch.ops._build import host_library

    indices = np.ascontiguousarray(indices)
    cap = 2 * width * height + 1024
    out = np.empty(cap, np.uint8)
    n = host_library().ape_gif_lzw_encode(indices.ctypes.data, width, height, interlace, 8,
                                          out.ctypes.data, cap)
    if n < 0:
        raise RuntimeError("GIF LZW encoder: output buffer too small")
    return (b"GIF87a" + struct.pack("<HHBBB", width, height, size + 128, 0, 0) + table.tobytes()
            + b"," + struct.pack("<HHHHB", 0, 0, width, height, 64 * interlace) + b"\x08"
            + out[:n].tobytes() + b"\x00;")
