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

from ape_tpu_torch.data.bmp import decode_bmp, dib_as_bmp, dib_pixel_start
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
        width, height = struct.unpack_from("<HH", dib, 4)
        half = int(height / 2)
        struct.pack_into("<H", dib, 6, half)
    else:
        width, height = struct.unpack_from("<Ii", dib, 4)
        struct.unpack_from("<I", dib, 32)  # a header cut short raises here, as PIL's does
        bomb_check(width, abs(height))
        half = int(height / 2)
        struct.pack_into("<i", dib, 8, half)
    # the pixels start after the header, the bitfield masks and the palette,
    # where PIL's DibImageFile finds them
    pixel_start = at + dib_pixel_start(bytes(dib))
    bmp = dib_as_bmp(bytes(dib))
    samples, mode, palette = decode_bmp(bmp)
    height = abs(half)
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


# --- writing: PIL 12.1's IcoImagePlugin._save with its default sizes

SIZES = ((16, 16), (24, 24), (32, 32), (48, 48), (64, 64), (128, 128), (256, 256))


def thumbnail_size(width: int, height: int, size) -> tuple:
    """``Image.thumbnail(size)``'s final (width, height) of a width x height
    image: the aspect kept, each side the floor or the ceiling of its
    exact value, whichever keeps the aspect closer, at least 1; the image's
    own size where it already fits."""
    x, y = size
    if x >= width and y >= height:
        return width, height

    def round_aspect(number: float, key) -> int:
        return max(min(math.floor(number), math.ceil(number), key=key), 1)

    aspect = width / height
    if x / y >= aspect:
        x = round_aspect(y * aspect, key=lambda n: abs(aspect - n / y))
    else:
        y = round_aspect(x / aspect, key=lambda n: 0 if n == 0 else abs(aspect - x / n))
    return x, y


def encode_ico(image: np.ndarray) -> bytes:
    """uint8 (H, W) or (H, W, 3) -> the bytes of PIL's
    ``Image.fromarray(image).save(f, "ICO")``: a frame for each of
    ``SIZES`` no wider and no taller than the image, each the image's
    ``thumbnail`` under LANCZOS (``transforms.resize_lanczos``) stored as
    PIL's PNG bytes (``png.encode_png``), 32 bits in the directory."""
    from ape_tpu_torch.data.png import encode_png
    from ape_tpu_torch.data.transforms import resize_lanczos

    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim not in (2, 3) or (
            image.ndim == 3 and image.shape[2] != 3):
        raise ValueError(f"encode_ico takes uint8 (H, W) or (H, W, 3), not {image.dtype} "
                         f"{image.shape}")
    height, width = image.shape[:2]
    frames = []
    for size in sorted(set(SIZES)):
        if size[0] > width or size[1] > height or size[0] > 256 or size[1] > 256:
            continue
        w, h = thumbnail_size(width, height, size)
        frame = image if (w, h) == (width, height) else resize_lanczos(image, h, w)
        frames.append((w, h, encode_png(frame)))
    head = ICO_MAGIC + struct.pack("<H", len(frames))
    offset = len(head) + 16 * len(frames)
    directory, body = b"", b""
    for w, h, data in frames:
        directory += struct.pack("<BBBBHHII", w if w < 256 else 0, h if h < 256 else 0, 0, 0,
                                 0, 32, len(data), offset)
        body += data
        offset += len(data)
    return head + directory + body
