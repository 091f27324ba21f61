"""PNG writing without PIL: the bytes of PIL 12.1's
``Image.fromarray(x).save(f, "PNG")`` for a uint8 "L", "RGB" or "RGBA"
array (``PngImagePlugin._save`` over Pillow's ``ZipEncode.c``).

* The chunks: the signature, IHDR (8 bits, color type 0, 2 or 6, no
  interlace), the IDAT chunks, IEND; PIL writes no other chunk for an array
  without info.
* The filter of each row is ZipEncode's choice (libpng's heuristic): the
  least sum of the filtered bytes read as signed (``min(v, 256 - v)``),
  tried in the order None, Up, Sub, Paeth, a later filter taken only where
  its sum is strictly less; the row above the first is zeros. Average is
  tried only under ``optimize``, which ``save`` leaves off.
* Deflate: zlib at level 6, window 15, memory level 9, ``Z_FILTERED``, the
  rows fed one by one, as ZipEncode initialises it.
* The IDAT split: ``ImageFile._save`` hands the encoder a buffer of
  ``max(65536, 4 * width)`` bytes and PIL's ``_idat`` writes each filled
  buffer as one chunk.

If the host's zlib is not the one PIL was built against (1.2.13 for PIL
12.1's wheels), the deflate stream, and so the bytes, may differ while the
pixels stay the same.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ape_tpu_torch.data.image_io import PNG_MAGIC

MAXBLOCK = 65536  # ImageFile.MAXBLOCK
# PngImagePlugin._OUTMODES: mode -> (bit depth, color type)
_COLOR = {1: 0, 3: 2, 4: 6}


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _cost(rows: np.ndarray) -> np.ndarray:
    """ZipEncode's sum of |v| over each filtered row, v read as signed."""
    v = rows.astype(np.int32)
    return np.minimum(v, 256 - v).sum(axis=1)


def filter_rows(rows: np.ndarray, bpp: int) -> bytes:
    """(H, stride) uint8 scanlines -> the filtered image data, a filter
    byte before each row, each row's filter picked as ZipEncode picks it."""
    prev = np.zeros_like(rows)
    prev[1:] = rows[:-1]
    a = np.zeros_like(rows)
    a[:, bpp:] = rows[:, :-bpp]
    c = np.zeros_like(rows)
    c[:, bpp:] = prev[:, :-bpp]
    up = rows - prev
    sub = rows - a
    ai, bi, ci = a.astype(np.int16), prev.astype(np.int16), c.astype(np.int16)
    pa, pb, pc = np.abs(bi - ci), np.abs(ai - ci), np.abs(ai + bi - 2 * ci)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
    paeth = rows - pred
    candidates = ((0, rows), (2, up), (1, sub), (4, paeth))
    best_kind = np.zeros(len(rows), np.uint8)
    best_sum = _cost(rows)
    out = rows.copy()
    for kind, filtered in candidates[1:]:
        s = _cost(filtered)
        better = s < best_sum
        best_sum = np.where(better, s, best_sum)
        best_kind[better] = kind
        out[better] = filtered[better]
    return np.concatenate([best_kind[:, None], out], axis=1).tobytes()


def encode_png(image: np.ndarray) -> bytes:
    """uint8 (H, W), (H, W, 3) or (H, W, 4) -> the PNG bytes PIL's ``save``
    writes for it (mode "L", "RGB" or "RGBA")."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim not in (2, 3) or (
            image.ndim == 3 and image.shape[2] not in (3, 4)):
        raise ValueError(f"encode_png takes uint8 (H, W), (H, W, 3) or (H, W, 4), not "
                         f"{image.dtype} {image.shape}")
    height, width = image.shape[:2]
    channels = 1 if image.ndim == 2 else image.shape[2]
    rows = np.ascontiguousarray(image).reshape(height, width * channels)
    data = filter_rows(rows, channels) if height and width else b""
    z = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
    stride = width * channels + 1
    stream = b"".join(z.compress(data[y * stride:(y + 1) * stride]) for y in range(height))
    stream += z.flush()
    block = max(MAXBLOCK, 4 * width)
    idat = b"".join(_chunk(b"IDAT", stream[i:i + block]) for i in range(0, len(stream), block))
    header = struct.pack(">IIBBBBB", width, height, 8, _COLOR[channels], 0, 0, 0)
    return PNG_MAGIC + _chunk(b"IHDR", header) + idat + _chunk(b"IEND", b"")
