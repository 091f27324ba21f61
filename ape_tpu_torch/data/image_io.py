"""Reading and writing images without PIL (the port's own; JAX's mapper
reads through ``PIL.Image.open(...).convert("RGB")``, which the card machine
lacks).

``read_image`` returns RGB uint8 (H, W, 3) as PIL's ``convert("RGB")`` gives
it, for:

* JPEG, decoded by the port's host codec (``data.jpeg``) bit for bit as
  PIL 12.1 on libjpeg-turbo 3.1 decodes it (no EXIF orientation applied,
  as JAX's reader applies none);
* PNG, decoded with the standard library's ``zlib``: 8-bit gray, gray +
  alpha, RGB, RGBA and palette (bit depth 1, 2, 4 or 8), every filter type,
  not interlaced. The alpha channel is dropped, gray is repeated over the
  three channels and a palette is looked up, as PIL converts.
* ``.npy``: a uint8 (H, W) or (H, W, 3|4) array.

``read_rgb`` is the same read raising on a corrupt file (the panoptic
mapper's ``convert("RGB")`` of an id PNG), which ``read_image`` turns into
None; ``read_label_map`` gives a PNG's
stored samples as ``np.asarray(Image.open(f))`` does (the semantic labels:
palette indices, not colours).

The format is read off the file's first bytes, as PIL sniffs it: a PNG
named ``.jpg`` reads as PNG and a JPEG named ``.png`` as JPEG. Any other
format, and a coding the port does not decode (interlaced or 16-bit PNG;
arithmetic-coded, lossless, hierarchical, 12-bit or YCCK JPEG), raises
``ValueError`` naming it. A file of a supported format that is corrupt (a
bad CRC, a truncated stream) returns None with a warning, as JAX's reader
returns None on an unreadable file and its mapper then drops the record.

``write_png`` writes gray, RGB or RGBA uint8 arrays (filter type 0 or 1 per
row, alternating, so the reader's filters are exercised). ``write_image``
is the counterpart of PIL's ``Image.fromarray(x).save(path)``: ``.jpg`` and
``.jpeg`` through ``encode_jpeg`` (PIL's bytes), ``.png`` through
``write_png`` (the same pixels, not PIL's bytes).
"""

from __future__ import annotations

import logging
import os
import struct
import zlib
from typing import Optional

import numpy as np

logger = logging.getLogger("ape_tpu_torch")

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
JPEG_MAGIC = b"\xff\xd8\xff"  # PIL's JpegImagePlugin._accept
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG color type -> samples a pixel


class CorruptImage(ValueError):
    """A file of a format the port reads whose content is damaged."""


def _chunks(data: bytes):
    pos = len(PNG_MAGIC)
    while pos < len(data):
        if pos + 8 > len(data):
            raise CorruptImage("truncated chunk header")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise CorruptImage(f"truncated {kind!r} chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise CorruptImage(f"bad CRC in {kind!r} chunk")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise CorruptImage("no IEND chunk")


def _paeth_row(raw: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the Paeth filter of one row: sequential over its bytes."""
    out = bytearray(raw.tobytes())
    up = prior.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        c = up[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _average_row(raw: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the Average filter of one row: sequential over its bytes."""
    out = bytearray(raw.tobytes())
    up = prior.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + up[i]) >> 1)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _unfilter(data: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """The scanlines of a non-interlaced image, filters undone: (H, stride) uint8."""
    if len(data) != height * (stride + 1):
        raise CorruptImage(f"{len(data)} bytes of image data for {height} rows of {stride + 1}")
    rows = np.frombuffer(data, np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, raw = rows[y, 0], rows[y, 1:]
        if kind == 0:
            row = raw.copy()
        elif kind == 1:  # Sub: a running sum along each byte lane of the pixel
            pad = -stride % bpp
            lanes = np.concatenate([raw, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
            row = (np.cumsum(lanes, axis=0, dtype=np.uint64) % 256).astype(np.uint8).ravel()
            row = row[:stride]
        elif kind == 2:
            row = raw + prior
        elif kind == 3:
            row = _average_row(raw, prior, bpp)
        elif kind == 4:
            row = _paeth_row(raw, prior, bpp)
        else:
            raise CorruptImage(f"unknown filter type {kind} in row {y}")
        out[y] = row
        prior = out[y]
    return out


def _png_samples(data: bytes):
    """PNG bytes -> (samples (H, W, C) uint8, color type): the stored samples
    as PIL opens them, palette indices not looked up, gray of 2 or 4 bits
    scaled to 0..255 and of 1 bit left 0/1."""
    header, idat, palette = None, [], None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise CorruptImage("no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if interlace:
        raise ValueError("interlaced PNG is not decoded by the port")
    if color not in _CHANNELS or depth not in ((1, 2, 4, 8) if color in (0, 3) else (8,)):
        raise ValueError(f"PNG of color type {color} at bit depth {depth} is not decoded by "
                         "the port (8-bit gray, gray + alpha, RGB, RGBA; palette and gray "
                         "also at 1, 2 or 4 bits)")
    if color == 3 and palette is None:
        raise CorruptImage("palette image without a PLTE chunk")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise CorruptImage(f"image data: {e}") from e
    channels = _CHANNELS[color]
    stride = (width * channels * depth + 7) // 8
    rows = _unfilter(raw, height, stride, max(1, channels * depth // 8))
    if depth < 8:
        bits = np.unpackbits(rows, axis=1).reshape(height, -1, depth)[:, :width]
        weights = 1 << np.arange(depth - 1, -1, -1)
        samples = (bits * weights).sum(-1).astype(np.uint8)
        if color == 0 and depth > 1:  # PIL opens gray of 2 or 4 bits as L, scaled
            samples = (samples.astype(np.int64) * 255 // ((1 << depth) - 1)).astype(np.uint8)
        return samples[..., None], color, depth, palette
    return rows.reshape(height, width, channels), color, depth, palette


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> RGB uint8 (H, W, 3), PIL's ``convert("RGB")`` of it."""
    pixels, color, depth, palette = _png_samples(data)
    if color == 3:
        full = np.zeros((256, 3), np.uint8)
        full[:len(palette)] = palette
        return full[pixels[..., 0]]
    if color == 0 and depth == 1:  # PIL's "1" converts to 0 and 255
        pixels = pixels * np.uint8(255)
    if color in (0, 4):
        return np.repeat(pixels[..., :1], 3, axis=2)
    return np.ascontiguousarray(pixels[..., :3])


def read_label_map(file_name: str) -> np.ndarray:
    """A label map as ``np.asarray(PIL.Image.open(file_name))`` gives it, for
    a PNG: palette images give their indices (not the colours), gray its
    values (H, W) uint8 (1-bit gray bool, as PIL's mode "1"), gray + alpha
    (H, W, 2), RGB (H, W, 3) and RGBA (H, W, 4). Another format, and a
    corrupt file, raise."""
    with open(file_name, "rb") as f:
        data = f.read()
    if not data.startswith(PNG_MAGIC):
        raise ValueError(f"{file_name}: the port reads label maps from PNG files only")
    pixels, color, depth, _ = _png_samples(data)
    if color in (0, 3):
        return pixels[..., 0].astype(bool) if color == 0 and depth == 1 else pixels[..., 0]
    return pixels


def read_rgb(file_name: str) -> np.ndarray:
    """RGB uint8 (H, W, 3) of a JPEG, PNG or ``.npy`` file (module
    docstring), raising ``CorruptImage`` on a corrupt one as PIL's
    ``Image.open(file_name).convert("RGB")`` raises, and ValueError for
    another format or a coding the port does not decode."""
    if str(file_name).endswith(".npy"):
        try:
            arr = np.load(file_name)
        except (OSError, ValueError) as e:
            raise CorruptImage(str(e)) from e
        if arr.dtype != np.uint8 or arr.ndim not in (2, 3):
            raise ValueError(f"{file_name}: .npy images are uint8 (H, W) or (H, W, C)")
        if arr.ndim == 2:
            return np.repeat(arr[..., None], 3, axis=2)
        return np.ascontiguousarray(arr[..., :3]) if arr.shape[2] >= 3 else np.repeat(
            arr[..., :1], 3, axis=2)
    with open(file_name, "rb") as f:
        data = f.read()
    if data.startswith(JPEG_MAGIC):
        from ape_tpu_torch.data.jpeg import decode_jpeg as decode
    elif data.startswith(PNG_MAGIC):
        decode = decode_png
    else:
        raise ValueError(f"{file_name}: the port reads JPEG, PNG and .npy images only")
    return decode(data)


def read_image(file_name: str) -> Optional[np.ndarray]:
    """``read_rgb``, with None and a warning for a corrupt file, as JAX's
    reader returns None and its mapper then drops the record."""
    try:
        return read_rgb(file_name)
    except CorruptImage as e:
        logger.warning(f"failed to read {file_name}: {e}")
        return None


def write_image(file_name: str, image: np.ndarray) -> None:
    """Write a uint8 (H, W) or (H, W, 3) image as PIL's
    ``Image.fromarray(image).save(file_name)`` does, by its extension:
    ``.jpg``/``.jpeg`` as JPEG (PIL's bytes), ``.png`` as PNG."""
    ext = os.path.splitext(str(file_name))[1].lower()
    if ext in (".jpg", ".jpeg"):
        from ape_tpu_torch.data.jpeg import encode_jpeg

        data = encode_jpeg(image)
        with open(file_name, "wb") as f:
            f.write(data)
    elif ext == ".png":
        write_png(file_name, image)
    else:
        raise ValueError(f"{file_name}: the port writes .jpg, .jpeg and .png images, not "
                         f"{ext or 'a file without an extension'}")


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def write_png(file_name: str, image: np.ndarray) -> None:
    """Write a uint8 (H, W), (H, W, 3) or (H, W, 4) array as an 8-bit PNG."""
    image = np.ascontiguousarray(image, np.uint8)
    if image.ndim == 2:
        image = image[..., None]
    height, width, channels = image.shape
    color = {1: 0, 3: 2, 4: 6}[channels]
    rows = image.reshape(height, width * channels)
    sub = rows.astype(np.int16)
    sub[:, channels:] -= rows[:, :-channels]
    sub = (sub % 256).astype(np.uint8)
    lines = [b"\x01" + sub[y].tobytes() if y % 2 else b"\x00" + rows[y].tobytes()
             for y in range(height)]
    with open(file_name, "wb") as f:
        f.write(PNG_MAGIC + _chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, color,
                                                        0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(b"".join(lines), 6)) + _chunk(b"IEND", b""))
