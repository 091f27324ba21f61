"""BMP reading and writing without PIL, as PIL 12.1's ``BmpImagePlugin``
reads and writes them, for ``image_io``.

``decode_bmp`` gives what ``Image.open(f)`` holds, before any conversion:
(samples, mode, palette), mode one of PIL's "1", "L", "P", "RGB", "RGBA":

* 1-, 4- and 8-bit palette images ("P"; "L" where the palette is the
  identity gray ramp, "1" where two entries are black and white, read
  with PIL's raw modes "L" and "1" whatever the depth, as PIL reads them),
  with a palette of ``clr_used`` entries (4 bytes each, 3 under the OS/2
  12-byte header; more than 256 refused, as PIL's ``putpalette`` refuses
  them);
* 16-bit 555 (raw, or BITFIELDS 0x7C00/0x3E0/0x1F) and BITFIELDS 565,
  each field scaled to 0..255 as PIL's unpackers scale it;
* 24-bit, and BITFIELDS 0xFF0000/0xFF00/0xFF;
* 32-bit BGRX, and every BITFIELDS mask set PIL accepts (with alpha
  where the alpha mask is set: mode "RGBA");
* RLE8 and RLE4 (``csrc/bmp_host.cpp``, PIL's decoder's steps);
* bottom-up rows, or top-down under a negative height; headers of 12, 40,
  52, 56, 64, 108 and 124 bytes.

Everything else PIL raises on (another depth, mask set or compression, a
palette of more than 65536 entries, a truncated file) raises
``CorruptImage``. A DIB (a BMP without its file header: PIL's "DIB"
plugin, ``.dib`` files) reads as the BMP ``dib_as_bmp`` makes of it.
``encode_bmp`` writes the bytes of ``Image.fromarray(x).save(f, "BMP")``
for uint8 (H, W) and (H, W, 3), ``encode_dib`` those of ``save(f,
"DIB")``.
"""

from __future__ import annotations

import struct

import numpy as np

from ape_tpu_torch.data.image_io import CorruptImage, bomb_check

BMP_MAGIC = b"BM"  # PIL's BmpImagePlugin._accept
_HEADERS = (12, 40, 52, 56, 64, 108, 124)
_BIT2MODE = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"), 16: ("RGB", "BGR;15"),
             24: ("RGB", "BGR"), 32: ("RGB", "BGRX")}
# (bits, masks) -> raw mode: BmpImagePlugin's MASK_MODES
_MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
_RAW_BITS = {"1": 1, "L": 8, "P": 8, "P;1": 1, "P;4": 4, "BGR;15": 16, "BGR;16": 16, "BGR": 24}


def _u32(data: bytes, pos: int) -> int:
    return struct.unpack_from("<I", data, pos)[0]


def _u16(data: bytes, pos: int) -> int:
    return struct.unpack_from("<H", data, pos)[0]


def decode_bmp(data: bytes):
    """BMP bytes -> (samples, mode, palette): samples (H, W) uint8 for "P"
    and "L", bool for "1", (H, W, 3) or (H, W, 4) uint8 for "RGB" and
    "RGBA"; palette (N, 3) uint8 for "P", else None."""
    if len(data) < 18 or not data.startswith(BMP_MAGIC):
        raise CorruptImage("not a BMP file")
    offset = _u32(data, 10)
    header_size = _u32(data, 14)
    if header_size not in _HEADERS:
        raise CorruptImage(f"Unsupported BMP header type ({header_size})")
    head = data[18:14 + header_size]
    if len(head) < header_size - 4:
        raise CorruptImage("truncated BMP header")
    pos = 14 + header_size
    direction = -1
    masks = None
    if header_size == 12:
        width, height, _, bits = struct.unpack_from("<HHHH", head)
        compression, colors, padding = 0, 0, 3
    else:
        y_flip = head[7] == 0xFF
        direction = 1 if y_flip else -1
        width = _u32(head, 0)
        height = _u32(head, 4) if not y_flip else 2**32 - _u32(head, 4)
        bits = _u16(head, 10)
        compression = _u32(head, 12)
        colors = _u32(head, 28)
        padding = 4
        if compression == 3:
            if len(head) >= 48:
                names = 4 if len(head) >= 52 else 3
                masks = tuple(_u32(head, 36 + 4 * i) for i in range(names)) + (0,) * (4 - names)
            else:  # 40-byte header: three masks follow it
                if len(data) < pos + 12:
                    raise CorruptImage("truncated BMP bitfields")
                masks = struct.unpack_from("<III", data, pos) + (0,)
                pos += 12
    if width == 0 or height == 0:
        raise CorruptImage("an empty BMP image")  # PIL's ImageFile identifies no such image
    bomb_check(width, height)
    colors = colors if colors else 1 << bits
    if offset == 14 + header_size and bits <= 8:
        offset += 4 * colors
    if bits not in _BIT2MODE:
        raise CorruptImage(f"Unsupported BMP pixel depth ({bits})")
    mode, raw = _BIT2MODE[bits]
    rle = False
    if compression == 3:
        if bits == 32 and (32, masks) in _MASK_MODES:
            raw = _MASK_MODES[(32, masks)]
            mode = "RGBA" if "A" in raw else mode
        elif bits in (24, 16) and (bits, masks[:3]) in _MASK_MODES:
            raw = _MASK_MODES[(bits, masks[:3])]
        else:
            raise CorruptImage("Unsupported BMP bitfields layout")
    elif compression in (1, 2):
        rle = True
    elif compression != 0:
        raise CorruptImage(f"Unsupported BMP compression ({compression})")
    palette = None
    if mode == "P":
        if not 0 < colors <= 65536:
            raise CorruptImage(f"Unsupported BMP Palette size ({colors})")
        table = data[pos:pos + padding * colors]
        if len(table) // padding > 256:
            raise CorruptImage("invalid palette size")  # PIL's putpalette refuses it
        ramp = (0, 255) if colors == 2 else range(colors)
        if all(table[i * padding:i * padding + 3] == bytes([v]) * 3 for i, v in enumerate(ramp)):
            mode = raw = "1" if colors == 2 else "L"
        else:
            entries = len(table) // padding
            palette = np.frombuffer(table[:entries * padding], np.uint8).reshape(
                entries, padding)[:, 2::-1]
    if rle:
        samples = _rle(data, offset, compression == 2, width, height, mode)
    else:
        samples = _raw(data, offset, raw, width, height, bits)
    if direction == -1:
        samples = samples[::-1]
    samples = np.ascontiguousarray(samples)
    if mode == "1":
        samples = samples.astype(bool)
    return samples, mode, palette


def _rle(data, offset, rle4, width, height, mode):
    if mode not in ("P", "L"):
        raise CorruptImage(f"BMP run-length data for mode {mode}")
    from ape_tpu_torch.ops._build import host_library

    out = np.empty((height, width), np.uint8)
    rc = host_library().ape_bmp_rle(data, len(data), offset, int(rle4), width, height,
                                    out.ctypes.data)
    if rc:
        raise CorruptImage("not enough image data" if rc == 1 else "truncated BMP delta")
    return out


def _raw(data, offset, raw, width, height, bits):
    """PIL's raw decoder: rows of the stride BMP's depth gives, each read
    with ``raw``'s own bits a pixel."""
    stride = ((width * bits + 31) >> 3) & ~3
    need = (width * _RAW_BITS.get(raw, 32) + 7) // 8
    if need > stride:
        raise CorruptImage("BMP rows shorter than the raw mode reads")
    if len(data) < offset + stride * (height - 1) + need:  # the last row's padding may be cut
        raise CorruptImage("image file is truncated")
    body = np.frombuffer(data, np.uint8, len(data) - offset, offset)[:stride * height]
    rows = np.zeros(stride * height, np.uint8)
    rows[:body.size] = body
    rows = rows.reshape(height, stride)[:, :need]
    if raw in ("P;1", "1"):
        return np.unpackbits(rows, axis=1)[:, :width]
    if raw == "P;4":
        return np.stack([rows >> 4, rows & 15], -1).reshape(height, -1)[:, :width]
    if raw in ("P", "L"):
        return rows
    if raw in ("BGR;15", "BGR;16"):
        v = rows.view("<u2").astype(np.int32)
        if raw == "BGR;15":
            fields = [(v >> 10) & 31, (v >> 5) & 31, v & 31]
            scale = (31, 31, 31)
        else:
            fields = [(v >> 11) & 31, (v >> 5) & 63, v & 31]
            scale = (31, 63, 31)
        return np.stack([f * 255 // s for f, s in zip(fields, scale)], -1).astype(np.uint8)
    px = rows.reshape(height, width, len(raw))
    order = [raw.index(c) for c in ("RGBA" if "A" in raw else "RGB")]
    return px[..., order]


def encode_bmp(image: np.ndarray) -> bytes:
    """uint8 (H, W) or (H, W, 3) -> the bytes of PIL's
    ``Image.fromarray(image).save(f, "BMP")``: 24-bit BGR, or 8-bit with a
    gray palette for (H, W); 96 dpi; rows bottom-up, padded to 4 bytes."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim not in (2, 3) or (
            image.ndim == 3 and image.shape[2] != 3):
        raise ValueError(f"encode_bmp takes uint8 (H, W) or (H, W, 3), not {image.dtype} "
                         f"{image.shape}")
    height, width = image.shape[:2]
    gray = image.ndim == 2
    bits, colors = (8, 256) if gray else (24, 0)
    stride = ((width * bits + 7) // 8 + 3) & ~3
    ppm = int(96 * 39.3701 + 0.5)
    palette = b"".join(bytes([i, i, i, 0]) for i in range(256)) if gray else b""
    offset = 14 + 40 + colors * 4
    size = stride * height
    rows = image if gray else image[..., ::-1].reshape(height, width * 3)
    body = np.zeros((height, stride), np.uint8)
    body[:, :rows.shape[1]] = rows
    return (b"BM" + struct.pack("<IIIIiiHHIIiiII", offset + size, 0, offset, 40, width, height,
                                1, bits, 0, size, ppm, ppm, colors, colors)
            + palette + body[::-1].tobytes())


def encode_dib(image: np.ndarray) -> bytes:
    """The bytes of PIL's ``save(f, "DIB")`` (the ``.dib`` name): the BMP
    of ``encode_bmp`` without its 14-byte file header."""
    return encode_bmp(image)[14:]


def dib_pixel_start(dib: bytes) -> int:
    """Where PIL's ``DibImageFile`` (a BMP without its 14-byte file header,
    as ``.dib`` files and ICO entries hold it) reads the pixels: after the
    header, the three bitfield masks that follow a 40-byte BITFIELDS
    header, and a palette of ``clr_used`` (else 2 ** bits) entries for 8
    bits or fewer (3 bytes each under the 12-byte header, else 4)."""
    if len(dib) < 16:
        raise CorruptImage("truncated DIB header")
    header_size = _u32(dib, 0)
    if header_size == 12:
        bits = _u16(dib, 10)
        colors, padding, compression = 1 << bits, 3, 0
    else:
        if len(dib) < 36:
            raise CorruptImage("truncated DIB header")
        bits, compression, used = _u16(dib, 14), _u32(dib, 16), _u32(dib, 32)
        colors, padding = used or 1 << bits, 4
    start = header_size
    if header_size == 40 and compression == 3:
        start += 12
    if bits <= 8:
        start += padding * colors
    return start


def dib_as_bmp(dib: bytes) -> bytes:
    """A DIB as the BMP file ``decode_bmp`` reads to the same image: the
    file header, its pixel offset at ``dib_pixel_start``."""
    return b"BM" + struct.pack("<IHHI", 14 + len(dib), 0, 0, 14 + dib_pixel_start(dib)) + dib
