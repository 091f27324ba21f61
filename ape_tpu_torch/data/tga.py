"""TGA reading and writing without PIL, as PIL 12.1's ``TgaImagePlugin``
reads and writes them, for ``image_io``.

``decode_tga`` gives what ``Image.open(f)`` holds: (samples, mode, palette)
for the image types PIL opens:

* colour-mapped (types 1 and 9: mode "P", palette entries of 16 bits
  (5-5-5) or 24 bits from the map's first index on, the entries before it
  zero), true colour (2 and 10:
  "RGB" at 24 bits, "RGBA" at 15/16 and 32) and gray (3 and 11: "L" at 8,
  "LA" at 16, "1" at 1 bit);
* raw data, or run-length data (types 9, 10, 11) decoded by the host
  library (``csrc/tga_host.cpp``, PIL's TgaRleDecode: a literal packet of
  pixels wider than a byte may run past a row, any other packet that does
  is an overrun);
* rows bottom-up unless descriptor bit 5 is set, flipped left to right
  under bit 4; the ID field skipped.

TGA has no magic number: ``accept`` is PIL's ``_open`` checks (a colour
map type of 0 or 1, a nonzero size, a depth of 1, 8, 16, 24 or 32, a known
image type and origin); ``image_io.sniff`` asks it only after the plugins
PIL tries first. A file PIL raises on (another depth or type pair, a
colour-mapped type without a map, a map depth other than 15/16 or 24 (a
32-bit map fails PIL's palette), data cut short, an RLE packet PIL's
decoder overruns on, which includes those of PIL's own 1-bit RLE files)
raises ``CorruptImage``.

``encode_tga`` writes the bytes of ``Image.fromarray(x).save(f)`` under a
.tga name: uncompressed, bottom-up, with PIL's footer.
"""

from __future__ import annotations

import struct

import numpy as np

from ape_tpu_torch.data.image_io import CorruptImage, bomb_check

# (image type & 7, depth) -> raw mode: TgaImagePlugin.MODES
MODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGRA;15Z",
         (2, 24): "BGR", (2, 32): "BGRA"}
_BITS = {"P": 8, "1": 1, "L": 8, "LA": 16, "BGRA;15Z": 16, "BGR": 24, "BGRA": 32}
FOOTER = b"\0" * 8 + b"TRUEVISION-XFILE." + b"\0"


def _header(data: bytes):
    """(id length, colour map type, image type, width, height, depth,
    descriptor, mode), or a CorruptImage where PIL's _open refuses."""
    if len(data) < 18:
        raise CorruptImage("not a TGA file (truncated header)")
    id_len, cmtype, imagetype = data[0], data[1], data[2]
    width, height = struct.unpack_from("<HH", data, 12)
    depth, flags = data[16], data[17]
    if cmtype not in (0, 1) or width <= 0 or height <= 0 or depth not in (1, 8, 16, 24, 32):
        raise CorruptImage("not a TGA file")
    if imagetype in (3, 11):
        mode = "1" if depth == 1 else "LA" if depth == 16 else "L"
    elif imagetype in (1, 9):
        mode = "P" if cmtype else "L"
    elif imagetype in (2, 10):
        mode = "RGB" if depth == 24 else "RGBA"
    else:
        raise CorruptImage("unknown TGA mode")
    if flags & 0x30 not in (0, 0x10, 0x20, 0x30):
        raise CorruptImage("unknown TGA orientation")
    return id_len, cmtype, imagetype, width, height, depth, flags, mode


def accept(data: bytes) -> bool:
    """Whether PIL's TGA ``_open`` takes the header."""
    try:
        _header(data)
    except CorruptImage:
        return False
    return True


def _colors(raw: np.ndarray, rawmode: str) -> np.ndarray:
    """Pixels of a raw mode -> RGB or RGBA (N, ...) uint8."""
    if rawmode == "BGRA;15Z":  # 5-5-5, each field scaled as PIL's unpacker scales it
        v = raw.reshape(-1, 2).copy().view("<u2")[:, 0].astype(np.int32)
        rgb = [((v >> s) & 31) * 255 // 31 for s in (10, 5, 0)]
        alpha = np.where(v & 0x8000, 0, 255)
        return np.stack(rgb + [alpha], -1).astype(np.uint8)
    n = len(rawmode.replace(";", ""))
    px = raw.reshape(-1, n)
    return px[:, [2, 1, 0, 3][:n]]


def decode_tga(data: bytes):
    """TGA bytes -> (samples, mode, palette): (H, W) uint8 for "P" and "L",
    bool for "1"; (H, W, 2 | 3 | 4) for "LA", "RGB", "RGBA"; palette (N, 3)
    uint8 for "P", else None."""
    id_len, cmtype, imagetype, width, height, depth, flags, mode = _header(data)
    bomb_check(width, height)
    pos = 18 + id_len
    palette = None
    if cmtype:
        start, size, mapdepth = struct.unpack_from("<HHB", data, 3)
        entry = {16: 2, 24: 3, 32: 4}.get(mapdepth)
        if entry is None:
            raise CorruptImage("unknown TGA map depth")
        if entry == 4:  # PIL's palette has no BGRA raw mode: its load fails
            raise CorruptImage("unrecognized raw mode (a 32-bit TGA colour map)")
        table = data[pos:pos + entry * size]
        pos += len(table)
        table = bytes(entry * start) + table
        table = table[:len(table) // entry * entry]
        rawmode = {2: "BGRA;15Z", 3: "BGR", 4: "BGRA"}[entry]
        palette = _colors(np.frombuffer(table, np.uint8), rawmode)[:, :3]
    rawmode = MODES.get((imagetype & 7, depth))
    if rawmode is None or (rawmode == "P" and mode == "L"):
        raise CorruptImage(f"cannot load this TGA image (type {imagetype}, depth {depth})")
    stride = (width * _BITS[rawmode] + 7) // 8
    if imagetype & 8:
        from ape_tpu_torch.ops._build import host_library

        rows = np.empty((height, stride), np.uint8)
        rc = host_library().ape_tga_rle(data, len(data), pos, (depth + 7) // 8, stride, height,
                                        rows.ctypes.data)
        if rc:
            raise CorruptImage("image file is truncated" if rc == 1 else
                               "buffer overrun when reading image file")
    else:
        if len(data) < pos + stride * height:
            raise CorruptImage("image file is truncated")
        rows = np.frombuffer(data, np.uint8, stride * height, pos).reshape(height, stride)
    if not flags & 0x20:  # bottom-up
        rows = rows[::-1]
    if rawmode == "1":
        samples = np.unpackbits(rows, axis=1)[:, :width].astype(bool)
    elif rawmode in ("P", "L"):
        samples = rows[:, :width]
    elif rawmode == "LA":
        samples = rows[:, :2 * width].reshape(height, width, 2)
    else:
        samples = _colors(rows[:, :width * _BITS[rawmode] // 8].reshape(-1), rawmode).reshape(
            height, width, -1)
        if mode == "RGB":
            samples = samples[..., :3]
    if flags & 0x10:
        samples = samples[:, ::-1]
    return np.ascontiguousarray(samples), mode, palette


def encode_tga(image: np.ndarray) -> bytes:
    """uint8 (H, W) or (H, W, 3) -> the bytes of PIL's
    ``Image.fromarray(image).save(f, "TGA")``: type 3 (gray) or 2 (24-bit
    BGR), uncompressed, rows bottom-up, PIL's footer."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim not in (2, 3) or (
            image.ndim == 3 and image.shape[2] != 3):
        raise ValueError(f"encode_tga takes uint8 (H, W) or (H, W, 3), not {image.dtype} "
                         f"{image.shape}")
    height, width = image.shape[:2]
    gray = image.ndim == 2
    header = struct.pack("<BBBHHBHHHHBB", 0, 0, 3 if gray else 2, 0, 0, 0, 0, 0, width, height,
                         8 if gray else 24, 0)
    rows = image if gray else image[..., ::-1]
    return header + np.ascontiguousarray(rows[::-1]).tobytes() + FOOTER
