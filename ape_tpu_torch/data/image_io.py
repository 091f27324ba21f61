"""Reading and writing images without PIL (the port's own; JAX's mapper
reads through ``PIL.Image.open(...).convert("RGB")``, which the card machine
lacks). The rule is JAX's reader's through PIL 12.1: a file PIL decodes is
decoded to the same pixels, and a file PIL refuses is dropped.

``read_image`` returns RGB uint8 (H, W, 3) as PIL's ``convert("RGB")`` gives
it, for:

* JPEG, decoded by the port's host codec (``data.jpeg``) bit for bit as
  PIL 12.1 on libjpeg-turbo 3.1 decodes it (no EXIF orientation applied,
  as JAX's reader applies none): Huffman baseline, extended and
  progressive, arithmetic-coded sequential and progressive, lossless;
  gray, YCbCr, RGB, CMYK and YCCK; libjpeg's block smoothing; and damaged
  entropy-coded data as libjpeg recovers it (zero bits past a marker and
  the rest of the restart interval skipped, restart markers resynced, a
  code no table holds read as 0, the standard Huffman tables where a
  sequential frame defines none, nothing after a single-scan image's scan
  looked at);
* PNG, decoded with the standard library's ``zlib``: every color type and
  bit depth the format has (gray at 1, 2, 4, 8 and 16 bits, palette at 1,
  2, 4 and 8, gray + alpha, RGB and RGBA at 8 and 16), plain or Adam7
  interlaced, every filter type. The alpha channel is dropped, gray is
  repeated over the three channels, a palette is looked up, 16-bit color
  keeps its high byte and 16-bit gray is clipped to 255, as PIL converts;
* BMP (``data.bmp``): 1-, 4- and 8-bit palettes, RLE8 and RLE4, 16-bit
  555 and 565, 24-bit, 32-bit with every BITFIELDS mask set PIL takes,
  OS/2, V4 and V5 headers, top-down rows;
* GIF (``data.gif``): the first frame as PIL presents it (the screen
  around it filled with the transparency index or 0, a palette looked up,
  mode "L" where the palette is the identity gray ramp);
* WebP (``data.webp``): lossy, lossless, with alpha, animated (the first
  frame on its canvas), as libwebp 1.6's WebPAnimDecoder gives it to PIL;
* ``.npy``: a uint8 (H, W) or (H, W, 3|4) array.

The format is read off the file's first bytes, as PIL's plugins sniff it
(``sniff``): a PNG named ``.jpg`` reads as PNG and a WebP named ``.bmp`` as
WebP.

``read_image`` returns None with a warning, as JAX's reader does on PIL's
exception (its mapper then drops the record), for a file that is corrupt in
a way PIL raises on (a truncated stream, a bad CRC, an empty file, a GIF
whose LZW data breaks, a WebP shorter than its RIFF size) and for one PIL
refuses too (12-bit, 2-component, hierarchical, lossless arithmetic-coded
JPEG, fractional sampling ratios, a height left to a DNL marker, lossless
JPEG that needs a colour conversion, an arithmetic-coded scan past PIL's
64 KiB read block; a PNG of an undefined color type and depth; a BMP of an
unknown depth, mask set or compression; a RIFF WebP whose first chunk PIL
does not take). A file PIL reads and the port does not (TIFF, PPM, ICO,
TGA, AVIF, JPEG 2000 and any other format) raises ``ValueError`` naming it,
so that no record JAX trains on is dropped quietly.

``read_rgb`` is the same read raising ``CorruptImage`` where ``read_image``
returns None (the panoptic mapper's ``convert("RGB")`` of an id PNG);
``read_label_map`` gives a PNG's, BMP's or GIF's stored samples as
``np.asarray(Image.open(f))`` does (the semantic labels: palette indices,
not colours; 16-bit gray as uint16; a BMP's "1" as bool, its direct colour
as RGB or RGBA).

``write_png`` writes gray, RGB or RGBA uint8 arrays (filter type 0 or 1 per
row, alternating, so the reader's filters are exercised). ``write_image``
is the counterpart of PIL's ``Image.fromarray(x).save(path)``: ``.jpg`` and
``.jpeg`` through ``encode_jpeg`` (PIL's bytes), ``.bmp`` through
``encode_bmp`` (PIL's bytes), ``.png`` through ``write_png`` (the same
pixels, not PIL's bytes); ``.webp``, ``.gif`` and other extensions raise
``ValueError`` naming them.
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
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))  # (x0, y0, dx, dy) of each interlace pass
# first bytes of the formats PIL reads and the port does not (their plugins' _accept)
_OTHER_FORMATS = ((b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"), (b"II+\x00", "TIFF"),
                  (b"MM\x00+", "TIFF"), (b"\x00\x00\x01\x00", "ICO"), (b"P1", "PPM"),
                  (b"P2", "PPM"), (b"P3", "PPM"), (b"P4", "PPM"), (b"P5", "PPM"), (b"P6", "PPM"),
                  (b"P7", "PPM"), (b"Pf", "PPM"), (b"PF", "PPM"),
                  (b"\x00\x00\x00\x0cjP  \r\n\x87\n", "JPEG 2000"),
                  (b"\xff\x4f\xff\x51", "JPEG 2000"))
MAX_IMAGE_PIXELS = 1024 * 1024 * 1024 // 4 // 3  # PIL's Image.MAX_IMAGE_PIXELS


class CorruptImage(ValueError):
    """A file of a format the port reads whose content is damaged."""


def bomb_check(width: int, height: int) -> None:
    """PIL's ``_decompression_bomb_check``: ``Image.open`` raises past twice
    ``MAX_IMAGE_PIXELS``."""
    if max(1, width) * max(1, height) > 2 * MAX_IMAGE_PIXELS:
        raise CorruptImage(f"image size ({width}x{height}) exceeds the decompression-bomb limit")


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


def _unfilter(data: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """The scanlines of one image (or interlace pass), filters undone by the
    host library's ``ape_png_unfilter``: (H, stride) uint8."""
    if len(data) != height * (stride + 1):
        raise CorruptImage(f"{len(data)} bytes of image data for {height} rows of {stride + 1}")
    from ape_tpu_torch.ops._build import host_library

    out = np.empty((height, stride), np.uint8)
    bad = host_library().ape_png_unfilter(data, height, stride, bpp, out.ctypes.data)
    if bad:
        raise CorruptImage(f"unknown filter type {data[(bad - 1) * (stride + 1)]} in row {bad - 1}")
    return out


def _unpack(rows: np.ndarray, width: int, channels: int, depth: int, color: int) -> np.ndarray:
    """Scanline bytes -> samples (H, W, C): uint16 at depth 16, else uint8;
    gray of 2 or 4 bits scaled to 0..255 (PIL opens it as L), of 1 bit 0/1."""
    height = rows.shape[0]
    if depth == 16:
        return rows.view(">u2").reshape(height, width, channels).astype(np.uint16)
    if depth == 8:
        return rows.reshape(height, width, channels)
    bits = np.unpackbits(rows, axis=1).reshape(height, -1, depth)[:, :width]
    samples = (bits * (1 << np.arange(depth - 1, -1, -1))).sum(-1).astype(np.uint8)
    if color == 0 and depth > 1:
        samples = (samples.astype(np.int64) * 255 // ((1 << depth) - 1)).astype(np.uint8)
    return samples[..., None]


def _png_samples(data: bytes):
    """PNG bytes -> (samples (H, W, C), color type, depth, palette): the
    stored samples as PIL opens them (``_unpack``), palette indices not
    looked up, the Adam7 passes put back in place."""
    header, idat, palette = None, [], None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            if len(body) < 13:
                raise CorruptImage("truncated IHDR chunk")
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            palette = np.frombuffer(body[:len(body) // 3 * 3], np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise CorruptImage("no IHDR chunk")
    width, height, depth, color, _, filter_method, interlace = header
    if depth not in _DEPTHS.get(color, ()) or filter_method:
        raise CorruptImage(f"PNG of color type {color} at bit depth {depth}, filter method "
                           f"{filter_method}: no PNG mode (PIL refuses it too)")
    if color == 3 and palette is None:
        raise CorruptImage("palette image without a PLTE chunk")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise CorruptImage(f"image data: {e}") from e
    channels = _CHANNELS[color]
    bpp = max(1, channels * depth // 8)

    def stride(w):
        return (w * channels * depth + 7) // 8

    if not interlace:  # PIL takes any nonzero interlace method as Adam7
        rows = _unfilter(raw, height, stride(width), bpp)
        return _unpack(rows, width, channels, depth, color), color, depth, palette
    samples = np.zeros((height, width, channels), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in ADAM7:
        pw, ph = (width - x0 + dx - 1) // dx, (height - y0 + dy - 1) // dy
        if pw <= 0 or ph <= 0:
            continue  # an empty pass has no scanlines
        n = ph * (stride(pw) + 1)
        rows = _unfilter(raw[pos:pos + n], ph, stride(pw), bpp)
        samples[y0::dy, x0::dx] = _unpack(rows, pw, channels, depth, color)
        pos += n
    if pos != len(raw):
        raise CorruptImage(f"{len(raw)} bytes of interlaced image data, {pos} expected")
    return samples, color, depth, palette


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> RGB uint8 (H, W, 3), PIL's ``convert("RGB")`` of it."""
    pixels, color, depth, palette = _png_samples(data)
    if color == 3:
        full = np.zeros((256, 3), np.uint8)
        full[:len(palette)] = palette[:256]
        return full[pixels[..., 0]]
    if depth == 16:  # PIL's I;16 -> RGB clips; its ;16B rawmodes keep the high byte
        pixels = (np.minimum(pixels, 255) if color == 0 else pixels >> 8).astype(np.uint8)
    if color == 0 and depth == 1:  # PIL's "1" converts to 0 and 255
        pixels = pixels * np.uint8(255)
    if color in (0, 4):
        return np.repeat(pixels[..., :1], 3, axis=2)
    return np.ascontiguousarray(pixels[..., :3])


def read_label_map(file_name: str) -> np.ndarray:
    """A label map as ``np.asarray(PIL.Image.open(file_name))`` gives it, for
    a PNG: palette images give their indices (not the colours), gray its
    values (H, W) uint8 (1-bit gray bool, as PIL's mode "1"; 16-bit gray
    uint16, as its "I;16"), gray + alpha (H, W, 2), RGB (H, W, 3) and RGBA
    (H, W, 4), 16-bit color as the high bytes (16-bit gray + alpha as RGBA,
    the gray repeated, as PIL opens it); for a BMP or GIF, ``decode_bmp``'s
    and ``decode_gif``'s samples. Another format, and a corrupt file,
    raise."""
    with open(file_name, "rb") as f:
        data = f.read()
    kind = sniff(data)
    if kind == "gif":
        from ape_tpu_torch.data.gif import decode_gif

        return decode_gif(data)[0]
    if kind == "bmp":
        from ape_tpu_torch.data.bmp import decode_bmp

        return decode_bmp(data)[0]
    if kind != "png":
        raise ValueError(f"{file_name}: the port reads label maps from PNG, BMP and GIF files "
                         "only")
    pixels, color, depth, _ = _png_samples(data)
    if color in (0, 3):
        return pixels[..., 0].astype(bool) if color == 0 and depth == 1 else pixels[..., 0]
    if depth == 16:
        pixels = (pixels >> 8).astype(np.uint8)
        if color == 4:
            return np.ascontiguousarray(pixels[..., [0, 0, 0, 1]])
    return pixels


def read_rgb(file_name: str) -> np.ndarray:
    """RGB uint8 (H, W, 3) of a JPEG, PNG, BMP, GIF, WebP or ``.npy`` file
    (module docstring), raising ``CorruptImage`` on a corrupt file and on
    one PIL refuses, as PIL's ``Image.open(file_name).convert("RGB")``
    raises, and ValueError for a format PIL reads and the port does not."""
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
    kind = sniff(data)
    if kind is None:
        if not data:
            raise CorruptImage(f"{file_name}: an empty file")
        raise ValueError(f"{file_name}: {_format_name(data, file_name)}, which PIL reads and the "
                         "port does not yet (the port reads JPEG, PNG, BMP, GIF, WebP and .npy "
                         "images)")
    return decode_rgb(data, kind)


def sniff(data: bytes) -> Optional[str]:
    """The container the port reads that PIL would open ``data`` as, by its
    plugins' ``_accept`` tests: "jpeg", "png", "bmp", "gif", "webp", or None.
    A RIFF WebP file whose first chunk is not VP8, VP8L or VP8X is no image
    to PIL: "webp" all the same, and its decoder refuses it."""
    if data.startswith(JPEG_MAGIC):
        return "jpeg"
    if data.startswith(PNG_MAGIC):
        return "png"
    if data.startswith(b"BM"):
        return "bmp"
    if data.startswith((b"GIF87a", b"GIF89a")):
        return "gif"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "webp"
    return None


def decode_rgb(data: bytes, kind: str) -> np.ndarray:
    """The bytes of a ``sniff``-ed container -> RGB uint8 (H, W, 3), PIL's
    ``convert("RGB")``: palettes looked up, gray repeated, alpha dropped."""
    if kind == "jpeg":
        from ape_tpu_torch.data.jpeg import decode_jpeg

        return decode_jpeg(data)
    if kind == "png":
        return decode_png(data)
    if kind == "webp":
        from ape_tpu_torch.data.webp import decode_webp

        return np.ascontiguousarray(decode_webp(data)[..., :3])
    if kind == "gif":
        from ape_tpu_torch.data.gif import decode_gif

        samples, palette = decode_gif(data)
        mode = "L" if palette is None else "P"
    else:
        from ape_tpu_torch.data.bmp import decode_bmp

        samples, mode, palette = decode_bmp(data)
    if mode == "P":
        return _palette_lookup(samples, palette)
    if mode in ("L", "1"):
        gray = samples.astype(np.uint8) * np.uint8(255) if mode == "1" else samples
        return np.repeat(gray[..., None], 3, axis=2)
    return np.ascontiguousarray(samples[..., :3])


def _palette_lookup(indices: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """P -> RGB as PIL converts it: a palette of fewer than 256 entries
    gives black past its end."""
    full = np.zeros((256, 3), np.uint8)
    full[:min(len(palette), 256)] = palette[:256]
    return full[indices]


def _format_name(data: bytes, file_name: str = "") -> str:
    """The container PIL would sniff in ``data``'s first bytes, for the error."""
    for magic, name in _OTHER_FORMATS:
        if data.startswith(magic):
            return f"a {name} image"
    if data[4:8] == b"ftyp" and data[8:12] in (b"avif", b"avis", b"mif1", b"msf1"):
        return "an AVIF image"
    if data.endswith(b"TRUEVISION-XFILE.\x00") or str(file_name).lower().endswith(
            (".tga", ".icb", ".vda", ".vst")):
        return "a TGA image"
    return f"an image of another format (first bytes {data[:8].hex()})"


def read_image(file_name: str) -> Optional[np.ndarray]:
    """``read_rgb``, with None and a warning for a corrupt file and for one
    PIL refuses, as JAX's reader returns None and its mapper then drops the
    record."""
    try:
        return read_rgb(file_name)
    except CorruptImage as e:
        logger.warning(f"failed to read {file_name}: {e}")
        return None


def write_image(file_name: str, image: np.ndarray) -> None:
    """Write a uint8 (H, W) or (H, W, 3) image as PIL's
    ``Image.fromarray(image).save(file_name)`` does, by its extension:
    ``.jpg``/``.jpeg`` as JPEG and ``.bmp`` as BMP (PIL's bytes), ``.png``
    as PNG."""
    ext = os.path.splitext(str(file_name))[1].lower()
    if ext in (".jpg", ".jpeg", ".bmp"):
        if ext == ".bmp":
            from ape_tpu_torch.data.bmp import encode_bmp as encode
        else:
            from ape_tpu_torch.data.jpeg import encode_jpeg as encode

        data = encode(image)
        with open(file_name, "wb") as f:
            f.write(data)
    elif ext == ".png":
        write_png(file_name, image)
    else:
        raise ValueError(f"{file_name}: the port writes .jpg, .jpeg, .png and .bmp images, not "
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
