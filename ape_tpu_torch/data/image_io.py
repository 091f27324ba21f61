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
  OS/2, V4 and V5 headers, top-down rows; and DIB, a BMP without its file
  header, as PIL's DIB plugin reads it;
* GIF (``data.gif``): the first frame as PIL presents it (the screen
  around it filled with the transparency index or 0, a palette looked up,
  mode "L" where the palette is the identity gray ramp);
* WebP (``data.webp``): lossy, lossless, with alpha, animated (the first
  frame on its canvas), as libwebp 1.6's WebPAnimDecoder gives it to PIL;
* TIFF (``data.tiff``): PIL's ``OPEN_INFO`` modes, uncompressed through
  PIL's raw decoder, CCITT, LZW, PackBits, Deflate, LZMA and JPEG as
  libtiff gives them to PIL, strips and tiles, both byte orders, BigTIFF,
  predictors, planar files, YCbCr through libtiff's RGBA interface, the
  Orientation tag applied as PIL applies it to TIFF;
* Netpbm (``data.netpbm``): P1-P6 plain and raw at any maxval, Pf;
* TGA (``data.tga``): colour-mapped, true colour and gray, raw and RLE;
* ICO (``data.ico``): the entry PIL picks, PNG or DIB with its mask;
* QOI (``data.qoi``), PCX and DCX's first page (``data.pcx``), SGI
  (``data.sgi``), Sun raster (``data.sun``), PIL's IM (``data.im``), MSP
  (``data.msp``) and XBM (``data.xbm``): every mode PIL opens them in, with
  PIL's decoders' quirks;
* ``.npy``: a uint8 (H, W) or (H, W, 3|4) array.

Every container but JPEG and WebP is decoded first to the samples and mode
``Image.open`` holds (``image_of``), then converted as PIL's
``convert("RGB")`` converts that mode (``convert_rgb``).

The format is read off the file's content, as ``Image.open`` asks its
plugins in turn (``pil_format``, ``sniff``, ``PIL_PLUGINS``: the accept
tests and, where ``Image.open`` passes a file on, the checks of each
plugin's _open, IM's, IMT's, IPTC's, PCD's and SPIDER's among them, which
have no accept test): a PNG named ``.jpg`` reads as PNG, a WebP named
``.bmp`` as WebP, and TGA, which has no magic number, only where no plugin
PIL tries first keeps the file.

``read_image`` returns None with a warning, as JAX's reader does on PIL's
exception (its mapper then drops the record), for a file that is corrupt in
a way PIL raises on (a truncated stream, a bad CRC, an empty file, a GIF
whose LZW data breaks, a WebP shorter than its RIFF size, a TIFF strip cut
short, a run past a PCX line or an SGI row) and for one PIL refuses too
(12-bit, 2-component, hierarchical, lossless arithmetic-coded JPEG,
fractional sampling ratios, a height left to a DNL marker, lossless JPEG
that needs a colour conversion, an arithmetic-coded scan past PIL's 64 KiB
read block; a PNG of an undefined color type and depth; a BMP of an
unknown depth, mask set or compression; a RIFF WebP whose first chunk PIL
does not take; a TIFF whose key is not in ``OPEN_INFO`` or whose
compression code PIL does not know; a P7 PAM or PF file, which PIL 12.1
opens no plugin for; a file whose magic number a plugin takes and whose
header it then refuses, when no other plugin opens it). So it does for the
files PIL opens and cannot load (``STUBS``): BUFR, GRIB and HDF5 (stubs
without a handler), MPEG (a header alone) and WMF or EMF (PIL has no
loader for them off Windows); and for EPS where no Ghostscript is installed
(``shutil.which("gs")``). A file PIL reads and the port does not (AVIF,
JPEG 2000, a CIELab TIFF, a TIFF under zstd, WebP, old-style JPEG,
ThunderScan, SGILog or RLEW, an IM image of PIL's bit decoder, EPS where
Ghostscript is installed, and any other format) raises ``ValueError``
naming it, so that no record JAX trains on is dropped quietly.

``read_rgb`` is the same read raising ``CorruptImage`` where ``read_image``
returns None (the panoptic mapper's ``convert("RGB")`` of an id PNG);
``read_label_map`` gives a file's stored samples as
``np.asarray(Image.open(f))`` does (the semantic labels: palette indices,
not colours; 16-bit gray as uint16, big-endian for an MM TIFF; 32-bit
integers as int32, floats as float32; a "1" image as bool).

``write_png`` writes gray, RGB or RGBA uint8 arrays (filter type 0 or 1 per
row, alternating, so the reader's filters are exercised; the reader tests'
fixtures). ``write_image`` is the counterpart of PIL's
``Image.fromarray(x).save(path)`` under every name PIL 12.1 registers for a
format the port reads (``_ENCODERS``): PIL's bytes for JPEG (``.jpg``,
``.jpeg``, ``.jfif``, ``.jpe``, ``.mpo``: ``encode_jpeg``), PNG (``.png``,
``.apng``: ``png.encode_png``), BMP and DIB (``encode_bmp``,
``encode_dib``), GIF (``gif.encode_gif``), ICO (``ico.encode_ico``), TIFF
(``encode_tiff``), Netpbm (``.ppm``, ``.pgm``, ``.pbm``, ``.pnm``,
``.pfm``: ``encode_netpbm``, P5 or P6 whatever the name), TGA (``.tga``,
``.icb``, ``.vda``, ``.vst``: ``encode_tga``), QOI (``qoi.encode_qoi``),
PCX (``pcx.encode_pcx``), SGI (``.sgi``, ``.rgb``, ``.rgba``, ``.bw``:
``sgi.encode_sgi``) and IM (``im.encode_im``); a lossy WebP file for
``.webp`` (``webp.encode_webp``, libwebp's settings under PIL, not its
bytes). ``.ras``, ``.dcx``, ``.msp`` and ``.xbm``, which the port reads and
PIL cannot write from a uint8 image, raise ``ValueError`` with PIL's
reason; other extensions (``.jp2``, ``.avif``, ...) raise ``ValueError``
naming them.
"""

from __future__ import annotations

import logging
import os
import shutil
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


def _i16(data: bytes, pos: int = 0, order: str = "<") -> int:
    return struct.unpack_from(order + "H", data, pos)[0] if len(data) >= pos + 2 else -1


def _i32(data: bytes, pos: int = 0, order: str = "<") -> int:
    return struct.unpack_from(order + "I", data, pos)[0] if len(data) >= pos + 4 else -1


def _cur_claims(d: bytes) -> bool:
    """Whether PIL's CUR plugin keeps a file its _accept takes: its _open
    raises an error ``Image.open`` passes over (no entry, a short entry, a
    bitmap header past the file: TypeError, IndexError, struct.error) and
    the next plugin is asked, or it goes on to the bitmap."""
    if not d.startswith(b"\0\0\2\0"):
        return False
    m = b""
    for i in range(_i16(d, 4)):
        s = d[6 + 16 * i:22 + 16 * i]
        if not s:
            return False
        if not m:
            m = s
        elif s[0] > m[0] and s[1] > m[1]:
            m = s
    return len(m) == 16 and _i32(d, _i32(m, 12)) != -1


def _gbr_claims(d: bytes) -> bool:
    """Whether PIL's GIMP brush plugin keeps a file: its _accept, then the
    header checks whose SyntaxError sends ``Image.open`` to the next plugin
    (big-endian words)."""
    if len(d) < 20 or _i32(d, 0, ">") < 20 or _i32(d, 4, ">") not in (1, 2):
        return False
    if _i32(d, 8, ">") == 0 or _i32(d, 12, ">") == 0 or _i32(d, 16, ">") not in (1, 4):
        return False
    return _i32(d, 4, ">") == 1 or d[20:24] == b"GIMP"


def _port(module: str, name: str = "claims"):
    """A plugin test that lives in one of the port's modules, imported at
    first use (the modules import this one)."""
    def test(data: bytes):
        import importlib

        return getattr(importlib.import_module(f"ape_tpu_torch.data.{module}"), name)(data)
    return test


def _tiff_prefix(d: bytes) -> bool:
    return d.startswith((b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a",
                         b"MM\x00\x2b", b"II\x2b\x00"))


def _gbr_short(d: bytes) -> bool:
    """Whether a file PIL opens as a GIMP brush holds less than its width x
    height x depth bytes after its header (PIL's load then raises "not
    enough image data"): a version 2 header shorter than 28 bytes reads its
    comment to the end of the file."""
    size, version, width, height, depth = struct.unpack_from(">5I", d)
    start = size if version == 1 or size >= 28 else len(d)
    return len(d) - min(start, len(d)) < width * height * depth


# the plugins Image.open tries, in its order (Image.preinit's six, then the
# rest of Image.ID after Image.init): (the format PIL names, the port's
# container or None, the test). A test answers False where the plugin's
# _accept refuses the file (or, without an _accept, its _open passes it
# on), a reason where its _accept takes the file and its _open raises a
# SyntaxError (Image.open then asks the next plugin), True where the plugin
# opens the file; it raises CorruptImage where Image.open raises. The
# plugins the port does not read are there for their place in the order
# and for the error that names them.
PIL_PLUGINS = (
    ("BMP", "bmp", lambda d: d.startswith(b"BM")),
    ("DIB", "dib", lambda d: _i32(d) in (12, 40, 52, 56, 64, 108, 124)),
    ("GIF", "gif", lambda d: d.startswith((b"GIF87a", b"GIF89a"))),
    ("JPEG", "jpeg", lambda d: d.startswith(JPEG_MAGIC)),
    ("PPM", "netpbm", lambda d: len(d) >= 2 and d.startswith(b"P") and d[1] in b"0123456fy"),
    ("PNG", "png", lambda d: d.startswith(PNG_MAGIC)),
    ("AVIF", None, lambda d: d[4:8] == b"ftyp" and d[8:12] in (b"avif", b"avis", b"mif1",
                                                                b"msf1")),
    ("BLP", None, lambda d: d.startswith((b"BLP1", b"BLP2"))),
    ("BUFR", None, lambda d: d.startswith((b"BUFR", b"ZCZC"))),
    ("CUR", None, lambda d: _cur_claims(d)),
    ("PCX", "pcx", _port("pcx")),
    ("DCX", "dcx", _port("pcx", "dcx_claims")),
    ("DDS", None, lambda d: d.startswith(b"DDS ")),
    ("EPS", None, lambda d: d.startswith(b"%!PS") or _i32(d) == 0xC6D3D0C5),
    ("FITS", None, lambda d: d.startswith(b"SIMPLE")),
    ("FLI", None, lambda d: len(d) >= 16 and _i16(d, 4) in (0xAF11, 0xAF12)
     and _i16(d, 14) in (0, 3)),
    ("FTEX", None, lambda d: d.startswith(b"FTEX")),
    ("GBR", None, lambda d: _gbr_claims(d)),
    ("GRIB", None, lambda d: len(d) >= 8 and d.startswith(b"GRIB") and d[7] == 1),
    ("HDF5", None, lambda d: d.startswith(b"\x89HDF\r\n\x1a\n")),
    ("JPEG2000", None, lambda d: d.startswith((b"\xff\x4f\xff\x51",
                                               b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"))),
    ("ICNS", None, lambda d: d.startswith(b"icns")),
    ("ICO", "ico", lambda d: d.startswith(b"\0\0\1\0")),
    ("IM", "im", _port("im")),
    ("IMT", None, _port("pil_plugins", "imt_claims")),
    ("IPTC", None, _port("pil_plugins", "iptc_claims")),
    ("MCIDAS", None, lambda d: d.startswith(b"\x00\x00\x00\x00\x00\x00\x00\x04")),
    ("MPEG", None, _port("pil_plugins", "mpeg_claims")),
    ("TIFF", "tiff", _tiff_prefix),
    ("MSP", "msp", _port("msp")),
    ("PCD", None, _port("pil_plugins", "pcd_claims")),
    ("PIXAR", None, lambda d: d.startswith(b"\200\350\000\000")),
    ("PSD", None, lambda d: d.startswith(b"8BPS")),
    ("QOI", "qoi", _port("qoi")),
    ("SGI", "sgi", _port("sgi")),
    ("SPIDER", None, _port("pil_plugins", "spider_claims")),
    ("SUN", "sun", _port("sun")),
    ("TGA", "tga", _port("tga", "accept")),
    ("WEBP", "webp", lambda d: d.startswith(b"RIFF") and d[8:12] == b"WEBP"
     and d[12:16] in (b"VP8 ", b"VP8X", b"VP8L")),
    ("WMF", None, _port("pil_plugins", "wmf_claims")),
    ("XBM", "xbm", _port("xbm")),
    ("XPM", None, _port("pil_plugins", "xpm_claims")),
    ("XVThumb", None, _port("pil_plugins", "xvthumb_claims")),
)
_KINDS = {fmt: kind for fmt, kind, _ in PIL_PLUGINS}
# the formats PIL opens as an image it has no loader for: convert("RGB")
# raises (a stub without its handler; MPEG's header alone; WMF off Windows)
STUBS = ("BUFR", "GRIB", "HDF5", "MPEG", "WMF")
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


def png_image(data: bytes):
    """PNG bytes -> (samples, mode, palette) as PIL opens them: "1" (bool),
    "L", "I;16" (uint16) and "P" (indices) (H, W); "LA", "RGB" and "RGBA"
    (H, W, C) uint8, 16-bit color as its high bytes (16-bit gray + alpha as
    "RGBA", the gray repeated)."""
    pixels, color, depth, palette = _png_samples(data)
    if color == 3:
        return pixels[..., 0], "P", palette
    if color == 0:
        return ((pixels[..., 0].astype(bool), "1", None) if depth == 1 else
                (pixels[..., 0], "I;16" if depth == 16 else "L", None))
    if depth == 16:
        pixels = (pixels >> 8).astype(np.uint8)
        if color == 4:
            return np.ascontiguousarray(pixels[..., [0, 0, 0, 1]]), "RGBA", None
    return pixels, {2: "RGB", 4: "LA", 6: "RGBA"}[color], None


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> RGB uint8 (H, W, 3), PIL's ``convert("RGB")`` of it."""
    return convert_rgb(*png_image(data))


def read_label_map(file_name: str) -> np.ndarray:
    """A label map as ``np.asarray(PIL.Image.open(file_name))`` gives it
    (``image_of``'s samples): palette images give their indices (not the
    colours), gray its values (H, W) uint8, 1-bit gray bool (PIL's "1"),
    16-bit gray uint16 ("I;16", big-endian for a TIFF's or an IM's
    "I;16B"), 32-bit integers int32 ("I"), floats float32 ("F"); color
    (H, W, C). A JPEG, WebP or ``.npy`` file, and a corrupt one, raise."""
    with open(file_name, "rb") as f:
        data = f.read()
    kind = sniff(data)
    if kind is None or kind in ("jpeg", "webp"):
        raise ValueError(f"{file_name}: the port reads label maps from PNG, BMP, DIB, GIF, "
                         "TIFF, Netpbm, TGA, ICO, QOI, PCX, DCX, SGI, Sun raster, IM, MSP and "
                         "XBM files only")
    return image_of(data, kind)[0]


def read_rgb(file_name: str) -> np.ndarray:
    """RGB uint8 (H, W, 3) of a file of a format the port reads
    (module docstring), raising ``CorruptImage`` where PIL's
    ``Image.open(file_name).convert("RGB")`` raises (a corrupt file, one
    PIL refuses, one PIL opens and cannot load), and ValueError for a
    format PIL reads and the port does not."""
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
    fmt, kind = _open_as(data)
    if kind is None:
        if not data:
            raise CorruptImage(f"{file_name}: an empty file")
        if fmt in STUBS:
            raise CorruptImage(f"PIL opens it as a {fmt} image and has no loader for it (cannot "
                               "load this image)")
        if fmt == "GBR" and _gbr_short(data):
            raise CorruptImage("PIL opens it as a GBR image and finds not enough image data")
        if fmt == "EPS":
            if shutil.which("gs") is None:
                raise CorruptImage("an EPS image, which PIL loads through Ghostscript, and no "
                                   "Ghostscript is installed")
            raise ValueError(f"{file_name}: an EPS image, which PIL rasterises through "
                             "Ghostscript and the port does not")
        raise ValueError(f"{file_name}: {_format_name(fmt, data)}, which PIL reads and the port "
                         "does not yet (the port reads JPEG, PNG, BMP, DIB, GIF, WebP, TIFF, "
                         "Netpbm, TGA, ICO, QOI, PCX, DCX, SGI, Sun raster, IM, MSP, XBM and "
                         ".npy images)")
    return decode_rgb(data, kind)


def pil_format(data: bytes) -> Optional[str]:
    """The format ``Image.open`` opens ``data`` as (``Image.open(f).format``:
    "JPEG", "PNG", "BUFR", "XVThumb", ...), asking ``PIL_PLUGINS`` in turn;
    None where no plugin takes it. Raises ``CorruptImage`` where
    ``Image.open`` raises: a plugin's _open fails on the file in a way PIL
    does not pass over, or a plugin took the file by its magic number,
    refused it, and no other plugin opens it."""
    refused = None
    for fmt, _, test in PIL_PLUGINS:
        got = test(data)
        if got is True:
            return fmt
        if got and refused is None:
            refused = f"PIL's {fmt} plugin refuses it ({got}) and no other plugin opens it"
    if refused:
        raise CorruptImage(refused)
    return None


def _open_as(data: bytes):
    """(``pil_format``'s answer, the port's container for it or None)."""
    fmt = pil_format(data)
    if fmt is not None:
        return fmt, _KINDS[fmt]
    if data[:2] in (b"P7", b"PF"):
        return None, "netpbm"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return None, "webp"
    return None, None


def sniff(data: bytes) -> Optional[str]:
    """The container the port reads that PIL would open ``data`` as:
    "jpeg", "png", "bmp", "dib", "gif", "netpbm", "ico", "tiff", "tga",
    "webp", "qoi", "pcx", "dcx", "sgi", "sun", "im", "msp", "xbm", or None
    (``pil_format``: the plugins are asked in ``Image.open``'s order, so a
    file that another plugin claims first, a DIB, a CUR, an IM header, is
    not read as TGA, which has no magic number and comes after them). P7 and
    PF Netpbm files, which no plugin of PIL 12.1 takes, are "netpbm", whose
    decoder refuses them; so is a RIFF WebP file whose first chunk is not
    VP8, VP8L or VP8X, which is no image to PIL: "webp", and its decoder
    refuses it. Raises ``CorruptImage`` where ``pil_format`` does."""
    return _open_as(data)[1]


def image_of(data: bytes, kind: str):
    """(samples, mode, palette) of a ``sniff``-ed container: what
    ``Image.open`` holds, before any conversion (``np.asarray`` of it)."""
    if kind == "png":
        return png_image(data)
    if kind == "gif":
        from ape_tpu_torch.data.gif import decode_gif

        samples, palette = decode_gif(data)
        return samples, "L" if palette is None else "P", palette
    if kind == "dib":
        from ape_tpu_torch.data.bmp import decode_bmp, dib_as_bmp

        return decode_bmp(dib_as_bmp(data))
    if kind == "netpbm":
        from ape_tpu_torch.data.netpbm import decode_netpbm

        return decode_netpbm(data) + (None,)
    if kind not in _READERS:
        raise ValueError(f"no sample reader for {kind}")
    import importlib

    module, name = _READERS[kind]
    return getattr(importlib.import_module(f"ape_tpu_torch.data.{module}"), name)(data)


# container -> (module, decoder of (samples, mode, palette))
_READERS = {"bmp": ("bmp", "decode_bmp"), "tiff": ("tiff", "decode_tiff"),
            "tga": ("tga", "decode_tga"), "ico": ("ico", "decode_ico"),
            "qoi": ("qoi", "decode_qoi"), "pcx": ("pcx", "decode_pcx"),
            "dcx": ("pcx", "decode_dcx"), "sgi": ("sgi", "decode_sgi"),
            "sun": ("sun", "decode_sun"), "im": ("im", "decode_im"),
            "msp": ("msp", "decode_msp"), "xbm": ("xbm", "decode_xbm")}


def decode_rgb(data: bytes, kind: str) -> np.ndarray:
    """The bytes of a ``sniff``-ed container -> RGB uint8 (H, W, 3), PIL's
    ``convert("RGB")``: palettes looked up, gray repeated, alpha dropped."""
    if kind == "jpeg":
        from ape_tpu_torch.data.jpeg import decode_jpeg

        return decode_jpeg(data)
    if kind == "webp":
        from ape_tpu_torch.data.webp import decode_webp

        return np.ascontiguousarray(decode_webp(data)[..., :3])
    return convert_rgb(*image_of(data, kind))


def convert_rgb(samples: np.ndarray, mode: str, palette) -> np.ndarray:
    """PIL's ``convert("RGB")`` of a mode's samples: "1" to 0 and 255, "L"
    and "LA" repeated, "I;16", "I;16L", "I;16B" and "I" clipped to 0..255,
    "F" clipped and truncated (f2l), "P" and "PA" looked up, "CMYK" through
    ``cmyk2rgb``, "YCbCr" through ``ycbcr2rgb``, alpha dropped; "LAB" goes
    through LittleCMS in PIL and raises ``ValueError`` here."""
    if mode in ("P", "PA"):
        return _palette_lookup(samples if mode == "P" else samples[..., 0], palette)
    if mode == "LAB":
        raise ValueError("a CIELab image: PIL converts LAB to RGB through LittleCMS, which the "
                         "port does not carry")
    if mode == "CMYK":
        return cmyk_to_rgb(samples)
    if mode == "YCbCr":
        return ycbcr_to_rgb(samples)
    if mode in ("RGB", "RGBA"):
        return np.ascontiguousarray(samples[..., :3])
    if mode == "1":
        gray = samples.astype(np.uint8) * np.uint8(255)
    elif mode == "LA":
        gray = samples[..., 0]
    elif mode == "F":
        v = np.nan_to_num(samples.astype(np.float32), nan=0.0)
        gray = np.where(v <= 0, 0, np.where(v >= 255, 255, v)).astype(np.uint8)
    elif mode in ("I;16", "I;16L", "I;16B", "I"):
        gray = np.clip(samples.astype(np.int64), 0, 255).astype(np.uint8)
    else:
        gray = samples
    return np.repeat(gray[..., None], 3, axis=2)


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """PIL's cmyk2rgb: C, M and Y each scaled by 255 - K and taken from it."""
    v = cmyk.astype(np.int32)
    nk = 255 - v[..., 3:4]
    tmp = v[..., :3] * nk + 128
    return np.clip(nk - (((tmp >> 8) + tmp) >> 8), 0, 255).astype(np.uint8)


def _ycbcr_table(c: float) -> np.ndarray:
    """One of ConvertYCbCr.c's tables: c * (i - 128) at 6 fraction bits, as
    C's ``(int)(x + 0.5)`` rounds it."""
    return np.trunc(c * 64 * (np.arange(256) - 128) + 0.5).astype(np.int32)


_R_CR, _G_CB, _G_CR, _B_CB = (_ycbcr_table(c) for c in (1.402, -0.34414, -0.71414, 1.772))


def ycbcr_to_rgb(ycc: np.ndarray) -> np.ndarray:
    """PIL's ycbcr2rgb (ConvertYCbCr.c): fixed-point offsets from Cb and Cr
    added to Y, each shifted down by 6 bits, clipped to 0..255."""
    y = ycc[..., 0].astype(np.int32)
    cb, cr = ycc[..., 1], ycc[..., 2]
    rgb = np.stack([y + (_R_CR[cr] >> 6), y + ((_G_CB[cb] + _G_CR[cr]) >> 6),
                    y + (_B_CB[cb] >> 6)], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _palette_lookup(indices: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """P -> RGB as PIL converts it: a palette of fewer than 256 entries
    gives black past its end."""
    full = np.zeros((256, 3), np.uint8)
    full[:min(len(palette), 256)] = palette[:256]
    return full[indices]


def _format_name(fmt: Optional[str], data: bytes) -> str:
    """The format PIL opens ``data`` as (``pil_format``), for the error."""
    if fmt is None:
        return f"an image of another format (first bytes {data[:8].hex()})"
    return f"a {fmt} image"


def read_image(file_name: str) -> Optional[np.ndarray]:
    """``read_rgb``, with None and a warning for a corrupt file and for one
    PIL refuses, as JAX's reader returns None and its mapper then drops the
    record."""
    try:
        return read_rgb(file_name)
    except CorruptImage as e:
        logger.warning(f"failed to read {file_name}: {e}")
        return None


# extension -> (module, encoder) of each name PIL 12.1 registers for a
# format the port reads and PIL writes (Image.registered_extensions()); PIL
# writes ".mpo" as its JPEG, ".pfm" as its PPM, ".dib" as BMP without the
# file header, ".rgb", ".rgba" and ".bw" as any SGI image
_ENCODERS = {".jpg": ("jpeg", "encode_jpeg"), ".jpeg": ("jpeg", "encode_jpeg"),
             ".jfif": ("jpeg", "encode_jpeg"), ".jpe": ("jpeg", "encode_jpeg"),
             ".mpo": ("jpeg", "encode_jpeg"), ".png": ("png", "encode_png"),
             ".apng": ("png", "encode_png"), ".bmp": ("bmp", "encode_bmp"),
             ".dib": ("bmp", "encode_dib"), ".gif": ("gif", "encode_gif"),
             ".ico": ("ico", "encode_ico"), ".webp": ("webp", "encode_webp"),
             ".tif": ("tiff", "encode_tiff"), ".tiff": ("tiff", "encode_tiff"),
             ".ppm": ("netpbm", "encode_netpbm"), ".pgm": ("netpbm", "encode_netpbm"),
             ".pbm": ("netpbm", "encode_netpbm"), ".pnm": ("netpbm", "encode_netpbm"),
             ".pfm": ("netpbm", "encode_netpbm"), ".tga": ("tga", "encode_tga"),
             ".icb": ("tga", "encode_tga"), ".vda": ("tga", "encode_tga"),
             ".vst": ("tga", "encode_tga"), ".qoi": ("qoi", "encode_qoi"),
             ".pcx": ("pcx", "encode_pcx"), ".sgi": ("sgi", "encode_sgi"),
             ".rgb": ("sgi", "encode_sgi"), ".rgba": ("sgi", "encode_sgi"),
             ".bw": ("sgi", "encode_sgi"), ".im": ("im", "encode_im")}
# the encoders that write the file's name into its header, as PIL's do
_NAMED = ("encode_sgi", "encode_im")
# names of formats the port reads that PIL cannot write from a uint8 gray
# or RGB image, with PIL's reason
_UNWRITABLE = {".ras": "PIL registers no Sun raster writer (its save raises KeyError 'SUN')",
               ".dcx": "PIL registers no DCX writer (its save raises KeyError 'DCX')",
               ".msp": "PIL writes MSP from mode \"1\" images only (cannot write mode RGB or "
                       "L as MSP)",
               ".xbm": "PIL writes XBM from mode \"1\" images only (cannot write mode RGB or "
                       "L as XBM)"}


def encoder_of(file_name: str):
    """The encoder ``write_image`` uses for ``file_name``'s extension (any
    case); ``ValueError`` naming the extension where the port writes none,
    with PIL's reason where PIL cannot write it either."""
    import importlib

    ext = os.path.splitext(str(file_name))[1].lower()
    if ext in _UNWRITABLE:
        raise ValueError(f"{file_name}: {_UNWRITABLE[ext]}, so the port writes no {ext} images")
    if ext not in _ENCODERS:
        raise ValueError(f"{file_name}: the port writes {', '.join(_ENCODERS)} images, not "
                         f"{ext or 'a file without an extension'}")
    module, name = _ENCODERS[ext]
    return getattr(importlib.import_module(f"ape_tpu_torch.data.{module}"), name)


def write_image(file_name: str, image: np.ndarray) -> None:
    """Write a uint8 (H, W) or (H, W, 3) image as PIL's
    ``Image.fromarray(image).save(file_name)`` does, by its extension: PIL's
    bytes for JPEG (``.jpg``, ``.jpeg``, ``.jfif``, ``.jpe``, ``.mpo``),
    PNG (``.png``, ``.apng``), BMP (``.bmp``; ``.dib`` without the file
    header), GIF (``.gif``: PIL's median-cut palette and LZW), ICO
    (``.ico``: PIL's seven sizes as PNG frames), uncompressed TIFF
    (``.tif``, ``.tiff``), Netpbm (``.ppm``, ``.pgm``, ``.pbm``, ``.pnm``,
    ``.pfm``: P5 or P6), TGA (``.tga``, ``.icb``, ``.vda``, ``.vst``), QOI
    (``.qoi``), PCX (``.pcx``), SGI (``.sgi``, ``.rgb``, ``.rgba``,
    ``.bw``) and IM (``.im``), the last two with the file's name in their
    header; for ``.webp`` a lossy WebP file encoded at PIL's settings
    (quality 80, method 4), whose bytes may differ from libwebp's. Any other
    extension raises ``ValueError`` naming it (``.ras``, ``.dcx``, ``.msp``
    and ``.xbm`` with PIL's reason); nothing is written then."""
    encode = encoder_of(file_name)
    data = encode(image, str(file_name)) if encode.__name__ in _NAMED else encode(image)
    with open(file_name, "wb") as f:
        f.write(data)


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
