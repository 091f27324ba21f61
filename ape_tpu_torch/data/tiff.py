"""TIFF reading and writing without PIL, as PIL 12.1's ``TiffImagePlugin``
reads and writes them (on libtiff 4.7), for ``image_io``.

``decode_tiff`` gives what ``Image.open(f)`` holds, before any conversion:
(samples, mode, palette), the first image of the file (PIL opens frame 0):

* the container: II and MM byte order, classic TIFF, and BigTIFF where PIL
  reads it as BigTIFF (only under II: PIL reads the third byte of the
  header, which is 0 in an MM BigTIFF, and then fails on its directory);
  the tags PIL's directory loader keeps (an entry of an unknown type, or
  whose data lies past the file, is skipped);
* the mode: PIL's ``OPEN_INFO`` table, keyed by byte order, photometric,
  sample format, fill order, bits per sample and extra samples; a key not
  in it is refused;
* uncompressed data through PIL's own raw decoder: strips, or tiles (an
  interior tile's rows as wide as its extent, an edge tile's rows as wide
  as the tile), each strip or tile of a PlanarConfiguration 2 file read
  into one band with one character of the raw mode; FillOrder 2 reverses
  each byte's bits, the predictor is ignored (PIL's raw decoder does);
* compressed data as libtiff gives it to PIL (FillOrder 2 folded into the
  data, 16- and 32-bit samples in the machine's byte order, the predictor
  undone): CCITT modified Huffman, Group 3 (1-D and 2-D), Group 4, LZW and
  PackBits by the host library (``csrc/tiff_host.cpp``), Deflate and LZMA
  by the standard library's ``zlib`` and ``lzma``, JPEG by the port's codec
  (``data.jpeg``, each strip or tile completed by the JPEGTables tag; a
  YCbCr image in one plane converted to RGB by libjpeg, any other the
  components as stored); predictor 2 at 8, 16 and 32 bits and predictor 3;
  planar files read plane by plane into the first bands, as PIL's libtiff
  decoder does;
* YCbCr that is not JPEG through libtiff's RGBA interface, as PIL reads
  it: subsampling 1, 2 and 4 each way (the chroma of a block repeated over
  it), ``TIFFYCbCrToRGB``'s integer tables from ReferenceBlackWhite and
  YCbCrCoefficients;
* the Orientation tag applied after the load, as PIL's ``load_end`` applies
  it (``ImageOps.exif_transpose``);
* PIL's decompression-bomb check.

A file PIL refuses (a key not in ``OPEN_INFO``, a compression code PIL does
not know, a strip cut short, data libtiff fails on, an offset past the end)
raises ``CorruptImage``. The compressions PIL hands to libtiff and the port
does not decode (old-style JPEG, ThunderScan, SGILog, CCITT RLEW, zstd,
WebP) raise ``ValueError`` naming them.

``image_io.convert_rgb`` then converts each mode as PIL's
``convert("RGB")`` does (a "P" image through its ColorMap reduced to the
high bytes; "LAB", which PIL converts through LittleCMS, raises
``ValueError``). Damaged Group 3 data is not matched: libtiff passes a
strip that ends early and leaves the rows after the damage as its buffer
held them, which the port leaves white.

``encode_tiff`` writes the bytes of ``Image.fromarray(x).save(f, "TIFF")``
for uint8 (H, W) and (H, W, 3): PIL's uncompressed writer, one strip.
"""

from __future__ import annotations

import lzma
import struct
import zlib

import numpy as np

from ape_tpu_torch.data.image_io import CorruptImage, bomb_check

II, MM = b"II", b"MM"
# TiffImagePlugin.PREFIXES: the headers PIL's _accept takes
TIFF_PREFIXES = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a", b"MM\x00\x2b",
                 b"II\x2b\x00")
COMPRESSION_INFO = {1: "raw", 2: "tiff_ccitt", 3: "group3", 4: "group4", 5: "tiff_lzw",
                    6: "tiff_jpeg", 7: "jpeg", 8: "tiff_adobe_deflate", 32771: "tiff_raw_16",
                    32773: "packbits", 32809: "tiff_thunderscan", 32946: "tiff_deflate",
                    34676: "tiff_sgilog", 34677: "tiff_sgilog24", 34925: "lzma", 50000: "zstd",
                    50001: "webp"}
# the compressions PIL hands to libtiff and the port does not decode
NOT_PORTED = {"tiff_jpeg": "old-style JPEG (6)", "tiff_raw_16": "CCITT RLEW (32771)",
              "tiff_thunderscan": "ThunderScan (32809)", "tiff_sgilog": "SGILog (34676)",
              "tiff_sgilog24": "SGILog24 (34677)", "zstd": "zstd (50000)", "webp": "WebP (50001)"}

# TiffImagePlugin.OPEN_INFO: (photometric, sample format, fill order, bits,
# extra samples) -> (mode, raw mode) under both byte orders ...
_OPEN_BOTH = {
    (0, (1,), 1, (1,), ()): ("1", "1;I"), (0, (1,), 2, (1,), ()): ("1", "1;IR"),
    (1, (1,), 1, (1,), ()): ("1", "1"), (1, (1,), 2, (1,), ()): ("1", "1;R"),
    (0, (1,), 1, (2,), ()): ("L", "L;2I"), (0, (1,), 2, (2,), ()): ("L", "L;2IR"),
    (1, (1,), 1, (2,), ()): ("L", "L;2"), (1, (1,), 2, (2,), ()): ("L", "L;2R"),
    (0, (1,), 1, (4,), ()): ("L", "L;4I"), (0, (1,), 2, (4,), ()): ("L", "L;4IR"),
    (1, (1,), 1, (4,), ()): ("L", "L;4"), (1, (1,), 2, (4,), ()): ("L", "L;4R"),
    (0, (1,), 1, (8,), ()): ("L", "L;I"), (0, (1,), 2, (8,), ()): ("L", "L;IR"),
    (1, (1,), 1, (8,), ()): ("L", "L"), (1, (2,), 1, (8,), ()): ("L", "L"),
    (1, (1,), 2, (8,), ()): ("L", "L;R"),
    (1, (1,), 1, (8, 8), (2,)): ("LA", "LA"),
    (2, (1,), 1, (8, 8, 8), ()): ("RGB", "RGB"), (2, (1,), 2, (8, 8, 8), ()): ("RGB", "RGB;R"),
    (2, (1,), 1, (8, 8, 8, 8), ()): ("RGBA", "RGBA"),
    (2, (1,), 1, (8, 8, 8, 8), (0,)): ("RGB", "RGBX"),
    (2, (1,), 1, (8, 8, 8, 8, 8), (0, 0)): ("RGB", "RGBXX"),
    (2, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0, 0)): ("RGB", "RGBXXX"),
    (2, (1,), 1, (8, 8, 8, 8), (1,)): ("RGBA", "RGBa"),
    (2, (1,), 1, (8, 8, 8, 8, 8), (1, 0)): ("RGBA", "RGBaX"),
    (2, (1,), 1, (8, 8, 8, 8, 8, 8), (1, 0, 0)): ("RGBA", "RGBaXX"),
    (2, (1,), 1, (8, 8, 8, 8), (2,)): ("RGBA", "RGBA"),
    (2, (1,), 1, (8, 8, 8, 8, 8), (2, 0)): ("RGBA", "RGBAX"),
    (2, (1,), 1, (8, 8, 8, 8, 8, 8), (2, 0, 0)): ("RGBA", "RGBAXX"),
    (2, (1,), 1, (8, 8, 8, 8), (999,)): ("RGBA", "RGBA"),
    (3, (1,), 1, (1,), ()): ("P", "P;1"), (3, (1,), 2, (1,), ()): ("P", "P;1R"),
    (3, (1,), 1, (2,), ()): ("P", "P;2"), (3, (1,), 2, (2,), ()): ("P", "P;2R"),
    (3, (1,), 1, (4,), ()): ("P", "P;4"), (3, (1,), 2, (4,), ()): ("P", "P;4R"),
    (3, (1,), 1, (8,), ()): ("P", "P"), (3, (1,), 2, (8,), ()): ("P", "P;R"),
    (3, (1,), 1, (8, 8), (0,)): ("P", "PX"), (3, (1,), 1, (8, 8), (2,)): ("PA", "PA"),
    (5, (1,), 1, (8, 8, 8, 8), ()): ("CMYK", "CMYK"),
    (5, (1,), 1, (8, 8, 8, 8, 8), (0,)): ("CMYK", "CMYKX"),
    (5, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0)): ("CMYK", "CMYKXX"),
    (6, (1,), 1, (8,), ()): ("L", "L"),
    (6, (1,), 1, (8, 8, 8), ()): ("RGB", "RGBX"),
    (8, (1,), 1, (8, 8, 8), ()): ("LAB", "LAB"),
}
# ... and under one byte order
_OPEN_ONE = {
    (II, 1, (1,), 1, (12,), ()): ("I;16", "I;12"),
    (II, 0, (1,), 1, (16,), ()): ("I;16", "I;16"),
    (II, 1, (1,), 1, (16,), ()): ("I;16", "I;16"),
    (MM, 1, (1,), 1, (16,), ()): ("I;16B", "I;16B"),
    (II, 1, (1,), 2, (16,), ()): ("I;16", "I;16R"),
    (II, 1, (2,), 1, (16,), ()): ("I", "I;16S"),
    (MM, 1, (2,), 1, (16,), ()): ("I", "I;16BS"),
    (II, 0, (3,), 1, (32,), ()): ("F", "F;32F"),
    (MM, 0, (3,), 1, (32,), ()): ("F", "F;32BF"),
    (II, 1, (1,), 1, (32,), ()): ("I", "I;32N"),
    (II, 1, (2,), 1, (32,), ()): ("I", "I;32S"),
    (MM, 1, (2,), 1, (32,), ()): ("I", "I;32BS"),
    (II, 1, (3,), 1, (32,), ()): ("F", "F;32F"),
    (MM, 1, (3,), 1, (32,), ()): ("F", "F;32BF"),
}
for _order, _end in ((II, "L"), (MM, "B")):
    _OPEN_ONE.update({
        (_order, 2, (1,), 1, (16, 16, 16), ()): ("RGB", f"RGB;16{_end}"),
        (_order, 2, (1,), 1, (16, 16, 16, 16), ()): ("RGBA", f"RGBA;16{_end}"),
        (_order, 2, (1,), 1, (16, 16, 16, 16), (0,)): ("RGB", f"RGBX;16{_end}"),
        (_order, 2, (1,), 1, (16, 16, 16, 16), (1,)): ("RGBA", f"RGBa;16{_end}"),
        (_order, 2, (1,), 1, (16, 16, 16, 16), (2,)): ("RGBA", f"RGBA;16{_end}"),
        (_order, 5, (1,), 1, (16, 16, 16, 16), ()): ("CMYK", f"CMYK;16{_end}"),
    })
OPEN_INFO = {**{(order,) + key: v for key, v in _OPEN_BOTH.items() for order in (II, MM)},
             **_OPEN_ONE}
MAX_SAMPLESPERPIXEL = max(len(key[4]) for key in OPEN_INFO)

# tags
WIDTH, LENGTH, BITS, COMPRESSION, PHOTOMETRIC, FILLORDER = 256, 257, 258, 259, 262, 266
STRIPOFFSETS, ORIENTATION, SAMPLES, ROWSPERSTRIP, STRIPBYTECOUNTS = 273, 274, 277, 278, 279
PLANAR, T4OPTIONS, PREDICTOR, COLORMAP = 284, 292, 317, 320
TILEWIDTH, TILELENGTH, TILEOFFSETS, TILEBYTECOUNTS = 322, 323, 324, 325
EXTRASAMPLES, SAMPLEFORMAT, JPEGTABLES = 338, 339, 347
YCBCRCOEFFICIENTS, YCBCRSUBSAMPLING, REFERENCEBLACKWHITE = 529, 530, 532
# tag type -> (bytes a value, struct code); PIL loads these and skips others
_TYPES = {1: (1, "B"), 2: (1, "s"), 3: (2, "H"), 4: (4, "L"), 5: (8, "LL"), 6: (1, "b"),
          7: (1, "s"), 8: (2, "h"), 9: (4, "l"), 10: (8, "ll"), 11: (4, "f"), 12: (8, "d"),
          13: (4, "L"), 16: (8, "Q")}

# raw mode -> bits a pixel (PIL's unpackers)
_RAW_BITS = {"1": 1, "1;I": 1, "1;R": 1, "1;IR": 1, "P;1": 1, "P;1R": 1,
             "L;2": 2, "L;2I": 2, "L;2R": 2, "L;2IR": 2, "P;2": 2, "P;2R": 2,
             "L;4": 4, "L;4I": 4, "L;4R": 4, "L;4IR": 4, "P;4": 4, "P;4R": 4,
             "L": 8, "L;I": 8, "L;R": 8, "L;IR": 8, "P": 8, "P;R": 8, "I;12": 12,
             "LA": 16, "PA": 16, "PX": 16, "RGB": 24, "RGB;R": 24, "LAB": 24,
             "RGBA": 32, "RGBX": 32, "RGBa": 32, "CMYK": 32, "RGBXX": 40, "RGBaX": 40,
             "RGBAX": 40, "CMYKX": 40, "RGBXXX": 48, "RGBaXX": 48, "RGBAXX": 48, "CMYKXX": 48}
_BANDS = {"1": 1, "L": 1, "P": 1, "I;16": 1, "I;16B": 1, "I": 1, "F": 1, "LA": 2, "PA": 2,
          "RGB": 3, "LAB": 3, "RGBA": 4, "CMYK": 4}
# where each band of a mode sits in PIL's 4-byte pixel (LA and PA keep alpha last)
_PIXEL_BYTES = {"LA": (0, 3), "PA": (0, 3)}
_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def raw_bits(rawmode: str) -> int:
    if rawmode in _RAW_BITS:
        return _RAW_BITS[rawmode]
    if rawmode.startswith(("I;16", "RGB;16")):
        return 16 if rawmode.startswith("I") else 48
    if rawmode.startswith(("F;32", "I;32")):
        return 32
    if ";16" in rawmode:  # RGBA;16, RGBX;16, RGBa;16, CMYK;16
        return 64
    if len(rawmode) == 1:  # one band of a planar file
        return 8
    raise CorruptImage(f"no unpacker for raw mode {rawmode}")


def _dtype(mode: str):
    return {"1": bool, "I;16": "<u2", "I;16B": ">u2", "I": "<i4", "F": "<f4"}.get(mode, np.uint8)


def _new(mode: str, width: int, height: int) -> np.ndarray:
    bands = _BANDS[mode]
    shape = (height, width) if bands == 1 else (height, width, bands)
    return np.zeros(shape, _dtype(mode))


def unpack(rawmode: str, rows: np.ndarray, width: int, mode: str) -> np.ndarray:
    """PIL's unpacker of ``rawmode`` into ``mode``: rows (H, >= row bytes)
    uint8 -> samples (H, W) or (H, W, bands) as ``np.asarray`` gives them."""
    height = rows.shape[0]
    need = (width * raw_bits(rawmode) + 7) // 8
    rows = np.ascontiguousarray(rows[:, :need])
    if len(rawmode) > 1 and rawmode.endswith("R"):  # FillOrder 2: each byte's bits reversed
        rows = _REVERSE[rows]
        rawmode = rawmode[:-1].rstrip(";")
    bits = raw_bits(rawmode)
    if bits < 8 and not rawmode.startswith("I;"):
        depth = bits
        v = np.unpackbits(rows, axis=1).reshape(height, -1, depth)[:, :width]
        v = (v * (1 << np.arange(depth - 1, -1, -1))).sum(-1)
        invert = rawmode.startswith(("1;I", "L;2I", "L;4I"))
        if rawmode.startswith("1"):
            return (v == 0) if invert else (v == 1)
        if rawmode.startswith("P"):
            return v.astype(np.uint8)
        v = v * (255 // ((1 << depth) - 1))
        return (255 - v if invert else v).astype(np.uint8)
    if rawmode in ("L", "P", "L;I"):
        v = rows[:, :width]
        return 255 - v if rawmode == "L;I" else v.copy()
    if rawmode == "I;12":
        b = rows.astype(np.uint16)
        out = np.zeros((height, width), "<u2")
        pairs = (width + 1) // 2
        trip = np.zeros((height, pairs * 3), np.uint16)
        trip[:, :b.shape[1]] = b[:, :pairs * 3]
        out_pairs = np.stack([(trip[:, 0::3] << 4) | (trip[:, 1::3] >> 4),
                              ((trip[:, 1::3] & 15) << 8) | trip[:, 2::3]], -1)
        out[:] = out_pairs.reshape(height, -1)[:, :width]
        return out
    if rawmode.startswith(("I;16", "I;32", "F;32")):
        size = 2 if rawmode.startswith("I;16") else 4
        big = rawmode in ("I;16B", "I;16BS", "I;32BS", "F;32BF")
        kind = "f" if rawmode.startswith("F") else "i" if rawmode.endswith("S") else "u"
        v = rows[:, :width * size].copy().view(f"{'>' if big else '<'}{kind}{size}")
        return v.astype(_dtype(mode))
    if len(rawmode) == 1:  # one band of a planar file
        return rows[:, :width]
    wide = ";16" in rawmode
    name = rawmode.split(";")[0]
    step = 2 if wide else 1
    px = rows[:, :width * len(name) * step].reshape(height, width, len(name) * step)
    if wide:  # the high byte of each sample
        px = px[..., 0::2] if rawmode.endswith("B") else px[..., 1::2]
    bands = _BANDS[mode]
    if bands == 1:  # PX: the palette index, the extra sample skipped
        return np.ascontiguousarray(px[..., 0])
    out = np.ascontiguousarray(px[..., :bands])
    if name.startswith("RGBa"):  # premultiplied: PIL's unpackRGBa divides, 0 where alpha is
        a = out[..., 3:].astype(np.int32)
        rgb = np.minimum(out[..., :3].astype(np.int32) * 255 // np.maximum(a, 1), 255)
        out = np.where(a == 0, 0, np.concatenate([rgb, a], -1)).astype(np.uint8)
    return out


class _Directory:
    """The first image file directory as PIL's ``ImageFileDirectory_v2``
    loads it: tag -> values (a tuple; bytes for BYTE, ASCII and UNDEFINED)."""

    def __init__(self, data: bytes):
        if not data.startswith(TIFF_PREFIXES):
            raise CorruptImage("not a TIFF file")
        self.prefix = data[:2]
        self.e = ">" if self.prefix == MM else "<"
        self.big = data[2] == 43
        header = data[:16] if self.big else data[:8]
        if len(header) < (16 if self.big else 8):
            raise CorruptImage("truncated TIFF header")
        offset = struct.unpack(self.e + ("Q" if self.big else "L"),
                               header[8:16] if self.big else header[4:8])[0]
        if not offset:
            raise CorruptImage("no more images in TIFF file")
        if offset >= 2**63:
            raise CorruptImage("Unable to seek to frame")
        self.tags = {}
        self._load(data, offset)

    def _load(self, data: bytes, pos: int) -> None:
        e, big = self.e, self.big
        entry, head = (20, "HHQ8s") if big else (12, "HHL4s")
        count_size = 8 if big else 2
        if pos + count_size > len(data):
            return  # PIL warns and keeps no tag
        n = struct.unpack_from(e + ("Q" if big else "H"), data, pos)[0]
        pos += count_size
        for _ in range(n):
            if pos + entry > len(data):
                return  # the tags read so far stand
            tag, typ, count, inline = struct.unpack_from(e + head, data, pos)
            pos += entry
            if typ not in _TYPES:
                continue
            unit, code = _TYPES[typ]
            size = count * unit
            if size > (8 if big else 4):
                at = struct.unpack(e + ("Q" if big else "L"), inline)[0]
                value = data[at:at + size]
            else:
                value = inline[:size]
            if len(value) != size or not value:
                continue  # "Possibly corrupt EXIF data": the tag is skipped
            if code == "s" or typ == 1:
                self.tags[tag] = value
            else:
                vals = struct.unpack(e + code * count, value)
                if typ in (5, 10):
                    vals = tuple(a / b if b else float("nan") for a, b in zip(vals[::2],
                                                                             vals[1::2]))
                self.tags[tag] = vals

    def get(self, tag, default=None):
        v = self.tags.get(tag)
        if v is None:
            return default
        return tuple(v) if isinstance(v, bytes) else v

    def one(self, tag, default=None):
        v = self.get(tag)
        return default if v is None else v[0]


def _ycbcr_tables(luma, ref):
    """libtiff's TIFFYCbCrToRGBInit (tif_color.c), in float as it computes
    them: Y, Cr->R, Cb->B, Cr->G and Cb->G tables over the 256 codes."""
    f32 = np.float32
    lr, lg, lb = (f32(v) for v in luma)
    ref = [f32(v) for v in ref]

    def fix(x):
        return int(np.float64(x) * 65536 + 0.5)

    def clampf(v, lo, hi):
        return lo if v < lo else hi if v > hi else v

    f1 = f32(2) - f32(2) * lr
    d1 = fix(clampf(f1, f32(0), f32(2)))
    f2 = lr * f1 / lg
    d2 = -fix(clampf(f2, f32(0), f32(2)))
    f3 = f32(2) - f32(2) * lb
    d3 = fix(clampf(f3, f32(0), f32(2)))
    f4 = lb * f3 / lg
    d4 = -fix(clampf(f4, f32(0), f32(2)))

    def code2v(c, rb, rw, cr):
        den = f32(rw - rb) if rw - rb != 0 else f32(1)
        return f32(f32(c - int(rb)) * f32(cr)) / den

    def clampw(v):
        return int(clampf(v, f32(-128 * 32), f32(128 * 32)))

    y_tab, cr_r, cb_b, cr_g, cb_g = (np.zeros(256, np.int64) for _ in range(5))
    for i, x in enumerate(range(-128, 128)):
        cr = clampw(code2v(x, ref[4] - f32(128), ref[5] - f32(128), 127))
        cb = clampw(code2v(x, ref[2] - f32(128), ref[3] - f32(128), 127))
        cr_r[i] = (d1 * cr + 32768) >> 16
        cb_b[i] = (d3 * cb + 32768) >> 16
        cr_g[i] = d2 * cr
        cb_g[i] = d4 * cb + 32768
        y_tab[i] = clampw(code2v(x + 128, ref[0], ref[1], 255))
    return y_tab, cr_r, cb_b, cr_g, cb_g


def _ycbcr_to_rgb(blocks: np.ndarray, width: int, height: int, hs: int, vs: int, tables):
    """Decoded YCbCr blocks (hs * vs luma samples, Cb, Cr each) of a strip
    or tile -> RGB (height, width, 3), as TIFFRGBAImage's putcontig8bitYCbCr
    routines fill it (a block's chroma over all its pixels)."""
    bw, bh = -(-width // hs), -(-height // vs)
    size = hs * vs + 2
    if blocks.size < bw * bh * size:
        raise CorruptImage("not enough YCbCr data")
    b = blocks[:bw * bh * size].reshape(bh, bw, size).astype(np.int64)
    y = b[..., :hs * vs].reshape(bh, bw, vs, hs).transpose(0, 2, 1, 3).reshape(bh * vs, bw * hs)
    cb = np.repeat(np.repeat(b[..., -2], vs, 0), hs, 1)
    cr = np.repeat(np.repeat(b[..., -1], vs, 0), hs, 1)
    y, cb, cr = y[:height, :width], cb[:height, :width], cr[:height, :width]
    y_tab, cr_r, cb_b, cr_g, cb_g = tables
    yv = y_tab[y]
    r = yv + cr_r[cr]
    g = yv + ((cb_g[cb] + cr_g[cr]) >> 16)
    bl = yv + cb_b[cb]
    return np.clip(np.stack([r, g, bl], -1), 0, 255).astype(np.uint8)


def _jpeg_sof(stream: bytes):
    """(components, [(h, v) per component], width, height) of the first
    frame header in a JPEG stream, or None."""
    pos = 2
    while pos + 4 <= len(stream):
        if stream[pos] != 0xFF:
            pos += 1
            continue
        m = stream[pos + 1]
        if m in (0xD8, 0x01) or 0xD0 <= m <= 0xD7 or m == 0xFF:
            pos += 2 if m != 0xFF else 1
            continue
        length = struct.unpack(">H", stream[pos + 2:pos + 4])[0]
        if m in (0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF):
            body = stream[pos + 4:pos + 2 + length]
            if len(body) < 6:
                return None
            height, width, n = struct.unpack(">HHB", body[1:6])
            samp = [(body[7 + 3 * i] >> 4, body[7 + 3 * i] & 15) for i in range(n)
                    if 8 + 3 * i < len(body)]
            return n, samp, width, height
        pos += 2 + length
    return None


class _Image:
    """The first image of a TIFF file, set up as PIL's ``_setup`` sets it."""

    def __init__(self, data: bytes):
        self.data = data
        d = self.d = _Directory(data)
        if 0xBC01 in d.tags:
            raise CorruptImage("Windows Media Photo files not yet supported")
        code = d.one(COMPRESSION, 1)
        if code not in COMPRESSION_INFO:
            raise CorruptImage(f"TIFF compression {code}, which PIL does not know")
        self.compression = COMPRESSION_INFO[code]
        self.code = code
        self.planar = d.one(PLANAR, 1)
        photo = d.one(PHOTOMETRIC, 0)
        if self.compression == "tiff_jpeg":
            photo = 6
        self.photo = photo
        fillorder = d.one(FILLORDER, 1)
        if WIDTH not in d.tags or LENGTH not in d.tags:
            raise CorruptImage("Missing dimensions")
        xsize, ysize = d.one(WIDTH), d.one(LENGTH)
        if not isinstance(xsize, int) or not isinstance(ysize, int):
            raise CorruptImage("Invalid dimensions")
        self.width, self.height = xsize, ysize
        self.orientation = d.one(ORIENTATION)
        sample_format = d.get(SAMPLEFORMAT, (1,))
        if len(sample_format) > 1 and max(sample_format) == min(sample_format) == 1:
            sample_format = (1,)
        bps = d.get(BITS, (1,))
        extra = d.get(EXTRASAMPLES, ())
        self.bands_count = (3 if photo in (2, 6, 8) else 4 if photo == 5 else 1) + len(extra)
        spp = d.one(SAMPLES, 3 if self.compression == "tiff_jpeg" and photo in (2, 6) else 1)
        if spp > MAX_SAMPLESPERPIXEL:
            raise CorruptImage("Invalid value for samples per pixel")
        if spp < len(bps):
            bps = bps[:spp]
        elif spp > len(bps) and len(bps) == 1:
            bps = bps * spp
        if len(bps) != spp:
            raise CorruptImage("unknown data organization")
        self.spp, self.bps = spp, bps
        key = (d.prefix, photo, tuple(sample_format), fillorder, tuple(bps), tuple(extra))
        if key not in OPEN_INFO:
            raise CorruptImage(f"unknown pixel mode (TIFF key {key[1:]})")
        self.mode, self.rawmode = OPEN_INFO[key]
        self.fillorder = fillorder
        self.libtiff = self.compression != "raw"
        if self.libtiff:
            if fillorder == 2:
                self.mode, self.rawmode = OPEN_INFO[key[:3] + (1,) + key[4:]]
            if photo == 6 and self.compression == "jpeg" and self.planar == 1:
                self.rawmode = "RGB"
            elif self.rawmode == "I;16":
                self.rawmode = "I;16N"
            elif self.rawmode.endswith((";16B", ";16L")):
                self.rawmode = self.rawmode[:-1] + "N"
        elif STRIPOFFSETS not in d.tags and TILEOFFSETS not in d.tags:
            raise CorruptImage("unknown data organization")
        self.palette = None
        if self.mode in ("P", "PA"):
            if COLORMAP not in d.tags:
                raise CorruptImage("palette image without a ColorMap")
            cmap = np.array(d.get(COLORMAP), np.int64) // 256
            n = len(cmap) // 3
            self.palette = np.stack([cmap[:n], cmap[n:2 * n], cmap[2 * n:3 * n]], -1).astype(
                np.uint8)

    # --- uncompressed: PIL's raw decoder ---------------------------------------
    def raw(self) -> np.ndarray:
        d, mode = self.d, self.mode
        out = _new(mode, self.width, self.height)
        if STRIPOFFSETS in d.tags:
            offsets = d.get(STRIPOFFSETS)
            h = d.one(ROWSPERSTRIP, self.height)
            w = self.width
        else:
            offsets = d.get(TILEOFFSETS)
            w, h = d.one(TILEWIDTH), d.one(TILELENGTH)
            if not isinstance(w, int) or not isinstance(h, int):
                raise CorruptImage("Invalid tile dimensions")
        if w == self.width and h == self.height and self.planar != 2:
            offsets = offsets[-1:]
        tiles, x, y, layer = [], 0, 0, 0
        for offset in offsets:
            stride = w * sum(self.bps) / 8 if x + w > self.width else 0
            rawmode = self.rawmode
            if self.planar == 2:
                rawmode = self.rawmode[layer] if layer < len(self.rawmode) else None
                if _BANDS[mode] == 1 and rawmode not in ("1", "L", "P"):
                    rawmode = None
                stride /= self.bands_count
            tiles.append((offset, rawmode, int(stride),
                          (x, y, min(x + w, self.width), min(y + h, self.height)), layer))
            x += w
            if x >= self.width:
                x, y = 0, y + h
                if y >= self.height:
                    y = 0
                    layer += 1
        for offset, rawmode, stride, (x0, y0, x1, y1), layer in sorted(tiles,
                                                                     key=lambda t: t[0]):
            if rawmode is None:
                raise CorruptImage("no raw mode for this plane")
            tw, th = x1 - x0, y1 - y0
            if tw <= 0 or th <= 0:
                continue
            row = stride or (tw * raw_bits(rawmode) + 7) // 8
            body = self.data[offset:offset + row * th]
            if offset >= len(self.data) or len(body) < row * th:
                raise CorruptImage("image file is truncated")
            rows = np.frombuffer(body, np.uint8).reshape(th, row)
            self._place(out, unpack(rawmode, rows, tw, mode), x0, y0, rawmode)
        return out

    def _place(self, out, samples, x0, y0, rawmode):
        th, tw = samples.shape[:2]
        if samples.ndim == 2 and out.ndim == 3:  # one band of a planar file
            names = "LAB" if self.mode == "LAB" else self.mode
            if rawmode not in names:  # "X", "a": PIL has no such band unpacker
                raise CorruptImage(f"no unpacker for raw mode {rawmode} in mode {self.mode}")
            out[y0:y0 + th, x0:x0 + tw, names.index(rawmode)] = samples
        else:
            out[y0:y0 + th, x0:x0 + tw] = samples

    # --- compressed: libtiff ------------------------------------------------
    def _segments(self):
        """(offsets, byte counts, segment width, segment rows, tiled)."""
        d = self.d
        if TILEOFFSETS in d.tags and TILEWIDTH in d.tags:
            tw, th = d.one(TILEWIDTH), d.one(TILELENGTH)
            if not tw or not th:
                raise CorruptImage("bad tile size")
            offsets = d.get(TILEOFFSETS)
            counts = d.get(TILEBYTECOUNTS)
            tiled = True
        else:
            if STRIPOFFSETS not in d.tags:
                raise CorruptImage("TIFF directory is missing required StripOffsets field")
            tw = self.width
            th = min(d.one(ROWSPERSTRIP, self.height) or self.height, self.height)
            offsets = d.get(STRIPOFFSETS)
            counts = d.get(STRIPBYTECOUNTS)
            tiled = False
        if counts is None:
            counts = tuple(max(0, len(self.data) - o) for o in offsets)
        return offsets, counts, tw, th, tiled

    def _decode_segment(self, index, offsets, counts, size, seg_w, seg_rows, spp, bps):
        """One strip or tile decoded as libtiff's TIFFReadEncodedStrip /
        TIFFReadTile gives it: ``size`` bytes, samples in machine order."""
        if index >= len(offsets) or index >= len(counts):
            raise CorruptImage("strip or tile past the offsets")
        start, count = offsets[index], counts[index]
        if start + count > len(self.data):
            raise CorruptImage(f"Read error on strip {index}")
        raw = self.data[start:start + count]
        comp = self.compression
        if self.fillorder == 2 and comp != "jpeg":
            raw = _REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
        from ape_tpu_torch.ops._build import host_library

        out = np.zeros(size, np.uint8)
        if comp in ("tiff_ccitt", "group3", "group4"):
            rc = host_library().ape_tiff_fax(raw, len(raw), self.code,
                                             self.d.one(T4OPTIONS, 0) or 0, seg_w, seg_rows,
                                             out.ctypes.data)
            if rc:
                raise CorruptImage(f"CCITT data of strip {index}: "
                                   f"{'broken' if rc == 1 else 'not enough data'}")
            return out
        if comp in ("tiff_lzw", "packbits"):
            fn = host_library().ape_tiff_lzw if comp == "tiff_lzw" else \
                host_library().ape_tiff_packbits
            rc = fn(raw, len(raw), out.ctypes.data, size)
            if rc:
                raise CorruptImage(f"{comp} data of strip {index}: "
                                   f"{'Corrupted LZW table' if rc == 1 else 'Not enough data'}")
        elif comp in ("tiff_adobe_deflate", "tiff_deflate", "lzma"):
            try:
                dec = (zlib.decompressobj() if comp != "lzma"
                       else lzma.LZMADecompressor(lzma.FORMAT_XZ))
                got = dec.decompress(raw, size)
            except (zlib.error, lzma.LZMAError) as e:
                raise CorruptImage(f"{comp} data of strip {index}: {e}") from e
            if len(got) < size:
                raise CorruptImage(f"{comp} data of strip {index}: Not enough data")
            out[:] = np.frombuffer(got, np.uint8)
        if self.d.e == ">" and self.d.one(PREDICTOR, 1) != 3 and bps[0] in (16, 32, 64):
            s = bps[0] // 8
            out = out.reshape(-1, s)[:, ::-1].reshape(-1).copy()
        predictor = self.d.one(PREDICTOR, 1)
        if comp in ("tiff_lzw", "tiff_adobe_deflate", "tiff_deflate", "lzma") and predictor != 1:
            out = self._unpredict(out, predictor, seg_w, spp, bps)
        return out

    def _unpredict(self, out, predictor, seg_w, spp, bps):
        """tif_predict.c: horizontal accumulation (2) or the floating point
        predictor's byte planes (3), row by row."""
        bits = bps[0]
        if self.planar == 2:
            spp = 1
        if predictor == 2:
            if bits not in (8, 16, 32):
                raise CorruptImage(f"Horizontal differencing Predictor with {bits}-bit samples")
            kind = {8: np.uint8, 16: "<u2", 32: "<u4"}[bits]
            row = seg_w * spp * bits // 8
            v = out.reshape(-1, row).copy().view(kind).reshape(-1, seg_w, spp)
            v = np.cumsum(v, axis=1, dtype=v.dtype)
            return v.reshape(-1).view(np.uint8).copy()
        if predictor == 3:
            if 3 not in self.d.get(SAMPLEFORMAT, (1,)) or bits not in (16, 24, 32, 64):
                raise CorruptImage("Floating point Predictor on these samples")
            nb = bits // 8
            row = seg_w * spp * nb
            r = out.reshape(-1, row)
            acc = np.cumsum(r.reshape(r.shape[0], -1, spp), axis=1, dtype=np.uint8).reshape(
                r.shape[0], row)
            wc = seg_w * spp
            planes = acc.reshape(r.shape[0], nb, wc)  # plane 0 the most significant byte
            return planes[:, ::-1].transpose(0, 2, 1).reshape(-1).copy()
        raise CorruptImage(f"bad Predictor {predictor}")

    def libtiff_read(self) -> np.ndarray:
        if self.compression in NOT_PORTED:
            raise ValueError(f"a TIFF image under {NOT_PORTED[self.compression]} compression, "
                             "which PIL reads through libtiff and the port does not decode yet")
        if self.photo == 6 and self.compression != "jpeg":
            return self._rgba_ycbcr()
        offsets, counts, seg_w, seg_h, tiled = self._segments()
        mode = self.mode
        out = _new(mode, self.width, self.height)
        bands = _BANDS[mode]
        planes = bands if self.planar == 2 and bands > 1 else 1
        bits = raw_bits(self.rawmode)
        if planes > 1:
            if self.bps[0] not in (8, 16):
                raise CorruptImage(f"Invalid value for bits per sample: {self.bps[0]}")
            row_bytes = (seg_w * self.bps[0] + 7) // 8
        else:
            row_bytes = (seg_w * sum(self.bps) + 7) // 8
        if self.compression == "jpeg" and self.rawmode == "RGB" and self.photo == 6:
            row_bytes = seg_w * 3
        if row_bytes < (seg_w * bits // planes + 7) // 8:
            raise CorruptImage("TIFF rows shorter than the raw mode reads")
        across = -(-self.width // seg_w)
        down = -(-self.height // seg_h)
        per_plane = across * down
        pixel_bytes = _PIXEL_BYTES.get(mode, tuple(range(bands)))
        for sy in range(down):
            y0 = sy * seg_h
            rows_here = seg_h if tiled else min(seg_h, self.height - y0)
            for sx in range(across):
                x0 = sx * seg_w
                cw, ch = min(seg_w, self.width - x0), min(seg_h, self.height - y0)
                for plane in range(planes):
                    index = plane * per_plane + sy * across + sx
                    size = row_bytes * rows_here
                    if self.compression == "jpeg":
                        seg = self._jpeg_segment(index, offsets, counts, seg_w, rows_here)
                    else:
                        spp = 1 if self.planar == 2 else self.spp
                        seg = self._decode_segment(index, offsets, counts, size, seg_w,
                                                   rows_here, spp, self.bps)
                    rows = seg[:size].reshape(rows_here, row_bytes)[:ch]
                    if planes > 1:  # PIL's "R", "G", "B", "A" (";16N") plane unpackers
                        v = rows[:, :cw * self.bps[0] // 8]
                        v = v[:, 1::2] if self.bps[0] == 16 else v
                        byte = plane
                        if byte in pixel_bytes:
                            out[y0:y0 + ch, x0:x0 + cw, pixel_bytes.index(byte)] = v
                        continue
                    self._place(out, unpack(self.rawmode, rows, cw, mode), x0, y0, self.rawmode)
        return out

    def _jpeg_segment(self, index, offsets, counts, seg_w, seg_rows) -> np.ndarray:
        from ape_tpu_torch.data.jpeg import RAW, YCC, decode_jpeg

        if index >= len(offsets) or offsets[index] + counts[index] > len(self.data):
            raise CorruptImage(f"Read error on strip {index}")
        stream = self.data[offsets[index]:offsets[index] + counts[index]]
        tables = self.d.tags.get(JPEGTABLES)
        if isinstance(tables, bytes) and len(tables) > 4 and stream[:2] == b"\xff\xd8":
            # the abbreviated stream after the tables-only one libjpeg read first
            stream = tables[:-2] + stream[2:] if tables.endswith(b"\xff\xd9") else \
                tables + stream[2:]
        sof = _jpeg_sof(stream)
        if sof is None:
            raise CorruptImage(f"no JPEG frame in strip {index}")
        n, samp, jw, jh = sof
        contig = self.planar == 1
        if contig and n != self.spp or not contig and n != 1:
            raise CorruptImage("Improper JPEG component count")
        expect = (1, 1)
        if self.photo == 6 and contig:
            expect = tuple(self.d.get(YCBCRSUBSAMPLING, (2, 2))[:2])
        if contig and (samp[0] != expect or any(s != (1, 1) for s in samp[1:])):
            raise CorruptImage("Improper JPEG sampling factors")
        if jw > seg_w or jh > seg_rows:
            raise CorruptImage("JPEG strip/tile size exceeds expected dimensions")
        if jw != seg_w or jh != seg_rows:
            raise CorruptImage("Improper JPEG strip/tile size")
        return decode_jpeg(stream, YCC if self.photo == 6 and contig else RAW).reshape(-1)

    def _rgba_ycbcr(self) -> np.ndarray:
        """YCbCr through libtiff's TIFFRGBAImage, as PIL reads it."""
        if self.planar != 1:
            raise ValueError("a planar YCbCr TIFF image, which PIL reads through libtiff's RGBA "
                             "interface and the port does not decode yet")
        if self.bps[0] != 8 or self.spp != 3:
            raise CorruptImage(f"YCbCr images of {self.spp} {self.bps[0]}-bit samples")
        hs, vs = self.d.get(YCBCRSUBSAMPLING, (2, 2))[:2]
        if (hs, vs) not in ((4, 4), (4, 2), (4, 1), (2, 2), (2, 1), (1, 2), (1, 1)):
            raise CorruptImage(f"YCbCr subsampling {hs}, {vs}")
        luma = self.d.get(YCBCRCOEFFICIENTS, (0.299, 0.587, 0.114))
        ref = self.d.get(REFERENCEBLACKWHITE, (0, 255, 128, 255, 128, 255))
        tables = _ycbcr_tables(luma, ref)
        offsets, counts, seg_w, seg_h, tiled = self._segments()
        out = np.zeros((self.height, self.width, 3), np.uint8)
        across, down = -(-self.width // seg_w), -(-self.height // seg_h)
        for sy in range(down):
            y0 = sy * seg_h
            rows_here = seg_h if tiled else min(seg_h, self.height - y0)
            for sx in range(across):
                x0 = sx * seg_w
                index = sy * across + sx
                block_row = -(-seg_w // hs) * (hs * vs + 2)
                size = block_row * -(-rows_here // vs)
                # gtStripContig reads a strip's rows times TIFFScanlineSize, a block
                # row over vs rounded down: under 4x4 the end of the strip can fall
                # short, and its place in libtiff's zeroed buffer stays 0
                read = size if tiled else -(-rows_here // vs) * vs * (block_row // vs)
                seg = np.zeros(size, np.uint8)
                seg[:read] = self._decode_segment(index, offsets, counts, read, seg_w,
                                                  rows_here, self.spp, self.bps)
                rgb = _ycbcr_to_rgb(seg, seg_w, rows_here, hs, vs, tables)
                ch, cw = min(seg_h, self.height - y0), min(seg_w, self.width - x0)
                out[y0:y0 + ch, x0:x0 + cw] = rgb[:ch, :cw]
        return out


def _transpose(a: np.ndarray, orientation) -> np.ndarray:
    """``ImageOps.exif_transpose`` of an Orientation tag."""
    if orientation == 2:
        a = a[:, ::-1]
    elif orientation == 3:
        a = a[::-1, ::-1]
    elif orientation == 4:
        a = a[::-1]
    elif orientation == 5:
        a = a.swapaxes(0, 1)
    elif orientation == 6:
        a = a.swapaxes(0, 1)[:, ::-1]
    elif orientation == 7:
        a = a[::-1, ::-1].swapaxes(0, 1)
    elif orientation == 8:
        a = a.swapaxes(0, 1)[::-1]
    return np.ascontiguousarray(a)


def decode_tiff(data: bytes):
    """TIFF bytes -> (samples, mode, palette): the first image as
    ``np.asarray(Image.open(f))`` gives it (mode PIL's: "1" bool, "L",
    "P" indices, "I;16" / "I;16B" uint16, "I" int32, "F" float32, "LA",
    "PA", "RGB", "RGBA", "CMYK", "LAB"); palette (N, 3) uint8 for "P" and
    "PA", else None."""
    im = _Image(data)
    bomb_check(im.width, im.height)
    samples = im.libtiff_read() if im.libtiff else im.raw()
    samples = _transpose(samples, im.orientation)
    return samples, im.mode, im.palette


def encode_tiff(image: np.ndarray) -> bytes:
    """uint8 (H, W) or (H, W, 3) -> the bytes of PIL's
    ``Image.fromarray(image).save(f, "TIFF")``: little-endian, the
    directory at offset 8, the tags PIL writes in ascending order, one strip
    of the image after the directory and its out-of-line values."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim not in (2, 3) or (
            image.ndim == 3 and image.shape[2] != 3):
        raise ValueError(f"encode_tiff takes uint8 (H, W) or (H, W, 3), not {image.dtype} "
                         f"{image.shape}")
    height, width = image.shape[:2]
    rgb = image.ndim == 3
    bits = (8, 8, 8) if rgb else (8,)
    size = width * height * len(bits)
    # (tag, type, values): ImageFileDirectory_v2.tobytes writes them sorted
    entries = [(WIDTH, 4, (width,)), (LENGTH, 4, (height,)), (BITS, 3, bits),
               (COMPRESSION, 3, (1,)), (PHOTOMETRIC, 3, (2 if rgb else 1,)),
               (STRIPOFFSETS, 4, (0,))]
    if rgb:
        entries.append((SAMPLES, 3, (3,)))
    entries += [(ROWSPERSTRIP, 4, (height,)), (STRIPBYTECOUNTS, 4, (size,)), (PLANAR, 3, (1,))]
    entries.sort()
    ifd_size = 2 + 12 * len(entries) + 4
    extra = b""
    offset = 8 + ifd_size
    body = b""
    strip_entry = None
    for tag, typ, values in entries:
        code = {3: "H", 4: "L"}[typ]
        data = struct.pack("<" + code * len(values), *values)
        if tag == STRIPOFFSETS:
            strip_entry = len(body)
        if len(data) <= 4:
            body += struct.pack("<HHL", tag, typ, len(values)) + data.ljust(4, b"\0")
        else:
            body += struct.pack("<HHLL", tag, typ, len(values), offset + len(extra))
            extra += data
            if len(extra) % 2:
                extra += b"\0"
    data_offset = offset + len(extra)
    body = (body[:strip_entry + 8] + struct.pack("<L", data_offset) + body[strip_entry + 12:])
    return (b"II*\x00" + struct.pack("<L", 8) + struct.pack("<H", len(entries)) + body
            + struct.pack("<L", 0) + extra + np.ascontiguousarray(image).tobytes())
