"""Writers of image files that neither PIL nor the port writes, for the
tests of the port's reader and for ``chip_smoke.py`` (numpy and the
standard library only, so that the card machine can load it):

* ``arithmetic_jpeg``: arithmetic-coded sequential (SOF9) and progressive
  (SOF10) JPEG of given quantized coefficients, after libjpeg's
  ``jcarith.c`` (T.81 Annex D's QM coder, F.1.4 and G.1.3's contexts),
  with DAC conditioning and restart intervals;
* ``huffman_jpeg``: a baseline (SOF0) file of the same coefficients with
  the standard luminance tables, as the oracle's twin of an arithmetic
  file and as the smoke's YCCK file;
* ``lossless_jpeg``: lossless (SOF3) JPEG, predictors 1-7, a point
  transform and restart intervals, with a Huffman table built from the
  difference counts;
* ``png``: PNG of any color type at bit depth 8 or 16, plain or Adam7
  interlaced;
* ``bmp``: BMP of 1-, 4-, 8-, 16-, 24- and 32-bit pixels, RLE8 and RLE4
  (encoded and absolute runs, deltas), BITFIELDS masks, OS/2, V4 and V5
  headers, top-down rows;
* ``gif``: GIF of one or more frames, with global or local palettes,
  interlace, a frame offset inside a larger screen, a transparency index,
  and an LZW stream that clears its table when full or keeps it;
* ``tiff``: TIFF of strips or tiles, classic or BigTIFF, either byte
  order, uncompressed, CCITT (``ccitt``: modified Huffman, Group 3 1-D and
  2-D, Group 4), LZW (``lzw_tiff``, old style too), Deflate, PackBits and
  LZMA, predictors 2 and 3, FillOrder 2, planar files, YCbCr blocks
  (``ycbcr_blocks``) and JPEG strips or tiles with JPEGTables
  (``jpeg_tiff``);
* ``netpbm``: P1-P6, plain or raw, any maxval;
* ``tga``: TGA of raw or RLE (``tga_rle``) pixels, colour-mapped or not,
  any origin; ``ico``: ICO of PNG and DIB (``dib_entry``) entries;
* ``pcx``: PCX of any depth, plane count, stride and version (runs that
  stay in a line or cross it), ``dcx`` of PCX pages; ``sgi``: SGI at 1 or
  2 bytes a sample, verbatim or RLE with its tables; ``sun``: Sun raster
  raw (``sun_rows``) or RLE (``sun_rle``), with a colour map; ``msp``: MSP
  versions 1 and 2; ``xbm``: X10 and X11 bitmaps; ``im``: IM headers over
  any data and lookup table.

``coefficients`` turns an image into the quantized blocks the JPEG writers
take: an integer colour transform, box downsampling and an integer DCT,
all exact integer arithmetic so that a seeded image gives the same bytes on
every machine.
"""

from __future__ import annotations

import heapq
import struct
import zlib

import numpy as np

NATURAL = []  # zigzag index -> natural index
for _s in range(15):
    _lo, _hi = max(0, _s - 7), min(_s, 7)
    NATURAL += [r * 8 + (_s - r) for r in (range(_hi, _lo - 1, -1) if _s % 2 == 0
                                           else range(_lo, _hi + 1))]
NATURAL = np.array(NATURAL)

# jcparam.c's standard tables (natural order)
LUM_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
CHROM_QUANT = np.array([17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
                        24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
                       + [99] * 32)
DC_BITS = (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0)
AC_BITS = (0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D)
AC_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f024336272820"
    "90a161718191a25262728292a3435363738393a434445464748494a535455565758595a6364"
    "65666768696a737475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7a8"
    "a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9"
    "eaf1f2f3f4f5f6f7f8f9fa")

# round(4096 * c(u) / 2 * cos((2x + 1) u pi / 16)), c(0) = 1 / sqrt(2): the
# DCT-II basis in integers
DCT_BASIS = np.array([
    [1448, 1448, 1448, 1448, 1448, 1448, 1448, 1448],
    [2009, 1703, 1138, 400, -400, -1138, -1703, -2009],
    [1892, 784, -784, -1892, -1892, -784, 784, 1892],
    [1703, -400, -2009, -1138, 1138, 2009, 400, -1703],
    [1448, -1448, -1448, 1448, 1448, -1448, -1448, 1448],
    [1138, -2009, 400, 1703, -1703, -400, 2009, -1138],
    [784, -1892, 1892, -784, -784, 1892, -1892, 784],
    [400, -1138, 1703, -2009, 2009, -1703, 1138, -400]], np.int64)


def quality_table(base: np.ndarray, quality: int) -> np.ndarray:
    """jcparam.c's scaling of a standard table to ``quality``, baseline-limited."""
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return np.clip((base * scale + 50) // 100, 1, 255)


def _ycc(rgb: np.ndarray) -> np.ndarray:
    """jccolor.c's RGB -> YCbCr in its integer tables: (3, H, W) uint8."""
    fix = lambda x: int(x * 65536 + 0.5)  # noqa: E731
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, off = 1 << 15, 128 << 16
    y = (fix(0.299) * r + fix(0.587) * g + fix(0.114) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + off + half - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + off + half - 1) >> 16
    return np.stack([y, cb, cr]).astype(np.uint8)


def planes_of(image: np.ndarray, color: str) -> list:
    """The component planes a JPEG of ``color`` stores for a uint8 image:
    ``gray`` (H, W), ``ycc`` and ``rgb`` from (H, W, 3), ``cmyk`` (Adobe's
    inverted samples) and ``ycck`` from (H, W, 4) CMYK."""
    if color == "gray":
        return [image]
    if color == "rgb":
        return [image[..., c] for c in range(3)]
    if color == "ycc":
        return list(_ycc(image))
    inverted = 255 - image
    if color == "cmyk":
        return [inverted[..., c] for c in range(4)]
    if color == "ycck":  # jccolor.c cmyk_ycck_convert: C, M, Y as 255 - R, G, B
        return list(_ycc(image[..., :3])) + [inverted[..., 3]]
    raise ValueError(color)


def _blocks_of(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """(rows, cols, 64) samples - 128 of ``plane`` edge-padded to whole blocks."""
    h, w = plane.shape
    padded = np.pad(plane.astype(np.int64), ((0, rows * 8 - h), (0, cols * 8 - w)), mode="edge")
    return padded.reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3).reshape(rows, cols, 64) - 128


def coefficients(planes, sampling, qtables, table_of=None):
    """Quantized DCT blocks of full-size ``planes`` under ``sampling``
    ((h, v) a component): each plane box-downsampled by (hmax / h, vmax /
    v), cut into the MCU-padded blocks of its component, transformed and
    divided by its table (``table_of[c]``, default 0 for the first
    component and 1 for the rest) with rounding. Returns int64 (rows,
    cols, 64) arrays in natural order."""
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    height, width = planes[0].shape
    mx, my = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    table_of = table_of or [min(c, len(qtables) - 1) for c in range(len(sampling))]
    out = []
    for c, (h, v) in enumerate(sampling):
        fx, fy = hmax // h, vmax // v
        plane = planes[c].astype(np.int64)
        ph, pw = -(-height // fy) * fy, -(-width // fx) * fx
        plane = np.pad(plane, ((0, ph - height), (0, pw - width)), mode="edge")
        n = fx * fy
        small = (plane.reshape(ph // fy, fy, pw // fx, fx).sum((1, 3)) + n // 2) // n
        blocks = _blocks_of(small, my * v, mx * h).reshape(my * v, mx * h, 8, 8)
        raw = np.einsum("ux,rcxy,vy->rcuv", DCT_BASIS, blocks, DCT_BASIS).reshape(
            my * v, mx * h, 64)
        q = np.asarray(qtables[table_of[c]], np.int64) << 24
        out.append(np.sign(raw) * ((np.abs(raw) + q // 2) // q))
    return out


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def _headers(width, height, sampling, qtables, table_of, sof, ids, jfif, adobe):
    out = b"\xff\xd8"
    if jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        out += _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([adobe]))
    for t, q in enumerate(qtables or ()):
        wide = max(q) > 255
        zz = [int(q[NATURAL[i]]) for i in range(64)]
        out += _segment(0xDB, bytes([t | (16 if wide else 0)])
                        + (struct.pack(">64H", *zz) if wide else bytes(zz)))
    body = struct.pack(">BHHB", 8, height, width, len(sampling))
    for c, (h, v) in enumerate(sampling):
        body += bytes([ids[c], (h << 4) | v, table_of[c] if table_of else 0])
    return out + _segment(sof, body)


def _codes(bits, vals):
    out, code, k = {}, 0, 0
    for length, n in enumerate(bits, 1):
        for _ in range(n):
            out[vals[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return out


class _Bits:
    """MSB-first bits with 0xFF 0x00 stuffing; ``flush`` pads with 1 bits."""

    def __init__(self):
        self.acc, self.n, self.data = 0, 0, bytearray()

    def put(self, value: int, n: int):
        self.acc, self.n = (self.acc << n) | (value & ((1 << n) - 1)), self.n + n
        while self.n >= 8:
            byte = (self.acc >> (self.n - 8)) & 0xFF
            self.data.append(byte)
            if byte == 0xFF:
                self.data.append(0)
            self.n -= 8
        self.acc &= (1 << self.n) - 1

    def flush(self) -> bytes:
        if self.n:
            self.put(0x7F, 8 - self.n)
        out, self.data = bytes(self.data), bytearray()
        return out


def _mcu_blocks(sampling, coefs, width, height, comps):
    """(component, block) of each MCU of an interleaved scan over ``comps``,
    or of each block of a one-component scan, in coding order."""
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    mx, my = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    if len(comps) == 1:
        c = comps[0]
        h, v = sampling[c]
        bw, bh = -(-width * h // (8 * hmax)), -(-height * v // (8 * vmax))
        return [[(c, coefs[c][y, x])] for y in range(bh) for x in range(bw)]
    mcus = []
    for y in range(my):
        for x in range(mx):
            mcus.append([(c, coefs[c][by, bx]) for c in comps
                         for by in range(y * sampling[c][1], (y + 1) * sampling[c][1])
                         for bx in range(x * sampling[c][0], (x + 1) * sampling[c][0])])
    return mcus


def huffman_jpeg(width, height, sampling, coefs, qtables, table_of=None, ids=None, jfif=True,
                 adobe=None, restart=0) -> bytes:
    """A baseline (SOF0) file of ``coefs`` in one interleaved scan, every
    component on the standard luminance tables (DC within +-2047 of its
    neighbour, AC within +-1023)."""
    ids = ids or list(range(1, len(sampling) + 1))
    table_of = table_of or [min(c, len(qtables) - 1) for c in range(len(sampling))]
    dc, ac = _codes(DC_BITS, list(range(12))), _codes(AC_BITS, AC_VALS)
    out = _headers(width, height, sampling, qtables, table_of, 0xC0, ids, jfif, adobe)
    out += _segment(0xC4, b"\x00" + bytes(DC_BITS) + bytes(range(12)))
    out += _segment(0xC4, b"\x10" + bytes(AC_BITS) + AC_VALS)
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    out += _segment(0xDA, bytes([len(sampling)]) + b"".join(bytes([i, 0]) for i in ids)
                    + b"\x00\x3f\x00")
    bits, data = _Bits(), bytearray()
    pred = [0] * len(sampling)
    for m, mcu in enumerate(_mcu_blocks(sampling, coefs, width, height,
                                        list(range(len(sampling))))):
        if restart and m and m % restart == 0:
            data += bits.flush() + bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
            pred = [0] * len(sampling)
        for c, blk in mcu:
            diff, pred[c] = int(blk[0]) - pred[c], int(blk[0])
            n = abs(diff).bit_length()
            bits.put(*dc[n])
            if n:
                bits.put(diff if diff >= 0 else diff - 1, n)
            run = 0
            for k in range(1, 64):
                a = int(blk[NATURAL[k]])
                if a == 0:
                    run += 1
                    continue
                while run > 15:
                    bits.put(*ac[0xF0])
                    run -= 16
                n = abs(a).bit_length()
                bits.put(*ac[(run << 4) | n])
                bits.put(a if a >= 0 else a - 1, n)
                run = 0
            if run:
                bits.put(*ac[0])
    return out + bytes(data) + bits.flush() + b"\xff\xd9"


# --- arithmetic coding --------------------------------------------------------

# T.81 Table D.2 as libjpeg's jaricom.c packs it: Qe << 16 | Next_Index_MPS << 8
# | Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed 0.5 estimate
_QE = [
    (0x5a1d, 1, 1, 1), (0x2586, 2, 14, 0), (0x1114, 3, 16, 0), (0x080b, 4, 18, 0),
    (0x03d8, 5, 20, 0), (0x01da, 6, 23, 0), (0x00e5, 7, 25, 0), (0x006f, 8, 28, 0),
    (0x0036, 9, 30, 0), (0x001a, 10, 33, 0), (0x000d, 11, 35, 0), (0x0006, 12, 9, 0),
    (0x0003, 13, 10, 0), (0x0001, 13, 12, 0), (0x5a7f, 15, 15, 1), (0x3f25, 16, 36, 0),
    (0x2cf2, 17, 38, 0), (0x207c, 18, 39, 0), (0x17b9, 19, 40, 0), (0x1182, 20, 42, 0),
    (0x0cef, 21, 43, 0), (0x09a1, 22, 45, 0), (0x072f, 23, 46, 0), (0x055c, 24, 48, 0),
    (0x0406, 25, 49, 0), (0x0303, 26, 51, 0), (0x0240, 27, 52, 0), (0x01b1, 28, 54, 0),
    (0x0144, 29, 56, 0), (0x00f5, 30, 57, 0), (0x00b7, 31, 59, 0), (0x008a, 32, 60, 0),
    (0x0068, 33, 62, 0), (0x004e, 34, 63, 0), (0x003b, 35, 32, 0), (0x002c, 9, 33, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 38, 64, 0), (0x3a0d, 39, 65, 0), (0x2ef1, 40, 67, 0),
    (0x261f, 41, 68, 0), (0x1f33, 42, 69, 0), (0x19a8, 43, 70, 0), (0x1518, 44, 72, 0),
    (0x1177, 45, 73, 0), (0x0e74, 46, 74, 0), (0x0bfb, 47, 75, 0), (0x09f8, 48, 77, 0),
    (0x0861, 49, 78, 0), (0x0706, 50, 79, 0), (0x05cd, 51, 48, 0), (0x04de, 52, 50, 0),
    (0x040f, 53, 50, 0), (0x0363, 54, 51, 0), (0x02d4, 55, 52, 0), (0x025c, 56, 53, 0),
    (0x01f8, 57, 54, 0), (0x01a4, 58, 55, 0), (0x0160, 59, 56, 0), (0x0125, 60, 57, 0),
    (0x00f6, 61, 58, 0), (0x00cb, 62, 59, 0), (0x00ab, 63, 61, 0), (0x008f, 32, 61, 0),
    (0x5b12, 65, 65, 1), (0x4d04, 66, 80, 0), (0x412c, 67, 81, 0), (0x37d8, 68, 82, 0),
    (0x2fe8, 69, 83, 0), (0x293c, 70, 84, 0), (0x2379, 71, 86, 0), (0x1edf, 72, 87, 0),
    (0x1aa9, 73, 87, 0), (0x174e, 74, 72, 0), (0x1424, 75, 72, 0), (0x119c, 76, 74, 0),
    (0x0f6b, 77, 74, 0), (0x0d51, 78, 75, 0), (0x0bb6, 79, 77, 0), (0x0a40, 48, 77, 0),
    (0x5832, 81, 80, 1), (0x4d1c, 82, 88, 0), (0x438e, 83, 89, 0), (0x3bdd, 84, 90, 0),
    (0x34ee, 85, 91, 0), (0x2eae, 86, 92, 0), (0x299a, 87, 93, 0), (0x2516, 71, 86, 0),
    (0x5570, 89, 88, 1), (0x4ca9, 90, 95, 0), (0x44d9, 91, 96, 0), (0x3e22, 92, 97, 0),
    (0x3824, 93, 99, 0), (0x32b4, 94, 99, 0), (0x2e17, 86, 93, 0), (0x56a8, 96, 95, 1),
    (0x4f46, 97, 101, 0), (0x47e5, 98, 102, 0), (0x41cf, 99, 103, 0), (0x3c3d, 100, 104, 0),
    (0x375e, 93, 99, 0), (0x5231, 102, 105, 0), (0x4c0f, 103, 106, 0), (0x4639, 104, 107, 0),
    (0x415e, 99, 103, 0), (0x5627, 106, 105, 1), (0x50e7, 107, 108, 0), (0x4b85, 103, 109, 0),
    (0x5597, 109, 110, 0), (0x504f, 107, 111, 0), (0x5a10, 111, 110, 1), (0x5522, 109, 112, 0),
    (0x59eb, 111, 112, 1), (0x5a1d, 113, 113, 0)]
FIXED = 113  # the state of the fixed 0.5 estimate (jcarith.c fixed_bin)


class _QMEncoder:
    """jcarith.c's arith_encode and finish_pass over context bins, each a
    state index with the MPS in bit 7."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit(self, b):
        self.out.append(b)

    def _zeros(self):
        self.out += b"\x00" * self.zc
        self.zc = 0

    def encode(self, bins, i, val):
        sv = bins[i]
        qe, nm, nl, switch = _QE[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            bins[i] = (sv & 0x80) ^ (nl | (switch << 7))
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            bins[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer)
                    if self.sc:
                        self._zeros()
                        self.out += b"\xff\x00" * self.sc
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer)
            if self.sc:
                self._zeros()
                self.out += b"\xff\x00" * self.sc
                self.sc = 0
        if self.c & 0x7FFF800:
            self._zeros()
            self._emit((self.c >> 19) & 0xFF)
            if (self.c >> 19) & 0xFF == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if (self.c >> 11) & 0xFF == 0xFF:
                    self._emit(0)
        out, self.out = bytes(self.out), bytearray()
        self.reset()
        return out


def _magnitude(enc, bins, st, v, big):
    """F.8 and F.9: the magnitude category and bits of ``v`` (>= 1) after
    its sign, from bin ``st``; ``big`` the bin of the X2.. categories."""
    m = 0
    v -= 1
    if v:
        enc.encode(bins, st, 1)
        m, v2 = 1, v
        v2 >>= 1
        if big is None:  # DC: X1 at 20
            st = 20
            while v2:
                enc.encode(bins, st, 1)
                m <<= 1
                st += 1
                v2 >>= 1
        elif v2:
            enc.encode(bins, st, 1)
            m <<= 1
            st = big
            v2 >>= 1
            while v2:
                enc.encode(bins, st, 1)
                m <<= 1
                st += 1
                v2 >>= 1
    enc.encode(bins, st, 0)
    st += 14
    m >>= 1
    while m:
        enc.encode(bins, st, 1 if m & v else 0)
        m >>= 1


def _dc_diff(enc, bins, ctx, v, lo, hi):
    """F.1.4.1's DC difference ``v`` in context ``ctx``; returns the next context."""
    if v == 0:
        enc.encode(bins, ctx, 0)
        return 0
    enc.encode(bins, ctx, 1)
    sign = v < 0
    enc.encode(bins, ctx + 1, int(sign))
    a = -v if sign else v
    # the category decides the next context (F.1.4.4.1.2)
    m = 0 if a == 1 else 1 << ((a - 1).bit_length() - 1)
    _magnitude(enc, bins, ctx + 2 + sign, a, None)
    if m < (1 << lo) >> 1:
        return 0
    return (12 if m > (1 << hi) >> 1 else 4) + 4 * sign


def _ac_first(enc, bins, fixed, blk, ss, se, al, k_cond):
    """F.1.4.4.2 / G.1.3.2: the AC coefficients ss..se of ``blk`` >> al."""
    vals = [int(blk[NATURAL[k]]) for k in range(64)]
    shifted = [(-((-x) >> al) if x < 0 else x >> al) for x in vals]
    ke = se
    while ke >= ss and shifted[ke] == 0:
        ke -= 1
    k = ss
    while k <= ke:
        st = 3 * (k - 1)
        enc.encode(bins, st, 0)
        while shifted[k] == 0:
            enc.encode(bins, st + 1, 0)
            st += 3
            k += 1
        enc.encode(bins, st + 1, 1)
        v = shifted[k]
        enc.encode(fixed, 0, int(v < 0))
        _magnitude(enc, bins, st + 2, abs(v), 189 if k <= k_cond else 217)
        k += 1
    if k <= se:
        enc.encode(bins, 3 * (k - 1), 1)


def _ac_refine(enc, bins, fixed, blk, ss, se, al):
    """G.1.3.3: bit ``al`` of the AC coefficients ss..se of ``blk``."""
    vals = [abs(int(blk[NATURAL[k]])) for k in range(64)]
    signs = [int(blk[NATURAL[k]]) < 0 for k in range(64)]
    ke = se
    while ke > 0 and vals[ke] >> al == 0:
        ke -= 1
    kex = ke
    while kex > 0 and vals[kex] >> (al + 1) == 0:
        kex -= 1
    k = ss
    while k <= ke:
        st = 3 * (k - 1)
        if k > kex:
            enc.encode(bins, st, 0)
        while True:
            v = vals[k] >> al
            if v:
                if v >> 1:
                    enc.encode(bins, st + 2, v & 1)
                else:
                    enc.encode(bins, st + 1, 1)
                    enc.encode(fixed, 0, int(signs[k]))
                break
            enc.encode(bins, st + 1, 0)
            st += 3
            k += 1
        k += 1
    if k <= se:
        enc.encode(bins, 3 * (k - 1), 1)


# libjpeg's jpeg_simple_progression scripts: (components, Ss, Se, Ah, Al)
PROGRESSION_YCC = (((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
                   ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                   ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
                   ((0,), 1, 63, 1, 0))
PROGRESSION_GRAY = (((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((0,), 6, 63, 0, 2),
                    ((0,), 1, 63, 2, 1), ((0,), 0, 0, 1, 0), ((0,), 1, 63, 1, 0))


def progression(ncomp: int) -> tuple:
    """libjpeg's simple progression for 1 or 3 components, and its
    every-component-alone form for 4 (DC, then AC in two bits)."""
    if ncomp == 1:
        return PROGRESSION_GRAY
    if ncomp == 3:
        return PROGRESSION_YCC
    comps = tuple(range(ncomp))
    return ((comps, 0, 0, 0, 1),) + tuple(((c,), 1, 63, 0, 1) for c in comps) + (
        (comps, 0, 0, 1, 0),) + tuple(((c,), 1, 63, 1, 0) for c in comps)


def arithmetic_jpeg(width, height, sampling, coefs, qtables, table_of=None, progressive=False,
                    scans=None, restart=0, dac=None, ids=None, jfif=True, adobe=None) -> bytes:
    """An arithmetic-coded file of ``coefs`` (natural order, the blocks of
    ``coefficients``): SOF9 in one interleaved scan, or SOF10 with
    ``scans`` ((components, Ss, Se, Ah, Al) each; default ``progression``).
    Component c codes with DC and AC conditioning table ``table_of[c]``;
    ``dac``: {("dc", t): (L, U)} and {("ac", t): Kx} written as DAC
    segments; ``restart``: the restart interval in MCUs."""
    ids = ids or list(range(1, len(sampling) + 1))
    table_of = table_of or [min(c, len(qtables) - 1) for c in range(len(sampling))]
    out = _headers(width, height, sampling, qtables, table_of, 0xCA if progressive else 0xC9,
                   ids, jfif, adobe)
    cond = {("dc", t): (0, 1) for t in range(4)} | {("ac", t): 5 for t in range(4)}
    if dac:
        cond.update(dac)
        body = b""
        for (kind, t), value in sorted(dac.items()):
            if kind == "dc":
                body += bytes([t, value[1] << 4 | value[0]])
            else:
                body += bytes([0x10 | t, value])
        out += _segment(0xCC, body)
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    scans = (scans or progression(len(sampling))) if progressive else (
        (tuple(range(len(sampling))), 0, 63, 0, 0),)
    enc = _QMEncoder()
    for comps, ss, se, ah, al in scans:
        out += _segment(0xDA, bytes([len(comps)])
                        + b"".join(bytes([ids[c], table_of[c] << 4 | table_of[c]]) for c in comps)
                        + bytes([ss, se, ah << 4 | al]))
        dc_bins = {t: [0] * 64 for t in set(table_of)}
        ac_bins = {t: [0] * 256 for t in set(table_of)}
        fixed = [FIXED]
        last, ctx = [0] * len(sampling), [0] * len(sampling)
        data = bytearray()
        for m, mcu in enumerate(_mcu_blocks(sampling, coefs, width, height, list(comps))):
            if restart and m and m % restart == 0:
                data += enc.finish() + bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
                dc_bins = {t: [0] * 64 for t in set(table_of)}
                ac_bins = {t: [0] * 256 for t in set(table_of)}
                last, ctx = [0] * len(sampling), [0] * len(sampling)
            for c, blk in mcu:
                t = table_of[c]
                if ss == 0 and ah == 0:
                    dc = int(blk[0]) >> al  # an arithmetic shift, as jcarith.c's
                    lo, hi = cond[("dc", t)]
                    ctx[c] = _dc_diff(enc, dc_bins[t], ctx[c], dc - last[c], lo, hi)
                    last[c] = dc
                elif ss == 0:
                    enc.encode(fixed, 0, (int(blk[0]) >> al) & 1)
                if not progressive:
                    _ac_first(enc, ac_bins[t], fixed, blk, 1, 63, 0, cond[("ac", t)])
                elif ss and ah == 0:
                    _ac_first(enc, ac_bins[t], fixed, blk, ss, se, al, cond[("ac", t)])
                elif ss:
                    _ac_refine(enc, ac_bins[t], fixed, blk, ss, se, al)
        out += bytes(data) + enc.finish()
    return out + b"\xff\xd9"


# --- lossless ------------------------------------------------------------------

def _predict(plane: np.ndarray, psv: int, first: np.ndarray, initial: int) -> np.ndarray:
    """H.1.2's prediction of every sample of ``plane`` (int64), the rows
    where ``first`` is set coded as a scan's first line."""
    h, w = plane.shape
    ra = np.zeros_like(plane)
    ra[:, 1:] = plane[:, :-1]
    rb = np.zeros_like(plane)
    rb[1:] = plane[:-1]
    rc = np.zeros_like(plane)
    rc[1:, 1:] = plane[:-1, :-1]
    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[psv].copy()
    pred[:, 0] = rb[:, 0]
    pred[first, 0] = initial
    pred[first, 1:] = ra[first, 1:]
    return pred


def _huffman_table(counts) -> tuple:
    """A length-limited (16 bits) Huffman table for symbol ``counts``, as
    jchuff.c's jpeg_gen_optimal_table builds one: (bits[1..16], values)."""
    freq = list(counts) + [0] * (257 - len(counts))
    freq[256] = 1  # the reserved code point
    codesize, others = [0] * 257, [-1] * 257
    heap = [(f, i) for i, f in enumerate(freq) if f]
    heapq.heapify(heap)
    groups = {i: [i] for _, i in heap}
    while len(heap) > 1:
        f1, c1 = heapq.heappop(heap)
        f2, c2 = heapq.heappop(heap)
        for i in groups[c1] + groups[c2]:
            codesize[i] += 1
        groups[c1] = groups[c1] + groups.pop(c2)
        heapq.heappush(heap, (f1 + f2, c1))
    bits = [0] * 33
    for i in range(257):
        if codesize[i]:
            bits[codesize[i]] += 1
    for i in range(32, 16, -1):  # jchuff.c's length limit
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1  # drop the reserved code point
    values = [s for size in range(1, 33) for s in range(256)
              if codesize[s] == size and freq[s]]
    return bits[1:17], values


def lossless_jpeg(planes, sampling=None, psv=1, pt=0, restart_rows=0, ids=None, jfif=True,
                  adobe=None, interleave=True) -> bytes:
    """A lossless (SOF3) file of the component ``planes`` (uint8, already
    downsampled: component c of (ceil(H v / vmax), ceil(W h / hmax)), the
    first at full size; ``sampling`` (h, v) each, default 1x1), predictor ``psv`` (1-7),
    point transform ``pt``, a restart marker every ``restart_rows`` MCU
    rows, one interleaved scan (or one scan a component), each component's
    Huffman table built from its difference counts."""
    ncomp = len(planes)
    sampling = sampling or [(1, 1)] * ncomp
    ids = ids or list(range(1, ncomp + 1))
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    height, width = planes[0].shape
    mx, my = -(-width // hmax), -(-height // vmax)
    tables = list(range(ncomp))  # a Huffman table a component
    out = _headers(width, height, sampling, None, tables, 0xC3, ids, jfif, adobe)
    diffs = []
    for c, plane in enumerate(planes):
        h, v = sampling[c]
        p = plane.astype(np.int64) >> pt
        if interleave and ncomp > 1:  # the MCU-padded plane, edge-replicated
            p = np.pad(p, ((0, my * v - p.shape[0]), (0, mx * h - p.shape[1])), mode="edge")
        rows_per_restart = restart_rows * (v if interleave and ncomp > 1 else 1)
        first = np.zeros(p.shape[0], bool)
        first[0] = True
        if rows_per_restart:
            first[::rows_per_restart] = True
        pred = _predict(p, psv, first, 1 << (8 - pt - 1))
        diffs.append(((p - pred + 32768) % 65536) - 32768)
    # the difference categories (SSSS): bit lengths of |d|, 16 for -32768
    cats = [np.frexp(np.abs(d))[1].astype(np.int64) for d in diffs]
    codes = []
    for c in range(ncomp):
        counts = np.bincount(cats[c].ravel(), minlength=17)
        bits, values = _huffman_table(counts)
        codes.append(_codes(bits, values))
        out += _segment(0xC4, bytes([tables[c]]) + bytes(bits) + bytes(values))
    scans = [list(range(ncomp))] if interleave else [[c] for c in range(ncomp)]
    for comps in scans:
        if restart_rows:  # in MCUs: a row of MCUs, or of the scan's component's samples
            per_row = mx if len(comps) > 1 else diffs[comps[0]].shape[1]
            out += _segment(0xDD, struct.pack(">H", restart_rows * per_row))
        out += _segment(0xDA, bytes([len(comps)])
                        + b"".join(bytes([ids[c], tables[c] << 4]) for c in comps)
                        + bytes([psv, 0, pt]))
        if len(comps) > 1:  # MCU by MCU, each component's v x h samples in turn
            per_mcu = []
            for c in comps:
                h, v = sampling[c]
                yy, xx, dy, dx = np.meshgrid(np.arange(my), np.arange(mx), np.arange(v),
                                             np.arange(h), indexing="ij")
                flat = ((yy * v + dy) * diffs[c].shape[1] + xx * h + dx).reshape(my, mx, v * h)
                per_mcu.append(np.stack([np.full_like(flat, c), flat], -1))
            units = np.concatenate(per_mcu, 2).reshape(-1, 2)
            per_row = units.shape[0] // my
        else:
            c = comps[0]
            flat = np.arange(diffs[c].size)
            units = np.stack([np.full_like(flat, c), flat], -1)
            per_row = diffs[c].shape[1]
        comp, at = units[:, 0], units[:, 1]
        d = np.zeros(len(units), np.int64)
        s = np.zeros(len(units), np.int64)
        for c in comps:
            mask = comp == c
            d[mask], s[mask] = diffs[c].ravel()[at[mask]], cats[c].ravel()[at[mask]]
        code = np.zeros(len(units), np.int64)
        size = np.zeros(len(units), np.int64)
        for c in comps:
            mask = comp == c
            table = np.array([codes[c].get(k, (0, 0)) for k in range(17)])
            code[mask], size[mask] = table[s[mask], 0], table[s[mask], 1]
        extra = np.where(s < 16, s, 0)
        bits_of = np.where(d >= 0, d, d - 1) & ((1 << extra) - 1)
        values, lengths = (code << extra) | bits_of, size + extra
        step = per_row * restart_rows if restart_rows else len(units)
        for n, start in enumerate(range(0, len(units), step)):
            if n:
                out += bytes([0xFF, 0xD0 + (n - 1) % 8])
            out += _pack_bits(values[start:start + step], lengths[start:start + step])
    return out + b"\xff\xd9"


def _pack_bits(values: np.ndarray, lengths: np.ndarray) -> bytes:
    """Codes of the given bit lengths, MSB first, padded with 1 bits to a
    byte and 0xFF-stuffed: an entropy-coded segment."""
    total = int(lengths.sum())
    starts = np.cumsum(lengths) - lengths
    item = np.repeat(np.arange(len(lengths)), lengths)
    shift = lengths[item] - 1 - (np.arange(total) - starts[item])
    bits = ((values[item] >> shift) & 1).astype(np.uint8)
    data = np.packbits(np.concatenate([bits, np.ones(-total % 8, np.uint8)]))
    return np.insert(data, np.nonzero(data == 0xFF)[0] + 1, 0).tobytes()


# --- PNG -------------------------------------------------------------------------

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))  # (x0, y0, dx, dy) of each pass


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _filtered(rows: np.ndarray, bpp: int, seed: int) -> bytes:
    """Scanlines of (n, stride) uint8 with filter types 0-4 in turn from ``seed``."""
    out = bytearray()
    prior = np.zeros(rows.shape[1], np.int64)
    for y, row in enumerate(rows.astype(np.int64)):
        kind = (y + seed) % 5
        left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])[:row.size]
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])[:row.size]
        if kind == 0:
            f = row
        elif kind == 1:
            f = row - left
        elif kind == 2:
            f = row - prior
        elif kind == 3:
            f = row - ((left + prior) >> 1)
        else:
            p = left + prior - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
            f = row - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        out += bytes([kind]) + (f % 256).astype(np.uint8).tobytes()
        prior = row
    return bytes(out)


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, c) samples -> (h, stride) uint8 scanline bytes at ``depth``."""
    h, w, c = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, w * c * 2)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, w * c)
    bits = np.unpackbits(samples.astype(np.uint8).reshape(h, w * c, 1), axis=2)[..., 8 - depth:]
    return np.packbits(bits.reshape(h, -1), axis=1)


def png(samples: np.ndarray, color: int, depth: int = 8, interlace: bool = False,
        palette=None, seed: int = 0) -> bytes:
    """A PNG of ``samples`` ((H, W) or (H, W, C), uint8 or uint16) of
    ``color`` type (0 gray, 2 RGB, 3 palette, 4 gray + alpha, 6 RGBA) at
    ``depth``, Adam7-interlaced if asked, filters 0-4 in turn."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    height, width, channels = samples.shape
    bpp = max(1, channels * depth // 8)
    body = PNG_MAGIC + _chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth, color, 0, 0,
                                                   int(interlace)))
    if color == 3:
        body += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if interlace:
        raw = b""
        for i, (x0, y0, dx, dy) in enumerate(ADAM7):
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                raw += _filtered(_pack(sub, depth), bpp, seed + i)
    else:
        raw = _filtered(_pack(samples, depth), bpp, seed)
    return body + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b"")


# --- BMP -------------------------------------------------------------------------

BMP_HEADERS = (12, 40, 52, 56, 64, 108, 124)


def _rle_row(row: np.ndarray, rle4: bool, pos: int, runs: str) -> bytes:
    """One row of RLE8/RLE4 ops (no end-of-line): "encoded" repeats each
    value, "absolute" writes literal runs (2 + n bytes, then a pad byte where
    the file offset ``pos`` after them is odd, as PIL aligns), "mixed" takes
    repeats of 3 or more encoded and the rest absolute."""
    out = bytearray()
    vals = [int(v) for v in row]
    i, n = 0, len(vals)

    def literal(chunk):
        nonlocal out
        if len(chunk) < 3:  # an absolute run takes 3 or more pixels
            for v in chunk:
                out += bytes([1, v * 17 if rle4 else v])
            return
        out += bytes([0, len(chunk)])
        if rle4:
            padded = chunk + [0] * (len(chunk) % 2)
            out += bytes((padded[k] << 4) | padded[k + 1] for k in range(0, len(padded), 2))
        else:
            out += bytes(chunk)
        if (pos + len(out)) % 2:
            out += b"\x00"

    while i < n:
        j = i + 1
        while j < n and vals[j] == vals[i] and j - i < 255:
            j += 1
        if runs == "encoded" or (runs == "mixed" and j - i >= 3):
            out += bytes([j - i, vals[i] * 17 if rle4 else vals[i]])
            i = j
            continue
        k = i
        while k < n and k - i < 254 and not (runs == "mixed" and k + 2 < n
                                             and vals[k] == vals[k + 1] == vals[k + 2]):
            k += 1
        literal(vals[i:k])
        i = k
    return bytes(out)


def bmp(pixels: np.ndarray, bits: int, palette=None, compression: int = 0, header: int = 40,
        top_down: bool = False, masks=None, clr_used: int = None, runs: str = "mixed",
        delta: tuple = None, end_of_bitmap: bool = True) -> bytes:
    """A BMP of ``pixels``: palette indices (H, W) at ``bits`` 1, 4 or 8
    (``palette`` (N, 3) RGB, ``clr_used`` entries recorded, default N);
    at 16 and 32 bits the raw little-endian pixel values (H, W) (``masks``
    (r, g, b[, a]) under BITFIELDS, ``compression`` 3); at 24 bits RGB
    (H, W, 3). ``compression`` 1 and 2 are RLE8 and RLE4 of the indices
    (``runs``, see ``_rle_row``; ``delta`` = (row, col, right, up) puts a
    delta escape at that place of that row). ``header`` is the info header's
    size (12: OS/2, 3-byte palette entries). Rows run bottom-up, or
    top-down (a negative height) if ``top_down``."""
    pixels = np.asarray(pixels)
    height, width = pixels.shape[:2]
    entry = 3 if header == 12 else 4
    table = b""
    if palette is not None:
        pal = np.asarray(palette, np.uint8)
        table = b"".join(bytes([b, g, r]) + (b"\x00" if entry == 4 else b"") for r, g, b in pal)
    extra = b""
    if compression == 3 and header == 40:
        extra = struct.pack("<III", *masks[:3])
    offset = 14 + header + len(extra) + len(table)
    order = range(height) if top_down else range(height - 1, -1, -1)
    if compression in (1, 2):
        body = bytearray()
        for y in order:
            row = pixels[y]
            if delta is not None and delta[0] == y:
                body += _rle_row(row[:delta[1]], compression == 2, offset + len(body), runs)
                body += bytes([0, 2, delta[2], delta[3]])
                row = row[delta[1]:]
            body += _rle_row(row, compression == 2, offset + len(body), runs) + b"\x00\x00"
        if end_of_bitmap:
            body += b"\x00\x01"
        body = bytes(body)
    else:
        stride = ((width * bits + 31) >> 3) & ~3
        if bits <= 8:
            packed = np.packbits(np.unpackbits(pixels.astype(np.uint8)[..., None], axis=2)[
                ..., 8 - bits:].reshape(height, -1), axis=1)
        elif bits == 16:
            packed = pixels.astype("<u2").view(np.uint8).reshape(height, -1)
        elif bits == 24:
            packed = pixels[..., ::-1].astype(np.uint8).reshape(height, -1)
        else:
            packed = pixels.astype("<u4").view(np.uint8).reshape(height, -1)
        rows = np.zeros((height, stride), np.uint8)
        rows[:, :packed.shape[1]] = packed
        body = rows[list(order)].tobytes()
    n_colors = (len(table) // entry) if clr_used is None else clr_used
    if header == 12:
        info = struct.pack("<IHHHH", 12, width, height, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, width, -height if top_down else height, 1,
                           bits, compression, len(body), 2835, 2835, n_colors, 0)
        if header >= 52:
            m = tuple(masks) + (0,) * (4 - len(masks)) if masks else (0, 0, 0, 0)
            info += struct.pack("<III", *m[:3]) + (struct.pack("<I", m[3]) if header >= 56 else b"")
        if header >= 108:
            info += b"BGRs" + bytes(48)  # LCS_sRGB, endpoints, gammas
        if header == 124:
            info += struct.pack("<IIII", 4, 0, 0, 0)  # intent, profile data, size, reserved
        info += bytes(header - len(info))
    return (b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset) + info + extra + table
            + body)


# --- GIF -------------------------------------------------------------------------

def _lzw(indices: np.ndarray, min_size: int, clear_when_full: bool = True) -> bytes:
    """GIF LZW of a flat index sequence (a clear code first, the end code
    last), each code written at the width the decoder reads it at; a full
    table (4096 codes) is cleared, or kept and no longer grown."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    acc, nbits, out = 0, 0, bytearray()

    def emit(code, width):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    def reset():
        return {(i,): i for i in range(clear)}, clear + 2

    table, nxt = reset()
    dec_next, dec_size, dec_codes = clear + 2, min_size + 1, 0  # the decoder's view
    emit(clear, dec_size)

    def sent(code):
        nonlocal dec_next, dec_size, dec_codes
        emit(code, dec_size)
        dec_codes += 1
        if dec_codes >= 2 and dec_next < 4096:
            if dec_next == (1 << dec_size) - 1 and dec_size < 12:
                dec_size += 1
            dec_next += 1

    w = ()
    for v in (int(x) for x in np.asarray(indices).ravel()):
        wc = w + (v,)
        if wc in table:
            w = wc
            continue
        sent(table[w])
        if nxt < 4096:
            table[wc] = nxt
            nxt += 1
        elif clear_when_full:
            emit(clear, dec_size)
            table, nxt = reset()
            dec_next, dec_size, dec_codes = clear + 2, min_size + 1, 0
        w = (v,)
    if w:
        sent(table[w])
    emit(end, dec_size)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def sub_blocks(data: bytes) -> bytes:
    """GIF data sub-blocks of ``data`` (at most 255 bytes each), then the
    terminator."""
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def _gif_palette(palette) -> tuple:
    """(size field, table bytes) of a palette padded to a power of two."""
    pal = np.asarray(palette, np.uint8).reshape(-1, 3)
    size = max(1, int(np.ceil(np.log2(max(len(pal), 2)))))
    table = np.zeros((1 << size, 3), np.uint8)
    table[:len(pal)] = pal
    return size - 1, table.tobytes()


INTERLACE_ROWS = ((0, 8), (4, 8), (2, 4), (1, 2))


def gif(frames, screen=None, global_palette=None, version: bytes = b"GIF89a") -> bytes:
    """A GIF of ``frames``: each a dict of ``indices`` (h, w), and optional
    ``offset`` (x, y), ``palette`` (a local palette (N, 3)), ``interlace``,
    ``transparency`` (an index, in a graphic control extension),
    ``min_size`` (the LZW minimum code size, default the palette's bits
    or the indices', at least 2) and ``clear_when_full``. ``screen`` (w, h) defaults to the
    first frame's extent."""
    first = frames[0]
    if screen is None:
        h, w = np.asarray(first["indices"]).shape
        x, y = first.get("offset", (0, 0))
        screen = (x + w, y + h)
    flags, table = 0, b""
    if global_palette is not None:
        size, table = _gif_palette(global_palette)
        flags = 0x80 | 0x70 | size
    out = version + struct.pack("<HHBBB", screen[0], screen[1], flags, 0, 0) + table
    if len(frames) > 1:
        out += b"!\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
    for f in frames:
        idx = np.asarray(f["indices"], np.uint8)
        h, w = idx.shape
        if "transparency" in f or len(frames) > 1:
            t = f.get("transparency")
            out += b"!\xf9\x04" + struct.pack("<BHB", 1 if t is not None else 0, 10, t or 0) + b"\x00"
        x, y = f.get("offset", (0, 0))
        fflags, local = 0, b""
        if f.get("palette") is not None:
            size, local = _gif_palette(f["palette"])
            fflags = 0x80 | size
        if f.get("interlace"):
            fflags |= 0x40
            idx = np.concatenate([idx[r0::step] for r0, step in INTERLACE_ROWS])
        pal_bits = (fflags & 7 if local else flags & 7) + 1
        min_size = f.get("min_size", max(2, pal_bits, int(idx.max()).bit_length()))
        out += b"," + struct.pack("<HHHHB", x, y, w, h, fflags) + local + bytes([min_size])
        out += sub_blocks(_lzw(idx, min_size, f.get("clear_when_full", True)))
    return out + b";"


# --- TIFF ------------------------------------------------------------------------

# ITU-T T.4 run-length codes (bits as text) of white and black runs 0-63,
# makeup runs 64-1728, and the makeup runs 1792-2560 both colors share
_T4_WHITE = (
    "00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111 01000 001000 000011 "
    "110100 110101 101010 101011 0100111 0001100 0001000 0010111 0000011 0000100 0101000 "
    "0101011 0010011 0100100 0011000 00000010 00000011 00011010 00011011 00010010 00010011 "
    "00010100 00010101 00010110 00010111 00101000 00101001 00101010 00101011 00101100 "
    "00101101 00000100 00000101 00001010 00001011 01010010 01010011 01010100 01010101 "
    "00100100 00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010 "
    "00110011 00110100 11011 10010 010111 0110111 00110110 00110111 01100100 01100101 "
    "01101000 01100111 011001100 011001101 011010010 011010011 011010100 011010101 011010110 "
    "011010111 011011000 011011001 011011010 011011011 010011000 010011001 010011010 011000 "
    "010011011").split()
_T4_BLACK = (
    "0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100 0000101 0000111 00000100 "
    "00000111 000011000 0000010111 0000011000 0000001000 00001100111 00001101000 00001101100 "
    "00000110111 00000101000 00000010111 00000011000 000011001010 000011001011 000011001100 "
    "000011001101 000001101000 000001101001 000001101010 000001101011 000011010010 "
    "000011010011 000011010100 000011010101 000011010110 000011010111 000001101100 "
    "000001101101 000011011010 000011011011 000001010100 000001010101 000001010110 "
    "000001010111 000001100100 000001100101 000001010010 000001010011 000000100100 "
    "000000110111 000000111000 000000100111 000000101000 000001011000 000001011001 "
    "000000101011 000000101100 000001011010 000001100110 000001100111 0000001111 "
    "000011001000 000011001001 000001011011 000000110011 000000110100 000000110101 "
    "0000001101100 0000001101101 0000001001010 0000001001011 0000001001100 0000001001101 "
    "0000001110010 0000001110011 0000001110100 0000001110101 0000001110110 0000001110111 "
    "0000001010010 0000001010011 0000001010100 0000001010101 0000001011010 0000001011011 "
    "0000001100100 0000001100101").split()
_T4_EXT = ("00000001000 00000001100 00000001101 000000010010 000000010011 000000010100 "
           "000000010101 000000010110 000000010111 000000011100 000000011101 000000011110 "
           "000000011111").split()
_T4_EOL = "000000000001"


def _t4_run(run: int, black: bool) -> str:
    """The T.4 codes of one run: makeup codes (2560 at most each), then a
    terminating code."""
    table = _T4_BLACK if black else _T4_WHITE
    out = ""
    while run >= 2560 + 64:
        out += _T4_EXT[-1]
        run -= 2560
    if run >= 1792:
        out += _T4_EXT[(run - 1792) // 64]
        run %= 64
    elif run >= 64:
        out += table[63 + run // 64]
        run %= 64
    return out + table[run]


def _changes(row: np.ndarray) -> list:
    """Positions where a bilevel row (True black) changes color, the
    imaginary pixel before it white."""
    prev = np.concatenate([[False], row[:-1]])
    return list(np.flatnonzero(row != prev))


def _t4_1d(row: np.ndarray) -> str:
    edges = _changes(row) + [row.size]
    out, x, black = "", 0, False
    for e in edges:
        out += _t4_run(e - x, black)
        x, black = e, not black
    return out


def _t4_2d(row: np.ndarray, ref: np.ndarray) -> str:
    """One row coded against the row above (T.4 section 4.2, T.6)."""
    width = row.size
    cur_changes, ref_changes = _changes(row), _changes(ref)

    def next_change(changes, after):
        for c in changes:
            if c > after:
                return c
        return width

    def ref_b1(a0, color):
        for c in ref_changes:  # a change to the opposite of `color` past a0
            if c > a0 and bool(ref[c]) != color:
                return c
        return width

    out, a0, color = "", -1, False
    vertical = {0: "1", 1: "011", 2: "000011", 3: "0000011", -1: "010", -2: "000010",
                -3: "0000010"}
    while a0 < width:
        a1 = next_change(cur_changes, a0)
        b1 = ref_b1(a0, color)
        b2 = next_change(ref_changes, b1)
        if b2 < a1:
            out += "0001"
            a0 = b2
        elif abs(a1 - b1) <= 3:
            out += vertical[a1 - b1]
            a0, color = a1, not color
        else:
            a2 = next_change(cur_changes, a1)
            out += "001" + _t4_run(a1 - max(a0, 0), color) + _t4_run(a2 - a1, not color)
            a0 = a2
    return out


def _bits_to_bytes(bits: str) -> bytes:
    bits += "0" * (-len(bits) % 8)
    return int(bits, 2).to_bytes(len(bits) // 8, "big") if bits else b""


def ccitt(pixels: np.ndarray, compression: int, options: int = 0, eofb: bool = True,
          rtc: bool = True) -> bytes:
    """A bilevel image (True black) coded as CCITT modified Huffman (2: each
    row 1-D and byte aligned), Group 3 (3: an EOL before each row, under
    ``options`` bit 0 a tag bit and 2-D rows between 1-D ones, bit 2 EOLs
    byte aligned; ``rtc`` ends with six EOLs) or Group 4 (4: every row 2-D;
    ``eofb`` ends with two EOLs)."""
    pixels = np.asarray(pixels, bool)
    ref = np.zeros(pixels.shape[1], bool)
    if compression == 2:
        return b"".join(_bits_to_bytes(_t4_1d(row)) for row in pixels)
    out = ""
    for y, row in enumerate(pixels):
        if compression == 3:
            eol = _T4_EOL
            if options & 4:  # fill bits so that the EOL ends a byte
                eol = "0" * ((4 - len(out)) % 8) + eol
            out += eol
            if options & 1:
                one_d = y % 3 == 0
                out += ("1" if one_d else "0") + (_t4_1d(row) if one_d else _t4_2d(row, ref))
            else:
                out += _t4_1d(row)
        else:
            out += _t4_2d(row, ref)
        ref = row
    if compression == 3 and rtc:
        out += (_T4_EOL + ("1" if options & 1 else "")) * 6
    if compression == 4 and eofb:
        out += _T4_EOL * 2
    return _bits_to_bytes(out)


def lzw_tiff(data: bytes, compat: bool = False) -> bytes:
    """TIFF LZW: a clear code first, codes of 9-12 bits most significant bit
    first, the width growing as libtiff's encoder grows it, a clear where
    the table is full, the end code last. ``compat``: the old style (least
    significant bit first, the width growing one code late), which decodes
    only as long as the table needs no clear."""
    codes, widths = [256], [9]
    nbits, next_code = 9, 258
    table = {}  # (prefix code << 8 | byte) -> code

    def grow():
        nonlocal nbits, next_code, table
        next_code += 1
        if next_code == 4094:
            codes.append(256)
            widths.append(nbits)
            table, nbits, next_code = {}, 9, 258
        elif next_code > (1 << nbits) - (0 if compat else 1):
            nbits += 1

    w = -1
    for c in data:
        if w < 0:
            w = c
            continue
        key = w << 8 | c
        code = table.get(key)
        if code is not None:
            w = code
            continue
        codes.append(w)
        widths.append(nbits)
        table[key] = next_code
        grow()
        w = c
    if w >= 0:
        codes.append(w)
        widths.append(nbits)
        grow()
    codes.append(257)
    widths.append(nbits)
    acc, bits, out = 0, 0, bytearray()
    for code, width in zip(codes, widths):
        if compat:
            acc |= code << bits
            bits += width
            while bits >= 8:
                out.append(acc & 255)
                acc >>= 8
                bits -= 8
        else:
            acc = (acc << width) | code
            bits += width
            while bits >= 8:
                out.append((acc >> (bits - 8)) & 255)
                bits -= 8
            acc &= (1 << bits) - 1
    if bits:
        out.append(acc & 255 if compat else (acc << (8 - bits)) & 255)
    return bytes(out)


def packbits(data: bytes) -> bytes:
    """PackBits: repeats of 3-128 bytes as runs, the rest as literals of up
    to 128."""
    out, i, n = bytearray(), 0, len(data)
    lit = bytearray()
    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            while lit:
                out += bytes([len(lit[:128]) - 1]) + lit[:128]
                lit = lit[128:]
            out += bytes([257 - (j - i), data[i]])
            i = j
        else:
            lit.append(data[i])
            i += 1
    while lit:
        out += bytes([len(lit[:128]) - 1]) + lit[:128]
        lit = lit[128:]
    return bytes(out)


def jpeg_tables(stream: bytes):
    """A JPEG stream split as a TIFF holds it: (the JPEGTables stream: SOI,
    the DQT and DHT segments, EOI; the abbreviated stream: SOI, then the
    rest without APPn segments)."""
    tables, rest, pos = b"", b"", 2
    while pos < len(stream):
        marker = stream[pos + 1]
        if marker == 0xDA:
            rest += stream[pos:]
            break
        length = struct.unpack(">H", stream[pos + 2:pos + 4])[0]
        seg = stream[pos:pos + 2 + length]
        if marker in (0xDB, 0xC4):
            tables += seg
        elif not 0xE0 <= marker <= 0xEF:
            rest += seg
        pos += 2 + length
    return b"\xff\xd8" + tables + b"\xff\xd9", b"\xff\xd8" + rest


def ycbcr_blocks(y: np.ndarray, cb: np.ndarray, cr: np.ndarray, hs: int, vs: int) -> bytes:
    """Full-size Y and chroma planes (chroma taken at each block's top left)
    -> YCbCr data in blocks of hs x vs luma samples, Cb and Cr; the image
    padded to whole blocks by repeating its last row and column."""
    h, w = y.shape
    bh, bw = -(-h // vs), -(-w // hs)
    pad = ((0, bh * vs - h), (0, bw * hs - w))
    y, cb, cr = (np.pad(p, pad, mode="edge") for p in (y, cb, cr))
    blocks = y.reshape(bh, vs, bw, hs).transpose(0, 2, 1, 3).reshape(bh, bw, vs * hs)
    return np.concatenate([blocks, cb[::vs, ::hs, None], cr[::vs, ::hs, None]], -1).astype(
        np.uint8).tobytes()


def _samples_bytes(samples: np.ndarray, bits: int, order: str) -> bytes:
    """Rows of (h, w, c) samples at ``bits`` (1, 2, 4: packed, rows padded
    to a byte; 8-64: in ``order``'s byte order)."""
    h, w, c = samples.shape
    if bits < 8:
        v = samples.astype(np.uint8).reshape(h, w * c, 1)
        packed = np.unpackbits(v, axis=2)[..., 8 - bits:].reshape(h, -1)
        return np.packbits(packed, axis=1).tobytes()
    if bits == 8:
        return samples.astype(np.uint8).tobytes()
    kind = samples.dtype.kind if samples.dtype.kind in "fi" else "u"
    return samples.astype(f"{order}{kind}{bits // 8}").tobytes()


def _tiff_predict(raw: bytes, predictor: int, width: int, spp: int, bits: int, order: str,
             rows: int) -> bytes:
    """The encoder's side of predictor 2 (horizontal differences of the
    samples) and 3 (the float predictor: byte planes, most significant
    first, then byte differences)."""
    if predictor == 2:
        dt = {8: np.uint8, 16: f"{order}u2", 32: f"{order}u4"}[bits]
        v = np.frombuffer(raw, dt).reshape(rows, width, spp).astype(np.int64)
        d = v.copy()
        d[:, 1:] -= v[:, :-1]
        return (d % (1 << bits)).astype(dt).tobytes()
    nb = bits // 8
    v = np.frombuffer(raw, f"{order}f{nb}").reshape(rows, width * spp).astype(f">f{nb}")
    planes = v.view(np.uint8).reshape(rows, width * spp, nb).transpose(0, 2, 1).reshape(rows, -1)
    d = planes.astype(np.int64)
    d[:, spp:] -= planes[:, :-spp].astype(np.int64)
    return (d % 256).astype(np.uint8).tobytes()


def _compress(raw: bytes, compression: int) -> bytes:
    if compression in (8, 32946):
        return zlib.compress(raw, 6)
    if compression == 5:
        return lzw_tiff(raw)
    if compression == 32773:
        return packbits(raw)
    if compression == 34925:
        import lzma

        return lzma.compress(raw, format=lzma.FORMAT_XZ, check=lzma.CHECK_CRC32, preset=1)
    return raw


def tiff(samples=None, photometric: int = 2, bits: int = 8, compression: int = 1,
         sample_format: int = 1, extra=(), predictor: int = 1, planar: int = 1,
         fillorder: int = 1, order: str = "<", big: bool = False, tile=None,
         rows_per_strip=None, colormap=None, options: int = 0, orientation=None,
         segments=None, size=None, spp=None, tags=()) -> bytes:
    """A TIFF of ``samples`` (H, W) or (H, W, C) as stored (uint8, uint16,
    uint32, int or float arrays; 1, 2 and 4 bits packed from uint8 values):
    strips of ``rows_per_strip`` rows or ``tile`` = (width, length) tiles,
    PlanarConfiguration 1 or 2, each segment compressed (1 none, 2/3/4 CCITT
    of a bilevel image whose True is black, 5 LZW, 8 Deflate, 32773
    PackBits, 34925 LZMA) after ``predictor``; FillOrder 2 reverses the
    bits of each stored byte; ``order`` "<" (II) or ">" (MM); ``big`` for
    BigTIFF. ``segments`` gives the stored strips or tiles instead (JPEG,
    YCbCr blocks), with ``size`` = (W, H) and ``spp``. ``tags`` adds
    (tag, type, values) entries, replacing any of the same number."""
    if samples is not None:
        samples = np.asarray(samples)
        if samples.ndim == 2:
            samples = samples[..., None]
        height, width, spp = samples.shape
    else:
        width, height = size
    spp = spp or 1
    tw, th = tile if tile else (width, rows_per_strip or height)
    if segments is None:
        segments = []
        across, down = -(-width // tw), -(-height // th)
        planes = range(spp) if planar == 2 else (None,)
        for plane in planes:
            for sy in range(down):
                for sx in range(across):
                    if tile:  # whole tiles, the edge ones padded with zeros
                        part = np.zeros((th, tw, spp), samples.dtype)
                        src = samples[sy * th:(sy + 1) * th, sx * tw:(sx + 1) * tw]
                        part[:src.shape[0], :src.shape[1]] = src
                    else:
                        part = samples[sy * th:(sy + 1) * th]
                    if plane is not None:
                        part = part[..., plane:plane + 1]
                    rows, pw, pc = part.shape
                    if compression in (2, 3, 4):
                        data = ccitt(part[..., 0].astype(bool), compression, options)
                    else:
                        data = _samples_bytes(part, bits, order)
                        if predictor != 1:
                            data = _tiff_predict(data, predictor, pw, pc, bits, order, rows)
                        data = _compress(data, compression)
                    segments.append(data)
    if fillorder == 2:
        rev = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)
        segments = [rev[np.frombuffer(s, np.uint8)].tobytes() for s in segments]
    head = 16 if big else 8
    body = b"".join(segments)
    offsets, pos = [], head
    for s in segments:
        offsets.append(pos)
        pos += len(s)
    long_type = 16 if big else 4
    entries = {256: (4, (width,)), 257: (4, (height,)), 258: (3, (bits,) * spp),
               259: (3, (compression,)), 262: (3, (photometric,)), 277: (3, (spp,)),
               284: (3, (planar,))}
    if tile:
        entries.update({322: (3, (tw,)), 323: (3, (th,)), 324: (long_type, tuple(offsets)),
                        325: (long_type, tuple(len(s) for s in segments))})
    else:
        entries.update({273: (long_type, tuple(offsets)), 278: (4, (th,)),
                        279: (long_type, tuple(len(s) for s in segments))})
    if fillorder != 1:
        entries[266] = (3, (fillorder,))
    if sample_format != 1:
        entries[339] = (3, (sample_format,) * spp)
    if extra:
        entries[338] = (3, tuple(extra))
    if predictor != 1:
        entries[317] = (3, (predictor,))
    if colormap is not None:
        entries[320] = (3, tuple(int(v) for v in np.asarray(colormap).T.reshape(-1)))
    if options:
        entries[292 if compression == 3 else 293] = (4, (options,))
    if orientation:
        entries[274] = (3, (orientation,))
    for tag, typ, values in tags:
        entries[tag] = (typ, values)
    e = order
    codes = {1: "B", 2: "s", 3: "H", 4: "L", 5: "LL", 7: "s", 11: "f", 12: "d", 16: "Q"}
    sizes = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 7: 1, 11: 4, 12: 8, 16: 8}
    inline = 8 if big else 4
    ifd_at = head + len(body) + (len(body) % 2)
    ifd_len = (8 + 20 * len(entries) + 8) if big else (2 + 12 * len(entries) + 4)
    extra_at = ifd_at + ifd_len
    ifd, out_of_line = bytearray(), bytearray()
    for tag in sorted(entries):
        typ, values = entries[tag]
        if typ in (2, 7) or isinstance(values, (bytes, bytearray)):
            data, count = bytes(values), len(values)
        elif typ == 5:
            flat = [int(x) for v in values for x in (round(v * 10000), 10000)]
            data, count = struct.pack(f"{e}{2 * len(values)}L", *flat), len(values)
        else:
            data, count = struct.pack(f"{e}{len(values)}{codes[typ]}", *values), len(values)
        if len(data) <= inline:
            value = data.ljust(inline, b"\0")
        else:
            value = struct.pack(f"{e}{'Q' if big else 'L'}", extra_at + len(out_of_line))
            out_of_line += data + b"\0" * (len(data) % 2)
        ifd += struct.pack(f"{e}HH{'Q' if big else 'L'}", tag, typ, count) + value
    count = struct.pack(f"{e}{'Q' if big else 'H'}", len(entries))
    nxt = struct.pack(f"{e}{'Q' if big else 'L'}", 0)
    prefix = b"II" if order == "<" else b"MM"
    if big:
        header = prefix + struct.pack(f"{e}HHHQ", 43, 8, 0, ifd_at)
    else:
        header = prefix + struct.pack(f"{e}HL", 42, ifd_at)
    return header + body + b"\0" * (len(body) % 2) + count + bytes(ifd) + nxt + bytes(out_of_line)


def jpeg_tiff(img: np.ndarray, sampling, qtables, rows=None, tile=None, tables: bool = True,
              photometric: int = 6) -> bytes:
    """A JPEG-compressed TIFF of an RGB image: strips of ``rows`` rows (or
    one), or ``tile`` x ``tile`` tiles, each a baseline stream of
    ``huffman_jpeg`` without a JFIF marker (YCbCr samples under photometric
    6, the RGB values as stored under 2, gray under 1 with one sampling
    pair), their tables moved to the JPEGTables tag unless ``tables`` is
    False."""
    h, w = img.shape[:2]
    color = "gray" if len(sampling) == 1 else "ycc" if photometric == 6 else "rgb"

    def stream(part):
        ph, pw = part.shape[:2]
        planes = planes_of(part[..., 0] if color == "gray" else part, color)
        return huffman_jpeg(pw, ph, sampling, coefficients(planes, sampling, qtables), qtables,
                            jfif=False)

    parts = []
    if tile:
        for ty in range(0, h, tile):
            for tx in range(0, w, tile):
                part = np.zeros((tile, tile, 3), np.uint8)
                src = img[ty:ty + tile, tx:tx + tile]
                part[:src.shape[0], :src.shape[1]] = src
                parts.append(stream(part))
    else:
        step = rows or h
        parts = [stream(img[y:y + step]) for y in range(0, h, step)]
    extra = [(530, 3, tuple(sampling[0]))] if photometric == 6 else []
    if tables:
        split = [jpeg_tables(p) for p in parts]
        parts = [s[1] for s in split]
        extra.append((347, 7, split[0][0]))
    return tiff(size=(w, h), spp=len(sampling), photometric=photometric, compression=7,
                segments=parts, rows_per_strip=rows, tile=(tile, tile) if tile else None,
                tags=tuple(extra))


def netpbm(magic: bytes, samples: np.ndarray, maxval: int = 255) -> bytes:
    """A Netpbm file of (H, W) or (H, W, 3) samples: P1-P3 as text (P1's
    samples 1 black), P4 packed bits, P5 and P6 one byte a sample up to a
    maxval of 255, else two big-endian."""
    samples = np.asarray(samples)
    h, w = samples.shape[:2]
    head = magic + b"\n%d %d\n" % (w, h)
    if magic in (b"P1", b"P4"):
        bits = samples.astype(np.uint8)
        if magic == b"P4":
            return head + np.packbits(bits, axis=1).tobytes()
        return head + b"\n".join(b" ".join(b"%d" % v for v in row) for row in bits) + b"\n"
    head += b"%d\n" % maxval
    if magic in (b"P2", b"P3"):
        rows = samples.reshape(h, -1)
        return head + b"\n".join(b" ".join(b"%d" % v for v in row) for row in rows) + b"\n"
    return head + samples.astype(np.uint8 if maxval < 256 else ">u2").tobytes()


# --- TGA and ICO -----------------------------------------------------------------

TGA_FOOTER = b"\0" * 8 + b"TRUEVISION-XFILE." + b"\0"


def tga(pixels: bytes, w: int, h: int, imagetype: int, depth: int, flags: int = 0,
        cmap: bytes = b"", cm_start: int = 0, cm_len: int = 0, cm_depth: int = 0,
        ident: bytes = b"", footer: bool = False) -> bytes:
    """A TGA of stored ``pixels`` (raw or ``tga_rle`` packets): the 18-byte
    header (the colour-map type set where ``cm_len`` is), the ID field, the
    colour map, the pixels, and with ``footer`` the TGA 2.0 footer."""
    head = struct.pack("<BBBHHBHHHHBB", len(ident), int(bool(cm_len)), imagetype, cm_start,
                       cm_len, cm_depth, 0, 0, w, h, depth, flags)
    return head + ident + cmap + pixels + (TGA_FOOTER if footer else b"")


def tga_rle(rows: np.ndarray, depth: int, cross_rows: bool = False) -> bytes:
    """TGA RLE packets of (h, w * depth) pixel bytes: runs of 2 or more as
    run packets, the rest literal; with ``cross_rows`` the rows are one
    stream, runs stay inside a row and literals of up to 128 pixels run on
    past its end."""
    h = rows.shape[0]
    width = rows.shape[1] // depth
    px = np.ascontiguousarray(rows).reshape(h * width, depth)
    # a run starts where a pixel differs from the one before, or a row starts
    key = px.view(np.dtype((np.void, depth)))[:, 0]
    start = np.ones(h * width, bool)
    start[1:] = key[1:] != key[:-1]
    start[::width] = True
    bounds = list(np.flatnonzero(start)) + [h * width]
    out = bytearray()
    literal = []  # pixel indices waiting for a literal packet

    def flush():
        while literal:
            take = literal[:128]
            if not cross_rows:  # a literal stays inside its row
                row = take[0] // width
                take = [i for i in take if i // width == row]
            out.append(len(take) - 1)
            out.extend(px[take[0]:take[-1] + 1].tobytes())
            del literal[:len(take)]

    for a, b in zip(bounds[:-1], bounds[1:]):
        if b - a >= 2:
            flush()
            while a < b:
                n = min(128, b - a)
                if n == 1:
                    literal.append(a)
                    flush()
                    break
                out.append(0x80 | (n - 1))
                out.extend(px[a].tobytes())
                a += n
        else:
            literal.append(a)
    flush()
    return bytes(out)


def dib_entry(pixels: np.ndarray, bits: int, mask: np.ndarray, palette=None) -> bytes:
    """A DIB for an ICO entry: the bitmap header with twice the height, the
    XOR image bottom-up and the AND mask (1 transparent) bottom-up, rows of
    both padded to 32 bits."""
    h, w = pixels.shape[:2]
    data = bmp(pixels, bits, palette=palette)
    offset = struct.unpack_from("<I", data, 10)[0]
    header = bytearray(data[14:offset])
    struct.pack_into("<i", header, 8, 2 * h)
    stride = (w + 31) // 32 * 4
    rows = np.zeros((h, stride * 8), np.uint8)
    rows[:, :w] = mask
    return bytes(header) + data[offset:] + np.packbits(rows[::-1], axis=1).tobytes()


def ico(entries) -> bytes:
    """An ICO of ``entries``: (payload (a PNG or ``dib_entry``), (w, h) for
    the directory (256 written as 0), bits per pixel, color count)."""
    out = b"\0\0\1\0" + struct.pack("<H", len(entries))
    pos = 6 + 16 * len(entries)
    body = b""
    for (payload, (w, h), bpp, colors) in entries:
        out += struct.pack("<BBBBHHII", w % 256 if w <= 256 else 0, h % 256 if h <= 256 else 0,
                           colors, 0, 1, bpp, len(payload),
                           pos + len(body))
        body += payload
    return out + body




# --- the small rasters: PCX, DCX, SGI, Sun raster, MSP, XBM, IM ---------------------

def pcx_runs(lines: np.ndarray, cross_lines: bool = False) -> bytes:
    """PCX run-length data of (h, line bytes) lines: runs of 2 or more (and
    any byte of 0xC0 or more) as 0xC0 | n, v (n up to 63), the rest
    literal; with ``cross_lines`` the lines are one stream, so that a run
    may reach past a line's end."""
    stream = [np.ascontiguousarray(lines).reshape(-1)] if cross_lines else list(lines)
    out = bytearray()
    for row in stream:
        i = 0
        while i < len(row):
            j = i
            while j < len(row) and j - i < 63 and row[j] == row[i]:
                j += 1
            if j - i > 1 or row[i] >= 0xC0:
                out += bytes([0xC0 | (j - i), row[i]])
            else:
                out.append(row[i])
            i = j
    return bytes(out)


def pcx(lines: np.ndarray, width: int, height: int, bits: int, planes: int,
        version: int = 5, palette16: bytes = bytes(48), stride: int = None,
        trailer: bytes = b"", x0: int = 0, y0: int = 0, cross_lines: bool = False) -> bytes:
    """A PCX file of (h, planes * stride) stored lines: the 128-byte header
    (its bounding box from (x0, y0), the 16-colour palette, the stride it
    states), the run-length data, then ``trailer`` (b"\\x0c" and 768 bytes
    for an 8-bit palette)."""
    stride = lines.shape[1] // planes if stride is None else stride
    head = struct.pack("<BBBBHHHHHH", 10, version, 1, bits, x0, y0, x0 + width - 1,
                       y0 + height - 1, 72, 72) + palette16 + b"\0" + bytes([planes])
    head += struct.pack("<HHHH", stride, 1, width, height) + b"\0" * 54
    return head + pcx_runs(lines, cross_lines) + trailer


def dcx(pages) -> bytes:
    """A DCX file: the magic number, the pages' offsets ended by 0, the pages."""
    pos = 4 + 4 * (len(pages) + 1)
    table = b""
    for page in pages:
        table += struct.pack("<I", pos)
        pos += len(page)
    return struct.pack("<I", 987654321) + table + b"\0\0\0\0" + b"".join(pages)


def sgi_rle_row(values: np.ndarray, bpc: int) -> bytes:
    """One SGI RLE row of samples: runs of 3 or more as a count and one
    sample, the rest as copies (0x80 | n, n samples), counts up to 127,
    a 0 count at the end (``bpc`` bytes a count and a sample)."""
    dt = ">u2" if bpc == 2 else "u1"
    out = bytearray()

    def count(n):
        out.extend(n.to_bytes(bpc, "big"))

    i, lit = 0, []
    vals = [int(v) for v in values]

    def flush():
        while lit:
            take = lit[:127]
            count(0x80 | len(take))
            out.extend(np.array(take, dt).tobytes())
            del lit[:len(take)]

    while i < len(vals):
        j = i
        while j < len(vals) and j - i < 127 and vals[j] == vals[i]:
            j += 1
        if j - i >= 3:
            flush()
            count(j - i)
            out.extend(np.array([vals[i]], dt).tobytes())
        else:
            lit.extend(vals[i:j])
        i = j
    flush()
    count(0)
    return bytes(out)


def sgi(planes: np.ndarray, bpc: int = 1, rle: bool = False, dimension: int = None,
        rows=None, shared: bool = False) -> bytes:
    """An SGI file of (channels, h, w) samples (uint8, or uint16 at
    ``bpc`` 2), rows stored bottom-up: verbatim, or RLE with the offset and
    length tables (``rows``: a function of (channel, row index from the
    bottom, samples) to a row's RLE bytes, else ``sgi_rle_row``; with
    ``shared`` identical rows point at one copy)."""
    z, h, w = planes.shape
    dimension = dimension or (3 if z > 1 else 2)
    head = struct.pack(">hBBHHHHll4s79ss", 474, int(rle), bpc, dimension, w, h, z, 0,
                       65535 if bpc == 2 else 255, b"", b"fixture", b"")
    head += struct.pack(">l404s", 0, b"")
    flipped = planes[:, ::-1]
    if not rle:
        return head + np.ascontiguousarray(flipped).astype(">u2" if bpc == 2 else "u1").tobytes()
    make = rows or (lambda c, y, v: sgi_rle_row(v, bpc))
    starts, lengths, body, seen = [], [], b"", {}
    base = 512 + 8 * z * h
    for c in range(z):
        for y in range(h):
            data = make(c, y, flipped[c, y])
            if shared and data in seen:
                starts.append(seen[data])
            else:
                seen[data] = base + len(body)
                starts.append(base + len(body))
                body += data
            lengths.append(len(data))
    return head + struct.pack(f">{2 * z * h}I", *starts, *lengths) + body


def sun(data: bytes, width: int, height: int, depth: int, file_type: int = 1,
        colormap: bytes = b"", map_type: int = None) -> bytes:
    """A Sun raster file: the 32-byte header (the data length, the colour
    map's type and length), the colour map (red, green and blue planes),
    the data."""
    map_type = (1 if colormap else 0) if map_type is None else map_type
    return struct.pack(">8I", 0x59A66A95, width, height, depth, len(data), file_type,
                       map_type, len(colormap)) + colormap + data


def sun_rows(rows: np.ndarray) -> bytes:
    """Raw Sun rows of (h, w bytes) padded to 16 bits."""
    h, n = rows.shape
    out = np.zeros((h, n + n % 2), np.uint8)
    out[:, :n] = rows
    return out.tobytes()


def sun_rle(data: bytes) -> bytes:
    """Sun run-length data of one byte stream: runs of 3 or more as 0x80,
    n - 1, v (n up to 256), a lone 0x80 as 0x80 0, the rest literal."""
    out = bytearray()
    i = 0
    while i < len(data):
        j = i
        while j < len(data) and j - i < 256 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([0x80, j - i - 1, data[i]])
            i = j
        elif data[i] == 0x80:
            out += b"\x80\x00"
            i += 1
        else:
            out.append(data[i])
            i += 1
    return bytes(out)


def msp(bits: np.ndarray, version: int = 2, runs: int = 8, blank: bool = False) -> bytes:
    """An MSP file of (h, w) 0/1 pixels (1 white): version 1 raw, or
    version 2 with the row table and each row as runs (0, n, v) of at least
    ``runs`` equal bytes and copies (n, n bytes) of the rest (with
    ``blank``, a row of white bytes as count 0 and no data); the header's
    checksum word makes its 16 words XOR to 0."""
    h, w = bits.shape
    rows = np.packbits(bits.astype(np.uint8), axis=1)
    words = [int.from_bytes(b"Da" if version == 1 else b"Li", "little"),
             int.from_bytes(b"nM" if version == 1 else b"nS", "little"), w, h, 1, 1, 1, 1, w, h,
             0, 0, 0, 0, 0, 0]
    check = 0
    for v in words:
        check ^= v
    words[12] = check
    head = struct.pack("<16H", *words)
    if version == 1:
        return head + rows.tobytes()
    body, table = b"", []
    for row in rows:
        if blank and (row == 0xFF).all():
            table.append(0)
            continue
        out, i, lit = bytearray(), 0, bytearray()
        while i < len(row):
            j = i
            while j < len(row) and j - i < 255 and row[j] == row[i]:
                j += 1
            if j - i >= runs:
                while lit:
                    out += bytes([min(len(lit), 255)]) + lit[:255]
                    del lit[:255]
                out += bytes([0, j - i, row[i]])
            else:
                lit += bytes(row[i:j])
            i = j
        while lit:
            out += bytes([min(len(lit), 255)]) + lit[:255]
            del lit[:255]
        table.append(len(out))
        body += bytes(out)
    return head + struct.pack(f"<{h}H", *table) + body


def xbm(bits: np.ndarray, x10: bool = False, hotspot=None, name: str = "img") -> bytes:
    """An XBM file of (h, w) 0/1 pixels: X11 (bytes, bits least
    significant first) or X10 (16-bit words), with an optional hotspot."""
    h, w = bits.shape
    packed = np.packbits(bits.astype(np.uint8), axis=1, bitorder="little")
    out = f"#define {name}_width {w}\n#define {name}_height {h}\n"
    if hotspot:
        out += f"#define {name}_x_hot {hotspot[0]}\n#define {name}_y_hot {hotspot[1]}\n"
    if x10:
        if packed.shape[1] % 2:
            packed = np.concatenate([packed, np.zeros((h, 1), np.uint8)], 1)
        words = packed.reshape(-1, 2)
        values = [f"0x{b:02x}{a:02x}" for a, b in words]
        out += f"static short {name}_bits[] = {{\n"
    else:
        values = [f"0x{v:02x}" for v in packed.reshape(-1)]
        out += f"static char {name}_bits[] = {{\n"
    lines = [", ".join(values[i:i + 12]) for i in range(0, len(values), 12)]
    return (out + ",\n".join("   " + line for line in lines) + " };\n").encode("ascii")


def im(image_type: str, width: int, height: int, body: bytes, lut: bytes = None,
       lines=(), pad: bool = True) -> bytes:
    """An IM file: the "Image type", "Image size" and extra header lines,
    "Lut: 1" with a 768-byte lookup table, zeros up to byte 511 (with
    ``pad``), 0x1A, the table, the data (rows bottom-up, as PIL stores
    them)."""
    head = f"Image type: {image_type}\r\nImage size (x*y): {width}*{height}\r\n"
    head += "".join(f"{line}\r\n" for line in lines)
    if lut is not None:
        head += "Lut: 1\r\n"
    head = head.encode("latin-1")
    head += (b"\0" * (511 - len(head)) if pad else b"") + b"\x1a"
    return head + (lut or b"") + body
