"""Netpbm reading and writing without PIL, as PIL 12.1's
``PpmImagePlugin`` reads and writes them, for ``image_io``.

``decode_netpbm`` gives what ``Image.open(f)`` holds: (samples, mode) for
the magic numbers PIL opens:

* P1 and P4 (mode "1"), P2 and P5 (mode "L", or "I" past a maxval of
  255), P3 and P6 ("RGB"); P0CMYK, PyRGBA and PyCMYK (PIL's own raw
  extensions); Pf (mode "F", rows bottom-up, the scale's sign the byte
  order);
* the header's tokens as ``_read_token`` reads them (comments to the end of
  the line, ten characters at most), the data after the one whitespace byte
  that ends the last token;
* raw data at a maxval of 255 (65535: big-endian 16-bit gray as "I") read
  as stored; any other maxval scaled by ``PpmDecoder`` (a sample s becomes
  ``round(s / maxval * 255)``, or 65535 for "I"); plain (ASCII) data by
  ``PpmPlainDecoder``: comments cut out of the data, tokens split on
  whitespace, scaled the same way, P1's digits one a pixel.

A header or data PIL raises on (another magic number, P7 PAM and PF, which
PIL 12.1 opens no plugin for; a missing, long or non-numeric token, a
maxval outside 1-65535, a sample past maxval, data cut short) raises
``CorruptImage``.

``encode_netpbm`` writes the bytes of ``Image.fromarray(x).save(f)`` under
a .ppm, .pgm, .pbm or .pnm name: P5 for (H, W), P6 for (H, W, 3), whatever
the extension.
"""

from __future__ import annotations

import math

import numpy as np

from ape_tpu_torch.data.image_io import CorruptImage, bomb_check

WHITESPACE = b"\x20\x09\x0a\x0b\x0c\x0d"  # PpmImagePlugin.b_whitespace
MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB",
         b"P0CMYK": "CMYK", b"Pf": "F", b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_BANDS = {"1": 1, "L": 1, "I": 1, "F": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}


def accept(data: bytes) -> bool:
    """PpmImagePlugin._accept."""
    return len(data) >= 2 and data.startswith(b"P") and data[1] in b"0123456fy"


class _Header:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def read(self) -> bytes:
        c = self.data[self.pos:self.pos + 1]
        self.pos += len(c)
        return c

    def magic(self) -> bytes:
        magic = b""
        for _ in range(6):
            c = self.read()
            if not c or c in WHITESPACE:
                break
            magic += c
        return magic

    def token(self) -> bytes:
        token = b""
        while len(token) <= 10:
            c = self.read()
            if not c:
                break
            if c in WHITESPACE:
                if not token:
                    continue
                break
            if c == b"#":
                while self.read() not in b"\r\n":
                    pass
                continue
            token += c
        if not token:
            raise CorruptImage("Reached EOF while reading header")
        if len(token) > 10:
            raise CorruptImage(f"Token too long in file header: {token!r}")
        return token


def _int(token: bytes) -> int:
    try:
        return int(token)
    except ValueError as e:
        raise CorruptImage(f"a Netpbm header token {token!r}: {e}") from e


def decode_netpbm(data: bytes):
    """Netpbm bytes -> (samples, mode): (H, W) bool for "1", uint8 for "L",
    int32 for "I", float32 for "F"; (H, W, 3 or 4) uint8 for "RGB", "RGBA"
    and "CMYK"."""
    if data[:2] in (b"P7", b"PF"):
        raise CorruptImage(f"a Netpbm {data[:2].decode()} file, which PIL 12.1 does not open")
    h = _Header(data)
    magic = h.magic()
    if magic not in MODES:
        raise CorruptImage("not a PPM file")
    mode = MODES[magic]
    width, height = _int(h.token()), _int(h.token())
    if width <= 0 or height <= 0:
        raise CorruptImage("an empty Netpbm image")  # PIL's ImageFile refuses a 0 size
    bomb_check(width, height)
    plain = magic in (b"P1", b"P2", b"P3")
    maxval, scale = None, None
    if mode == "F":
        try:
            scale = float(h.token())
        except ValueError as e:
            raise CorruptImage(f"a Netpbm scale: {e}") from e
        if scale == 0.0 or not math.isfinite(scale):
            raise CorruptImage("scale must be finite and non-zero")
    elif mode != "1":
        maxval = _int(h.token())
        if not 0 < maxval < 65536:
            raise CorruptImage("maxval must be greater than 0 and less than 65536")
        if maxval > 255 and mode == "L":
            mode = "I"
    body = data[h.pos:]
    if plain:
        return _plain(body, mode, width, height, maxval), mode
    bands = _BANDS[mode]
    if mode == "1":  # raw "1;I": rows padded to a byte, 1 black
        stride = (width + 7) // 8
        rows = _raw_rows(body, stride, height)
        return ~np.unpackbits(rows, axis=1)[:, :width].astype(bool), mode
    if mode == "F":
        rows = _raw_rows(body, 4 * width, height)
        v = rows.view("<f4" if scale < 0 else ">f4").astype(np.float32)
        return np.ascontiguousarray(v[::-1]), mode
    if maxval == 65535 and mode == "I":
        rows = _raw_rows(body, 2 * width, height)
        return rows.view(">u2").astype(np.int32), mode
    if maxval == 255:
        rows = _raw_rows(body, width * bands, height)
        return _shape(rows, height, width, bands), mode
    # PpmDecoder: whole pixels of 1 or 2 bytes a sample, rescaled
    size = 1 if maxval < 256 else 2
    count = width * height * bands
    n = min(len(body) // (size * bands) * bands, count)
    if n < count:
        raise CorruptImage("not enough image data")
    v = np.frombuffer(body, np.uint8 if size == 1 else ">u2", n).astype(np.float64)
    out_max = 65535 if mode == "I" else 255
    v = np.minimum(out_max, np.round(v / maxval * out_max))
    return _shape(v.astype(np.int32 if mode == "I" else np.uint8), height, width, bands), mode


def _raw_rows(body: bytes, stride: int, height: int) -> np.ndarray:
    if len(body) < stride * height:
        raise CorruptImage("image file is truncated")
    return np.frombuffer(body, np.uint8, stride * height).reshape(height, stride)


def _shape(v: np.ndarray, height: int, width: int, bands: int) -> np.ndarray:
    v = v.reshape(height, width, bands)
    return np.ascontiguousarray(v[..., 0] if bands == 1 else v)


def _without_comments(block: bytes) -> bytes:
    """PpmPlainDecoder._ignore_comments over the whole data: each "#" to
    the end of its line (CR or LF) cut out, nothing put in its place."""
    while True:
        start = block.find(b"#")
        if start == -1:
            return block
        ends = [e for e in (block.find(b"\n", start), block.find(b"\r", start)) if e != -1]
        if not ends:
            return block[:start]
        block = block[:start] + block[min(ends) + 1:]


def _plain(body: bytes, mode: str, width: int, height: int, maxval) -> np.ndarray:
    block = _without_comments(body)
    if mode == "1":  # every token of the block is checked, then the pixels taken
        tokens = b"".join(block.split())
        if tokens.translate(None, b"01"):
            raise CorruptImage("Invalid token for this mode")
        tokens = tokens[:width * height]
        if len(tokens) < width * height:
            raise CorruptImage("not enough image data")
        return (np.frombuffer(tokens, np.uint8) == 48).reshape(height, width)
    bands = _BANDS[mode]
    count = width * height * bands
    out_max = 65535 if mode == "I" else 255
    tokens = block.split()[:count]  # the tokens past the image are not read
    if any(len(t) > 10 for t in tokens):
        raise CorruptImage("Token too long found in data")
    if len(tokens) < count:
        raise CorruptImage("not enough image data")
    try:
        values = np.array([int(t) for t in tokens], np.int64)
    except ValueError as e:
        raise CorruptImage(f"a Netpbm sample: {e}") from e
    if (values < 0).any():
        raise CorruptImage(f"Channel value is negative: {values[values < 0][0]}")
    if (values > maxval).any():
        raise CorruptImage(f"Channel value too large for this mode: {values[values > maxval][0]}")
    scaled = np.round(values / maxval * out_max)  # Python's round: half to even
    return _shape(scaled.astype(np.int32 if mode == "I" else np.uint8), height, width, bands)


def encode_netpbm(image: np.ndarray) -> bytes:
    """uint8 (H, W) or (H, W, 3) -> the bytes of PIL's
    ``Image.fromarray(image).save(f, "PPM")``: P5 or P6, maxval 255."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim not in (2, 3) or (
            image.ndim == 3 and image.shape[2] != 3):
        raise ValueError(f"encode_netpbm takes uint8 (H, W) or (H, W, 3), not {image.dtype} "
                         f"{image.shape}")
    height, width = image.shape[:2]
    head = b"P5" if image.ndim == 2 else b"P6"
    return head + b"\n%d %d\n255\n" % (width, height) + np.ascontiguousarray(image).tobytes()
