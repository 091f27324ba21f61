"""PIL's own IM format (IFUNC Image Memory) read and written without PIL,
as PIL 12.1's ``ImImagePlugin`` reads and writes it, for ``image_io``.

``header`` is ``ImImageFile._open``: text lines of "key: value" (each at
most 100 bytes, "\\r" skipped) up to a 0 or 0x1A byte; the image type,
size and frame count; the data after the next 0x1A byte and, with a "Lut"
key, the 768-byte lookup table (the red, green and blue planes). IM has no
magic number and no _accept: ``Image.open`` tries this _open on every file
that reaches IM's place in its plugin order, and ``image_io.sniff`` does the
same. A header it raises a SyntaxError on (a line without a key, a long
line, no known key, no 0x1A byte) is no IM file; one it raises another
error on (a size that is not a number) makes ``Image.open`` raise, and the
port raises ``CorruptImage``.

``decode_im`` gives what ``Image.open(f)`` holds: (samples, mode, palette)
for the image types PIL's ``OPEN`` lists and loads, rows bottom-up as PIL
stores them: "1"; "L" (mode "P" with a lookup table that is not gray, its
palette); "P" from 2 and 4 bits (black without a colour table, as PIL's
default palette); "RGB" interleaved, in line-interleaved planes and in
three whole planes (green, red, blue: PIL's "RGB;T"); "RGBA", "RGBX" (mode
"RGB"), "CMYK" and "YCbCr" in line-interleaved planes; "LA" (or "PA" with
a colour table); "I;16", "I;16L" and "I;16B"; "I" from 32-bit integers;
"F" from 8-, 16- and 32-bit integers and 32-bit floats. PIL's raw modes
without an unpacker ("RLB", a "PA" image without a colour table) and data
cut short raise ``CorruptImage``; the bit decoder's floats of 2-31 bits
("L*12 image") raise ``ValueError``: PIL reads them and the port does not
yet.

``encode_im`` writes the bytes of ``Image.fromarray(x).save(name)`` under
a .im name: the header with the file's base name, zeros to byte 511, 0x1A,
then gray rows or RGB rows in line-interleaved planes, bottom-up.
"""

from __future__ import annotations

import os
import re

import numpy as np

from ape_tpu_torch.data.image_io import CorruptImage, bomb_check

COMMENT, DATE, EQUIPMENT = "Comment", "Date", "Digitalization equipment"
FRAMES, LUT, NAME = "File size (no of images)", "Lut", "Name"
SCALE, SIZE, MODE = "Scale (x,y)", "Image size (x*y)", "Image type"
TAGS = {COMMENT, DATE, EQUIPMENT, FRAMES, LUT, NAME, SCALE, SIZE, MODE}
# image type -> (mode, raw mode): ImImagePlugin.OPEN
OPEN = {"0 1 image": ("1", "1"), "L 1 image": ("1", "1"), "Greyscale image": ("L", "L"),
        "Grayscale image": ("L", "L"), "RGB image": ("RGB", "RGB;L"), "RLB image": ("RGB", "RLB"),
        "RYB image": ("RGB", "RLB"), "B1 image": ("1", "1"), "B2 image": ("P", "P;2"),
        "B4 image": ("P", "P;4"), "X 24 image": ("RGB", "RGB"), "L 32 S image": ("I", "I;32"),
        "L 32 F image": ("F", "F;32"), "RGB3 image": ("RGB", "RGB;T"),
        "RYB3 image": ("RGB", "RYB;T"), "LA image": ("LA", "LA;L"), "PA image": ("LA", "PA;L"),
        "RGBA image": ("RGBA", "RGBA;L"), "RGBX image": ("RGB", "RGBX;L"),
        "CMYK image": ("CMYK", "CMYK;L"), "YCC image": ("YCbCr", "YCbCr;L")}
for _i in ("8", "8S", "16", "16S", "32", "32F"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = ("F", f"F;{_i}")
for _i in ("16", "16L", "16B"):
    OPEN[f"L {_i} image"] = OPEN[f"L*{_i} image"] = (f"I;{_i}", f"I;{_i}")
OPEN["L 32S image"] = OPEN["L*32S image"] = ("I", "I;32S")
for _j in range(2, 33):
    OPEN[f"L*{_j} image"] = ("F", f"F;{_j}")
SPLIT = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
# raw mode -> (mode it unpacks to, numpy dtype of a sample, samples a pixel,
# whether a row holds them in planes, one after the other); "1", "P;2" and
# "P;4" are bits
_RAW = {"1": ("1", None, 1, False), "P;2": ("P", None, 2, False), "P;4": ("P", None, 4, False),
        "L": ("L", "u1", 1, False), "P": ("P", "u1", 1, False), "RGB": ("RGB", "u1", 3, False),
        "RGB;L": ("RGB", "u1", 3, True), "RGB;T": ("RGB", "u1", 3, True),
        "RYB;T": ("RGB", "u1", 3, True), "LA;L": ("LA", "u1", 2, True),
        "PA;L": ("PA", "u1", 2, True), "RGBA;L": ("RGBA", "u1", 4, True),
        "RGBX;L": ("RGB", "u1", 4, True), "CMYK;L": ("CMYK", "u1", 4, True),
        "YCbCr;L": ("YCbCr", "u1", 3, True), "I;16": ("I;16", "<u2", 1, False),
        "I;16L": ("I;16L", "<u2", 1, False), "I;16B": ("I;16B", ">u2", 1, False),
        "I;32": ("I", "<i4", 1, False), "I;32S": ("I", "<i4", 1, False),
        "F;8": ("F", "u1", 1, False), "F;8S": ("F", "i1", 1, False),
        "F;16": ("F", "<u2", 1, False), "F;16S": ("F", "<i2", 1, False),
        "F;32": ("F", "<u4", 1, False), "F;32F": ("F", "<f4", 1, False)}

def _number(s: str):
    """ImImagePlugin.number."""
    try:
        return int(s)
    except ValueError:
        return float(s)


def header(data: bytes):
    """``ImImageFile._open`` on ``data``: None where it raises a SyntaxError
    (or an error PIL turns into one), else (mode, raw mode, size, offset,
    lut); ``CorruptImage`` where it raises another error."""
    if b"\n" not in data[:100]:
        return None
    info = {MODE: "L", SIZE: (512, 512), FRAMES: 1}
    rawmode, pos, n, s = "L", 0, 0, b""
    while True:
        s = data[pos:pos + 1]
        pos += len(s)
        if s == b"\r":
            continue
        if not s or s in (b"\0", b"\x1a"):
            break
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end + 1
        s, pos = s + data[pos:end], end
        if len(s) > 100:
            return None
        s = s[:-2] if s.endswith(b"\r\n") else s[:-1] if s.endswith(b"\n") else s
        m = SPLIT.match(s)
        if not m:
            return None
        k, v = (g.decode("latin-1", "replace") for g in m.group(1, 2))
        if k in (FRAMES, SCALE, SIZE):
            try:
                v = tuple(map(_number, v.replace("*", ",").split(",")))
            except ValueError as e:
                raise CorruptImage(f"IM header: {e}") from e
            v = v[0] if len(v) == 1 else v
        elif k == MODE and v in OPEN:
            v, rawmode = OPEN[v]
        if k != COMMENT:
            info[k] = v
        n += k in TAGS
    if not n:
        return None
    size, mode = info[SIZE], info[MODE]
    while s and not s.startswith(b"\x1a"):
        s = data[pos:pos + 1]
        pos += len(s)
    if not s:
        return None
    lut = None
    if LUT in info:
        lut = data[pos:pos + 768]
        pos += len(lut)
        greyscale = linear = True
        try:
            for i in range(256):
                if lut[i] == lut[i + 256] == lut[i + 512]:
                    linear = linear and lut[i] == i
                else:
                    greyscale = False
        except IndexError:
            return None
        if mode in ("L", "LA", "P", "PA"):
            if greyscale:
                lut = None  # PIL keeps it as im.lut, which no conversion reads
            elif mode in ("L", "P"):
                mode = rawmode = "P"
            else:
                mode, rawmode = "PA", "PA;L"
        else:
            lut = None
    try:
        if not mode or size[0] <= 0 or size[1] <= 0:
            return None
    except TypeError:  # a size of one number: Image.open asks the next plugin
        return None
    return mode, rawmode, size, pos, lut


def claims(data: bytes) -> bool:
    """Whether ``Image.open`` opens ``data`` as IM (``header``)."""
    return header(data) is not None


def _unpack(rows: np.ndarray, rawmode: str, width: int) -> np.ndarray:
    """(H, row bytes) of one raw mode -> its samples."""
    height = rows.shape[0]
    _, dtype, n, planar = _RAW[rawmode]
    if dtype is None:  # "1" (a set bit 1), "P;2", "P;4": bits, the first the highest
        b = np.unpackbits(rows, axis=1)[:, :width * n].reshape(height, width, n)
        v = (b * (1 << np.arange(n - 1, -1, -1))).sum(-1).astype(np.uint8)
        return v.astype(bool) if rawmode == "1" else v
    v = rows.view(dtype)
    if n == 1:
        return v.reshape(height, width)
    v = v.reshape(height, n, width).transpose(0, 2, 1) if planar else v.reshape(height, width, n)
    return v[..., :3] if rawmode == "RGBX;L" else v


def decode_im(data: bytes):
    """IM bytes -> (samples, mode, palette) as ``np.asarray(Image.open(f))``
    gives them (module docstring)."""
    got = header(data)
    if got is None:
        raise CorruptImage("not an IM file")
    mode, rawmode, size, offset, lut = got
    if len(size) != 2 or not all(isinstance(v, int) for v in size):
        raise CorruptImage(f"an IM image of size {size}")
    width, height = size[:2]
    bomb_check(width, height)
    if rawmode.startswith("F;") and rawmode[2:].isdigit() and int(rawmode[2:]) not in (8, 16, 32):
        raise ValueError(f"an IM image of {rawmode[2:]}-bit float samples, which PIL reads "
                         "through its bit decoder and the port does not yet")
    if rawmode not in _RAW or _RAW[rawmode][0] != mode:
        raise CorruptImage(f"unknown raw mode {rawmode} for an IM image of mode {mode}")
    if rawmode in ("RGB;T", "RYB;T"):  # three whole planes: green, red, blue
        page = width * height
        if len(data) < offset + 3 * page:
            raise CorruptImage("image file is truncated")
        g, r, b = np.frombuffer(data, np.uint8, 3 * page, offset).reshape(3, height, width)
        samples = np.stack([r, g, b], -1)[::-1]
    else:
        _, dtype, n, _ = _RAW[rawmode]
        stride = (width * n + 7) // 8 if dtype is None else width * n * np.dtype(dtype).itemsize
        if len(data) < offset + stride * height:
            raise CorruptImage("image file is truncated")
        rows = np.frombuffer(data, np.uint8, stride * height, offset).reshape(height, stride)
        samples = _unpack(rows[::-1].copy(), rawmode, width)
        if mode == "F":
            samples = samples.astype(np.float32)
    palette = None
    if mode in ("P", "PA"):
        palette = (np.frombuffer(lut, np.uint8).reshape(3, 256).T if lut is not None
                   else np.zeros((0, 3), np.uint8))
    return np.ascontiguousarray(samples), mode, palette


def encode_im(image: np.ndarray, file_name: str = "") -> bytes:
    """uint8 (H, W) or (H, W, 3) -> the bytes of PIL's
    ``Image.fromarray(image).save(file_name, "IM")``."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim not in (2, 3) or (
            image.ndim == 3 and image.shape[2] != 3):
        raise ValueError(f"encode_im takes uint8 (H, W) or (H, W, 3), not {image.dtype} "
                         f"{image.shape}")
    height, width = image.shape[:2]
    head = f"Image type: {'Greyscale' if image.ndim == 2 else 'RGB'} image\r\n".encode("ascii")
    if file_name:
        name, ext = os.path.splitext(os.path.basename(str(file_name)))
        head += f"Name: {name[:92 - len(ext)]}{ext}\r\n".encode("ascii")
    head += f"Image size (x*y): {width}*{height}\r\nFile size (no of images): 1\r\n".encode(
        "ascii")
    head += b"\0" * (511 - len(head)) + b"\x1a"
    rows = image if image.ndim == 2 else image.transpose(0, 2, 1)  # a line's planes
    return head + np.ascontiguousarray(rows[::-1]).tobytes()
