"""The _open checks of the PIL 12.1 plugins the port does not read, as
``image_io.sniff`` needs them to follow ``Image.open``'s plugin order.

Each ``*_claims(data)`` answers as ``image_io.PIL_PLUGINS``' tests answer:
False where the plugin's _accept refuses ``data`` (or, for a plugin without
an _accept, where its _open raises an error ``Image.open`` passes over);
a reason where its _accept takes the file and its _open raises a
SyntaxError, so that ``Image.open`` asks the next plugin; True where the
plugin opens the file. Where _open raises an error ``Image.open`` lets
through (ValueError, OSError, ZeroDivisionError), they raise
``CorruptImage``: JAX's reader drops such a file.

* IMT, IPTC, PCD and SPIDER have no _accept: ``Image.open`` tries their
  _open on every file that reaches them, before TGA's;
* MPEG, WMF (and EMF) are opened as images PIL cannot load (``image_io``
  drops them, as the stubs BUFR, GRIB and HDF5);
* XPM and XVThumb come after TGA and WEBP in the order.
"""

from __future__ import annotations

import math
import re
import struct

from ape_tpu_torch.data.image_io import CorruptImage


def _line(data: bytes, pos: int):
    """``fp.readline()`` at ``pos``: (line, next position)."""
    end = data.find(b"\n", pos)
    end = len(data) if end < 0 else end + 1
    return data[pos:end], end


def imt_claims(data: bytes):
    """ImtImagePlugin's _open: key/value lines ("width", "height", "pixel
    n8") up to a 0x0C byte."""
    buffer, pos = data[:100], 100
    if b"\n" not in buffer:
        return False
    xsize = ysize = 0
    mode = ""
    field = re.compile(rb"([a-z]*) ([^ \r\n]*)")
    while True:
        if buffer:
            s, buffer = buffer[:1], buffer[1:]
        else:
            s, pos = data[pos:pos + 1], pos + 1
        if not s:
            break
        if s == b"\x0c":
            break
        if b"\n" not in buffer:
            buffer += data[pos:pos + 100]
            pos += 100
        lines = buffer.split(b"\n")
        s += lines.pop(0)
        buffer = b"\n".join(lines)
        if len(s) == 1 or len(s) > 100:
            break
        if s[0] == ord("*"):
            continue
        m = field.match(s)
        if not m:
            break
        k, v = m.group(1, 2)
        try:
            if k == b"width":
                xsize = int(v)
            elif k == b"height":
                ysize = int(v)
            elif k == b"pixel" and v == b"n8":
                mode = "L"
        except ValueError as e:
            raise CorruptImage(f"IMT header: {e}") from e
    return bool(mode) and xsize > 0 and ysize > 0


def _iptc_int(value: bytes) -> int:
    return int.from_bytes((b"\0\0\0\0" + value)[-4:], "big")


def iptc_claims(data: bytes):
    """IptcImagePlugin's _open: IPTC/NAA fields (0x1C, a record and a tag,
    a size) up to the image data's field (8, 10); the image's layers,
    size and compression from record 3."""
    info, pos = {}, 0
    while True:
        s = data[pos:pos + 5]
        pos += len(s)
        if not s.strip(b"\0"):
            break
        if len(s) < 4 or s[0] != 0x1C or s[1] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
            return False
        tag, size = (s[1], s[2]), s[3]
        if size > 132:
            raise CorruptImage("illegal field length in IPTC/NAA file")
        if size == 128:
            size = 0
        elif size > 128:
            raw = data[pos:pos + size - 128]
            pos += len(raw)
            size = _iptc_int(raw)
        elif len(s) < 5:
            return False
        else:
            size = struct.unpack_from(">H", s, 3)[0]
        if tag == (8, 10):
            break
        value = data[pos:pos + size] if size else None
        pos += len(value or b"")
        info[tag] = [info[tag], value] if tag in info else value
    try:
        layers, component = info[(3, 60)][0], info[(3, 60)][1]
        mode = "L" if layers == 1 and not component else (
            "RGB" if layers == 3 and component else "CMYK" if layers == 4 and component else "")
        if mode != "L" and (3, 65) in info:
            info[(3, 65)][0] - 1
        size = _iptc_int(info[(3, 20)]), _iptc_int(info[(3, 30)])
    except (KeyError, IndexError, TypeError):
        return False
    if (3, 120) not in info:
        raise CorruptImage("Unknown IPTC image compression")
    try:
        compression = _iptc_int(info[(3, 120)])
    except TypeError:
        return False
    if compression not in (1, 5):
        raise CorruptImage("Unknown IPTC image compression")
    return bool(mode) and size[0] > 0 and size[1] > 0


def pcd_claims(data: bytes):
    """PcdImagePlugin's _open: "PCD_" at byte 2048 and 1539 header bytes."""
    return data[2048:2052] == b"PCD_" and len(data) >= 2048 + 1539


def spider_claims(data: bytes):
    """SpiderImagePlugin's _open: 27 floats of either byte order forming a
    2-D SPIDER header."""
    if len(data) < 108:
        return False
    for order in ">", "<":
        t = struct.unpack(order + "27f", data[:108])
        hdrlen = _spider_header(t)
        if hdrlen:
            break
    else:
        return False
    h = (99,) + t
    if int(h[5]) != 1:
        return False
    try:
        istack, imgnumber = int(h[24]), int(h[27])
        if istack > 0 and imgnumber == 0:
            int(h[26])
    except (ValueError, OverflowError) as e:
        raise CorruptImage(f"SPIDER header: {e}") from e
    if istack == 0 and imgnumber > 0:  # PIL reads a stack offset a first open lacks
        raise CorruptImage("a SPIDER image inside a stack, opened alone")
    if imgnumber != 0 or istack < 0:
        return False
    return int(h[12]) > 0 and int(h[2]) > 0


def _spider_header(t) -> int:
    """SpiderImagePlugin.isSpiderHeader."""
    h = (99,) + t

    def is_int(f):
        try:
            return not math.isinf(f) and not math.isnan(f) and f - int(f) == 0
        except (ValueError, OverflowError):
            return False

    if not all(is_int(h[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
        return 0
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return 0
    labrec, labbyt, lenbyt = int(h[13]), int(h[22]), int(h[23])
    return labbyt if labbyt == labrec * lenbyt else 0


def mpeg_claims(data: bytes):
    """MpegImagePlugin's _open: the sequence header's 12-bit width and
    height."""
    if not data.startswith(b"\x00\x00\x01\xb3"):
        return False
    if len(data) < 7:
        return "truncated MPEG header"
    bits = int.from_bytes(data[4:7], "big")
    return "an MPEG image of size zero" if not bits >> 12 or not bits & 0xFFF else True


def wmf_claims(data: bytes):
    """WmfImagePlugin's _open: a placeable WMF header (its inch, bounding box
    and metafile header) or an EMF header (" EMF" at byte 40)."""
    if not data[:16].startswith((b"\xd7\xcd\xc6\x9a\x00\x00", b"\x01\x00\x00\x00")):
        return False
    s = data[:44]
    if s.startswith(b"\xd7\xcd\xc6\x9a\x00\x00"):
        if len(s) < 16:
            return "truncated WMF header"
        x0, y0, x1, y1, inch = struct.unpack_from("<hhhhH", s, 6)
        if inch == 0:
            raise CorruptImage("Invalid inch")
        size = (x1 - x0) * 72 // inch, (y1 - y0) * 72 // inch
        if s[22:26] != b"\x01\x00\t\x00":
            return "Unsupported WMF file format"
    elif s[40:44] == b" EMF":
        x0, y0, x1, y1, f0, f1, f2, f3 = struct.unpack_from("<8i", s, 8)
        if f2 == f0 or f3 == f1:
            raise CorruptImage("division by zero (an EMF frame of width or height zero)")
        size = x1 - x0, y1 - y0
    else:
        return "Unsupported file format"
    return True if size[0] > 0 and size[1] > 0 else "a WMF image of size zero"


def xpm_claims(data: bytes):
    """XpmImagePlugin's _open, as far as its header line (the colour table
    is not parsed)."""
    if not data.startswith(b"/* XPM */"):
        return False
    head = re.compile(rb'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')
    pos = 9
    while True:
        line, pos = _line(data, pos)
        if not line:
            return "broken XPM file"
        m = head.match(line)
        if m:
            break
    try:
        size = int(m[1]), int(m[2])
        int(m[3]), int(m[4])
    except ValueError as e:
        raise CorruptImage(f"XPM header: {e}") from e
    return True if size[0] > 0 and size[1] > 0 else "an XPM image of size zero"


def xvthumb_claims(data: bytes):
    """XVThumbImagePlugin's _open: "P7 332", comment lines, then the width
    and height."""
    if not data.startswith(b"P7 332"):
        return False
    _, pos = _line(data, 6)
    while True:
        s, pos = _line(data, pos)
        if not s:
            return "Unexpected EOF reading XV thumbnail file"
        if s[0] != 35:
            break
    try:
        w, h = s.strip().split(maxsplit=2)[:2]
        size = int(w), int(h)
    except ValueError as e:
        raise CorruptImage(f"XV thumbnail header: {e}") from e
    return True if size[0] > 0 and size[1] > 0 else "an XV thumbnail of size zero"
