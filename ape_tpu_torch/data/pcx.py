"""PCX and DCX reading and PCX writing without PIL, as PIL 12.1's
``PcxImagePlugin`` and ``DcxImagePlugin`` read and write them, for
``image_io``.

``decode_pcx`` gives what ``Image.open(f)`` holds: (samples, mode, palette)
for the forms PIL opens:

* 1 bit in one plane (mode "1");
* 1 bit in 2 or 4 planes (mode "P", the header's 16-colour palette);
* version 5, 8 bits in one plane: mode "L", or "P" where the file ends
  with PIL's 769-byte trailer (12 and 256 RGB entries) whose palette is
  not the gray ramp;
* version 5, 8 bits in 3 planes (mode "RGB", each row's planes one after
  the other).

The run lengths are decoded by the host library (``csrc/raster_host.cpp``,
PIL's PcxDecode.c: a run past the end of a line is an overrun). Each line
is then unpacked as PIL unpacks it, its quirks included: PcxDecode moves
the planes to the unpadded width only where the line's bytes over its band
count exceed that width (so a 1-pixel-wide RGB line keeps its padding, and
PIL reads green from it), and the 1-bit planes to their unpadded stride.
A header PIL's _open refuses with a SyntaxError (a short header, an empty
bounding box) is not PCX to ``image_io.sniff``; another depth or plane
count, an 8-bit file shorter than the trailer, a run past a line and data
cut short raise ``CorruptImage``.

``decode_dcx`` reads the first page of a DCX file, as ``DcxImageFile``
opens it (a table of page offsets after the magic number, ended by 0).

``encode_pcx`` writes the bytes of ``Image.fromarray(x).save(f)`` under a
.pcx name: gray as 8-bit with the gray-ramp trailer, RGB as three planes,
PcxEncode's runs within each plane's line, lines padded to an even length.
"""

from __future__ import annotations

import struct

import numpy as np

from ape_tpu_torch.data.image_io import CorruptImage, bomb_check

DCX_MAGIC = 987654321


def accept(data: bytes) -> bool:
    """PcxImagePlugin._accept."""
    return len(data) >= 2 and data[0] == 10 and data[1] in (0, 2, 3, 5)


def header(data: bytes, start: int = 0):
    """``PcxImageFile._open`` at ``start``: a dict (mode, rawmode, size,
    planes, stride, offset, palette), or a reason where it raises a
    SyntaxError (``Image.open`` then asks the next plugin); CorruptImage
    where it raises another error."""
    s = data[start:start + 68]
    if not accept(s):
        return "not a PCX file"
    if len(s) < 12:
        return "truncated PCX header"
    x0, y0, x1, y1 = struct.unpack_from("<4H", s, 4)
    if x1 + 1 <= x0 or y1 + 1 <= y0:
        return "bad PCX image size"
    if len(s) < 68:
        return "truncated PCX header"
    version, bits, planes = s[1], s[3], s[65]
    provided_stride = struct.unpack_from("<H", s, 66)[0]
    palette = None
    if bits == 1 and planes == 1:
        mode = rawmode = "1"
    elif bits == 1 and planes in (2, 4):
        mode, rawmode = "P", f"P;{planes}L"
        palette = np.frombuffer(s[16:64], np.uint8).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        mode = rawmode = "L"
        if len(data) < 769:  # PIL seeks 769 bytes back from the end of the file
            raise CorruptImage("an 8-bit PCX file shorter than its palette trailer (PIL's seek "
                               "fails)")
        trailer = data[-769:]
        if trailer[0] == 12:
            table = np.frombuffer(trailer[1:], np.uint8).reshape(256, 3)
            if not (table == np.arange(256, dtype=np.uint8)[:, None]).all():
                mode = rawmode = "P"
                palette = table
    elif version == 5 and bits == 8 and planes == 3:
        mode, rawmode = "RGB", "RGB;L"
    else:
        raise CorruptImage(f"unknown PCX mode (version {version}, {bits} bits, {planes} planes)")
    width, height = x1 + 1 - x0, y1 + 1 - y0
    stride = (width * bits + 7) // 8
    if provided_stride != stride:
        stride += stride % 2
    return dict(mode=mode, rawmode=rawmode, size=(width, height), planes=planes, stride=stride,
                offset=start + 128, palette=palette)


def claims(data: bytes):
    """False where PCX's _accept refuses ``data``, else ``header``'s answer
    (True where it opens)."""
    if not accept(data[:16]):
        return False
    got = header(data)
    return got if isinstance(got, str) else True


def _page(data: bytes, head: dict):
    width, height = head["size"]
    bomb_check(width, height)
    rawmode, line = head["rawmode"], head["planes"] * head["stride"]
    from ape_tpu_torch.ops._build import host_library

    rows = np.zeros((height, line), np.uint8)
    rc = host_library().ape_pcx_rle(data, len(data), head["offset"], line, height,
                                    rows.ctypes.data)
    if rc:
        raise CorruptImage("image file is truncated" if rc == 1 else
                           "buffer overrun when reading image file")
    if rawmode in ("P;2L", "P;4L"):  # PcxDecode's move of each plane to the unpadded stride
        size, bands = (width + 7) // 8, head["planes"]
        step = line // bands
    else:
        size, bands = width, line // width
        step = line // bands if bands else 0
    if step > size:
        for i in range(1, bands):
            rows[:, i * size:(i + 1) * size] = rows[:, i * step:i * step + size].copy()
    if rawmode == "1":
        samples = np.unpackbits(rows, axis=1)[:, :width].astype(bool)
    elif rawmode in ("L", "P"):
        samples = rows[:, :width]
    elif rawmode == "RGB;L":
        samples = np.stack([rows[:, k * width:(k + 1) * width] for k in range(3)], -1)
    else:  # P;2L, P;4L: the bit planes at the unpadded stride
        s = (width + 7) // 8
        samples = np.zeros((height, width), np.uint8)
        for k in range(int(rawmode[2])):
            samples |= (np.unpackbits(rows[:, k * s:(k + 1) * s], axis=1)[:, :width] << k)
    return np.ascontiguousarray(samples), head["mode"], head["palette"]


def decode_pcx(data: bytes):
    """PCX bytes -> (samples, mode, palette): (H, W) bool for "1", uint8
    indices for "P" (palette (16 | 256, 3)), gray for "L"; (H, W, 3) for
    "RGB"."""
    head = header(data)
    if isinstance(head, str):
        raise CorruptImage(head)
    return _page(data, head)


def dcx_offsets(data: bytes):
    """The page offsets of a DCX file as ``DcxImageFile`` reads them, or a
    reason where its _open raises a SyntaxError."""
    offsets = []
    for i in range(1024):
        if len(data) < 8 + 4 * i:
            return "truncated DCX page table"
        offset = struct.unpack_from("<I", data, 4 + 4 * i)[0]
        if not offset:
            break
        offsets.append(offset)
    return offsets or "a DCX file without pages"


def dcx_claims(data: bytes):
    """``DcxImageFile``'s _open on ``data``: False where its _accept
    refuses, a reason where it raises a SyntaxError, else True."""
    if len(data) < 4 or struct.unpack_from("<I", data)[0] != DCX_MAGIC:
        return False
    offsets = dcx_offsets(data)
    if isinstance(offsets, str):
        return offsets
    got = header(data, offsets[0])
    return got if isinstance(got, str) else True


def decode_dcx(data: bytes):
    """DCX bytes -> the first page's (samples, mode, palette)."""
    if dcx_claims(data) is not True:
        raise CorruptImage("not a DCX file")
    return _page(data, header(data, dcx_offsets(data)[0]))


def encode_pcx(image: np.ndarray) -> bytes:
    """uint8 (H, W) or (H, W, 3) -> the bytes of PIL's
    ``Image.fromarray(image).save(f, "PCX")``: version 5, 8 bits, one plane
    and the gray-ramp trailer for gray, three planes for RGB."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim not in (2, 3) or (
            image.ndim == 3 and image.shape[2] != 3):
        raise ValueError(f"encode_pcx takes uint8 (H, W) or (H, W, 3), not {image.dtype} "
                         f"{image.shape}")
    from ape_tpu_torch.ops._build import host_library

    height, width = image.shape[:2]
    planes = 1 if image.ndim == 2 else 3
    stride = width + width % 2
    head = struct.pack("<BBBBHHHHHH", 10, 5, 1, 8, 0, 0, width - 1, height - 1, 100, 100)
    head += b"\0" * 24 + b"\xff" * 24 + b"\0" + bytes([planes])
    head += struct.pack("<HHHH", stride, 1, width, height) + b"\0" * 54
    lines = np.ascontiguousarray(image if planes == 1 else image.transpose(0, 2, 1))
    out = np.empty(height * planes * (2 * width + 1), np.uint8)
    n = host_library().ape_pcx_encode(lines.ctypes.data, height, width, planes, width % 2,
                                      out.ctypes.data)
    data = head + out[:n].tobytes()
    if planes == 1:
        data += b"\x0c" + np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes()
    return data
