"""SGI image reading and writing without PIL, as PIL 12.1's
``SgiImagePlugin`` reads and writes it, for ``image_io``.

``decode_sgi`` gives what ``Image.open(f)`` holds: (samples, mode, None)
for the (bytes a sample, dimension, channels) triples PIL's ``MODES`` holds:
"L" (one channel, dimension 1 or 2), "RGB" (3) and "RGBA" (4), at 1 or 2
bytes a sample; a 16-bit sample keeps its high byte, as PIL's "L;16B" and
"RGB;16B" unpackers keep it. Rows are stored bottom-up. Verbatim files are
read plane after plane; RLE files through the host library
(``csrc/raster_host.cpp``, PIL's SgiRleDecode.c with its offset and length
tables and its quirks). Another triple raises ``CorruptImage`` (PIL's
"Unsupported SGI image mode" at open), as do another compression code
("cannot load this image"), data cut short and a run past a row or the
file.

``encode_sgi`` writes the bytes of ``Image.fromarray(x).save(name)``
under a .sgi, .rgb, .rgba or .bw name: verbatim, one byte a sample, the
dimension from the mode (gray of one row 1, else 2; RGB 3) whatever the
extension, and the file's base name (without its extension, ASCII) in the
header's name field, as PIL writes it.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from ape_tpu_torch.data.image_io import CorruptImage, bomb_check

MAGIC = 474
# (bytes a sample, dimension, channels) -> raw mode: SgiImagePlugin.MODES
MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L;16B", (2, 2, 1): "L;16B",
         (1, 3, 3): "RGB", (2, 3, 3): "RGB;16B", (1, 3, 4): "RGBA", (2, 3, 4): "RGBA;16B"}
HEADER = 512


def _header(data: bytes):
    """(compression, bytes a sample, width, height, mode) or a reason where
    ``SgiImageFile._open`` raises a SyntaxError; CorruptImage where it
    raises ValueError."""
    if len(data) < 2 or struct.unpack_from(">H", data)[0] != MAGIC:
        return "not an SGI image file"
    if len(data) < 12:
        return "truncated SGI header"
    compression, bpc = data[2], data[3]
    dimension, xsize, ysize, zsize = struct.unpack_from(">4H", data, 4)
    rawmode = MODES.get((bpc, dimension, zsize))
    if rawmode is None:
        raise CorruptImage(f"Unsupported SGI image mode ({bpc} bytes a sample, dimension "
                           f"{dimension}, {zsize} channels)")
    if not xsize or not ysize:
        return "an SGI image of size zero"
    return compression, bpc, xsize, ysize, rawmode.split(";")[0]


def claims(data: bytes):
    """False where SGI's _accept refuses ``data``, a reason where its _open
    raises a SyntaxError, else True."""
    if len(data) < 2 or struct.unpack_from(">H", data)[0] != MAGIC:
        return False
    got = _header(data)
    return got if isinstance(got, str) else True


def decode_sgi(data: bytes):
    """SGI bytes -> ((H, W) or (H, W, 3 | 4) uint8, "L", "RGB" or "RGBA",
    None)."""
    got = _header(data)
    if isinstance(got, str):
        raise CorruptImage(got)
    compression, bpc, width, height, mode = got
    bomb_check(width, height)
    bands = len(mode)
    if compression == 0:
        page = width * height * bpc
        if len(data) < HEADER + bands * page:
            raise CorruptImage("image file is truncated")
        planes = np.frombuffer(data, np.uint8, bands * page, HEADER).reshape(bands, height, -1)
        # rows bottom-up; of a 16-bit sample its high byte
        samples = planes[:, ::-1, ::bpc].transpose(1, 2, 0)
    elif compression == 1:
        from ape_tpu_torch.ops._build import host_library

        rows = np.zeros((height, width * bands * bpc), np.uint8)
        if host_library().ape_sgi_rle(data, len(data), bpc, width, height, bands,
                                      rows.ctypes.data):
            raise CorruptImage("buffer overrun when reading image file")
        samples = rows.reshape(height, width, bands, bpc)[..., 0]
    else:
        raise CorruptImage(f"cannot load this image (SGI compression {compression})")
    if bands == 1:
        samples = samples[..., 0]
    return np.ascontiguousarray(samples), mode, None


def encode_sgi(image: np.ndarray, file_name: str = "") -> bytes:
    """uint8 (H, W) or (H, W, 3) -> the bytes of PIL's
    ``Image.fromarray(image).save(file_name, "SGI")``: verbatim, one byte a
    sample, rows bottom-up, plane after plane."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim not in (2, 3) or (
            image.ndim == 3 and image.shape[2] != 3):
        raise ValueError(f"encode_sgi takes uint8 (H, W) or (H, W, 3), not {image.dtype} "
                         f"{image.shape}")
    height, width = image.shape[:2]
    planes = image[None] if image.ndim == 2 else image.transpose(2, 0, 1)
    dimension = (1 if height == 1 else 2) if image.ndim == 2 else 3
    name = os.path.splitext(os.path.basename(str(file_name)))[0].encode("ascii", "ignore")
    head = struct.pack(">hBBHHHHll4s79ss", MAGIC, 0, 1, dimension, width, height, len(planes), 0,
                       255, b"", name, b"")
    head += struct.pack(">l404s", 0, b"")
    return head + np.ascontiguousarray(planes[:, ::-1]).tobytes()
