"""QOI reading and writing without PIL, as PIL 12.1's ``QoiImagePlugin``
reads and writes it, for ``image_io``.

``decode_qoi`` gives what ``Image.open(f)`` holds: (samples, mode, None),
"RGB" where the header's channel count is 3 and "RGBA" for any other count,
as PIL opens it. The ops (INDEX, DIFF, LUMA, RUN, RGB, RGBA) are decoded by
the host library (``csrc/raster_host.cpp``) as PIL's Python decoder does:
the colour table starts zeroed, a RUN leaves it alone, the decode stops
once the pixels are filled (no end marker is looked for), and an op that
reads past the file raises ``CorruptImage`` (PIL's ``IndexError``).

``encode_qoi`` writes the bytes of ``Image.fromarray(x).save(f)`` under a
.qoi name: PIL's encoder (its table starts as {0: (0, 0, 0, 0)}, runs of
at most 62) and its header (colorspace 1, "linear", unless asked for sRGB).
"""

from __future__ import annotations

import struct

import numpy as np

from ape_tpu_torch.data.image_io import CorruptImage, bomb_check

MAGIC = b"qoif"
END = b"\0" * 7 + b"\1"


def claims(data: bytes):
    """``QoiImageFile``'s ``_open`` on ``data``: False where its _accept
    refuses, a reason where the header is short or the size zero (PIL's
    SyntaxError: ``Image.open`` asks the next plugin), else True."""
    if not data.startswith(MAGIC):
        return False
    if len(data) < 13:
        return "truncated QOI header"
    width, height = struct.unpack_from(">II", data, 4)
    return "a QOI image of size zero" if not width or not height else True


def decode_qoi(data: bytes):
    """QOI bytes -> ((H, W, 3 | 4) uint8, "RGB" or "RGBA", None)."""
    if claims(data) is not True:
        raise CorruptImage("not a QOI file")
    width, height = struct.unpack_from(">II", data, 4)
    mode = "RGB" if data[12] == 3 else "RGBA"
    bomb_check(width, height)
    bands = len(mode)
    if (len(data) - 14) * 62 < width * height:  # each op gives 62 pixels at most
        raise CorruptImage("image file is truncated")
    from ape_tpu_torch.ops._build import host_library

    out = np.empty((height, width, bands), np.uint8)
    if host_library().ape_qoi_decode(data, len(data), 14, bands, width * height,
                                     out.ctypes.data):
        raise CorruptImage("image file is truncated (a QOI op past the end of the file)")
    return out, mode, None


def encode_qoi(image: np.ndarray) -> bytes:
    """uint8 (H, W, 3) or (H, W, 4) -> the bytes of PIL's
    ``Image.fromarray(image).save(f, "QOI")``. A gray (H, W) image raises
    ``ValueError``, as PIL's "Unsupported QOI image mode"."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] not in (3, 4):
        raise ValueError(f"encode_qoi takes uint8 (H, W, 3) or (H, W, 4), not {image.dtype} "
                         f"{image.shape} (PIL: Unsupported QOI image mode)")
    from ape_tpu_torch.ops._build import host_library

    height, width, bands = image.shape
    pixels = np.ascontiguousarray(image)
    out = np.empty(5 * width * height + 1, np.uint8)
    n = host_library().ape_qoi_encode(pixels.ctypes.data, width * height, bands, out.ctypes.data)
    return MAGIC + struct.pack(">IIBB", width, height, bands, 1) + out[:n].tobytes() + END
