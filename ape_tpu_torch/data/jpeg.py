"""JPEG decoding and encoding on the host CPU without PIL: a ctypes binding
of the port's C++ codec (``csrc/jpeg_host.cpp``, built at first use by
``ops._build.host_library`` with the host compiler; a failed build raises).

``decode_jpeg`` gives what ``np.asarray(PIL.Image.open(f).convert("RGB"))``
gives under PIL 12.1 on libjpeg-turbo 3.1, bit for bit, for every file PIL
decodes: baseline, extended and progressive Huffman JPEG, arithmetic-coded
sequential and progressive JPEG with DAC conditioning, lossless JPEG
(predictors 1-7, point transform), restart markers, 8- and 16-bit
quantization tables, any integral sampling factors, gray, YCbCr, Adobe RGB,
CMYK and YCCK, and libjpeg's block smoothing of progressive files whose
scans leave low coefficients unrefined. No EXIF orientation is applied
(JAX's reader applies none).

Damaged entropy-coded data decodes as libjpeg recovers it (see
``csrc/jpeg_host.cpp``: zero bits past a marker, restart resync, a bad code
read as 0). A stream PIL raises on (cut where libjpeg's read-ahead reaches
the end of the file, a broken marker segment) raises
``image_io.CorruptImage``, and so does a file PIL refuses too (12-bit or
2-component frames, hierarchical or lossless arithmetic-coded frames,
fractional sampling ratios, a height left to a DNL marker, a lossless frame
that needs a colour conversion, an arithmetic-coded scan past PIL's 64 KiB
read block): ``image_io.read_image`` turns both into None, as JAX's reader
turns PIL's exception into None.

``encode_jpeg`` writes the bytes of ``PIL.Image.fromarray(x).save(f)`` with
no options (quality 75, 4:2:0 for RGB, standard Huffman tables).

Each call releases the GIL while it runs (ctypes), so loader and evaluator
threads decode beside the step.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ape_tpu_torch.data.image_io import CorruptImage
from ape_tpu_torch.ops._build import host_library

_ERR_LEN = 512


def _raise(rc: int, err, what: str):
    """Status 1 (corrupt) and 3 (refused as PIL refuses it) raise
    ``CorruptImage``; 2 (a form PIL handles and the codec does not),
    ``ValueError``."""
    message = f"{what}: {err.value.decode(errors='replace')}"
    raise ValueError(message) if rc == 2 else CorruptImage(message)


# the colour settings of ``decode_jpeg``: libjpeg's guess, as PIL's JPEG
# plugin leaves it; and as libtiff's JPEG codec sets it for a TIFF strip,
# the components as stored (JCS_UNKNOWN) or YCbCr converted to RGB
# (JPEGCOLORMODE_RGB)
GUESS, RAW, YCC = -1, 0, 1


def decode_jpeg(data: bytes, colour: int = GUESS) -> np.ndarray:
    """JPEG bytes -> RGB uint8 (H, W, 3), as PIL's ``convert("RGB")`` of them;
    under ``colour=RAW`` the stored components (H, W, components)."""
    lib = host_library()
    out = ctypes.POINTER(ctypes.c_uint8)()
    width, height, channels = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR_LEN)
    rc = lib.ape_jpeg_decode(data, len(data), colour, ctypes.byref(out), ctypes.byref(width),
                             ctypes.byref(height), ctypes.byref(channels), err, _ERR_LEN)
    if rc != 0:
        _raise(rc, err, "JPEG decode")
    try:
        return np.ctypeslib.as_array(out, (height.value, width.value, channels.value)).copy()
    finally:
        lib.ape_jpeg_free(out)


def encode_jpeg(image: np.ndarray) -> bytes:
    """uint8 (H, W) or (H, W, 3) -> the JPEG bytes PIL's ``save`` writes for it."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim not in (2, 3) or (
            image.ndim == 3 and image.shape[2] != 3):
        raise ValueError(f"encode_jpeg takes uint8 (H, W) or (H, W, 3), not {image.dtype} "
                         f"{image.shape}")
    image = np.ascontiguousarray(image)
    lib = host_library()
    out = ctypes.POINTER(ctypes.c_uint8)()
    size = ctypes.c_size_t()
    err = ctypes.create_string_buffer(_ERR_LEN)
    channels = 1 if image.ndim == 2 else 3
    rc = lib.ape_jpeg_encode(image.ctypes.data, image.shape[1], image.shape[0], channels,
                             ctypes.byref(out), ctypes.byref(size), err, _ERR_LEN)
    if rc != 0:
        _raise(rc, err, "JPEG encode")
    try:
        return ctypes.string_at(out, size.value)
    finally:
        lib.ape_jpeg_free(out)
