"""WebP decoding on the host CPU without PIL: a ctypes binding of the port's
C++ decoder (``csrc/webp_host.cpp``, built at first use by
``ops._build.host_library``).

``decode_webp`` gives what ``np.asarray(PIL.Image.open(f).convert("RGBA"))``
gives under PIL 12.1 on libwebp 1.6 for every file PIL decodes: the first
frame (lossy VP8 with or without ALPH alpha, or lossless VP8L) decoded into a
canvas of zeros at its offset, as libwebp's WebPAnimDecoder composes it; RGB
from libwebp's fancy upsampling and 14-bit YUV conversion. ``image_io``
drops the alpha, as ``convert("RGB")`` does. A file PIL refuses (a truncated
or damaged container or bitstream) raises ``image_io.CorruptImage``.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ape_tpu_torch.data.image_io import CorruptImage
from ape_tpu_torch.ops._build import host_library

_ERR_LEN = 512


def decode_webp(data: bytes) -> np.ndarray:
    """WebP bytes -> RGBA uint8 (H, W, 4) of the first frame on its canvas."""
    lib = host_library()
    out = ctypes.POINTER(ctypes.c_uint8)()
    width, height = ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR_LEN)
    rc = lib.ape_webp_decode(data, len(data), ctypes.byref(out), ctypes.byref(width),
                             ctypes.byref(height), err, _ERR_LEN)
    if rc != 0:
        raise CorruptImage(f"WebP decode: {err.value.decode(errors='replace')}")
    try:
        return np.ctypeslib.as_array(out, (height.value, width.value, 4)).copy()
    finally:
        lib.ape_webp_free(out)
