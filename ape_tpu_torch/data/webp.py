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


def encode_webp(image: np.ndarray) -> bytes:
    """uint8 (H, W) or (H, W, 3) -> a lossy WebP file (a 'VP8 ' key frame in
    a simple RIFF container) encoded as PIL's ``save`` asks libwebp to
    encode it (quality 80, method 4; ``csrc/webp_enc_host.cpp``). Gray is
    repeated over the three channels, as PIL converts "L" to "RGB" first."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim not in (2, 3) or (
            image.ndim == 3 and image.shape[2] != 3):
        raise ValueError(f"encode_webp takes uint8 (H, W) or (H, W, 3), not {image.dtype} "
                         f"{image.shape}")
    if image.ndim == 2:
        image = np.repeat(image[..., None], 3, axis=2)
    image = np.ascontiguousarray(image)
    height, width = image.shape[:2]
    lib = host_library()
    out = ctypes.POINTER(ctypes.c_uint8)()
    size = ctypes.c_size_t()
    if lib.ape_webp_encode(image.ctypes.data, width, height, ctypes.byref(out),
                           ctypes.byref(size)):
        raise ValueError(f"encode_webp: a {width}x{height} image (WebP holds 1 to 16383 a side)")
    try:
        return ctypes.string_at(out, size.value)
    finally:
        lib.ape_webp_enc_free(out)


def yuv420(image: np.ndarray):
    """The encoder's YUV 4:2:0 planes of an RGB uint8 (H, W, 3) image, as
    libwebp's ``WebPPictureImportRGB`` converts it: (Y (H, W), U, V
    ((H + 1) // 2, (W + 1) // 2))."""
    rgb = np.ascontiguousarray(image, np.uint8)
    height, width = rgb.shape[:2]
    y = np.empty((height, width), np.uint8)
    u = np.empty(((height + 1) // 2, (width + 1) // 2), np.uint8)
    v = np.empty_like(u)
    host_library().ape_webp_yuv420(rgb.ctypes.data, width, height, y.ctypes.data, u.ctypes.data,
                                   v.ctypes.data)
    return y, u, v
