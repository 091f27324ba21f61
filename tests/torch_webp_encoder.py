"""WebP files for the tests of the port's WebP reader: libwebp's encoder as
PIL ships it (``pillow.libs/libwebp-*.so``), called through ``ctypes`` with
a ``WebPConfig`` of the test's choosing, for the VP8 and VP8L features
PIL's ``save`` does not expose (the simple loop filter, token partitions,
segments, sharpness, a filter strength of 0, raw or unfiltered alpha), and
writers of the RIFF container (chunks, VP8X, ALPH with a chosen filter,
ANIM/ANMF frames) around the bitstreams it makes.

``encode(rgba, **options)`` sets the named ``WebPConfig`` fields on top of
``WebPConfigInit``'s defaults (quality 75) and returns the file's bytes.
"""

import ctypes
import glob
import os
import struct

import numpy as np
import PIL

ABI = 0x0210  # WEBP_ENCODER_ABI_VERSION: its major byte must match libwebp 1.x's
_LIB = None
_I, _F, _P = ctypes.c_int, ctypes.c_float, ctypes.c_void_p


class Config(ctypes.Structure):  # WebPConfig (encode.h), padded
    _fields_ = [("lossless", _I), ("quality", _F), ("method", _I), ("image_hint", _I),
                ("target_size", _I), ("target_PSNR", _F), ("segments", _I), ("sns_strength", _I),
                ("filter_strength", _I), ("filter_sharpness", _I), ("filter_type", _I),
                ("autofilter", _I), ("alpha_compression", _I), ("alpha_filtering", _I),
                ("alpha_quality", _I), ("pass_", _I), ("show_compressed", _I),
                ("preprocessing", _I), ("partitions", _I), ("partition_limit", _I),
                ("emulate_jpeg_size", _I), ("thread_level", _I), ("low_memory", _I),
                ("near_lossless", _I), ("exact", _I), ("use_delta_palette", _I),
                ("use_sharp_yuv", _I), ("qmin", _I), ("qmax", _I), ("pad", ctypes.c_uint32 * 16)]


class Picture(ctypes.Structure):  # WebPPicture, with room to spare
    _fields_ = [("use_argb", _I), ("colorspace", _I), ("width", _I), ("height", _I), ("y", _P),
                ("u", _P), ("v", _P), ("y_stride", _I), ("uv_stride", _I), ("a", _P),
                ("a_stride", _I), ("pad1", ctypes.c_uint32 * 2), ("argb", _P),
                ("argb_stride", _I), ("pad2", ctypes.c_uint32 * 3), ("writer", _P),
                ("custom_ptr", _P), ("extra_info_type", _I), ("extra_info", _P), ("stats", _P),
                ("error_code", _I), ("progress_hook", _P), ("user_data", _P),
                ("pad3", ctypes.c_uint32 * 3), ("pad4", _P), ("pad5", _P),
                ("pad6", ctypes.c_uint32 * 8), ("memory_", _P), ("memory_argb_", _P),
                ("pad7", _P * 2), ("spare", ctypes.c_uint8 * 256)]


class MemWriter(ctypes.Structure):  # WebPMemoryWriter, padded
    _fields_ = [("mem", _P), ("size", ctypes.c_size_t), ("max_size", ctypes.c_size_t),
                ("pad", ctypes.c_uint32 * 8)]


def lib():
    """libwebp as PIL loaded it."""
    global _LIB
    if _LIB is None:
        from PIL import _webp  # noqa: F401  (loads libwebp's own dependencies)

        libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
        _LIB = ctypes.CDLL(glob.glob(os.path.join(libs, "libwebp-*.so*"))[0])
        _LIB.WebPConfigInitInternal.argtypes = [_P, _I, _F, _I]
        _LIB.WebPValidateConfig.argtypes = [_P]
        _LIB.WebPPictureInitInternal.argtypes = [_P, _I]
        _LIB.WebPPictureImportRGBA.argtypes = [_P, _P, _I]
        _LIB.WebPMemoryWriterInit.argtypes = [_P]
        _LIB.WebPMemoryWriterClear.argtypes = [_P]
        _LIB.WebPEncode.argtypes = [_P, _P]
        _LIB.WebPPictureFree.argtypes = [_P]
    return _LIB


def encode(rgba, **options) -> bytes:
    """RGBA uint8 (H, W, 4) -> the WebP file libwebp writes under ``options``."""
    L = lib()
    rgba = np.ascontiguousarray(rgba, np.uint8)
    h, w = rgba.shape[:2]
    cfg = Config()
    assert L.WebPConfigInitInternal(ctypes.byref(cfg), 0, 75.0, ABI)
    for k, v in options.items():
        setattr(cfg, k, v)
    assert L.WebPValidateConfig(ctypes.byref(cfg)), options
    pic = Picture()
    assert L.WebPPictureInitInternal(ctypes.byref(pic), ABI)
    pic.use_argb = int(bool(options.get("lossless")))
    pic.width, pic.height = w, h
    assert L.WebPPictureImportRGBA(ctypes.byref(pic), rgba.ctypes.data, w * 4)
    writer = MemWriter()
    L.WebPMemoryWriterInit(ctypes.byref(writer))
    pic.writer = ctypes.cast(L.WebPMemoryWrite, _P)
    pic.custom_ptr = ctypes.cast(ctypes.pointer(writer), _P)
    ok = L.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic))
    L.WebPPictureFree(ctypes.byref(pic))
    assert ok, pic.error_code
    out = ctypes.string_at(writer.mem, writer.size)
    L.WebPMemoryWriterClear(ctypes.byref(writer))
    return out


def chunks(data: bytes) -> list:
    """[(fourcc, payload)] of a RIFF WebP file's top-level chunks."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        tag, size = data[pos:pos + 4], struct.unpack("<I", data[pos + 4:pos + 8])[0]
        out.append((tag, data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def chunk(tag: bytes, payload: bytes) -> bytes:
    """One RIFF chunk, padded to an even size."""
    return tag + struct.pack("<I", len(payload)) + payload + b"\0" * (len(payload) & 1)


def riff(body: bytes) -> bytes:
    """A RIFF WebP file around ``body`` (its chunks)."""
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def _le24(v: int) -> bytes:
    return struct.pack("<I", v)[:3]


def vp8x(w: int, h: int, flags: int) -> bytes:
    """A VP8X chunk: ``flags`` (0x10 alpha, 0x02 animation), canvas w x h."""
    return chunk(b"VP8X", bytes([flags, 0, 0, 0]) + _le24(w - 1) + _le24(h - 1))


def filtered_alpha(alpha: np.ndarray, filt: int) -> np.ndarray:
    """ALPH's filters as libwebp's encoder applies them (1 horizontal, 2
    vertical, 3 gradient; the first row and column predicted from their
    neighbour): the residuals mod 256."""
    a = alpha.astype(np.int32)
    out = a.copy()
    if filt == 1:
        out[:, 1:] = a[:, 1:] - a[:, :-1]
        out[1:, 0] = a[1:, 0] - a[:-1, 0]
    elif filt == 2:
        out[0, 1:] = a[0, 1:] - a[0, :-1]
        out[1:] = a[1:] - a[:-1]
    elif filt == 3:
        out[0, 1:] = a[0, 1:] - a[0, :-1]
        out[1:, 0] = a[1:, 0] - a[:-1, 0]
        out[1:, 1:] = a[1:, 1:] - np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    return (out % 256).astype(np.uint8)


def alph(alpha: np.ndarray, filt: int = 0, method: int = 0, pre: int = 0) -> bytes:
    """An ALPH payload: raw (method 0) or VP8L-coded (method 1: libwebp's
    lossless coding of the filtered values in the green channel, its 5-byte
    header dropped)."""
    f = filtered_alpha(alpha, filt)
    if method == 0:
        body = f.tobytes()
    else:
        g = np.dstack([np.zeros_like(f), f, np.zeros_like(f), np.full_like(f, 255)])
        body = dict(chunks(encode(g, lossless=1)))[b"VP8L"][5:]
    return bytes([method | (filt << 2) | (pre << 4)]) + body


def anmf(body: bytes, x: int, y: int, w: int, h: int, duration: int = 100,
         flags: int = 0) -> bytes:
    """An ANMF chunk: a frame's chunks ``body`` at (x, y) (even), w x h."""
    return chunk(b"ANMF", _le24(x // 2) + _le24(y // 2) + _le24(w - 1) + _le24(h - 1)
                 + _le24(duration) + bytes([flags]) + body)


def frame_chunks(data: bytes) -> bytes:
    """The ALPH, VP8 and VP8L chunks of a WebP file, ready for an ANMF."""
    return b"".join(chunk(t, p) for t, p in chunks(data) if t in (b"ALPH", b"VP8 ", b"VP8L"))


def animated(frames, canvas) -> bytes:
    """An animated WebP: ``frames`` of (file bytes, x, y), on ``canvas`` (w, h)."""
    body = vp8x(*canvas, 0x12) + chunk(b"ANIM", bytes(6))
    for data, x, y in frames:
        w, h = _size(data)
        body += anmf(frame_chunks(data), x, y, w, h)
    return riff(body)


def _size(data: bytes) -> tuple:
    """(w, h) of a simple or VP8X WebP file's image."""
    for tag, p in chunks(data):
        if tag == b"VP8 ":
            return (p[6] | p[7] << 8) & 0x3FFF, (p[8] | p[9] << 8) & 0x3FFF
        if tag == b"VP8L":
            bits = struct.unpack("<I", p[1:5])[0]
            return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
    raise ValueError("no image chunk")
