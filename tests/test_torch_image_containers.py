"""The port's reader on BMP, GIF and WebP, held to PIL 12.1 (libwebp 1.6)
on the same bytes, on the CPU: a file PIL decodes gives PIL's
``convert("RGB")`` pixels bit for bit (and, for WebP, PIL's RGBA), a file PIL
refuses is dropped (None from ``read_image``, ``CorruptImage`` from
``read_rgb``), as JAX's reader drops it.

* BMP: 1-, 4- and 8-bit palettes (``clr_used``, OS/2 12-byte headers with
  3-byte entries, V4 and V5 headers, PIL's gray-ramp and black-and-white
  modes), RLE8 and RLE4 (encoded and absolute runs, deltas, a missing
  end-of-bitmap), 16-bit 555 and 565, 24-bit, 32-bit BGRX and every
  BITFIELDS mask set PIL accepts, top-down rows;
* GIF: global and local palettes, the 4-pass interlace, PIL's mode "L" for
  a gray ramp, short palettes, a transparency index, a first frame smaller
  than the screen, a screen grown to hold its frame, animations, full LZW
  tables cleared or kept;
* WebP: lossy at qualities 1-100 and methods 0-6, with alpha (lossy and
  lossless, every ALPH filter, raw and VP8L-coded), lossless at methods 0-6
  with ``exact`` both ways, animations whose first frame lies inside a
  larger canvas, and libwebp's own configurations (the simple loop filter,
  4 token partitions, 4 segments, sharpness 7, filter strength 0);
* label maps (``np.asarray(Image.open(f))``), ``write_image``'s BMP bytes,
  damaged and truncated files, the mapper against JAX's, and the smoke's
  digests (``chip_smoke.IMAGE_CONTAINERS_DIGESTS``).

Files PIL cannot write come from ``torch_image_writers`` (BMP, GIF) and
``torch_webp_encoder`` (libwebp through ``ctypes``, WebP containers).
"""

import hashlib
import io
import random

import numpy as np
import pytest
from PIL import Image

import chip_smoke
import torch_image_writers as W
import torch_webp_encoder as E
from ape_tpu.data import mapper as j_mapper
from ape_tpu.data.mapper import read_image as jax_read_image
from ape_tpu_torch.data.bmp import decode_bmp, encode_bmp
from ape_tpu_torch.data.datasets.coco import load_coco_json
from ape_tpu_torch.data.image_io import (CorruptImage, read_image, read_label_map, read_rgb,
                                         write_image)
from ape_tpu_torch.data.mapper import DatasetMapperDETR
from ape_tpu_torch.data.webp import decode_webp
from test_torch_data import _same_example, write_dataset
from test_torch_image_forms import SIZES, image, size_id

SIZES = SIZES + ((1, 40),)  # and one row
GRAY = np.repeat(np.arange(256)[:, None], 3, axis=1).astype(np.uint8)


def pil_rgb(data: bytes):
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception:
        return None


def same_as_pil(tmp_path, data: bytes, name: str):
    """``read_image`` of the file equals PIL's pixels (JAX's reader's), or
    both drop it; returns PIL's pixels or None."""
    path = tmp_path / name
    path.write_bytes(data)
    want = pil_rgb(data)
    got = read_image(str(path))
    assert (got is None) == (want is None), name
    if want is not None:
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        with pytest.raises(CorruptImage):
            read_rgb(str(path))
    return want


def palette(n: int, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, (n, 3)).astype(np.uint8)


def indices(img: np.ndarray, bits: int) -> np.ndarray:
    return (img[..., 1].astype(int) * (1 << bits) // 256).astype(np.uint8)


def packed32(img: np.ndarray, masks, alpha) -> np.ndarray:
    """32-bit pixels with R, G, B (and alpha) at ``masks``' fields."""
    out = np.zeros(img.shape[:2], np.uint32)
    for plane, m in zip((img[..., 0], img[..., 1], img[..., 2], alpha), masks):
        if m:
            out |= plane.astype(np.uint32) << ((m & -m).bit_length() - 1)
    return out


# --- BMP -------------------------------------------------------------------------

MASKS32 = [(0xFF0000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0x0),
           (0xFF000000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
           (0xFF, 0xFF00, 0xFF0000, 0xFF000000), (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
           (0xFF000000, 0xFF00, 0xFF, 0xFF0000)]


def _bmp_forms():
    def pal(bits, img, **kw):
        return W.bmp(indices(img, bits), bits, palette=palette(1 << bits), **kw)

    def rgb16(img, bits6):
        r, g, b = (img[..., c].astype(np.uint16) for c in range(3))
        if bits6:
            return ((r >> 3) << 11) | ((g >> 2) << 5) | (b >> 3)
        return ((r >> 3) << 10) | ((g >> 3) << 5) | (b >> 3)

    forms = {
        "p1": lambda img: pal(1, img),
        "p4": lambda img: pal(4, img),
        "p8": lambda img: pal(8, img),
        "p4_os2": lambda img: pal(4, img, header=12),
        "p8_os2_topdown": lambda img: pal(8, img, header=12, top_down=True),
        "p8_clr_used": lambda img: W.bmp(indices(img, 8) % 100, 8, palette=palette(100)),
        "p4_v4": lambda img: pal(4, img, header=108),
        "p8_v5_topdown": lambda img: pal(8, img, header=124, top_down=True),
        "gray_ramp": lambda img: W.bmp(img[..., 0], 8, palette=GRAY),
        "black_white": lambda img: W.bmp(indices(img, 1), 1, palette=GRAY[[0, 255]]),
        "black_white_8bit": lambda img: W.bmp(indices(img, 1), 8, palette=GRAY[[0, 255]]),
        "rle8_encoded": lambda img: pal(8, img, compression=1, runs="encoded"),
        "rle8_absolute": lambda img: pal(8, img, compression=1, runs="absolute"),
        "rle8_mixed": lambda img: W.bmp(indices(img, 8) // 16 * 16, 8, palette=palette(256),
                                        compression=1),
        "rle8_delta": lambda img: pal(8, img, compression=1,
                                      delta=(img.shape[0] // 2, img.shape[1] // 3, 2, 1)),
        "rle8_no_end": lambda img: pal(8, img, compression=1, end_of_bitmap=False),
        "rle4_mixed": lambda img: pal(4, img, compression=2),
        "rle4_absolute": lambda img: pal(4, img, compression=2, runs="absolute"),
        "rle4_delta": lambda img: pal(4, img, compression=2, delta=(0, 1, 1, 0)),
        "rgb555": lambda img: W.bmp(rgb16(img, False), 16),
        "rgb555_bitfields": lambda img: W.bmp(rgb16(img, False), 16, compression=3,
                                              masks=(0x7C00, 0x3E0, 0x1F)),
        "rgb565_v5": lambda img: W.bmp(rgb16(img, True), 16, compression=3, header=124,
                                       masks=(0xF800, 0x7E0, 0x1F)),
        "rgb24": lambda img: W.bmp(img, 24),
        "rgb24_bitfields_topdown": lambda img: W.bmp(img, 24, compression=3, top_down=True,
                                                     masks=(0xFF0000, 0xFF00, 0xFF)),
        "bgrx32": lambda img: W.bmp(packed32(img, MASKS32[0], img[..., 0]), 32),
    }
    for i, masks in enumerate(MASKS32):
        forms[f"bitfields32_{i}"] = (lambda m: lambda img: W.bmp(
            packed32(img, m, img[..., 0] // 2), 32, compression=3, masks=m,
            header=40 if not m[3] else 56))(masks)
    return forms


BMP_FORMS = _bmp_forms()


@pytest.mark.parametrize("size", SIZES, ids=size_id)
@pytest.mark.parametrize("form", sorted(BMP_FORMS))
def test_bmp_equals_pil(tmp_path, form, size):
    img = image(*size, seed=size[0] + size[1])
    same_as_pil(tmp_path, BMP_FORMS[form](img), f"{form}.bmp")


def test_bmp_refusals_as_pil(tmp_path):
    """What PIL raises on is dropped: a mask set it does not take, JPEG and
    PNG compression, an unknown header, a palette of more than 256 entries,
    run lengths for a black-and-white image; a 4-bit gray ramp read as
    PIL's mode "L" where its rows are too short."""
    img = image(9, 17)
    data = W.bmp(packed32(img, (0xFF00, 0xFF, 0xFF0000, 0), None), 32, compression=3,
                 masks=(0xFF00, 0xFF, 0xFF0000, 0))
    for name, body in {
            "masks": data,
            "jpeg": data[:30] + (4).to_bytes(4, "little") + data[34:],
            "png": data[:30] + (5).to_bytes(4, "little") + data[34:],
            "header": data[:14] + (20).to_bytes(4, "little") + data[18:],
            "palette": W.bmp(indices(img, 8), 8, palette=palette(300)),
            "rle_black_white": W.bmp(indices(img, 1), 8, palette=GRAY[[0, 255]], compression=1),
            "gray4": W.bmp(indices(img, 4), 4, palette=GRAY[:16]),
            "width_0": data[:18] + bytes(4) + data[22:]}.items():
        assert same_as_pil(tmp_path, body, f"{name}.bmp") is None, name


# --- GIF -------------------------------------------------------------------------

def _gif_forms():
    def idx(img, bits=4):
        return indices(img, bits)

    pal16, ramp16 = palette(16), GRAY[:16]
    return {
        "global": lambda img: W.gif([dict(indices=idx(img))], global_palette=pal16),
        "global_interlaced": lambda img: W.gif([dict(indices=idx(img), interlace=True)],
                                               global_palette=pal16),
        "local": lambda img: W.gif([dict(indices=idx(img), palette=pal16)]),
        "local_interlaced_87a": lambda img: W.gif([dict(indices=idx(img), palette=pal16,
                                                        interlace=True)], version=b"GIF87a"),
        "local_over_global": lambda img: W.gif([dict(indices=idx(img), palette=pal16[::-1])],
                                               global_palette=pal16),
        "gray_ramp": lambda img: W.gif([dict(indices=idx(img))], global_palette=ramp16),
        "local_ramp_over_global": lambda img: W.gif([dict(indices=idx(img), palette=ramp16)],
                                                    global_palette=pal16),
        "no_palette": lambda img: W.gif([dict(indices=idx(img, 8))]),
        "short_palette": lambda img: W.gif([dict(indices=idx(img, 8), min_size=8)],
                                           global_palette=pal16[:4]),
        "two_bit": lambda img: W.gif([dict(indices=idx(img, 2))], global_palette=pal16[:4]),
        "transparency_offset": lambda img: W.gif(
            [dict(indices=idx(img), offset=(3, 2), transparency=5)],
            screen=(img.shape[1] + 5, img.shape[0] + 4), global_palette=pal16),
        "offset_no_transparency": lambda img: W.gif(
            [dict(indices=idx(img), offset=(2, 1))], screen=(img.shape[1] + 2, img.shape[0] + 3),
            global_palette=pal16),
        "screen_grown": lambda img: W.gif([dict(indices=idx(img), offset=(1, 1))], screen=(1, 1),
                                          global_palette=pal16),
        "animated": lambda img: W.gif([dict(indices=idx(img)),
                                       dict(indices=idx(img)[::-1], palette=pal16[::-1])],
                                      global_palette=pal16),
        "full_table_cleared": lambda img: W.gif(
            [dict(indices=np.random.RandomState(1).randint(0, 256, img.shape[:2]))],
            global_palette=palette(256)),
        "full_table_kept": lambda img: W.gif(
            [dict(indices=np.random.RandomState(1).randint(0, 256, img.shape[:2]),
                  clear_when_full=False)], global_palette=palette(256)),
    }


GIF_FORMS = _gif_forms()


@pytest.mark.parametrize("size", SIZES, ids=size_id)
@pytest.mark.parametrize("form", sorted(GIF_FORMS))
def test_gif_equals_pil(tmp_path, form, size):
    img = image(*size, seed=size[0] * size[1])
    same_as_pil(tmp_path, GIF_FORMS[form](img), f"{form}.gif")


def test_gif_large_file_full_table(tmp_path):
    """A 200x300 frame of noise: more than 64 KiB of data (PIL feeds its
    decoder in blocks), the 4096-code table full, cleared or kept."""
    idx = np.random.RandomState(5).randint(0, 256, (200, 300))
    for keep in (False, True):
        data = W.gif([dict(indices=idx, clear_when_full=not keep)], global_palette=palette(256))
        assert len(data) > 65536
        assert same_as_pil(tmp_path, data, f"keep{keep}.gif") is not None


def _lzw_codes(codes, min_size: int) -> bytes:
    """GIF image data of the given codes, each at the width the decoder
    reads it at."""
    clear = 1 << min_size
    acc, nbits, out = 0, 0, bytearray()
    width, nxt, fresh = min_size + 1, clear + 2, True
    for code in codes:
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8
        if code == clear:
            width, nxt, fresh = min_size + 1, clear + 2, True
        elif code != clear + 1 and not fresh and nxt < 4096:
            if nxt == (1 << width) - 1 and width < 12:
                width += 1
            nxt += 1
        elif code != clear + 1:
            fresh = False
    if nbits:
        out.append(acc & 255)
    return bytes(out)


def test_gif_refusals_as_pil(tmp_path):
    """What PIL raises on is dropped: a code past the table, an end code
    before the frame is full, a first code past the literals, a code size
    past 12, no image, a truncated extension; a frame cut short."""
    head = b"GIF89a" + (4).to_bytes(2, "little") + (2).to_bytes(2, "little") + bytes([0x81, 0, 0])
    head += palette(4).tobytes()
    desc = b"," + bytes(4) + (4).to_bytes(2, "little") + (2).to_bytes(2, "little") + b"\x00"

    def frame(codes, min_size=2, descriptor=desc):
        return (head + descriptor + bytes([min_size]) + W.sub_blocks(_lzw_codes(codes, min_size))
                + b";")

    def extent(x, y, w, h):
        return b"," + b"".join(v.to_bytes(2, "little") for v in (x, y, w, h)) + b"\x00"

    cases = {"code_past_table": frame([4, 1, 2, 30]), "early_end": frame([4, 1, 2, 5]),
             "first_code_past_literals": frame([4, 6, 1, 1, 1, 1, 1, 1, 1, 5]),
             "code_size_13": head + desc + b"\x0d" + W.sub_blocks(b"\x00" * 8) + b";",
             "no_image": head + b";", "truncated_extension": head + b"!\xf9\x02\x01\x00\x00;"}
    good = frame([4, 1, 2, 3, 0, 1, 2, 3, 0, 5])
    assert same_as_pil(tmp_path, good, "good.gif") is not None
    # an empty frame fails in PIL's setimage, except at x 0, where 0 wide
    # means the whole image
    cases["empty_frame"] = frame([4, 1, 2, 3, 0, 1, 2, 3, 0, 5], descriptor=extent(2, 0, 0, 2))
    whole = frame([4, 1, 2, 3, 0, 1, 2, 3, 0, 5], descriptor=extent(0, 1, 0, 0))
    assert same_as_pil(tmp_path, whole, "whole.gif") is not None
    for name, data in cases.items():
        assert same_as_pil(tmp_path, data, f"{name}.gif") is None, name
    for cut in range(len(head) + len(desc) + 2, len(good) - 1):
        same_as_pil(tmp_path, good[:cut], f"cut{cut}.gif")


# --- WebP ------------------------------------------------------------------------

def webp(img: np.ndarray, **options) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", **options)
    return buf.getvalue()


def alpha_of(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Partial alpha: a ramp with noise, transparent on the left, opaque on top."""
    rng = np.random.RandomState(seed)
    a = np.clip(rng.randn(h, w) * 50 + np.linspace(0, 255, w)[None], 0, 255).astype(np.uint8)
    a[:, :w // 4] = 0
    a[:h // 3] = 255
    return a


def same_rgba_as_pil(tmp_path, data: bytes, name: str):
    """``same_as_pil``, and ``decode_webp``'s RGBA equals PIL's ``convert("RGBA")``."""
    want = same_as_pil(tmp_path, data, name)
    if want is not None:
        np.testing.assert_array_equal(decode_webp(data),
                                      np.asarray(Image.open(io.BytesIO(data)).convert("RGBA")))
    return want


@pytest.mark.parametrize("size", SIZES, ids=size_id)
@pytest.mark.parametrize("method", (0, 4, 6))
@pytest.mark.parametrize("quality", (1, 50, 75, 100))
def test_webp_lossy_equals_pil(tmp_path, quality, method, size):
    img = image(*size, seed=quality + method)
    assert same_rgba_as_pil(tmp_path, webp(img, quality=quality, method=method),
                            "a.webp") is not None


@pytest.mark.parametrize("size", SIZES, ids=size_id)
@pytest.mark.parametrize("quality", (20, 90))
def test_webp_lossy_flat_regions_equal_pil(tmp_path, quality, size):
    """Flat regions beside detail: macroblocks with few or no coefficients."""
    img = image(*size, seed=quality)
    img[: size[0] // 2] = (40, 200, 90)
    img[:, : size[1] // 3] = 128
    assert same_rgba_as_pil(tmp_path, webp(img, quality=quality), "a.webp") is not None


ALPHA_FORMS = {
    "lossy_alpha_q100": dict(quality=75, alpha_quality=100),
    "lossy_alpha_q30": dict(quality=50, alpha_quality=30, method=6),
    "lossless_alpha": dict(lossless=True),
}


@pytest.mark.parametrize("size", SIZES, ids=size_id)
@pytest.mark.parametrize("form", sorted(ALPHA_FORMS))
def test_webp_alpha_equals_pil(tmp_path, form, size):
    img = image(*size, seed=size[0])
    rgba = np.dstack([img, alpha_of(*size)])
    assert same_rgba_as_pil(tmp_path, webp(rgba, **ALPHA_FORMS[form]), "a.webp") is not None


@pytest.mark.parametrize("size", SIZES, ids=size_id)
@pytest.mark.parametrize("method", (0, 1))
@pytest.mark.parametrize("filt", (0, 1, 2, 3))
def test_webp_alph_filters_equal_pil(tmp_path, filt, method, size):
    """A VP8 image with an ALPH chunk of each filter (none, horizontal,
    vertical, gradient), raw or VP8L-coded, with the pre-processing flag on
    the raw ones; and without the VP8X alpha flag, which drops it."""
    h, w = size
    img, alpha = image(h, w, seed=filt), alpha_of(h, w, filt)
    vp8 = dict(E.chunks(webp(img, quality=70)))[b"VP8 "]
    body = E.chunk(b"ALPH", E.alph(alpha, filt, method, pre=1 - method)) + E.chunk(b"VP8 ", vp8)
    for flags in (0x10, 0x00):
        assert same_rgba_as_pil(tmp_path, E.riff(E.vp8x(w, h, flags) + body),
                                "a.webp") is not None


@pytest.mark.parametrize("size", SIZES, ids=size_id)
@pytest.mark.parametrize("exact", (False, True))
@pytest.mark.parametrize("method", range(7))
def test_webp_lossless_equals_pil(tmp_path, method, exact, size):
    h, w = size
    rgba = np.dstack([image(h, w, seed=method), alpha_of(h, w, method)])
    if method % 2:  # a few colours: the color-indexing transform and its bundling
        rgba = rgba // 85 * 85
    assert same_rgba_as_pil(tmp_path, webp(rgba, lossless=True, method=method, exact=exact),
                            "a.webp") is not None


LIBWEBP_CONFIGS = {
    "simple_filter": dict(filter_type=0, filter_strength=60),
    "four_partitions": dict(partitions=2, quality=90),
    "four_segments": dict(segments=4, sns_strength=100),
    "sharpness_7": dict(filter_sharpness=7, filter_strength=80),
    "filter_strength_0": dict(filter_strength=0),
    "raw_unfiltered_alpha": dict(alpha_compression=0, alpha_filtering=0),
    "best_alpha_filter": dict(alpha_filtering=2, alpha_quality=60),
}


@pytest.mark.parametrize("size", SIZES, ids=size_id)
@pytest.mark.parametrize("config", sorted(LIBWEBP_CONFIGS))
def test_webp_libwebp_configurations(tmp_path, config, size):
    h, w = size
    rgba = np.dstack([image(h, w, seed=len(config)), alpha_of(h, w)])
    assert same_rgba_as_pil(tmp_path, E.encode(rgba, **LIBWEBP_CONFIGS[config]),
                            "a.webp") is not None


@pytest.mark.parametrize("size", SIZES, ids=size_id)
@pytest.mark.parametrize("layout", ("full", "offset", "offset_lossless"))
def test_webp_animation_first_frame(tmp_path, layout, size):
    """The first frame decoded into a zeroed canvas at its offset, as
    WebPAnimDecoder composes a key frame; PIL's own animations too."""
    h, w = size
    rgba = np.dstack([image(h, w, seed=3), alpha_of(h, w, 3)])
    first = E.encode(rgba, lossless=int(layout.endswith("lossless")), quality=60)
    second = E.encode(rgba[::-1], quality=40)
    x, y = (0, 0) if layout == "full" else (4, 2)
    data = E.animated([(first, x, y), (second, 0, 0)], (w + x + 3, h + y + 1))
    assert same_rgba_as_pil(tmp_path, data, "a.webp") is not None
    buf = io.BytesIO()
    Image.fromarray(rgba).save(buf, "WEBP", save_all=True, append_images=[
        Image.fromarray(rgba[::-1])], lossless=layout.endswith("lossless"))
    assert same_rgba_as_pil(tmp_path, buf.getvalue(), "b.webp") is not None


def test_webp_refusals_as_pil(tmp_path):
    """What WebPDemux or the decoders refuse is dropped: a file shorter than
    its RIFF size, an unknown VP8X flag, a still image whose size is not the
    canvas's, a frame outside the canvas, ALPH after VP8, no frame, a
    RIFF WebP whose first chunk PIL does not take."""
    img = image(16, 16)
    lossy = webp(img)
    vp8 = dict(E.chunks(lossy))[b"VP8 "]
    alpha = E.chunk(b"ALPH", E.alph(alpha_of(16, 16)))
    cases = {"short": lossy[:-10], "flag": E.riff(E.vp8x(16, 16, 0x41) + E.chunk(b"VP8 ", vp8)),
             "canvas": E.riff(E.vp8x(17, 16, 0x10) + E.chunk(b"VP8 ", vp8)),
             "outside": E.animated([(lossy, 4, 0)], (18, 16)),
             "alpha_after": E.riff(E.vp8x(16, 16, 0x10) + E.chunk(b"VP8 ", vp8) + alpha),
             "no_frame": E.riff(E.vp8x(16, 16, 0x12) + E.chunk(b"ANIM", bytes(6))),
             "alph_first": E.riff(alpha + E.chunk(b"VP8 ", vp8))}
    for name, data in cases.items():
        assert same_as_pil(tmp_path, data, f"{name}.webp") is None, name


# (image size, seed, how the file was made, bytes changed): damaged token
# data that decodes to coefficients whose transform sums leave int16
# ("overflow_*"), that marks macroblocks skipped below ones with chroma
# coefficients ("skipped_*"), or whose first byte puts the boolean decoder's
# value past its range, where libwebp's 56-bit loads decide what follows
# ("token_data_out_of_range_*")
DAMAGED_TOKENS = {
    "overflow_ctypes_alpha": ((64, 80), 321, "alpha", {1825: 117, 5597: 248}),
    "overflow_q50": ((120, 96), 559, "q50", {649: 205, 777: 48, 814: 253, 2180: 133}),
    "skipped_a": ((64, 80), 411, "q90", {45: 16, 887: 122, 1005: 116, 1229: 217, 2032: 165,
                                         2659: 249}),
    "skipped_b": ((64, 80), 302, "q90", {88: 235, 643: 107, 695: 132, 1219: 125, 2082: 5}),
    "token_data_out_of_range_a": ((9, 17), 941, "q90", {76: 255, 99: 245, 152: 201, 219: 87}),
    "token_data_out_of_range_b": ((37, 53), 71, "q10", {78: 112, 80: 255, 181: 83}),
}


@pytest.mark.parametrize("case", sorted(DAMAGED_TOKENS))
def test_webp_damaged_tokens_as_libwebp(tmp_path, case):
    """Damaged VP8 tokens decode as libwebp's x86-64 build decodes them:
    its SSE2 transform in 16-bit lanes that wrap, for the blocks it takes it
    for (a coefficient past the third; a chroma plane with any AC), no
    chroma transform at all for a plane without coefficients, and the
    boolean decoder's 56-bit loads."""
    (h, w), seed, made, changes = DAMAGED_TOKENS[case]
    img = image(h, w, seed=seed)
    if made == "alpha":
        alpha = np.clip(np.random.RandomState(44).randn(h, w) * 60 + 128, 0, 255)
        data = E.encode(np.dstack([img, alpha.astype(np.uint8)]), quality=60, partitions=0,
                        segments=2, filter_type=0)
    else:
        data = webp(img, quality=int(made[1:]))
    data = bytearray(data)
    for at, value in changes.items():
        data[at] = value
    assert same_rgba_as_pil(tmp_path, bytes(data), "a.webp") is not None


def _container_cases():
    img = image(12, 18, seed=9)
    rgba = np.dstack([img, alpha_of(12, 18, 9)])
    lossy, lossless = E.encode(rgba, quality=60), E.encode(rgba, lossless=1)
    vp8 = E.chunk(b"VP8 ", dict(E.chunks(lossy))[b"VP8 "])
    alph = E.chunk(b"ALPH", dict(E.chunks(lossy))[b"ALPH"])
    frame1, frame2 = E.frame_chunks(lossy), E.frame_chunks(lossless)

    def anim(*frames, canvas=(20, 14), anim_size=6):
        body = E.vp8x(*canvas, 0x12) + E.chunk(b"ANIM", bytes(anim_size))
        return E.riff(body + b"".join(frames))

    def vp8x_of(size):
        return b"VP8X" + size.to_bytes(4, "little") + E.vp8x(18, 12, 0x10)[8:] + bytes(size - 10)

    return {
        "still": E.riff(E.vp8x(18, 12, 0x10) + alph + vp8),
        "vp8x_12_bytes": E.riff(vp8x_of(12) + alph + vp8),
        "trailing_after_riff": E.riff(E.vp8x(18, 12, 0x10) + alph + vp8) + b"\x00" * 5,
        "riff_short_by_4": (lambda d: d[:4] + (int.from_bytes(d[4:8], "little") - 4).to_bytes(
            4, "little") + d[8:])(E.riff(E.vp8x(18, 12, 0x10) + alph + vp8)),
        "unknown_chunks_first": E.riff(E.vp8x(18, 12, 0x10) + E.chunk(b"ZZZZ", b"abc") + alph
                                       + vp8),
        "chunk_past_riff": E.riff(E.vp8x(18, 12, 0x10) + alph + vp8[:8] + vp8[8:-6]),
        "anim": anim(E.anmf(frame1, 0, 0, 18, 12), E.anmf(frame2, 2, 2, 18, 12)),
        "anim_5_byte_anim_chunk": anim(E.anmf(frame1, 0, 0, 18, 12), anim_size=5),
        "anmf_trailing_byte": anim(E.anmf(frame1 + b"\x00", 0, 0, 18, 12),
                                   E.anmf(frame2, 2, 2, 18, 12)),
        "anmf_exif_inside": anim(E.anmf(frame1 + E.chunk(b"EXIF", b"x" * 8), 0, 0, 18, 12),
                                 E.anmf(frame2, 2, 2, 18, 12)),
        "anmf_image_outside": anim(E.anmf(frame1[:len(alph)], 0, 0, 18, 12) + vp8),
        "anmf_short": anim(E.chunk(b"ANMF", bytes(12))),
        "anmf_before_anim": E.riff(E.vp8x(20, 14, 0x12) + E.anmf(frame1, 0, 0, 18, 12)
                                   + E.chunk(b"ANIM", bytes(6))),
        "second_frame_outside": anim(E.anmf(frame1, 0, 0, 18, 12), E.anmf(frame2, 4, 4, 18, 12)),
        "frame_without_flag": E.riff(E.vp8x(20, 14, 0x10) + E.chunk(b"ANIM", bytes(6))
                                     + E.anmf(frame1, 0, 0, 18, 12)),
    }


CONTAINER_CASES = _container_cases()


@pytest.mark.parametrize("case", sorted(CONTAINER_CASES))
def test_webp_container_rules_as_pil(tmp_path, case):
    """WebPGetFeatures' and WebPDemux's rules, which PIL's WebPAnimDecoder
    applies before decoding: a VP8X chunk of exactly 10 bytes, chunks within
    the RIFF size, bytes past it ignored, an ANIM chunk read with its pad
    byte, an ANMF whose image lies outside it or which leaves bytes the
    parser then misreads, frames inside the canvas."""
    same_rgba_as_pil(tmp_path, CONTAINER_CASES[case], "a.webp")


@pytest.mark.parametrize("seed", range(24))
def test_webp_chunk_surgery_as_pil(tmp_path, seed):
    """Chunks inserted, dropped, duplicated, swapped, grown and cut, flags
    changed, bytes after the RIFF and a shorter RIFF size: PIL's pixels, or
    both refuse."""
    rng = random.Random(seed)
    h, w = rng.randrange(1, 30), rng.randrange(1, 30)
    rgba = np.dstack([image(h, w, seed=seed), alpha_of(h, w, seed)])
    lossy, lossless = E.encode(rgba, quality=60), E.encode(rgba, lossless=1)
    if seed % 3 == 0:
        chunks = [(b"VP8X", E.vp8x(w, h, 0x10)[8:])] + [
            c for c in E.chunks(lossy) if c[0] != b"VP8X"]
    elif seed % 3 == 1:
        chunks = [(b"VP8X", E.vp8x(w + 4, h + 2, 0x12)[8:]), (b"ANIM", bytes(6))]
        for data, (x, y) in ((lossy, (2, 0)), (lossless, (0, 2))):
            chunks.append((b"ANMF", E.anmf(E.frame_chunks(data), x, y, w, h)[8:]))
    else:
        chunks = E.chunks(rng.choice([lossy, lossless]))
    for _ in range(rng.randint(1, 3)):
        op, i = rng.randrange(6), rng.randrange(len(chunks))
        tag, payload = chunks[i]
        if op == 0:
            chunks.insert(rng.randrange(len(chunks) + 1),
                          (rng.choice([b"EXIF", b"ZZZZ", b"ALPH", b"ANIM"]), bytes(rng.randrange(12))))
        elif op == 1 and len(chunks) > 1:
            del chunks[i]
        elif op == 2:
            chunks.insert(i, (tag, payload))
        elif op == 3:
            j = rng.randrange(len(chunks))
            chunks[i], chunks[j] = chunks[j], chunks[i]
        elif op == 4:
            chunks[i] = (tag, payload + bytes(rng.randrange(1, 5)))
        else:
            chunks[i] = (tag, payload[:max(0, len(payload) - rng.randrange(1, 5))])
    data = E.riff(b"".join(E.chunk(t, p) for t, p in chunks))
    if rng.random() < 0.3:
        data += bytes(rng.randrange(1, 9))
    same_rgba_as_pil(tmp_path, data, "a.webp")


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("kind", ("lossy", "lossy_alpha", "lossless", "gif", "bmp_rle8"))
def test_damaged_files_as_pil(tmp_path, kind, seed):
    """Truncations and changed bytes: PIL's pixels, or both refuse."""
    img = image(23, 37, seed=seed)
    rgba = np.dstack([img, alpha_of(23, 37, seed)])
    opaque = np.dstack([img, np.full(img.shape[:2], 255, np.uint8)])
    base = {"lossy": lambda: E.encode(opaque, partitions=2),
            "lossy_alpha": lambda: webp(rgba, quality=70),
            "lossless": lambda: webp(rgba, lossless=True),
            "gif": lambda: GIF_FORMS["global_interlaced"](img),
            "bmp_rle8": lambda: BMP_FORMS["rle8_mixed"](img)}[kind]()
    rng = random.Random(seed)
    data = bytearray(base)
    if seed % 2:
        for _ in range(rng.randint(1, 3)):
            q = rng.randrange(12, len(data))
            data[q] ^= 1 << rng.randrange(8)
    else:
        data = data[:rng.randrange(8, len(data))]
    ext = {"gif": "gif", "bmp_rle8": "bmp"}.get(kind, "webp")
    same_as_pil(tmp_path, bytes(data), f"a.{ext}")


# --- label maps, the writer, the mapper, the smoke --------------------------------

LABEL_FORMS = ("p4", "p8", "rle8_mixed", "gray_ramp", "black_white", "rgb24", "bitfields32_5",
               "bgrx32")


@pytest.mark.parametrize("form", LABEL_FORMS + ("gif_global", "gif_gray_ramp",
                                                "gif_transparency_offset"))
def test_label_maps_equal_pil(tmp_path, form):
    """``read_label_map`` gives ``np.asarray(Image.open(f))``: palette
    indices for "P", samples for "L", bool for "1", RGB(A) for direct
    colour."""
    img = image(33, 70, seed=2)
    data = GIF_FORMS[form[4:]](img) if form.startswith("gif_") else BMP_FORMS[form](img)
    path = tmp_path / f"label.{'gif' if form.startswith('gif_') else 'bmp'}"
    path.write_bytes(data)
    want, got = np.asarray(Image.open(path)), read_label_map(str(path))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", (1, 3))
@pytest.mark.parametrize("size", SIZES, ids=size_id)
def test_write_image_bmp_is_pils_bytes(tmp_path, size, channels):
    img = image(*size, seed=channels)
    img = img[..., 0] if channels == 1 else img
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "BMP")
    write_image(str(tmp_path / "a.bmp"), img)
    assert (tmp_path / "a.bmp").read_bytes() == buf.getvalue() == encode_bmp(img)
    samples, mode, _ = decode_bmp(buf.getvalue())
    assert mode == ("L" if channels == 1 else "RGB")
    np.testing.assert_array_equal(samples, img)


def test_write_image_webp_and_gif_raise_naming_them(tmp_path):
    """``.webp`` and ``.gif`` write a file PIL opens at the image's size; an
    array the format's encoder cannot take raises ``ValueError`` naming
    that encoder, and nothing is written."""
    for ext in (".webp", ".gif"):
        write_image(str(tmp_path / f"a{ext}"), image(8, 8))
        assert Image.open(tmp_path / f"a{ext}").size == (8, 8)
        with pytest.raises(ValueError, match=f"encode_{ext[1:]}"):
            write_image(str(tmp_path / f"b{ext}"), np.zeros((8, 8, 4), np.float32))
        assert not (tmp_path / f"b{ext}").exists()


@pytest.mark.parametrize("is_train", [True, False])
def test_mapper_keeps_and_drops_what_jax_does(tmp_path, is_train):
    """JAX's ``DatasetMapperDETR`` and the port's over the same records:
    WebP, GIF and BMP files of the dataset's images, damaged JPEGs libjpeg
    recovers, and a file of each container PIL refuses. The same records
    are kept, with the same arrays."""
    js, root = write_dataset(tmp_path / "coco", n=6, seed=11)
    dicts = load_coco_json(js, root)
    makers = [lambda a: webp(a, quality=80), lambda a: webp(a, lossless=True),
              lambda a: GIF_FORMS["global_interlaced"](a), lambda a: BMP_FORMS["rle8_mixed"](a),
              lambda a: BMP_FORMS["bitfields32_4"](a), None]
    good = []
    for k, d in enumerate(dicts):
        img = np.asarray(Image.open(d["file_name"]).convert("RGB"))
        if makers[k] is None:  # a JPEG whose data runs into EOI
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, "JPEG")
            data = buf.getvalue()
            data = data[:data.index(b"\xff\xda") + 200] + data[-2:]
            ext = "jpg"
        else:
            data = makers[k](img)
            ext = {0: "webp", 1: "webp", 2: "gif"}.get(k, "bmp")
        path = f"{d['file_name'][:-4]}_{k}.{ext}"
        open(path, "wb").write(data)
        good.append(dict(d, file_name=path))
    refused = {"webp": webp(image(16, 16))[:-10], "gif": GIF_FORMS["global"](image(16, 16))[:40],
               "bmp": BMP_FORMS["rgb24"](image(16, 16))[:-100]}
    bad = []
    for i, (ext, data) in enumerate(sorted(refused.items())):
        path = tmp_path / f"refused_{i}.{ext}"
        path.write_bytes(data)
        bad.append(dict(good[i], file_name=str(path), image_id=1000 + i))
    records = [r for pair in zip(good, bad) for r in pair] + good[len(bad):]
    kw = dict(is_train=is_train, image_size=96, max_gt=6, mask_size=24, seed=3)
    port, jax_ = DatasetMapperDETR(**kw), j_mapper.DatasetMapperDETR(**kw)
    kept = []
    for r in records:
        got, want = port(r), jax_(r)
        assert (got is None) == (want is None), r["file_name"]
        if want is not None:
            _same_example(got, want)
            kept.append(r["image_id"])
    assert sorted(kept) == sorted(d["image_id"] for d in good)


def test_chip_smoke_image_containers_digests_are_pils(tmp_path):
    """The SHA-256s chip_smoke.py's image_containers phase holds the card
    machine's reader to are PIL's pixels of each file
    ``image_containers_files`` gives (the WebP fixtures of
    ``tests/make_image_container_fixtures.py`` among them), which the port
    reads alike here; PIL refuses the truncated GIF the mapper pass drops."""
    files = chip_smoke.image_containers_files()
    assert sorted(files) == sorted(chip_smoke.IMAGE_CONTAINERS_DIGESTS)
    for name, data in files.items():
        want = same_as_pil(tmp_path, data, name)
        assert want is not None and want.shape == chip_smoke.FORMS_SIZE + (3,), name
        assert hashlib.sha256(want.tobytes()).hexdigest() == \
            chip_smoke.IMAGE_CONTAINERS_DIGESTS[name], name
    gif = files["gif.gif"]
    (tmp_path / "cut.gif").write_bytes(gif[:len(gif) // 2])
    assert jax_read_image(str(tmp_path / "cut.gif")) is None
    assert read_image(str(tmp_path / "cut.gif")) is None
