"""The port's TIFF reader held to JAX's (PIL 12.1 on libtiff 4.7) on the
same bytes, on the CPU: every form decodes to JAX's ``read_image`` pixels
bit for bit, ``read_label_map`` equals ``np.asarray(Image.open(f))`` in
dtype and values, a file PIL refuses is dropped (None and one warning) as
JAX's mapper drops it, and a form PIL reads and the port does not raises
``ValueError`` naming it.

* PIL writes uncompressed, LZW, PackBits, Deflate, LZMA, JPEG and CCITT
  (modified Huffman, Group 3 1-D, Group 4) files of every mode it saves,
  with predictor 2 where libtiff takes it;
* ``torch_image_writers.tiff`` writes what PIL cannot: tiles (edge tiles
  cropped), BigTIFF, MM byte order, FillOrder 2, PlanarConfiguration 2,
  Group 3 2-D and byte-aligned EOLs, Group 4 without EOFB, old-style LZW,
  the float predictor, 2-, 4- and 12-bit gray, MinIsWhite, ExtraSamples,
  16-bit RGB and CMYK, YCbCr subsampled outside JPEG, YCbCr JPEG with
  JPEGTables, the Orientation tag, and the files PIL refuses.

PIL's libtiff aborts or segfaults the process on some saves (JPEG of modes
"1", "P", "I;16", "I", "F"; Group 3 and 4 of any mode but "1"; a predictor
on 1-bit data), so none is asked of it.
"""

import io
import logging

import numpy as np
import pytest
from PIL import Image

import torch_image_writers as W
from ape_tpu.data.mapper import read_image as jax_read_image
from ape_tpu_torch.data.image_io import CorruptImage, read_image, read_label_map, read_rgb
from ape_tpu_torch.data.tiff import OPEN_INFO
from test_torch_image_forms import image, size_id

SIZES = ((1, 1), (9, 17), (37, 53), (40, 33))


def pil_save(arr, mode=None, **kw) -> bytes:
    im = Image.fromarray(arr) if mode is None else Image.fromarray(arr).convert(mode)
    b = io.BytesIO()
    im.save(b, "TIFF", **kw)
    return b.getvalue()


def mode_image(mode: str, h: int, w: int, seed: int = 0):
    """A PIL image of ``mode`` from the seeded test image."""
    rgb = image(h, w, seed)
    if mode == "P":
        return Image.fromarray(rgb).convert("P", palette=Image.Palette.ADAPTIVE, colors=100)
    if mode == "PA":
        return mode_image("P", h, w, seed).convert("PA")
    if mode == "I;16":
        return Image.fromarray(rgb[..., 0].astype(np.uint16) * 250 + rgb[..., 1])
    if mode == "I":
        return Image.fromarray(rgb[..., 0].astype(np.int32) * 3 - 200)
    if mode == "F":
        return Image.fromarray(rgb[..., 0].astype(np.float32) * 1.37 - 40.5)
    if mode == "1":
        return Image.fromarray(rgb[..., 0] > 120)
    return Image.fromarray(rgb).convert(mode)


def pil_form(mode: str, **kw):
    def make(h, w):
        b = io.BytesIO()
        mode_image(mode, h, w).save(b, "TIFF", **kw)
        return b.getvalue()
    return make


def bilevel(h, w, seed=0):
    """Black blobs and noise: long and short runs of both colors."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    blobs = ((xx // 7 + yy // 5) % 3 == 0) | ((xx - 2 * yy) % 29 < 4)
    return blobs ^ (rng.rand(h, w) < 0.05)


def gray16(h, w, seed=0):
    return image(h, w, seed)[..., 0].astype(np.uint16) * 257 + np.arange(w, dtype=np.uint16)


def _forms():
    forms = {}
    # PIL's own writer (uncompressed) and libtiff's (every other compression)
    for mode in ("RGB", "L", "1", "P", "RGBA", "CMYK", "I;16", "I", "F", "LA", "PA"):
        forms[f"pil_raw_{mode}"] = pil_form(mode)
    for comp in ("tiff_lzw", "packbits", "tiff_adobe_deflate", "lzma"):
        for mode in ("RGB", "L", "P", "I;16", "CMYK", "RGBA", "1"):
            forms[f"pil_{comp}_{mode}"] = pil_form(mode, compression=comp)
    for comp in ("tiff_lzw", "tiff_adobe_deflate", "lzma"):
        for mode in ("RGB", "L", "I;16", "I", "CMYK"):
            forms[f"pil_{comp}_pred2_{mode}"] = pil_form(mode, compression=comp,
                                                         tiffinfo={317: 2})
    forms["pil_deflate_F"] = pil_form("F", compression="tiff_adobe_deflate")
    for mode in ("RGB", "L", "CMYK", "RGBA"):
        forms[f"pil_jpeg_{mode}"] = pil_form(mode, compression="jpeg")
    forms["pil_jpeg_RGB_q95"] = pil_form("RGB", compression="jpeg", quality=95)
    for comp in ("group3", "group4", "tiff_ccitt"):
        forms[f"pil_{comp}"] = lambda h, w, c=comp: pil_save(bilevel(h, w), compression=c)
    # the test-side writer
    rgb = lambda h, w: image(h, w)  # noqa: E731
    for comp in (1, 5, 8, 32773, 34925):
        forms[f"tile_rgb_{comp}"] = lambda h, w, c=comp: W.tiff(rgb(h, w), compression=c,
                                                                tile=(16, 16))
    forms["tile_i16_lzw_pred2"] = lambda h, w: W.tiff(gray16(h, w), photometric=1, bits=16,
                                                      compression=5, predictor=2, tile=(32, 16))
    forms["strips_rgb_lzw_pred2"] = lambda h, w: W.tiff(rgb(h, w), compression=5, predictor=2,
                                                        rows_per_strip=5)
    forms["strips_rgb_raw"] = lambda h, w: W.tiff(rgb(h, w), rows_per_strip=3)
    for order in ("<", ">"):
        o = "mm" if order == ">" else "ii"
        forms[f"{o}_raw_rgb"] = lambda h, w, e=order: W.tiff(rgb(h, w), order=e, rows_per_strip=4)
        forms[f"{o}_lzw_rgb_pred2"] = lambda h, w, e=order: W.tiff(rgb(h, w), order=e,
                                                                   compression=5, predictor=2)
        forms[f"{o}_raw_gray16"] = lambda h, w, e=order: W.tiff(gray16(h, w), photometric=1,
                                                                bits=16, order=e)
        forms[f"{o}_deflate_gray16_pred2"] = lambda h, w, e=order: W.tiff(
            gray16(h, w), photometric=1, bits=16, order=e, compression=8, predictor=2)
        forms[f"{o}_lzw_rgb16"] = lambda h, w, e=order: W.tiff(
            gray16(h, w)[..., None] * np.array([1, 3, 7], np.uint16), bits=16, order=e,
            compression=5)
        forms[f"{o}_raw_rgba16_assoc"] = lambda h, w, e=order: W.tiff(
            np.concatenate([gray16(h, w)[..., None] // 2] * 3 + [gray16(h, w)[..., None]], -1),
            bits=16, order=e, extra=(1,))
        forms[f"{o}_deflate_float_pred3"] = lambda h, w, e=order: W.tiff(
            image(h, w)[..., 0].astype(np.float32) * 2.5 - 100, photometric=1, bits=32,
            sample_format=3, order=e, compression=8, predictor=3)
        forms[f"{o}_lzw_float"] = lambda h, w, e=order: W.tiff(
            image(h, w)[..., 0].astype(np.float32) / 3, photometric=1, bits=32,
            sample_format=3, order=e, compression=5)
        forms[f"{o}_raw_int16"] = lambda h, w, e=order: W.tiff(
            image(h, w)[..., 0].astype(np.int16) * 100 - 9000, photometric=1, bits=16,
            sample_format=2, order=e)
        forms[f"{o}_packbits_int32"] = lambda h, w, e=order: W.tiff(
            image(h, w)[..., 0].astype(np.int32) * 70000 - 10**7, photometric=1, bits=32,
            sample_format=2, order=e, compression=32773)
        forms[f"{o}_lzw_cmyk16"] = lambda h, w, e=order: W.tiff(
            np.concatenate([gray16(h, w)[..., None]] * 4, -1), photometric=5, bits=16, order=e,
            compression=5)
        forms[f"{o}_g4"] = lambda h, w, e=order: W.tiff(bilevel(h, w), photometric=0, bits=1,
                                                        order=e, compression=4)
    forms["bigtiff_raw_rgb"] = lambda h, w: W.tiff(rgb(h, w), big=True, rows_per_strip=7)
    forms["bigtiff_lzw_tiles"] = lambda h, w: W.tiff(rgb(h, w), big=True, compression=5,
                                                     tile=(16, 32))
    # CCITT
    for photometric in (0, 1):
        forms[f"g3_2d_ph{photometric}"] = lambda h, w, p=photometric: W.tiff(
            bilevel(h, w), photometric=p, bits=1, compression=3, options=1, rows_per_strip=8)
    forms["g3_2d_fill_bits"] = lambda h, w: W.tiff(bilevel(h, w, 1), photometric=0, bits=1,
                                                   compression=3, options=5)
    forms["g3_1d_fill_bits"] = lambda h, w: W.tiff(bilevel(h, w, 2), photometric=0, bits=1,
                                                   compression=3, options=4)
    forms["g3_1d_no_rtc"] = lambda h, w: W.tiff(
        size=(w, h), spp=1, photometric=0, bits=1, compression=3,
        segments=[W.ccitt(bilevel(h, w), 3, rtc=False)])
    forms["g4_no_eofb"] = lambda h, w: W.tiff(
        size=(w, h), spp=1, photometric=0, bits=1, compression=4,
        segments=[W.ccitt(bilevel(h, w), 4, eofb=False)])
    forms["g4_tiles"] = lambda h, w: W.tiff(bilevel(h, w), photometric=0, bits=1, compression=4,
                                            tile=(16, 16))
    forms["mh_strips"] = lambda h, w: W.tiff(bilevel(h, w, 3), photometric=0, bits=1,
                                             compression=2, rows_per_strip=6)
    forms["g4_wide_runs"] = lambda h, w: W.tiff(
        np.tile(np.arange(w * 40) % 2900 < 1500, (h, 1)) ^ bilevel(h, w * 40), photometric=0,
        bits=1, compression=4)
    # FillOrder 2
    forms["fill2_g4"] = lambda h, w: W.tiff(bilevel(h, w), photometric=0, bits=1, compression=4,
                                            fillorder=2)
    forms["fill2_g3_2d"] = lambda h, w: W.tiff(bilevel(h, w), photometric=0, bits=1,
                                               compression=3, options=1, fillorder=2)
    forms["fill2_lzw_gray"] = lambda h, w: W.tiff(image(h, w)[..., 0], photometric=1,
                                                  compression=5, fillorder=2)
    forms["fill2_raw_bilevel"] = lambda h, w: W.tiff(bilevel(h, w), photometric=1, bits=1,
                                                     fillorder=2)
    forms["fill2_raw_gray"] = lambda h, w: W.tiff(image(h, w)[..., 1], photometric=1,
                                                  fillorder=2)
    # planar configuration 2
    forms["planar_raw_rgb"] = lambda h, w: W.tiff(rgb(h, w), planar=2, rows_per_strip=5)
    forms["planar_lzw_rgb"] = lambda h, w: W.tiff(rgb(h, w), planar=2, compression=5,
                                                  rows_per_strip=5)
    forms["planar_deflate_rgb16_pred2"] = lambda h, w: W.tiff(
        gray16(h, w)[..., None] * np.array([1, 2, 5], np.uint16), bits=16, planar=2,
        compression=8, predictor=2)
    forms["planar_raw_rgba"] = lambda h, w: W.tiff(image(h, w, channels=4), planar=2, extra=(2,))
    forms["planar_lzw_cmyk_tiles"] = lambda h, w: W.tiff(image(h, w, channels=4), photometric=5,
                                                         planar=2, compression=5, tile=(16, 16))
    # extra samples
    rgba = lambda h, w: image(h, w, channels=4)  # noqa: E731
    for extra in ((0,), (1,), (2,), (2, 0), (1, 0, 0), (0, 0), (999,)):
        name = "_".join(map(str, extra))
        forms[f"extra_raw_{name}"] = lambda h, w, x=extra: W.tiff(
            np.concatenate([rgba(h, w)] + [rgba(h, w)[..., 1:2]] * (len(x) - 1), -1), extra=x)
        forms[f"extra_lzw_{name}"] = lambda h, w, x=extra: W.tiff(
            np.concatenate([rgba(h, w)] + [rgba(h, w)[..., 2:3]] * (len(x) - 1), -1), extra=x,
            compression=5)
    forms["gray_alpha_lzw"] = lambda h, w: W.tiff(image(h, w)[..., :2], photometric=1,
                                                  extra=(2,), compression=5)
    forms["cmyk_extra_raw"] = lambda h, w: W.tiff(
        np.concatenate([rgba(h, w), rgba(h, w)[..., :1]], -1), photometric=5, extra=(0,))
    # gray depths and MinIsWhite
    for bits in (1, 2, 4, 8):
        for photometric in (0, 1):
            for comp in (1, 5):
                forms[f"gray{bits}_ph{photometric}_{comp}"] = lambda h, w, b=bits, p=photometric, \
                    c=comp: W.tiff(image(h, w)[..., 0] >> (8 - b), photometric=p, bits=b,
                                   compression=c, rows_per_strip=6)
    forms["gray12_raw"] = lambda h, w: W.tiff(
        size=(w, h), spp=1, photometric=1, bits=12, segments=[_pack12(gray16(h, w) >> 4)])
    forms["gray12_lzw"] = lambda h, w: W.tiff(
        size=(w, h), spp=1, photometric=1, bits=12, compression=5,
        segments=[W.lzw_tiff(_pack12(gray16(h, w) >> 4))])
    forms["lzw_old_style"] = lambda h, w: W.tiff(
        size=(w, h), spp=1, photometric=1, compression=5,
        segments=[W.lzw_tiff(image(h, w)[..., 2].tobytes(), compat=True)])
    # palettes: 16-bit ColorMap entries reduced to their high bytes
    for bits in (1, 2, 4, 8):
        for comp in (1, 32773, 8):
            forms[f"palette{bits}_{comp}"] = lambda h, w, b=bits, c=comp: W.tiff(
                image(h, w)[..., 0] >> (8 - b), photometric=3, bits=b, compression=c,
                colormap=np.random.RandomState(b).randint(0, 65536, (1 << b, 3)))
    forms["palette_px"] = lambda h, w: W.tiff(
        image(h, w)[..., :2], photometric=3, extra=(0,),
        colormap=np.random.RandomState(5).randint(0, 65536, (256, 3)))
    forms["palette_pa_lzw"] = lambda h, w: W.tiff(
        image(h, w)[..., :2], photometric=3, extra=(2,), compression=5,
        colormap=np.random.RandomState(6).randint(0, 65536, (256, 3)))
    # YCbCr outside JPEG: libtiff's RGBA interface
    for hs, vs in ((1, 1), (2, 1), (2, 2), (4, 2), (4, 4), (1, 2), (4, 1)):
        forms[f"ycbcr_lzw_{hs}{vs}"] = lambda h, w, a=hs, b=vs: _ycbcr(h, w, a, b, 5)
    forms["ycbcr_deflate_22_tiles"] = lambda h, w: _ycbcr(h, w, 2, 2, 8, tile=(16, 16))
    forms["ycbcr_packbits_22_refbw"] = lambda h, w: _ycbcr(
        h, w, 2, 2, 32773, tags=((532, 5, (16, 235, 128, 240, 128, 240)),))
    forms["ycbcr_lzw_11_coefficients"] = lambda h, w: _ycbcr(
        h, w, 1, 1, 5, tags=((529, 5, (0.2126, 0.7152, 0.0722)),))
    # JPEG with JPEGTables
    for samp in ("420", "422", "444"):
        forms[f"jpeg_ycbcr_{samp}"] = lambda h, w, s=samp: _jpeg_tiff(h, w, s)
    forms["jpeg_ycbcr_420_strips"] = lambda h, w: _jpeg_tiff(h, w, "420", rows=16)
    forms["jpeg_ycbcr_420_tiles"] = lambda h, w: _jpeg_tiff(h, w, "420", tile=16)
    forms["jpeg_ycbcr_no_tables"] = lambda h, w: _jpeg_tiff(h, w, "420", tables=False)
    forms["jpeg_rgb_components"] = lambda h, w: _jpeg_tiff(h, w, "444", photometric=2)
    forms["jpeg_gray"] = lambda h, w: _jpeg_tiff(h, w, "gray", photometric=1)
    # Orientation, as PIL's load_end applies it
    for orientation in range(1, 9):
        forms[f"orientation_{orientation}"] = lambda h, w, o=orientation: W.tiff(
            rgb(h, w), orientation=o)
        forms[f"orientation_lzw_{orientation}"] = lambda h, w, o=orientation: W.tiff(
            image(h, w)[..., 1], photometric=1, orientation=o, compression=5)
    return forms


def _pack12(v: np.ndarray) -> bytes:
    """12-bit samples packed two in three bytes, rows padded to a byte."""
    h, w = v.shape
    v = np.pad(v.astype(np.uint16), ((0, 0), (0, w % 2)))
    a, b = v[:, 0::2], v[:, 1::2]
    trip = np.stack([a >> 4, ((a & 15) << 4) | (b >> 8), b & 255], -1).astype(np.uint8)
    rows = trip.reshape(h, -1)[:, :(w * 12 + 7) // 8]
    return rows.tobytes()


def _ycbcr(h, w, hs, vs, comp, tile=None, tags=()):
    img = image(h, w, 2)
    y, cb, cr = (img[..., c] for c in range(3))
    if tile:
        tw, th = tile
        segs = []
        for ty in range(0, h, th):
            for tx in range(0, w, tw):
                blk = [np.zeros((th, tw), np.uint8) for _ in range(3)]
                for b, p in zip(blk, (y, cb, cr)):
                    part = p[ty:ty + th, tx:tx + tw]
                    b[:part.shape[0], :part.shape[1]] = part
                segs.append(W._compress(W.ycbcr_blocks(*blk, hs, vs), comp))
    else:
        segs = [W._compress(W.ycbcr_blocks(y, cb, cr, hs, vs), comp)]
    return W.tiff(size=(w, h), spp=3, photometric=6, compression=comp, segments=segs, tile=tile,
                  tags=((530, 3, (hs, vs)),) + tuple(tags))


def _jpeg_tiff(h, w, samp, rows=None, tile=None, tables=True, photometric=6):
    from test_torch_image_forms import Q75, SAMPLINGS

    return W.jpeg_tiff(image(h, w, 3), SAMPLINGS[samp], Q75, rows, tile, tables, photometric)


FORMS = _forms()


def _pil(path):
    try:
        im = Image.open(path)
        return np.asarray(im), im.mode
    except Exception:
        return None, None


def same_as_jax(tmp_path, data: bytes, name: str = "a.tif"):
    path = tmp_path / name
    path.write_bytes(data)
    want = jax_read_image(str(path))
    samples, mode = _pil(str(path))
    if mode == "LAB":  # PIL converts through LittleCMS: the port names it
        with pytest.raises(ValueError, match="CIELab") as info:
            read_image(str(path))
        assert not isinstance(info.value, CorruptImage)
    else:
        got = read_image(str(path))
        assert (got is None) == (want is None), ("PIL", want is not None, "port", got is not None)
        if want is not None:
            assert got.dtype == np.uint8 and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
    if samples is not None:
        label = read_label_map(str(path))
        assert label.dtype == samples.dtype and label.shape == samples.shape
        np.testing.assert_array_equal(label, samples)
    return want


@pytest.mark.parametrize("size", SIZES, ids=size_id)
@pytest.mark.parametrize("form", sorted(FORMS))
def test_tiff_equals_jax(tmp_path, form, size):
    h, w = size
    assert same_as_jax(tmp_path, FORMS[form](h, w)) is not None, "PIL refuses the form"


def test_open_info_is_pils():
    from PIL import TiffImagePlugin

    assert OPEN_INFO == TiffImagePlugin.OPEN_INFO


def test_lab_label_map_and_refusal(tmp_path):
    lab = pil_save(image(13, 21), "LAB")
    same_as_jax(tmp_path, lab)
    same_as_jax(tmp_path, W.tiff(image(13, 21), photometric=8, compression=5))


def _lzw_corrupt_table():
    """After a clear code, a code past the literals: 'Corrupted LZW table'."""
    bits = "100000000" + format(300, "09b") + "100000001"
    return W._bits_to_bytes(bits)


def _retagged(data: bytes, tag: int, new: int) -> bytes:
    """A little-endian classic TIFF with the first directory's ``tag``
    entry renumbered."""
    at = int.from_bytes(data[4:8], "little")
    out = bytearray(data)
    for i in range(int.from_bytes(data[at:at + 2], "little")):
        pos = at + 2 + 12 * i
        if int.from_bytes(data[pos:pos + 2], "little") == tag:
            out[pos:pos + 2] = new.to_bytes(2, "little")
    return bytes(out)


def _cut(data: bytes, keep: float) -> bytes:
    return data[:int(len(data) * keep)]


# name -> the bytes of a file PIL refuses
REFUSED = {
    "unknown_compression": lambda: W.tiff(image(9, 13), compression=32909),
    "key_not_in_open_info": lambda: W.tiff(image(9, 13)[..., :2]),
    "rgb_float": lambda: W.tiff(image(9, 13).astype(np.float32), bits=32, sample_format=3),
    "truncated_raw": lambda: W.tiff(image(30, 40), rows_per_strip=30)[:900],
    "raw_strip_past_end": lambda: W.tiff(image(30, 40), rows_per_strip=10)[:2000],
    "truncated_lzw": lambda: W.tiff(size=(40, 30), spp=3, compression=5, segments=[
        _cut(W.lzw_tiff(image(30, 40).tobytes()), 0.5)]),
    "corrupt_lzw_table": lambda: W.tiff(size=(8, 4), spp=1, photometric=1, compression=5,
                                        segments=[_lzw_corrupt_table()]),
    "truncated_deflate": lambda: W.tiff(size=(40, 30), spp=3, compression=8, segments=[
        _cut(W._compress(image(30, 40).tobytes(), 8), 0.5)]),
    "short_packbits": lambda: W.tiff(size=(40, 30), spp=3, compression=32773, segments=[
        W.packbits(image(20, 40).tobytes())]),
    "truncated_mh": lambda: W.tiff(size=(40, 30), spp=1, photometric=0, bits=1, compression=2,
                                   segments=[_cut(W.ccitt(bilevel(30, 40), 2), 0.6)]),
    "ifd_past_end": lambda: b"II*\x00" + (10**6).to_bytes(4, "little") + bytes(16),
    "no_ifd": lambda: b"II*\x00\x00\x00\x00\x00" + bytes(16),
    "missing_dimensions": lambda: _retagged(W.tiff(image(9, 13)), 256, 0x9999),
    "bigtiff_mm": lambda: W.tiff(image(9, 13), big=True, order=">"),
    "ycbcr_uncompressed": lambda: _ycbcr(9, 13, 2, 2, 1),
    "palette_without_colormap": lambda: W.tiff(image(9, 13)[..., 0], photometric=3),
    "predictor2_on_4_bits": lambda: W.tiff(
        size=(13, 9), spp=1, photometric=1, bits=4, compression=5, tags=((317, 3, (2,)),),
        segments=[W.lzw_tiff(W._samples_bytes(image(9, 13)[..., :1] >> 4, 4, "<"))]),
    "jpeg_bad_sampling": lambda: _jpeg_tiff(16, 16, "422", photometric=2),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refusals_dropped_as_jax(tmp_path, case, caplog):
    path = tmp_path / "r.tif"
    path.write_bytes(REFUSED[case]())
    assert jax_read_image(str(path)) is None, "PIL decodes the file"
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="ape_tpu_torch"):
        assert read_image(str(path)) is None
    assert len([r for r in caplog.records if r.name == "ape_tpu_torch"]) == 1
    with pytest.raises(CorruptImage):
        read_rgb(str(path))


# compressions PIL hands to libtiff and the port does not decode
OUT_OF_SCOPE = {"zstd": (50000, "zstd"), "webp": (50001, "WebP"), "old_jpeg": (6, "old-style"),
                "thunderscan": (32809, "ThunderScan"), "sgilog": (34676, "SGILog"),
                "sgilog24": (34677, "SGILog24"), "rlew": (32771, "RLEW")}


@pytest.mark.parametrize("case", sorted(OUT_OF_SCOPE))
def test_out_of_scope_compressions_raise_naming_them(tmp_path, case):
    code, words = OUT_OF_SCOPE[case]
    if case == "zstd":
        data = pil_save(image(9, 13), compression="zstd")
        assert jax_read_image_bytes(tmp_path, data) is not None
    else:
        data = W.tiff(size=(13, 9), spp=3, compression=code, segments=[bytes(64)])
    path = tmp_path / "o.tif"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=words) as info:
        read_image(str(path))
    assert not isinstance(info.value, CorruptImage)
    assert "TIFF" in str(info.value)


def jax_read_image_bytes(tmp_path, data):
    path = tmp_path / "j.tif"
    path.write_bytes(data)
    return jax_read_image(str(path))


@pytest.mark.parametrize("channels", (1, 3))
@pytest.mark.parametrize("size", SIZES, ids=size_id)
@pytest.mark.parametrize("ext", (".tif", ".tiff"))
def test_write_image_tiff_is_pils_bytes(tmp_path, ext, size, channels):
    from ape_tpu_torch.data.image_io import write_image

    img = image(*size)
    img = img[..., 0] if channels == 1 else img
    path = tmp_path / f"w{ext}"
    write_image(str(path), img)
    assert path.read_bytes() == pil_save(img)
    np.testing.assert_array_equal(read_label_map(str(path)), img)
