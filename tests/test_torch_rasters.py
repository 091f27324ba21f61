"""The port's QOI, PCX, DCX, SGI, Sun raster, IM, MSP and XBM readers and
its QOI, PCX, SGI and IM writers held to PIL 12.1 on the CPU, and the drop
of the files PIL opens and cannot load:

* every form decodes to JAX's ``read_image`` pixels bit for bit and
  ``read_label_map`` equals ``np.asarray(Image.open(f))``, at 1x1, 5x7,
  9x23 and 53x37; a file PIL refuses is dropped with one warning;
* ``write_image`` writes PIL's bytes for each writer and mode, and raises
  where PIL cannot write (``.ras``, ``.dcx``, ``.msp``, ``.xbm``);
* BUFR, GRIB, HDF5, MPEG and placeable WMF files, and EPS without
  Ghostscript, are dropped as JAX drops them; EPS with Ghostscript raises
  naming it;
* ``pil_format`` and ``sniff`` name the plugin ``Image.open(f).format``
  names for every fixture of this file and of the earlier reader tests;
* the mapper keeps and drops what JAX's keeps and drops.
"""

import io
import logging
import struct

import numpy as np
import pytest
from PIL import Image

import torch_image_writers as W
from ape_tpu.data import mapper as j_mapper
from ape_tpu.data.mapper import read_image as jax_read_image
from ape_tpu_torch.data import image_io
from ape_tpu_torch.data.datasets.coco import load_coco_json
from ape_tpu_torch.data.image_io import (PIL_PLUGINS, CorruptImage, pil_format, read_image,
                                         sniff, write_image)
from ape_tpu_torch.data.mapper import DatasetMapperDETR
from test_torch_data import _same_example, write_dataset
from test_torch_image_forms import image, size_id
from test_torch_netpbm_tga_ico import (ICO_FORMS, NETPBM_FORMS, SIZES, TGA_FORMS,
                                       dropped_with_one_warning, flat, pil_bytes, same_as_jax)

KIND = {fmt: kind for fmt, kind, _ in PIL_PLUGINS}


def bits(h, w, seed=0):
    return image(h, w, seed)[..., 0] > 110


def palette_pil(h, w, colors=20):
    return Image.fromarray(flat(h, w)).convert("P", palette=Image.Palette.ADAPTIVE, colors=colors)


def saved(im: Image.Image, fmt: str, **kw) -> bytes:
    b = io.BytesIO()
    im.save(b, fmt, **kw)
    return b.getvalue()


# forms PIL refuses at one size though it reads them at the others
PIL_REFUSES = {
    # PcxEncode drops the last plane of a one-byte line: PIL's own 1x1 RGB
    # file is cut short, and PIL reads it as truncated
    ("pcx", "pil_RGB", (1, 1)), ("dcx", "one_page", (1, 1)),
    ("dcx", "two_pages_rgb_first", (1, 1)),
}


def held(forms: dict, form: str, size, tmp_path, name: str):
    """The form's file read as JAX reads it; ``pil_format`` and ``sniff``
    name PIL's plugin for it (a 1-pixel-wide Sun raster of 1 or 4 data
    bytes is a GIMP brush to PIL, which it then fails to load)."""
    data = forms[form](*size)
    path = tmp_path / f"a.{name}"
    path.write_bytes(data)
    fmt = Image.open(str(path)).format
    assert pil_format(data) == fmt and sniff(data) == KIND[fmt]
    got = same_as_jax(tmp_path, data, f"a.{name}")
    if fmt == name.upper() and (name, form, tuple(size)) not in PIL_REFUSES:
        assert got is not None, "PIL refuses the form"


# --- QOI ---------------------------------------------------------------------

def qoi_ops(w, h, ops: bytes, channels=4) -> bytes:
    """A QOI stream of ``ops`` then enough 62-pixel runs to fill the image."""
    return (b"qoif" + struct.pack(">IIBB", w, h, channels, 0) + ops
            + b"\xfd" * (w * h // 62 + 1) + W_QOI_END)


W_QOI_END = b"\0" * 7 + b"\1"


def _qoi_forms():
    forms = {
        "pil_rgb": lambda h, w: pil_bytes(image(h, w), "QOI"),
        "pil_rgba": lambda h, w: pil_bytes(image(h, w, 1, 4), "QOI"),
        "pil_rgb_flat": lambda h, w: pil_bytes(flat(h, w), "QOI"),
        "pil_rgba_alpha_steps": lambda h, w: pil_bytes(flat(h, w, 2, 4), "QOI"),
        "pil_rgb_srgb": lambda h, w: pil_bytes(image(h, w, 3), "QOI", colorspace="sRGB"),
        "channels_byte_7": lambda h, w: (lambda d: d[:12] + b"\x07" + d[13:])(
            pil_bytes(image(h, w, 4, 4), "QOI")),
        "without_end_marker": lambda h, w: pil_bytes(image(h, w, 5), "QOI")[:-8],
        # a RUN first (its pixel never enters the table), an INDEX of an
        # unseen entry, then RGB, DIFF, LUMA and RGBA ops
        "every_op": lambda h, w: qoi_ops(w, h, b"\xc2\x35\xfe\x10\x20\x30\x6a\xa0\x88"
                                         b"\xff\x01\x02\x03\x04\x1e\xe1"),
        "every_op_rgb": lambda h, w: qoi_ops(w, h, b"\xc0\x35\xfe\xf0\x20\x30\x55\xbf\xff"
                                             b"\xff\x90\x02\x03\x80", 3),
    }
    return forms


QOI_FORMS = _qoi_forms()


@pytest.mark.parametrize("size", SIZES, ids=size_id)
@pytest.mark.parametrize("form", sorted(QOI_FORMS))
def test_qoi_equals_jax(tmp_path, form, size):
    held(QOI_FORMS, form, size, tmp_path, "qoi")


# --- PCX and DCX -------------------------------------------------------------

def _plane_lines(idx: np.ndarray, planes: int, stride: int) -> np.ndarray:
    h, w = idx.shape
    out = np.zeros((h, planes * stride), np.uint8)
    for k in range(planes):
        packed = np.packbits((idx >> k) & 1, axis=1)
        out[:, k * stride:k * stride + packed.shape[1]] = packed
    return out


def _gray_lines(img: np.ndarray, stride: int) -> np.ndarray:
    h, w = img.shape[:2]
    planes = 1 if img.ndim == 2 else img.shape[2]
    out = np.zeros((h, planes, stride), np.uint8)
    out[:, :, :w] = img.reshape(h, w, planes).transpose(0, 2, 1)
    return out.reshape(h, -1)


def _pcx_forms():
    forms = {f"pil_{m}": (lambda h, w, m=m: saved(
        Image.fromarray(flat(h, w)).convert(m) if m != "1" else Image.fromarray(bits(h, w)),
        "PCX")) for m in ("L", "RGB", "1")}
    forms["pil_P"] = lambda h, w: saved(palette_pil(h, w), "PCX")
    forms["pil_L_noisy"] = lambda h, w: saved(Image.fromarray(image(h, w)[..., 1]), "PCX")
    pal16 = np.random.RandomState(3).randint(0, 256, 48).astype(np.uint8).tobytes()
    for planes in (2, 4):
        for exact in (False, True):
            def make(h, w, p=planes, e=exact):
                s = (w + 7) // 8
                stride = s if e else s + s % 2
                idx = (image(h, w)[..., 0] >> (8 - p)).astype(np.uint8)
                return W.pcx(_plane_lines(idx, p, stride), w, h, 1, p, palette16=pal16)
            forms[f"bits1_planes{planes}{'_exact_stride' if exact else ''}"] = make
    ramp = b"\x0c" + np.repeat(np.arange(256, dtype=np.uint8), 3).tobytes()
    colour = b"\x0c" + np.random.RandomState(4).randint(0, 256, 768).astype(np.uint8).tobytes()
    forms["gray_ramp_trailer"] = lambda h, w: W.pcx(
        _gray_lines(image(h, w)[..., 0], w + w % 2), w, h, 8, 1, trailer=ramp)
    forms["palette_trailer"] = lambda h, w: W.pcx(
        _gray_lines(image(h, w)[..., 2], w + w % 2), w, h, 8, 1, trailer=colour)
    forms["trailer_not_a_palette"] = lambda h, w: W.pcx(
        _gray_lines(image(h, w)[..., 1], w + w % 2), w, h, 8, 1, trailer=b"\x0b" + bytes(768))
    forms["rgb_exact_stride"] = lambda h, w: W.pcx(_gray_lines(flat(h, w, 1), w), w, h, 8, 3)
    forms["rgb_padded_noise"] = lambda h, w: W.pcx(
        _gray_lines(image(h, w, 2), w + w % 2), w, h, 8, 3)
    forms["rgb_bbox_offset"] = lambda h, w: W.pcx(
        _gray_lines(flat(h, w, 3), w + w % 2), w, h, 8, 3, x0=3, y0=2)
    forms["bits1_version0"] = lambda h, w: W.pcx(
        _plane_lines(bits(h, w).astype(np.uint8), 1, (w + 7) // 8), w, h, 1, 1, version=0)
    return forms


PCX_FORMS = _pcx_forms()


@pytest.mark.parametrize("size", SIZES, ids=size_id)
@pytest.mark.parametrize("form", sorted(PCX_FORMS))
def test_pcx_equals_jax(tmp_path, form, size):
    held(PCX_FORMS, form, size, tmp_path, "pcx")


def _dcx_forms():
    def page(m, h, w, seed):
        return saved(Image.fromarray(flat(h, w, seed)).convert(m), "PCX")
    return {
        "two_pages_rgb_first": lambda h, w: W.dcx([page("RGB", h, w, 0), page("L", 5, 4, 1)]),
        "two_pages_gray_first": lambda h, w: W.dcx([page("L", h, w, 2), page("RGB", 3, 6, 3)]),
        "one_page": lambda h, w: W.dcx([page("RGB", h, w, 4)]),
    }


DCX_FORMS = _dcx_forms()


@pytest.mark.parametrize("size", SIZES, ids=size_id)
@pytest.mark.parametrize("form", sorted(DCX_FORMS))
def test_dcx_equals_jax(tmp_path, form, size):
    held(DCX_FORMS, form, size, tmp_path, "dcx")


# --- SGI ---------------------------------------------------------------------

def _planes(h, w, z, seed=0, bpc=1):
    img = flat(h, w, seed, 4)[..., :z] if seed % 2 else image(h, w, seed, 4)[..., :z]
    planes = img.transpose(2, 0, 1)
    return planes.astype(np.uint16) * 257 + (seed * 37) % 256 if bpc == 2 else planes


def _sgi_forms():
    forms = {}
    for m in ("L", "RGB", "RGBA"):
        for bpc in (1, 2):
            forms[f"pil_{m}_bpc{bpc}"] = lambda h, w, m=m, b=bpc: saved(
                Image.fromarray(image(h, w, 0, 4)).convert(m), "SGI", bpc=b)
    for z in (1, 3, 4):
        for bpc in (1, 2):
            forms[f"verbatim_z{z}_bpc{bpc}"] = lambda h, w, z=z, b=bpc: W.sgi(
                _planes(h, w, z, 1, b), b)
            forms[f"rle_z{z}_bpc{bpc}"] = lambda h, w, z=z, b=bpc: W.sgi(
                _planes(h, w, z, 3, b), b, rle=True)
    forms["rle_noise"] = lambda h, w: W.sgi(_planes(h, w, 3, 2), 1, rle=True)
    forms["rle_shared_rows"] = lambda h, w: W.sgi(_planes(h, w, 3, 5), 1, rle=True, shared=True)
    forms["dimension1"] = lambda h, w: W.sgi(_planes(h, w, 1, 0), 1, dimension=1)

    def half_rows(c, y, v):  # odd rows stop halfway: the rest keeps the row before
        return W.sgi_rle_row(v[:max(1, len(v) // 2)] if y % 2 else v, 1)
    forms["rle_rows_end_early"] = lambda h, w: W.sgi(_planes(h, w, 3, 7), 1, rle=True,
                                                     rows=half_rows)

    def stop(c, y, v):  # a one-byte row that is no terminator: PIL stops, the rest zero
        return b"\x83" if (c, y) == (1, 0) else W.sgi_rle_row(v, 1)
    forms["rle_one_byte_row_stops"] = lambda h, w: W.sgi(_planes(h, w, 3, 9), 1, rle=True,
                                                         rows=stop)
    return forms


SGI_FORMS = _sgi_forms()


@pytest.mark.parametrize("size", SIZES, ids=size_id)
@pytest.mark.parametrize("form", sorted(SGI_FORMS))
def test_sgi_equals_jax(tmp_path, form, size):
    held(SGI_FORMS, form, size, tmp_path, "sgi")


# --- Sun raster --------------------------------------------------------------

def _sun_forms():
    def planar(n, seed):
        return np.random.RandomState(seed).randint(0, 256, (3, n)).astype(np.uint8).tobytes()

    def nibbles(h, w):
        v = (image(h, w)[..., 0] >> 4).astype(np.uint8)
        if w % 2:
            v = np.concatenate([v, np.zeros((h, 1), np.uint8)], 1)
        return (v[:, 0::2] << 4 | v[:, 1::2]).astype(np.uint8)

    forms = {
        "depth1": lambda h, w: W.sun(W.sun_rows(np.packbits(bits(h, w), axis=1)), w, h, 1),
        "depth4_gray": lambda h, w: W.sun(W.sun_rows(nibbles(h, w)), w, h, 4),
        "depth4_map": lambda h, w: W.sun(W.sun_rows(nibbles(h, w)), w, h, 4,
                                         colormap=planar(16, 1)),
        "depth8_gray": lambda h, w: W.sun(W.sun_rows(image(h, w)[..., 1]), w, h, 8),
        "depth8_map": lambda h, w: W.sun(W.sun_rows(image(h, w)[..., 2]), w, h, 8,
                                         colormap=planar(256, 2)),
        "depth8_short_map": lambda h, w: W.sun(W.sun_rows(image(h, w)[..., 2]), w, h, 8,
                                               colormap=planar(10, 3)),
        "rle8_gray": lambda h, w: W.sun(W.sun_rle(flat(h, w)[..., 0].tobytes()), w, h, 8, 2),
        "rle8_0x80": lambda h, w: W.sun(W.sun_rle(
            np.where(image(h, w)[..., 0] > 128, 0x80, image(h, w)[..., 1]).astype(
                np.uint8).tobytes()), w, h, 8, 2),
        "rle8_map": lambda h, w: W.sun(W.sun_rle(flat(h, w)[..., 1].tobytes()), w, h, 8, 2,
                                       colormap=planar(256, 4)),
        "rle24_across_rows": lambda h, w: W.sun(W.sun_rle(flat(h, w)[..., ::-1].tobytes()), w, h,
                                                24, 2),
        "rle1": lambda h, w: W.sun(W.sun_rle(np.packbits(bits(h, w), axis=1).tobytes()), w, h, 1,
                                   2),
    }
    for depth in (24, 32):
        for file_type in (0, 1, 3, 4, 5):
            forms[f"depth{depth}_type{file_type}"] = lambda h, w, d=depth, t=file_type: W.sun(
                W.sun_rows(image(h, w, t, d // 8).reshape(h, -1)), w, h, d, t)
    return forms


SUN_FORMS = _sun_forms()


@pytest.mark.parametrize("size", SIZES, ids=size_id)
@pytest.mark.parametrize("form", sorted(SUN_FORMS))
def test_sun_equals_jax(tmp_path, form, size):
    held(SUN_FORMS, form, size, tmp_path, "sun")


# --- IM ----------------------------------------------------------------------

def _im_forms():
    forms = {}
    for m in ("1", "L", "LA", "I", "I;16", "I;16L", "I;16B", "F", "RGB", "RGBA", "RGBX", "CMYK",
              "YCbCr"):
        def make(h, w, m=m):
            img = image(h, w, 0, 4)
            if m in ("I", "I;16", "I;16L", "I;16B", "F"):
                v = img[..., 0].astype(np.int64) * 300 - 20000
                im = (Image.fromarray(v.astype(np.int32), "I") if m == "I" else
                      Image.fromarray((v / 7).astype(np.float32), "F") if m == "F" else
                      Image.fromarray(np.clip(v, 0, 65535).astype(np.uint16)).convert(m))
            elif m == "1":
                im = Image.fromarray(bits(h, w))
            else:
                im = Image.fromarray(img).convert(m)
            return saved(im, "IM")
        forms[f"pil_{m.replace(';', '_')}"] = make
    forms["pil_P"] = lambda h, w: saved(palette_pil(h, w), "IM")
    forms["pil_PA"] = lambda h, w: saved(palette_pil(h, w).convert("PA"), "IM")
    colour = np.random.RandomState(5).randint(0, 256, 768).astype(np.uint8).tobytes()
    grey = np.repeat((255 - np.arange(256)).astype(np.uint8)[None], 3, 0).tobytes()

    def raw(kind, h, w, dtype="u1", planes=1, seed=0, lut=None, lines=(), pad=True):
        v = image(h, w, seed, 4)[..., :planes].astype(np.int64)
        if dtype != "u1":
            v = v * 257 - 30000 if dtype[1] in "if" else v * 257
        body = v.astype(dtype)[::-1].tobytes()
        return W.im(kind, w, h, body, lut=lut, lines=lines, pad=pad)

    forms["x24"] = lambda h, w: raw("X 24 image", h, w, planes=3)
    for name, kind, dtype in (("l16b", "L 16B image", ">u2"), ("l16l", "L*16L image", "<u2"),
                              ("l16", "L 16 image", "<u2"), ("l32s", "L 32S image", "<i4"),
                              ("l_32_s", "L 32 S image", "<i4"), ("l_32_f", "L 32 F image", "<u4"),
                              ("l8", "L 8 image", "u1"), ("l8s", "L 8S image", "i1"),
                              ("l16s", "L 16S image", "<i2"), ("l32f", "L*32F image", "<f4"),
                              ("l32", "L 32 image", "<u4"), ("l_star_16", "L*16 image", "<u2")):
        forms[name] = lambda h, w, k=kind, d=dtype: raw(k, h, w, d)

    def thirds(kind):  # RGB3 / RYB3: whole planes of green, red, blue, bottom-up
        def make(h, w):
            img = image(h, w, 2)
            body = b"".join(img[::-1, :, c].tobytes() for c in (1, 0, 2))
            return W.im(kind, w, h, body)
        return make
    forms["rgb3_planes"] = thirds("RGB3 image")
    forms["ryb3_planes"] = thirds("RYB3 image")
    forms["b2_no_lut"] = lambda h, w: W.im("B2 image", w, h, np.packbits(
        np.unpackbits(image(h, w)[::-1, :, 0:1], axis=2)[..., :2].reshape(h, -1), axis=1).tobytes())
    forms["b4_no_lut"] = lambda h, w: W.im("B4 image", w, h, np.packbits(
        np.unpackbits(image(h, w)[::-1, :, 1:2], axis=2)[..., :4].reshape(h, -1), axis=1).tobytes())
    forms["b4_colour_lut"] = lambda h, w: raw("B4 image", h, w, lut=colour)
    forms["grey_lut_nonlinear"] = lambda h, w: raw("Greyscale image", h, w, lut=grey)
    forms["grey_colour_lut"] = lambda h, w: raw("Greyscale image", h, w, seed=3, lut=colour)
    forms["la_colour_lut"] = lambda h, w: raw("LA image", h, w, planes=2, lut=colour)
    forms["pa_colour_lut"] = lambda h, w: raw("PA image", h, w, planes=2, lut=colour)
    forms["rgb_lut_ignored"] = lambda h, w: W.im("RGB image", w, h, np.ascontiguousarray(
        image(h, w, 4)[::-1].transpose(0, 2, 1)).tobytes(), lut=colour)
    forms["header_comments_name_crlf"] = lambda h, w: raw(
        "Greyscale image", h, w, seed=6, lines=("Comment: first", "Name: x.im", "Comment: second",
                                                "Date: today", "File size (no of images): 2"))
    forms["header_no_padding"] = lambda h, w: raw("Greyscale image", h, w, seed=7, pad=False)
    forms["header_lf_cr"] = lambda h, w: (
        f"Image type: L 16 image\n\rImage size (x*y): {w}*{h}\n\r".encode() + b"\x1a"
        + (image(h, w)[..., 0].astype("<u2") * 200).astype("<u2")[::-1].tobytes())
    return forms


IM_FORMS = _im_forms()


@pytest.mark.parametrize("size", SIZES, ids=size_id)
@pytest.mark.parametrize("form", sorted(IM_FORMS))
def test_im_equals_jax(tmp_path, form, size):
    held(IM_FORMS, form, size, tmp_path, "im")


def test_im_bit_decoder_raises_naming_it(tmp_path):
    """PIL reads floats of 2-31 bits ("L*12 image") through its bit decoder;
    the port does not yet, and raises ``ValueError`` (never None)."""
    path = tmp_path / "a.im"
    path.write_bytes(W.im("L*12 image", 8, 4, bytes(range(48))))
    assert jax_read_image(str(path)) is not None
    with pytest.raises(ValueError, match="bit decoder") as info:
        read_image(str(path))
    assert not isinstance(info.value, CorruptImage)


# --- MSP and XBM -------------------------------------------------------------

def _msp_runs_on(h, w):
    """Version 2 rows of unequal decoded length: row 0 one byte long, the
    last one short by it, so that the rows in between shift."""
    data = W.msp(bits(h, w, 1), 2, runs=2)
    stride = (w + 7) // 8
    table = list(struct.unpack_from(f"<{h}H", data, 32))
    body = data[32 + 2 * h:]
    rows, pos = [], 0
    for n in table:
        rows.append(body[pos:pos + n])
        pos += n
    if h == 1:
        return data
    rows[0] += b"\x01\xaa"
    rows[-1] = bytes([stride - 1]) + bytes(range(stride - 1)) if stride > 1 else b"\x00\x00\xaa"
    return data[:32] + struct.pack(f"<{h}H", *map(len, rows)) + b"".join(rows)


MSP_FORMS = {
    "v1": lambda h, w: W.msp(bits(h, w), 1),
    "v2": lambda h, w: W.msp(bits(h, w, 2), 2),
    "v2_runs": lambda h, w: W.msp(flat(h, w)[..., 0] > 100, 2, runs=2),
    "v2_blank_rows": lambda h, w: W.msp(np.where(np.arange(h)[:, None] % 3 == 1, True,
                                                 bits(h, w, 3)), 2, blank=True),
    "v2_rows_run_on": _msp_runs_on,
}


@pytest.mark.parametrize("size", SIZES, ids=size_id)
@pytest.mark.parametrize("form", sorted(MSP_FORMS))
def test_msp_equals_jax(tmp_path, form, size):
    held(MSP_FORMS, form, size, tmp_path, "msp")


XBM_FORMS = {
    "pil": lambda h, w: saved(Image.fromarray(bits(h, w)), "XBM"),
    "pil_hotspot": lambda h, w: saved(Image.fromarray(bits(h, w, 1)), "XBM", hotspot=(2, 3)),
    "x11": lambda h, w: W.xbm(bits(h, w, 2)),
    # PIL takes one byte from each 16-bit word: it reads an X10 file whole
    # only where a row is one byte (xbm_x10_wide in REFUSED)
    "x10_words": lambda h, w: W.xbm(bits(h, min(w, 8), 3), x10=True),
    "hotspot_upper_hex": lambda h, w: W.xbm(bits(h, w, 4), hotspot=(0, 1)).upper().replace(
        b"#DEFINE", b"#define").replace(b"_WIDTH", b"_width").replace(b"_HEIGHT", b"_height")
    .replace(b"_X_HOT", b"_x_hot").replace(b"_Y_HOT", b"_y_hot").replace(b"_BITS", b"_bits")
    .replace(b"0X", b"0x"),
}


@pytest.mark.parametrize("size", SIZES, ids=size_id)
@pytest.mark.parametrize("form", sorted(XBM_FORMS))
def test_xbm_equals_jax(tmp_path, form, size):
    held(XBM_FORMS, form, size, tmp_path, "xbm")


# --- what PIL refuses --------------------------------------------------------

def _sgi_table_patch(data: bytes, at: int, value: int) -> bytes:
    return data[:512 + 4 * at] + struct.pack(">I", value) + data[516 + 4 * at:]


REFUSED = {
    "qoi_cut": (lambda: pil_bytes(image(9, 13), "QOI")[:60], "qoi"),
    "qoi_cut_in_rgba_op": (lambda: b"qoif" + struct.pack(">IIBB", 4, 1, 4, 0)
                           + b"\xfe\x01\x02\x03\xff\x01\x02", "qoi"),
    "qoi_cut_in_luma": (lambda: b"qoif" + struct.pack(">IIBB", 4, 1, 3, 0) + b"\xc1\xa0", "qoi"),
    "qoi_size_zero": (lambda: b"qoif" + struct.pack(">IIBB", 0, 3, 3, 0) + bytes(20), "qoi"),
    "pcx_run_past_line": (lambda: W.pcx(np.full((9, 14), 7, np.uint8), 13, 9, 8, 1,
                                        trailer=bytes(769), cross_lines=True), "pcx"),
    "pcx_truncated": (lambda: saved(Image.fromarray(image(9, 13)), "PCX")[:300], "pcx"),
    "pcx_planes4_8bit": (lambda: W.pcx(np.zeros((9, 56), np.uint8), 13, 9, 8, 4,
                                       trailer=bytes(769)), "pcx"),
    "pcx_bits2": (lambda: W.pcx(np.zeros((9, 4), np.uint8), 13, 9, 2, 1), "pcx"),
    "pcx_version0_8bit": (lambda: W.pcx(np.zeros((9, 14), np.uint8), 13, 9, 8, 1, version=0,
                                        trailer=bytes(769)), "pcx"),
    "pcx_8bit_shorter_than_trailer": (lambda: W.pcx(np.zeros((2, 4), np.uint8), 3, 2, 8, 1),
                                      "pcx"),
    "pcx_bad_bbox": (lambda: (lambda d: d[:8] + struct.pack("<H", 2) + d[10:])(
        W.pcx(np.zeros((9, 14), np.uint8), 13, 9, 8, 1, x0=5, trailer=bytes(769))), "pcx"),
    "dcx_no_pages": (lambda: struct.pack("<II", 987654321, 0) + bytes(40), "dcx"),
    "dcx_page_past_end": (lambda: struct.pack("<III", 987654321, 5000, 0) + bytes(40), "dcx"),
    "sgi_verbatim_truncated": (lambda: W.sgi(_planes(9, 13, 3))[:600], "sgi"),
    "sgi_rle_run_past_row": (lambda: W.sgi(_planes(9, 13, 1), rle=True,
                                           rows=lambda c, y, v: W.sgi_rle_row(
                                               np.concatenate([v, v[:3]]), 1)), "sgi"),
    "sgi_rle_offset_in_header": (lambda: _sgi_table_patch(W.sgi(_planes(9, 13, 1), rle=True), 0,
                                                          100), "sgi"),
    "sgi_rle_tables_past_file": (lambda: W.sgi(_planes(9, 13, 3), rle=True)[:540], "sgi"),
    "sgi_copy_to_last_byte": (lambda: W.sgi(_planes(1, 13, 1), rle=True,
                                            rows=lambda c, y, v: bytes([0x80 | 13]) + v.tobytes()),
                              "sgi"),
    "sgi_bad_mode": (lambda: W.sgi(_planes(9, 13, 3)[:2]), "sgi"),
    "sgi_compression_2": (lambda: (lambda d: d[:2] + b"\x02" + d[3:])(W.sgi(_planes(9, 13, 3))),
                          "sgi"),
    "sun_raw_truncated": (lambda: W.sun(W.sun_rows(image(9, 13)[..., 0]), 13, 9, 8)[:100], "ras"),
    "sun_rle_truncated": (lambda: W.sun(W.sun_rle(flat(9, 13).tobytes()), 13, 9, 24, 2)[:80],
                          "ras"),
    "sun_depth16": (lambda: W.sun(bytes(300), 13, 9, 16), "ras"),
    "sun_map_type2": (lambda: W.sun(bytes(300), 13, 9, 8, colormap=bytes(30), map_type=2), "ras"),
    "sun_map_too_long": (lambda: W.sun(bytes(300), 13, 9, 8, colormap=bytes(1200)), "ras"),
    "sun_file_type6": (lambda: W.sun(bytes(300), 13, 9, 8, 6), "ras"),
    "sun_map_on_24bit": (lambda: W.sun(bytes(400), 13, 9, 24, colormap=bytes(30)), "ras"),
    "sun_map_on_1bit": (lambda: W.sun(bytes(400), 13, 9, 1, colormap=bytes(30)), "ras"),
    "im_rlb": (lambda: W.im("RLB image", 13, 9, bytes(400)), "im"),
    "im_pa_without_lut": (lambda: W.im("PA image", 13, 9, bytes(400)), "im"),
    "im_truncated": (lambda: W.im("RGB image", 13, 9, bytes(200)), "im"),
    "im_size_float": (lambda: W.im("Greyscale image", 4.5, 9, bytes(200)), "im"),
    "im_size_text": (lambda: W.im("Greyscale image", "abc", 9, bytes(200)), "im"),
    "im_size_three": (lambda: W.im("Greyscale image", "4*3", 9, bytes(200)), "im"),
    "msp_table_cut": (lambda: W.msp(bits(9, 13), 2)[:40], "msp"),
    "msp_row_cut": (lambda: W.msp(bits(9, 13), 2)[:-3], "msp"),
    "msp_run_cut": (lambda: (lambda d: d[:32] + struct.pack("<H", 2) + b"\x00\x05")(
        W.msp(bits(1, 13), 2)), "msp"),
    "msp_too_few_bytes": (lambda: (lambda d: d[:32] + struct.pack("<9H", *([1] * 9)) + b"\x00"
                                   * 9)(W.msp(bits(9, 13), 2)), "msp"),
    "msp_v1_truncated": (lambda: W.msp(bits(9, 13), 1)[:40], "msp"),
    "msp_bad_checksum": (lambda: (lambda d: d[:10] + b"\x07" + d[11:])(W.msp(bits(9, 13), 1)),
                         "msp"),
    "xbm_truncated": (lambda: W.xbm(bits(9, 13))[:-60], "xbm"),
    "xbm_x_at_end": (lambda: (lambda d: d[:d.rindex(b"0x") + 2])(W.xbm(bits(9, 13))), "xbm"),
    "xbm_x10_wide": (lambda: W.xbm(bits(9, 13), x10=True), "xbm"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refusals_dropped(tmp_path, case, caplog):
    make, ext = REFUSED[case]
    dropped_with_one_warning(tmp_path, make(), f"r.{ext}", caplog)


# --- the files PIL opens and cannot load (F13) -------------------------------

STUB_FILES = {
    "bufr": (lambda: b"BUFR" + bytes(60), "BUFR"),
    "bufr_zczc": (lambda: b"ZCZC" + bytes(60), "BUFR"),
    "grib": (lambda: b"GRIB\0\0\0\x01" + bytes(60), "GRIB"),
    "hdf5": (lambda: b"\x89HDF\r\n\x1a\n" + bytes(60), "HDF5"),
    "mpeg": (lambda: b"\x00\x00\x01\xb3" + bytes([0x14, 0x00, 0xF0]) + bytes(60), "MPEG"),
    "wmf_placeable": (lambda: struct.pack("<IHhhhhHIH", 0x9AC6CDD7, 0, 0, 0, 640, 480, 96, 0, 0)
                      + b"\x01\x00\t\x00" + bytes(60), "WMF"),
    "emf": (lambda: struct.pack("<II8i", 1, 88, 0, 0, 99, 49, 0, 0, 2540, 1270) + b" EMF"
            + bytes(60), "WMF"),
}


@pytest.mark.parametrize("case", sorted(STUB_FILES))
def test_stub_files_dropped_as_jax(tmp_path, case, caplog):
    """PIL opens these as images it has no loader for (``convert("RGB")``
    raises): JAX's reader drops them, and so does the port, with one
    warning, where it raised ``ValueError`` before."""
    make, fmt = STUB_FILES[case]
    data = make()
    path = tmp_path / "s.bin"
    path.write_bytes(data)
    assert Image.open(str(path)).format == fmt and pil_format(data) == fmt
    assert sniff(data) is None
    dropped_with_one_warning(tmp_path, data, "s.bin", caplog)


EPS = (b"%!PS-Adobe-3.0 EPSF-3.0\n%%BoundingBox: 0 0 13 9\n%%EndComments\n"
       b"0 0 moveto 13 9 lineto stroke\nshowpage\n%%EOF\n")


def test_eps_without_ghostscript_dropped(tmp_path, caplog, monkeypatch):
    """Without Ghostscript PIL opens an EPS file and cannot load it: JAX
    drops it, and so does the port where ``shutil.which("gs")`` finds none."""
    assert Image.open(io.BytesIO(EPS)).format == "EPS" and pil_format(EPS) == "EPS"
    monkeypatch.setattr(image_io.shutil, "which", lambda name: None)
    dropped_with_one_warning(tmp_path, EPS, "a.eps", caplog)


def test_eps_with_ghostscript_raises_naming_it(tmp_path, monkeypatch):
    """Where Ghostscript is installed PIL rasterises EPS; the port cannot,
    and raises ``ValueError`` naming EPS and Ghostscript."""
    monkeypatch.setattr(image_io.shutil, "which", lambda name: f"/usr/bin/{name}")
    path = tmp_path / "a.eps"
    path.write_bytes(EPS)
    with pytest.raises(ValueError, match="EPS.*Ghostscript") as info:
        read_image(str(path))
    assert not isinstance(info.value, CorruptImage)


def _iptc() -> bytes:
    def field(record, tag, value):
        return b"\x1c" + bytes([record, tag]) + struct.pack(">H", len(value)) + value
    return (field(3, 60, b"\x01\x00") + field(3, 20, b"\x00\x04") + field(3, 30, b"\x00\x02")
            + field(3, 120, b"\x01") + field(8, 10, bytes(range(10, 90, 10))))


def _spider() -> bytes:
    t = [0.0] * 27
    t[0], t[1], t[4], t[11] = 1, 3, 1, 5  # slices, rows, 2-D image, columns
    t[12], t[21], t[22] = 52, 1040, 20  # header records, bytes, record bytes
    return struct.pack(">27f", *t) + bytes(1040 - 108) + (np.arange(15, dtype=">f4") * 9).tobytes()


OTHER_FORMATS = {
    "XPM": b'/* XPM */\nstatic char *x[] = {\n"2 1 1 1",\n"a c #ff0000",\n"aa"};\n',
    "IMT": b"width 4\nheight 2\npixel n8\n\x0c" + bytes(8),
    "XVThumb": b"P7 332\n#XVVERSION\n#END_OF_COMMENTS\n4 2 255\n" + bytes(range(8)),
    "IPTC": _iptc(),
    "SPIDER": _spider(),
}


@pytest.mark.parametrize("fmt", sorted(OTHER_FORMATS))
def test_formats_pil_reads_are_named(tmp_path, fmt):
    """Formats PIL reads and the port does not yet, which ``Image.open``
    reaches by the plugin order (IMT, IPTC and SPIDER have no accept test
    and come before TGA; XPM and XVThumb after it, an XVThumb file starting
    as a PAM does): ``read_image`` raises ``ValueError`` naming the format
    (before, "another format", or for XVThumb a dropped PAM)."""
    data = OTHER_FORMATS[fmt]
    path = tmp_path / "a.img"
    path.write_bytes(data)
    assert Image.open(str(path)).format == fmt and pil_format(data) == fmt
    assert jax_read_image(str(path)) is not None
    with pytest.raises(ValueError, match=fmt) as info:
        read_image(str(path))
    assert not isinstance(info.value, CorruptImage)


def test_pcd_header_claims_its_place():
    """PIL's PCD plugin, which has no accept test, takes a file with
    "PCD_" at byte 2048 before the plugins after it in the order."""
    data = bytes(2048) + b"PCD_" + bytes(1600)
    assert Image.open(io.BytesIO(data)).format == "PCD" and pil_format(data) == "PCD"
    assert sniff(data) is None


# --- the plugin order --------------------------------------------------------

def _all_fixtures():
    from test_torch_image_containers import BMP_FORMS, GIF_FORMS
    from test_torch_tiff import FORMS as TIFF_FORMS

    h, w = 9, 23
    out = {}
    for prefix, forms in (("qoi", QOI_FORMS), ("pcx", PCX_FORMS), ("dcx", DCX_FORMS),
                          ("sgi", SGI_FORMS), ("sun", SUN_FORMS), ("im", IM_FORMS),
                          ("msp", MSP_FORMS), ("xbm", XBM_FORMS), ("netpbm", NETPBM_FORMS),
                          ("tga", TGA_FORMS), ("ico", ICO_FORMS), ("tiff", TIFF_FORMS)):
        for name, make in forms.items():
            out[f"{prefix}_{name}"] = lambda m=make: m(h, w)
    for prefix, forms in (("bmp", BMP_FORMS), ("gif", GIF_FORMS)):
        for name, make in forms.items():
            out[f"{prefix}_{name}"] = lambda m=make: m(image(h, w))
    for case, (make, _) in REFUSED.items():
        out[f"refused_{case}"] = make
    for fmt in ("JPEG", "PNG", "WEBP"):
        out[f"pil_{fmt.lower()}"] = lambda f=fmt: pil_bytes(image(h, w), f)
    return out


FIXTURES = _all_fixtures()


@pytest.mark.parametrize("case", sorted(FIXTURES))
def test_sniff_names_pils_plugin(tmp_path, case):
    """``pil_format`` names the plugin ``Image.open(f).format`` names, and
    ``sniff`` gives the port's container of it, for every fixture PIL
    opens; where ``Image.open`` raises, ``pil_format`` finds no plugin or
    raises ``CorruptImage``."""
    data = FIXTURES[case]()
    path = tmp_path / "f.bin"
    path.write_bytes(data)
    try:
        fmt = Image.open(str(path)).format
    except Exception:
        fmt = None
    if fmt is None:
        try:
            assert pil_format(data) is None
        except CorruptImage:
            pass
        return
    assert pil_format(data) == fmt
    assert sniff(data) == KIND[fmt]


# --- writers -----------------------------------------------------------------

@pytest.mark.parametrize("channels", (1, 3))
@pytest.mark.parametrize("size", SIZES, ids=size_id)
@pytest.mark.parametrize("ext", (".qoi", ".pcx", ".sgi", ".rgb", ".rgba", ".bw", ".im"))
def test_write_image_is_pils_bytes(tmp_path, ext, size, channels):
    """PIL's bytes under the same name (SGI and IM write it into their
    header); QOI refuses gray as PIL does."""
    img = image(*size)
    img = img[..., 0] if channels == 1 else img
    path = tmp_path / f"written{ext}"
    if ext == ".qoi" and channels == 1:
        with pytest.raises(ValueError, match="Unsupported QOI image mode"):
            Image.fromarray(img).save(path)
        with pytest.raises(ValueError, match="QOI"):
            write_image(str(path), img)
        return
    Image.fromarray(img).save(path)
    want = path.read_bytes()
    path.unlink()
    write_image(str(path), img)
    assert path.read_bytes() == want
    got, pil = read_image(str(path)), jax_read_image(str(path))
    assert (got is None) == (pil is None)  # PIL's 1x1 RGB PCX is cut short (PIL_REFUSES)
    if pil is not None:
        np.testing.assert_array_equal(got, pil)


@pytest.mark.parametrize("ext", (".ras", ".dcx", ".msp", ".xbm"))
def test_write_image_raises_where_pil_cannot(tmp_path, ext):
    """The port reads these and PIL cannot write them from a gray or RGB
    image: ``write_image`` raises ``ValueError`` with PIL's reason and
    writes nothing."""
    img = image(9, 13)
    with pytest.raises((KeyError, OSError)):
        Image.fromarray(img).save(tmp_path / f"pil{ext}")
    path = tmp_path / f"w{ext}"
    with pytest.raises(ValueError, match="PIL") as info:
        write_image(str(path), img)
    assert ext in str(info.value) and not path.exists()


# --- the mapper --------------------------------------------------------------

@pytest.mark.parametrize("is_train", [True, False])
def test_mapper_keeps_and_drops_what_jax_does(tmp_path, is_train):
    """JAX's ``DatasetMapperDETR`` and the port's over records of each new
    format, a refused file of each, and the stub files: the same records
    kept with the same arrays, the seeded draws in step."""
    js, root = write_dataset(tmp_path / "coco", n=8, seed=13)
    dicts = load_coco_json(js, root)
    makers = [(QOI_FORMS["pil_rgb"], ".qoi"), (PCX_FORMS["pil_RGB"], ".pcx"),
              (DCX_FORMS["two_pages_rgb_first"], ".dcx"), (SGI_FORMS["rle_z3_bpc1"], ".sgi"),
              (SUN_FORMS["rle24_across_rows"], ".ras"), (IM_FORMS["pil_RGB"], ".im"),
              (MSP_FORMS["v2"], ".msp"), (XBM_FORMS["x11"], ".xbm")]
    records = []
    for d, (make, ext) in zip(dicts, makers):
        path = d["file_name"][:-4] + ext
        open(path, "wb").write(make(d["height"], d["width"]))
        records.append(dict(d, file_name=path))
    extra = [(REFUSED[c][0](), c) for c in ("qoi_cut", "pcx_run_past_line", "sgi_bad_mode",
                                            "sun_map_on_24bit", "im_truncated", "msp_row_cut")]
    extra += [(STUB_FILES[c][0](), c) for c in sorted(STUB_FILES)]
    for i, (data, name) in enumerate(extra):
        path = tmp_path / f"{name}.img"
        path.write_bytes(data)
        records.insert(i % len(records), dict(dicts[i % len(dicts)], file_name=str(path),
                                              image_id=900 + i))
    kw = dict(is_train=is_train, image_size=96, max_gt=6, mask_size=24, seed=7)
    port, jax_ = DatasetMapperDETR(**kw), j_mapper.DatasetMapperDETR(**kw)
    kept = []
    for r in records:
        got, want = port(r), jax_(r)
        assert (got is None) == (want is None), r["file_name"]
        if want is not None:
            _same_example(got, want)
            kept.append(r["image_id"])
    assert sorted(kept) == sorted(d["image_id"] for d in dicts)


def test_import_closure_without_pil(tmp_path):
    """In an interpreter that refuses PIL, jax and the JAX package, the new
    readers and writers import and run: each writer's file reads back to
    its pixels, and a BUFR file is dropped."""
    import subprocess
    import sys
    import textwrap

    code = textwrap.dedent(f"""
        import sys
        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "flax", "PIL", "ape_tpu"):
                    raise ImportError("refused: " + name)
        sys.meta_path.insert(0, Refuse())
        import numpy as np
        from ape_tpu_torch.data.image_io import read_image, read_rgb, write_image
        img = (np.arange(9 * 13 * 3) % 251).astype(np.uint8).reshape(9, 13, 3)
        for ext in (".qoi", ".pcx", ".sgi", ".im"):
            path = {str(tmp_path)!r} + "/w" + ext
            write_image(path, img)
            assert (read_rgb(path) == img).all(), ext
        path = {str(tmp_path)!r} + "/s.bufr"
        open(path, "wb").write(b"BUFR" + bytes(40))
        assert read_image(path) is None
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]
