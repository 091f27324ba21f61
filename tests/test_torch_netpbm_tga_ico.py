"""The port's Netpbm, TGA and ICO readers and its TIFF, Netpbm and TGA
writers held to PIL 12.1 on the CPU: every form decodes to JAX's
``read_image`` pixels bit for bit and ``read_label_map`` equals
``np.asarray(Image.open(f))``; a file PIL refuses is dropped with one
warning; ``write_image`` writes PIL's bytes; the mapper keeps and drops
what JAX's keeps and drops.

* Netpbm: P1-P6 plain and raw, comments in the header and the data,
  maxvals below 255 (scaled), 256-65534 and 65535 (16-bit, mode "I" for
  gray), Pf both byte orders, PIL's P0CMYK/PyRGBA/PyCMYK; P7 PAM and PF,
  which PIL 12.1 does not open, are dropped;
* TGA: colour-mapped (16-, 24- and 32-bit maps, a first index past 0),
  true colour at 15/16, 24 and 32 bits, gray at 1, 8 and 16 bits, raw and
  RLE (packets that run past a row), the four origins, an ID field; a
  header another plugin claims first is not read as TGA;
* ICO: PNG and DIB entries (1-, 4-, 8-, 24- and 32-bit, the AND mask), the
  entry PIL picks among several sizes and depths.
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
from ape_tpu_torch.data.datasets.coco import load_coco_json
from ape_tpu_torch.data.image_io import (CorruptImage, read_image, read_label_map, read_rgb,
                                         sniff, write_image)
from ape_tpu_torch.data.mapper import DatasetMapperDETR
from test_torch_data import _same_example, write_dataset
from test_torch_image_forms import image, size_id

SIZES = ((1, 1), (7, 5), (23, 9), (37, 53))


def pil_bytes(arr, fmt, mode=None, **kw) -> bytes:
    im = Image.fromarray(arr) if mode is None else Image.fromarray(arr).convert(mode)
    b = io.BytesIO()
    im.save(b, fmt, **kw)
    return b.getvalue()


def same_as_jax(tmp_path, data: bytes, name: str):
    """``read_image`` equals JAX's reader (PIL's ``convert("RGB")``) and
    ``read_label_map`` equals ``np.asarray(Image.open(f))``; returns JAX's
    pixels or None."""
    path = tmp_path / name
    path.write_bytes(data)
    want = jax_read_image(str(path))
    got = read_image(str(path))
    assert (got is None) == (want is None), ("PIL", want is not None, "port", got is not None)
    if want is not None:
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        samples = np.asarray(Image.open(str(path)))
        label = read_label_map(str(path))
        assert label.dtype == samples.dtype and label.shape == samples.shape
        np.testing.assert_array_equal(label, samples)
    return want


def dropped_with_one_warning(tmp_path, data: bytes, name: str, caplog):
    path = tmp_path / name
    path.write_bytes(data)
    assert jax_read_image(str(path)) is None, "PIL decodes the file"
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="ape_tpu_torch"):
        assert read_image(str(path)) is None
    assert len([r for r in caplog.records if r.name == "ape_tpu_torch"]) == 1
    with pytest.raises(CorruptImage):
        read_rgb(str(path))


# --- Netpbm ------------------------------------------------------------------

def pnm(magic: bytes, w: int, h: int, body: bytes, maxval=None, head=b"") -> bytes:
    out = magic + b"\n" + head + b"%d %d\n" % (w, h)
    if maxval is not None:
        out += b"%d\n" % maxval if isinstance(maxval, int) else maxval + b"\n"
    return out + body


def plain(values: np.ndarray, per_line: int = 7, comment: bool = True) -> bytes:
    tokens = [str(int(v)).encode() for v in values.reshape(-1)]
    lines = [b" ".join(tokens[i:i + per_line]) for i in range(0, len(tokens), per_line)]
    if comment and len(lines) > 2:
        lines.insert(2, b"# a comment in the data\r")
    return b"\n".join(lines) + b"\n"


def _netpbm_forms():
    forms = {}
    for mode in ("1", "L", "RGB", "I;16", "F"):
        def make(h, w, m=mode):
            img = image(h, w)
            arr = {"1": img[..., 0] > 100, "L": img[..., 1], "RGB": img,
                   "I;16": img[..., 0].astype(np.uint16) * 257,
                   "F": img[..., 2].astype(np.float32) / 7}[m]
            return pil_bytes(arr, "PPM")
        forms[f"pil_{mode}"] = make
    bits = lambda h, w: (image(h, w)[..., 0] > 128).astype(np.uint8)  # noqa: E731
    forms["p1"] = lambda h, w: pnm(b"P1", w, h, plain(bits(h, w), 40), head=b"# c\n")
    forms["p1_packed"] = lambda h, w: pnm(b"P1", w, h, b"".join(
        b"%d" % v for v in bits(h, w).reshape(-1)) + b"\n")
    forms["p4"] = lambda h, w: pnm(b"P4", w, h, np.packbits(bits(h, w), axis=1).tobytes())
    for magic, ch in ((b"P2", 1), (b"P3", 3)):
        for maxval in (1, 15, 100, 255, 1000, 65535):
            forms[f"{magic.decode()}_max{maxval}"] = lambda h, w, m=magic, c=ch, mv=maxval: pnm(
                m, w, h, plain(image(h, w)[..., :c].astype(np.int64) * mv // 255), mv,
                head=b"# made for the test\n# two lines\n")
    for magic, ch in ((b"P5", 1), (b"P6", 3)):
        for maxval in (1, 100, 255, 256, 4095, 65535):
            def make(h, w, m=magic, c=ch, mv=maxval):
                v = image(h, w)[..., :c].astype(np.int64) * mv // 255
                body = v.astype(np.uint8 if mv < 256 else ">u2").tobytes()
                return pnm(m, w, h, body, mv)
            forms[f"{magic.decode()}_max{maxval}"] = make
    forms["p6_comments_tabs"] = lambda h, w: (b"P6\t#c1\n%d\t#c2\r%d # c3\n255\n" % (w, h)
                                              + image(h, w).tobytes())
    forms["pf_big_endian"] = lambda h, w: pnm(
        b"Pf", w, h, (image(h, w)[..., 0].astype(">f4") * 1.5 - 9).tobytes(), b"1.0")
    forms["pf_little_endian"] = lambda h, w: pnm(
        b"Pf", w, h, (image(h, w)[..., 1].astype("<f4") - 100).tobytes(), b"-2.5")
    forms["p0cmyk"] = lambda h, w: b"P0CMYK %d %d 255\n" % (w, h) + image(h, w, 1, 4).tobytes()
    forms["pyrgba"] = lambda h, w: b"PyRGBA %d %d 255\n" % (w, h) + image(h, w, 2, 4).tobytes()
    forms["pycmyk_max200"] = lambda h, w: b"PyCMYK %d %d 200\n" % (w, h) + (
        image(h, w, 3, 4).astype(np.int64) * 200 // 255).astype(np.uint8).tobytes()
    return forms


NETPBM_FORMS = _netpbm_forms()


@pytest.mark.parametrize("size", SIZES, ids=size_id)
@pytest.mark.parametrize("form", sorted(NETPBM_FORMS))
def test_netpbm_equals_jax(tmp_path, form, size):
    data = NETPBM_FORMS[form](*size)
    assert sniff(data) == "netpbm"
    assert same_as_jax(tmp_path, data, "a.ppm") is not None


NETPBM_REFUSED = {
    "pam": lambda: b"P7\nWIDTH 4\nHEIGHT 2\nDEPTH 4\nMAXVAL 255\nTUPLTYPE RGB_ALPHA\nENDHDR\n"
                   + bytes(32),
    "pf_upper": lambda: b"PF\n2 2\n-1.0\n" + bytes(48),
    "bad_magic": lambda: b"P61 4 4 255\n" + bytes(48),
    "missing_token": lambda: b"P6\n4 4\n",
    "long_token": lambda: b"P5\n4 123456789012\n255\n",
    "text_token": lambda: b"P5\n4 x4\n255\n" + bytes(16),
    "maxval_0": lambda: b"P5\n4 4\n0\n" + bytes(16),
    "maxval_65536": lambda: b"P5\n4 4\n65536\n" + bytes(32),
    "zero_width": lambda: b"P5\n0 4\n255\n",
    "truncated_raw": lambda: b"P6\n4 4\n255\n" + bytes(40),
    "truncated_scaled": lambda: b"P6\n4 4\n100\n" + bytes(40),
    "truncated_plain": lambda: b"P2\n4 4\n255\n" + b"1 2 3\n",
    "sample_past_maxval": lambda: b"P2\n2 2\n10\n1 2 11 3\n",
    "negative_sample": lambda: b"P2\n2 2\n10\n1 -2 1 3\n",
    "bad_p1_token": lambda: b"P1\n2 2\n0 1 2 0\n",
    "pf_scale_0": lambda: b"Pf\n2 2\n0.0\n" + bytes(16),
}


@pytest.mark.parametrize("case", sorted(NETPBM_REFUSED))
def test_netpbm_refusals_dropped(tmp_path, case, caplog):
    dropped_with_one_warning(tmp_path, NETPBM_REFUSED[case](), "r.ppm", caplog)


# --- TGA ---------------------------------------------------------------------

def flat(h, w, seed=0, channels=3):
    """Blocky colors: runs for the RLE packets."""
    img = image(h, w, seed, channels)
    return (img // 64 * 64).astype(np.uint8)


def _tga_forms():
    forms = {}
    for mode in ("L", "LA", "P", "RGB", "RGBA", "1"):
        for rle_ in (False, True) if mode != "1" else (False,):
            def make(h, w, m=mode, r=rle_):
                img = flat(h, w)
                im = Image.fromarray(img).convert(m) if m != "P" else Image.fromarray(img).convert(
                    "P", palette=Image.Palette.ADAPTIVE, colors=20)
                b = io.BytesIO()
                im.save(b, "TGA", rle=r)
                return b.getvalue()
            forms[f"pil_{mode}_{'rle' if rle_ else 'raw'}"] = make
    for flags in (0x00, 0x10, 0x20, 0x30):
        for depth in (24, 32):
            forms[f"truecolor{depth}_flags{flags:02x}"] = lambda h, w, f=flags, d=depth: W.tga(
                image(h, w, 1, d // 8)[..., [2, 1, 0, 3][:d // 8]].tobytes(), w, h, 2, d, f)
    for cross in (False, True):
        for depth in (16, 24, 32):
            def make(h, w, c=cross, d=depth):
                if d == 16:
                    px = (flat(h, w)[..., 0].astype(np.uint16) * 131 | 0x8000 * (
                        flat(h, w)[..., 1] > 100)).astype("<u2").view(np.uint8).reshape(h, -1)
                else:
                    px = flat(h, w, 2, d // 8).reshape(h, -1)
                return W.tga(W.tga_rle(px, d // 8, c), w, h, 10, d, 0x20 if c else 0)
            forms[f"rle{depth}{'_cross' if cross else ''}"] = make
    forms["truecolor16_raw"] = lambda h, w: W.tga(
        (image(h, w)[..., 0].astype(np.uint16) * 257).astype("<u2").tobytes(), w, h, 2, 16)
    for cm_depth in (16, 24):
        for start in (0, 5):
            def make(h, w, d=cm_depth, s=start):
                n = 40
                cmap = np.random.RandomState(d).randint(0, 256, (n, d // 8)).astype(np.uint8)
                idx = (image(h, w)[..., 0].astype(np.int64) * (n - 1) // 255 + s).astype(np.uint8)
                return W.tga(idx.tobytes(), w, h, 1, 8, 0, cmap.tobytes(), s, n, d,
                           ident=b"an ID field")
            forms[f"colormap{cm_depth}_start{start}"] = make
    forms["colormap_rle"] = lambda h, w: W.tga(
        W.tga_rle((flat(h, w)[..., 0] // 64).reshape(h, -1), 1), w, h, 9, 8, 0x20,
        bytes(range(12)), 0, 4, 24)
    forms["gray_la_rle_cross"] = lambda h, w: W.tga(W.tga_rle(flat(h, w)[..., 1:3].reshape(h, -1), 2,
                                                      True), w, h, 11, 16)
    forms["gray16_la"] = lambda h, w: W.tga(image(h, w)[..., :2].tobytes(), w, h, 3, 16, 0x30)
    forms["gray_footer"] = lambda h, w: W.tga(image(h, w)[..., 2].tobytes(), w, h, 3, 8,
                                            footer=True)
    return forms


TGA_FORMS = _tga_forms()


@pytest.mark.parametrize("size", SIZES, ids=size_id)
@pytest.mark.parametrize("form", sorted(TGA_FORMS))
def test_tga_equals_jax(tmp_path, form, size):
    data = TGA_FORMS[form](*size)
    assert sniff(data) == "tga"
    assert same_as_jax(tmp_path, data, "a.tga") is not None


TGA_REFUSED = {
    "truncated_raw": lambda: W.tga(image(9, 13).tobytes()[:200], 13, 9, 2, 24),
    "truncated_rle": lambda: W.tga(W.tga_rle(flat(9, 13).reshape(9, -1), 3)[:60], 13, 9, 10, 24),
    "map_depth_8": lambda: W.tga(bytes(117), 13, 9, 1, 8, 0, bytes(16), 0, 16, 8),
    "type_1_depth_16": lambda: W.tga(bytes(234), 13, 9, 1, 16, 0, bytes(48), 0, 16, 24),
    "type_1_without_map": lambda: W.tga(bytes(117), 13, 9, 1, 8),
    "map_depth_32": lambda: W.tga(bytes(117), 13, 9, 1, 8, 0, bytes(64), 0, 16, 32),
    "gray_rle_past_a_row": lambda: W.tga(bytes([0x80 | 9, 7, 0x80 | 24, 9]), 7, 5, 11, 8),
    "gray_literal_past_a_row": lambda: W.tga(bytes([9]) + bytes(range(10)) + bytes(40), 7, 5, 11,
                                           8),
    "rgb_run_past_a_row": lambda: W.tga(bytes([0x80 | 9, 1, 2, 3]) + bytes(100), 4, 3, 10, 24),
    "pil_1_rle": lambda: pil_bytes(image(5, 7)[..., 0] > 100, "TGA", rle=True),
}


@pytest.mark.parametrize("case", sorted(TGA_REFUSED))
def test_tga_refusals_dropped(tmp_path, case, caplog):
    dropped_with_one_warning(tmp_path, TGA_REFUSED[case](), "r.tga", caplog)


def test_tga_header_claimed_first_is_not_tga(tmp_path):
    """A Windows cursor whose first bytes also pass TGA's header checks (00
    00 02 00; a hotspot, a size whose third byte is 1, TGA's depth): PIL
    opens it as CUR, a plugin it tries before TGA's; the port does not read
    it as TGA, and names CUR."""
    dib = W.dib_entry(image(9, 13), 24, np.zeros((9, 13), np.uint8))
    data = struct.pack("<HHHBBBBHHII", 0, 2, 1, 13, 9, 0, 0, 0, 1, 0x10000 | len(dib), 22) + dib
    from ape_tpu_torch.data.tga import accept as tga_accept

    assert tga_accept(data) and sniff(data) is None
    path = tmp_path / "a.tga"
    path.write_bytes(data)
    assert Image.open(str(path)).format == "CUR"
    with pytest.raises(ValueError, match="CUR"):
        read_image(str(path))


def test_tga_header_cur_passes_over_is_tga(tmp_path):
    """A true-colour TGA with a colour-map length but no map starts as a CUR
    file does; PIL's CUR plugin then runs out of entries and passes it on,
    and TGA reads it: so does the port."""
    data = W.tga(image(9, 13).tobytes(), 13, 9, 2, 24)
    data = data[:5] + b"\x03" + data[6:]  # colour-map length 3, colour-map type still 0
    assert data.startswith(b"\0\0\2\0") and sniff(data) == "tga"
    assert same_as_jax(tmp_path, data, "a.tga") is not None


def test_unknown_format_raises_naming_it(tmp_path):
    path = tmp_path / "a.tga"
    path.write_bytes(b"\xde\xad\xbe\xef" + bytes(40))
    with pytest.raises(ValueError, match="another format") as info:
        read_image(str(path))
    assert not isinstance(info.value, CorruptImage)


# --- ICO ---------------------------------------------------------------------

def bgra(h, w):
    """32-bit DIB pixels: B, G, R, A little-endian in one word."""
    v = image(h, w, 0, 4).astype(np.uint32)
    return v[..., 2] | v[..., 1] << 8 | v[..., 0] << 16 | v[..., 3] << 24


def png_payload(img: np.ndarray) -> bytes:
    b = io.BytesIO()
    Image.fromarray(img).save(b, "PNG")
    return b.getvalue()


def _ico_forms():
    forms = {}
    for mode in ("RGBA", "RGB", "P", "L"):
        for fmt in ("png", "bmp"):
            def make(h, w, m=mode, f=fmt):
                img = image(h, w, 0, 4)
                im = Image.fromarray(img).convert(m) if m != "P" else Image.fromarray(
                    img[..., :3]).convert("P", palette=Image.Palette.ADAPTIVE, colors=30)
                b = io.BytesIO()
                im.save(b, "ICO", sizes=[(w, h)], bitmap_format=f)
                return b.getvalue()
            forms[f"pil_{mode}_{fmt}"] = make
    mask = lambda h, w: (image(h, w)[..., 1] > 150).astype(np.uint8)  # noqa: E731
    for bits in (1, 4, 8):
        def make(h, w, b=bits):
            idx = (image(h, w)[..., 0] >> (8 - b)).astype(np.uint8)
            pal = np.random.RandomState(b).randint(0, 256, (1 << b, 3)).astype(np.uint8)
            return W.ico([(W.dib_entry(idx, b, mask(h, w), pal), (w, h), b, 0)])
        forms[f"dib{bits}"] = make
    forms["dib24"] = lambda h, w: W.ico([(W.dib_entry(image(h, w), 24, mask(h, w)), (w, h), 24, 0)])
    forms["dib32"] = lambda h, w: W.ico([(W.dib_entry(bgra(h, w), 32, mask(h, w)), (w, h), 32, 0)])
    forms["png_rgba"] = lambda h, w: W.ico([(png_payload(image(h, w, 0, 4)), (w, h), 32, 0)])
    # PIL's pick: the largest area, then the fewest bits
    forms["pick_largest"] = lambda h, w: W.ico([
        (png_payload(image(3, 4)), (4, 3), 32, 0),
        (png_payload(image(h, w, 1)), (w, h), 24, 0)])
    forms["pick_fewest_bits"] = lambda h, w: W.ico([
        (W.dib_entry(bgra(h, w), 32, mask(h, w)), (w, h), 32, 0),
        (W.dib_entry(image(h, w, 2), 24, mask(h, w)), (w, h), 24, 0)])
    forms["bpp_from_colors"] = lambda h, w: W.ico([
        (W.dib_entry((image(h, w)[..., 0] >> 4).astype(np.uint8), 4, mask(h, w),
                   np.random.RandomState(1).randint(0, 256, (16, 3)).astype(np.uint8)),
         (w, h), 0, 16),
        (W.dib_entry(image(h, w, 3), 24, mask(h, w)), (w, h), 24, 0)])
    forms["png_size_not_the_directorys"] = lambda h, w: W.ico([
        (png_payload(image(h, w)), (w + 1, h + 2), 32, 0)])
    return forms


ICO_FORMS = _ico_forms()


@pytest.mark.parametrize("size", SIZES, ids=size_id)
@pytest.mark.parametrize("form", sorted(ICO_FORMS))
def test_ico_equals_jax(tmp_path, form, size):
    data = ICO_FORMS[form](*size)
    assert sniff(data) == "ico"
    assert same_as_jax(tmp_path, data, "a.ico") is not None


ICO_REFUSED = {
    "no_entries": lambda: W.ico([]),
    "mask_cut": lambda: W.ico([(W.dib_entry(image(9, 13), 24, np.zeros((9, 13), np.uint8)),
                              (13, 9), 24, 0)])[:-20],
    "entry_past_end": lambda: W.ico([(png_payload(image(9, 13)), (13, 9), 32, 0)])[:30],
}


@pytest.mark.parametrize("case", sorted(ICO_REFUSED))
def test_ico_refusals_dropped(tmp_path, case, caplog):
    dropped_with_one_warning(tmp_path, ICO_REFUSED[case](), "r.ico", caplog)


# --- writers -----------------------------------------------------------------

@pytest.mark.parametrize("channels", (1, 3))
@pytest.mark.parametrize("size", SIZES, ids=size_id)
@pytest.mark.parametrize("ext", (".ppm", ".pgm", ".pbm", ".pnm", ".tga"))
def test_write_image_is_pils_bytes(tmp_path, ext, size, channels):
    img = image(*size)
    img = img[..., 0] if channels == 1 else img
    path = tmp_path / f"w{ext}"
    write_image(str(path), img)
    want = io.BytesIO()
    Image.fromarray(img).save(want, Image.registered_extensions()[ext])
    assert path.read_bytes() == want.getvalue()
    np.testing.assert_array_equal(read_label_map(str(path)), img)


@pytest.mark.parametrize("ext", (".ico", ".webp", ".gif"))
def test_write_image_raises_naming_the_format(tmp_path, ext):
    """An array the format cannot hold raises ``ValueError`` naming the
    format's encoder and writes nothing; a uint8 image writes a file PIL
    opens (17 x 19: an ICO of a side below 16 holds no frame)."""
    with pytest.raises(ValueError, match=f"encode_{ext[1:]}"):
        write_image(str(tmp_path / f"w{ext}"), np.zeros((9, 13, 2), np.uint8))
    assert not (tmp_path / f"w{ext}").exists()
    write_image(str(tmp_path / f"w{ext}"), image(17, 19))
    Image.open(tmp_path / f"w{ext}").load()


# --- the mapper --------------------------------------------------------------

@pytest.mark.parametrize("is_train", [True, False])
def test_mapper_keeps_and_drops_what_jax_does(tmp_path, is_train):
    """JAX's ``DatasetMapperDETR`` and the port's over records of TIFF,
    Netpbm, TGA and ICO images, a TIFF PIL refuses and a PAM file: the same
    records kept with the same arrays, the seeded draws in step."""
    from test_torch_tiff import FORMS as TIFF_FORMS

    js, root = write_dataset(tmp_path / "coco", n=6, seed=11)
    dicts = load_coco_json(js, root)
    makers = [(TIFF_FORMS["jpeg_ycbcr_420"], ".tif"), (TIFF_FORMS["ii_lzw_rgb_pred2"], ".tif"),
              (NETPBM_FORMS["P6_max255"], ".ppm"), (TGA_FORMS["rle24"], ".tga"),
              (ICO_FORMS["dib32"], ".ico"), (TIFF_FORMS["g3_2d_ph0"], ".tiff")]
    records = []
    for d, (make, ext) in zip(dicts, makers):
        path = d["file_name"][:-4] + ext
        open(path, "wb").write(make(d["height"], d["width"]))
        records.append(dict(d, file_name=path))
    refused = tmp_path / "refused.tif"
    refused.write_bytes(W.tiff(image(30, 40), rows_per_strip=10)[:2000])
    pam = tmp_path / "pam.ppm"
    pam.write_bytes(NETPBM_REFUSED["pam"]())
    records.insert(2, dict(dicts[0], file_name=str(refused), image_id=900))
    records.append(dict(dicts[1], file_name=str(pam), image_id=901))
    kw = dict(is_train=is_train, image_size=96, max_gt=6, mask_size=24, seed=5)
    port, jax_ = DatasetMapperDETR(**kw), j_mapper.DatasetMapperDETR(**kw)
    kept = []
    for r in records:
        got, want = port(r), jax_(r)
        assert (got is None) == (want is None), r["file_name"]
        if want is not None:
            _same_example(got, want)
            kept.append(r["image_id"])
    assert sorted(kept) == sorted(d["image_id"] for d in dicts)
