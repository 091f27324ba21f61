"""The port's JPEG codec (``ape_tpu_torch/data/jpeg.py`` over
``csrc/jpeg_host.cpp``) and ``image_io`` against PIL and JAX's reader on the
CPU:

* ``read_image`` equal to JAX's ``ape_tpu.data.mapper.read_image`` (PIL 12.1
  on libjpeg-turbo 3.1) bit for bit on seeded images PIL writes: every
  subsampling PIL writes, quality 1-100, 16-bit tables, optimized and
  progressive Huffman coding, restart markers, gray, CMYK, Adobe RGB, EXIF,
  ICC and comment segments, sizes from 1x1 to 427x640, a truncated file
  (None from both), a PNG named ``.jpg`` and a JPEG named ``.png``;
* the sampling factors PIL cannot write (h1v2, h4v1, h1v4, mixed) and
  coefficients large enough to overflow the IDCT's 16-bit lanes, in files a
  test-only writer (``write_coefficients``) entropy-codes from seeded
  quantized blocks; PIL decodes each as the oracle. PIL's libjpeg-turbo runs
  its SIMD IDCT, whose 16-bit arithmetic saturates where jidctint.c's C code
  wraps; the port decodes as the SIMD build does;
* ``encode_jpeg`` and ``write_image`` equal to PIL's ``save`` bytes for RGB
  and L at every size above;
* the codings the codec once refused: those PIL decodes equal PIL, those
  PIL refuses too raise ``CorruptImage`` naming them (the other forms are
  in ``test_torch_image_forms.py``);
* the digests ``chip_smoke.py`` checks on the card: PIL's bytes and pixels
  of its seeded 640x480 image, PIL's pixels of its embedded samples, and
  PIL's pixels of each image form its image_forms phase writes.
"""

import base64
import hashlib
import io
import re
import struct

import numpy as np
import pytest
from PIL import Image

import chip_smoke
import torch_image_writers as W
from ape_tpu.data.mapper import read_image as jax_read_image
from ape_tpu_torch.data.image_io import CorruptImage, read_image, read_label_map, write_image
from ape_tpu_torch.data.jpeg import decode_jpeg, encode_jpeg

SIZES = ((1, 1), (5, 7), (9, 17), (48, 64), (640, 427))  # (h, w): 1x1, 7x5, 17x9, 64x48, 427x640


def image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Smooth gradients plus noise, stretched past 0..255 so that the
    colours saturate and the decoder's range limits are reached."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255.0 / max(w - 1, 1), yy * 255.0 / max(h - 1, 1),
                     (xx + yy) * 127.0 / max(w + h - 2, 1)], -1)
    return np.clip(base * 1.6 - 60 + rng.randn(h, w, 3) * 25, 0, 255).astype(np.uint8)


def pil_jpeg(arr: np.ndarray, mode=None, **kw) -> bytes:
    """PIL's JPEG bytes of ``arr``, converted to ``mode`` first if given."""
    im = Image.fromarray(arr)
    if mode and mode != im.mode:
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, "JPEG", **kw)
    return buf.getvalue()


def pil_pixels(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _exif_icc_comment():
    ex = Image.Exif()
    ex[0x0112] = 6  # orientation: rotate 90 (JAX's reader and the port ignore it)
    return dict(exif=ex, icc_profile=bytes(range(256)) * 12, comment=b"a comment")


WIDE_TABLES = [[min(1 + 37 * i, 2000) for i in range(64)], [300 + 20 * i for i in range(64)]]
PIL_CASES = {
    "444": dict(subsampling="4:4:4"),
    "422": dict(subsampling="4:2:2"),
    "420": dict(subsampling="4:2:0"),
    "411": dict(subsampling="4:1:1"),  # PIL 12.1 writes it as 2x2
    "q1": dict(quality=1),
    "q10": dict(quality=10),
    "q50": dict(quality=50),
    "q75": dict(quality=75),
    "q95": dict(quality=95),
    "q100": dict(quality=100),
    "q100_444": dict(quality=100, subsampling="4:4:4"),
    "qtables16": dict(qtables=WIDE_TABLES),
    "optimize": dict(optimize=True),
    "progressive": dict(progressive=True),
    "progressive_optimize": dict(progressive=True, optimize=True),
    "progressive_444": dict(progressive=True, subsampling="4:4:4"),
    "restart_blocks": dict(restart_marker_blocks=3),
    "restart_rows": dict(restart_marker_rows=1),
    "progressive_restart": dict(progressive=True, restart_marker_blocks=2),
    "gray": dict(mode="L"),
    "gray_progressive": dict(mode="L", progressive=True),
    "cmyk": dict(mode="CMYK"),
    "cmyk_progressive": dict(mode="CMYK", progressive=True),
    "keep_rgb": dict(keep_rgb=True),
    "exif_icc_comment": "exif",
}


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("case", sorted(PIL_CASES))
def test_read_image_equals_jax(tmp_path, case, size):
    kw = dict(_exif_icc_comment()) if PIL_CASES[case] == "exif" else dict(PIL_CASES[case])
    mode = kw.pop("mode", None)
    data = pil_jpeg(image(*size, seed=len(case)), mode, **kw)
    path = tmp_path / "a.jpg"
    path.write_bytes(data)
    want = jax_read_image(str(path))
    got = read_image(str(path))
    assert want is not None and got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# --- files PIL cannot write -----------------------------------------------

NATURAL = []
for _s in range(15):
    _lo, _hi = max(0, _s - 7), min(_s, 7)
    NATURAL += [r * 8 + (_s - r) for r in (range(_hi, _lo - 1, -1) if _s % 2 == 0
                                           else range(_lo, _hi + 1))]
DC_BITS = (0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0)
AC_BITS = (0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D)
AC_VALS = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f024336272820"
    "90a161718191a25262728292a3435363738393a434445464748494a535455565758595a6364"
    "65666768696a737475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7a8"
    "a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9"
    "eaf1f2f3f4f5f6f7f8f9fa")


def _codes(bits, vals):
    out, code, k = {}, 0, 0
    for length, n in enumerate(bits, 1):
        for _ in range(n):
            out[vals[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return out


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def write_coefficients(width, height, sampling, coefs, qtables, jfif=True, adobe=None,
                       ids=None) -> bytes:
    """A baseline file (SOF1 when a table needs 16 bits) of the given
    quantized coefficient blocks, entropy-coded in one interleaved scan
    with the standard luminance Huffman tables. ``sampling``: (h, v) a
    component; ``coefs[c]``: int (MCU rows * v, MCU columns * h, 64) in
    natural order, DC values within +-2047 of their neighbours and AC
    within +-1023. ``jfif``: a JFIF APP0; ``adobe``: an Adobe APP14 with
    this transform; ``ids``: the component ids (default 1, 2, ...)."""
    ids = ids or list(range(1, len(sampling) + 1))
    dc, ac = _codes(DC_BITS, list(range(12))), _codes(AC_BITS, AC_VALS)
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    mx, my = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    wide = any(max(q) > 255 for q in qtables)
    out = b"\xff\xd8"
    if jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        out += _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([adobe]))
    for t, q in enumerate(qtables):
        zz = [int(q[NATURAL[i]]) for i in range(64)]
        out += _segment(0xDB, bytes([t | (16 if wide else 0)])
                        + (struct.pack(">64H", *zz) if wide else bytes(zz)))
    body = struct.pack(">BHHB", 8, height, width, len(sampling))
    for c, (h, v) in enumerate(sampling):
        body += bytes([ids[c], (h << 4) | v, min(c, len(qtables) - 1)])
    out += _segment(0xC1 if wide else 0xC0, body)
    out += _segment(0xC4, b"\x00" + bytes(DC_BITS) + bytes(range(12)))
    out += _segment(0xC4, b"\x10" + bytes(AC_BITS) + AC_VALS)
    out += _segment(0xDA, bytes([len(sampling)]) + b"".join(bytes([i, 0]) for i in ids)
                    + b"\x00\x3f\x00")
    acc, nbits, data = 0, 0, bytearray()

    def put(value, n):
        nonlocal acc, nbits
        acc, nbits = (acc << n) | (value & ((1 << n) - 1)), nbits + n
        while nbits >= 8:
            byte = (acc >> (nbits - 8)) & 0xFF
            data.append(byte)
            if byte == 0xFF:
                data.append(0)
            nbits -= 8

    pred = [0] * len(sampling)
    for y in range(my):
        for x in range(mx):
            for c, (h, v) in enumerate(sampling):
                for by in range(y * v, y * v + v):
                    for bx in range(x * h, x * h + h):
                        blk = coefs[c][by, bx]
                        diff, pred[c] = int(blk[0]) - pred[c], int(blk[0])
                        n = abs(diff).bit_length()
                        put(*dc[n])
                        if n:
                            put(diff if diff >= 0 else diff - 1, n)
                        run = 0
                        for k in range(1, 64):
                            a = int(blk[NATURAL[k]])
                            if a == 0:
                                run += 1
                                continue
                            while run > 15:
                                put(*ac[0xF0])
                                run -= 16
                            n = abs(a).bit_length()
                            put(*ac[(run << 4) | n])
                            put(a if a >= 0 else a - 1, n)
                            run = 0
                        if run:
                            put(*ac[0])
    if nbits:
        put(0x7F, 8 - nbits)
    return out + bytes(data) + b"\xff\xd9"


def random_coefficients(rng, width, height, sampling, dc_range, ac_range, density=0.3):
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    mx, my = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    out = []
    for h, v in sampling:
        c = np.zeros((my * v, mx * h, 64), np.int64)
        c[..., 0] = rng.randint(-dc_range, dc_range + 1, c.shape[:2])
        live = rng.rand(*c.shape[:2], 63) < density
        c[..., 1:] = np.where(live, rng.randint(-ac_range, ac_range + 1, live.shape), 0)
        out.append(c)
    return out


SAMPLINGS = {"h1v2": ((1, 2), (1, 1), (1, 1)), "h4v1": ((4, 1), (1, 1), (1, 1)),
             "h1v4": ((1, 4), (1, 1), (1, 1)), "h2v1": ((2, 1), (1, 1), (1, 1)),
             "h2v2": ((2, 2), (1, 1), (1, 1)), "mixed": ((2, 2), (1, 2), (1, 1)),
             "mixed_h2v1": ((2, 2), (1, 1), (1, 2)), "gray_2x2": ((2, 2),)}
# (DC range, AC range, quantizer): a moderate range, then ones whose
# dequantized coefficients overflow the IDCT's 16-bit lanes and range limit
RANGES = {"moderate": (60, 20, 4), "wide": (1000, 500, 1), "q255": (30, 10, 255),
          "q1000": (16, 8, 1000), "q2000": (8, 4, 2000)}


@pytest.mark.parametrize("size", ((1, 1), (5, 7), (9, 17), (48, 64), (70, 33)),
                         ids=lambda s: f"{s[1]}x{s[0]}")
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
def test_sampling_factors_and_range_limit_equal_pil(sampling, size):
    rng = np.random.RandomState(len(sampling) + size[0])
    h, w = size
    for name, (dcr, acr, q) in RANGES.items():
        coefs = random_coefficients(rng, w, h, SAMPLINGS[sampling], dcr, acr)
        data = write_coefficients(w, h, SAMPLINGS[sampling], coefs,
                                  [np.full(64, q), np.full(64, q)])
        np.testing.assert_array_equal(decode_jpeg(data), pil_pixels(data), err_msg=name)


# libjpeg's colour-space guess for 3 components: a JFIF marker, then the
# Adobe transform, then the component ids ('R', 'G', 'B' is RGB)
COLOUR_GUESSES = {"jfif": (True, None, None), "jfif_over_adobe_rgb": (True, 0, None),
                  "adobe_rgb": (False, 0, None), "adobe_ycc": (False, 1, None),
                  "adobe_other": (False, 7, None), "ids_rgb": (False, None, [82, 71, 66]),
                  "ids_ycc": (False, None, [1, 2, 3]), "ids_other": (False, None, [5, 6, 9])}


@pytest.mark.parametrize("case", sorted(COLOUR_GUESSES))
def test_colour_space_guess_equals_pil(case):
    jfif, adobe, ids = COLOUR_GUESSES[case]
    rng = np.random.RandomState(11)
    sampling = ((2, 2), (1, 1), (1, 1))
    coefs = random_coefficients(rng, 24, 17, sampling, 60, 20)
    data = write_coefficients(24, 17, sampling, coefs, [np.full(64, 4), np.full(64, 4)],
                              jfif=jfif, adobe=adobe, ids=ids)
    np.testing.assert_array_equal(decode_jpeg(data), pil_pixels(data))


def test_fill_bytes_and_unknown_app_segments_equal_pil():
    """Fill bytes (0xFF runs) before markers, an APP15 and a COM segment
    inserted into a progressive file with restart markers."""
    data = pil_jpeg(image(40, 56), progressive=True, restart_marker_blocks=2)
    sos = data.index(b"\xff\xda")
    dqt = data.index(b"\xff\xdb")
    data = (data[:dqt] + b"\xff\xff\xff" + _segment(0xEF, b"app15 payload") + b"\xff"
            + _segment(0xFE, b"comment") + data[dqt:sos] + b"\xff\xff" + data[sos:])
    np.testing.assert_array_equal(decode_jpeg(data), pil_pixels(data))


def test_truncated_png_as_jpg_and_jpeg_as_png(tmp_path):
    data = pil_jpeg(image(48, 64))
    for cut in (len(data) // 2, len(data) - 2, 100):
        (tmp_path / "t.jpg").write_bytes(data[:cut])
        assert jax_read_image(str(tmp_path / "t.jpg")) is None
        assert read_image(str(tmp_path / "t.jpg")) is None
    Image.fromarray(image(9, 17)).save(tmp_path / "p.png")
    (tmp_path / "png.jpg").write_bytes((tmp_path / "p.png").read_bytes())
    (tmp_path / "jpeg.png").write_bytes(data)
    for name in ("png.jpg", "jpeg.png"):
        np.testing.assert_array_equal(read_image(str(tmp_path / name)),
                                      jax_read_image(str(tmp_path / name)))
    with pytest.raises(CorruptImage, match="truncated"):
        decode_jpeg(data[:len(data) // 2])


@pytest.mark.parametrize("mode", ("RGB", "L"))
@pytest.mark.parametrize("size", SIZES + ((480, 640),), ids=lambda s: f"{s[1]}x{s[0]}")
def test_encode_equals_pil_save(tmp_path, mode, size):
    arr = image(*size, seed=size[0])
    if mode == "L":
        arr = np.asarray(Image.fromarray(arr).convert("L"))
    want = pil_jpeg(arr)
    assert encode_jpeg(arr) == want
    write_image(str(tmp_path / "w.jpg"), arr)
    assert (tmp_path / "w.jpg").read_bytes() == want
    write_image(str(tmp_path / "w.png"), arr)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "w.png")), arr)


def _patched(data: bytes, marker: int, offset: int, value: int) -> bytes:
    """``data`` with the byte ``offset`` after the first ``0xFF marker`` set."""
    at = data.index(bytes([0xFF, marker]))
    out = bytearray(data)
    out[at + offset] = value
    return bytes(out)


def _incomplete_progressive() -> bytes:
    data = pil_jpeg(image(48, 64), progressive=True)
    last_scan = data.rindex(b"\xff\xda")
    return data[:last_scan] + b"\xff\xd9"


def _writer_stream(kind: str) -> bytes:
    """The test-side writers' real arithmetic-coded (SOF9) or lossless (SOF3)
    stream of the 64x48 image."""
    img = image(48, 64)
    if kind == "lossless":
        return W.lossless_jpeg([img[..., c] for c in range(3)], psv=4, adobe=0, jfif=False)
    q = [W.quality_table(W.LUM_QUANT, 75), W.quality_table(W.CHROM_QUANT, 75)]
    sampling = ((2, 2), (1, 1), (1, 1))
    return W.arithmetic_jpeg(64, 48, sampling, W.coefficients(W.planes_of(img, "ycc"), sampling, q),
                             q)


# the six codings the codec refused before it took what PIL takes: (file,
# None where PIL decodes it, else the words of the refusal)
REFUSED = {
    "arithmetic": (lambda: _writer_stream("arithmetic"), None),
    "lossless": (lambda: _writer_stream("lossless"), None),
    "hierarchical": (lambda: _patched(pil_jpeg(image(48, 64)), 0xC0, 1, 0xC5), "hierarchical"),
    "12-bit": (lambda: _patched(pil_jpeg(image(48, 64)), 0xC0, 4, 12), "12-bit"),
    "ycck": (lambda: _patched(pil_jpeg(image(48, 64), "CMYK"), 0xEE, 15, 2), None),
    "block_smoothing": (_incomplete_progressive, None),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_codings_raise_naming_them(tmp_path, case):
    """The codings the codec once refused: the four PIL decodes now give
    PIL's pixels; the two PIL refuses too raise ``CorruptImage`` naming
    them, which ``read_image`` turns into None as JAX's reader does."""
    make, words = REFUSED[case]
    data = make()
    (tmp_path / "r.jpg").write_bytes(data)
    if words is None:
        np.testing.assert_array_equal(decode_jpeg(data), pil_pixels(data))
        np.testing.assert_array_equal(read_image(str(tmp_path / "r.jpg")),
                                      jax_read_image(str(tmp_path / "r.jpg")))
        return
    with pytest.raises(CorruptImage, match=words):
        decode_jpeg(data)
    assert jax_read_image(str(tmp_path / "r.jpg")) is None
    assert read_image(str(tmp_path / "r.jpg")) is None


def test_corrupt_data_and_bad_arguments():
    data = bytearray(pil_jpeg(image(48, 64)))
    sos = data.index(b"\xff\xda")
    data[sos + 20:sos + 40] = b"\xff" * 20  # fill bytes, then a marker inside the scan
    data[sos + 40] = 0xC4
    with pytest.raises(CorruptImage):
        decode_jpeg(bytes(data))
    with pytest.raises(CorruptImage, match="no SOI"):
        decode_jpeg(b"\xff\xd9")
    with pytest.raises(ValueError, match="uint8"):
        encode_jpeg(np.zeros((4, 4, 4), np.uint8))
    with pytest.raises(ValueError, match=r"\.jp2"):
        write_image("x.jp2", np.zeros((4, 4, 3), np.uint8))


@pytest.mark.parametrize("ext", (".webp", ".jp2", ".avif", ".qoi", ".pcx"))
def test_write_image_webp_writes_and_unread_formats_raise(tmp_path, ext):
    """``.webp`` writes a WebP file PIL decodes at the image's size, and
    ``.qoi`` and ``.pcx``, which the port reads since it took the small
    rasters, PIL's files of the image's pixels; the names of formats PIL
    writes and the port does not read raise ``ValueError`` naming the
    extension, and nothing is written."""
    path = tmp_path / f"x{ext}"
    img = image(24, 40, seed=7)
    if ext in (".webp", ".qoi", ".pcx"):
        write_image(str(path), img)
        got = np.asarray(Image.open(path).convert("RGB"))
        assert got.shape == img.shape
        if ext != ".webp":
            np.testing.assert_array_equal(got, img)
        return
    with pytest.raises(ValueError, match=re.escape(ext)):
        write_image(str(path), img)
    assert not path.exists()


def test_chip_smoke_digests_are_pils():
    """The SHA-256s chip_smoke.py holds the card machine's codec to are
    PIL's: the bytes PIL's ``save`` writes for the seeded 640x480 image and
    the pixels PIL decodes from them, and PIL's pixels of each embedded
    sample; the port gives the same here."""
    img = chip_smoke.jpeg_check_image()
    assert img.shape == (480, 640, 3)
    data = pil_jpeg(img)
    assert hashlib.sha256(data).hexdigest() == chip_smoke.JPEG_CHECK_DIGESTS["jpeg"]
    assert hashlib.sha256(pil_pixels(data).tobytes()).hexdigest() == \
        chip_smoke.JPEG_CHECK_DIGESTS["pixels"]
    assert hashlib.sha256(encode_jpeg(img)).hexdigest() == chip_smoke.JPEG_CHECK_DIGESTS["jpeg"]
    for name, (b64, digest) in chip_smoke.JPEG_SAMPLES.items():
        sample = base64.b64decode(b64)
        assert hashlib.sha256(pil_pixels(sample).tobytes()).hexdigest() == digest, name
        assert hashlib.sha256(decode_jpeg(sample).tobytes()).hexdigest() == digest, name


def test_chip_smoke_image_forms_digests_are_pils(tmp_path):
    """The SHA-256s chip_smoke.py's image_forms phase holds the card
    machine's reader to are PIL's: of the pixels PIL decodes from each form
    ``image_forms_files`` writes (of ``np.asarray(Image.open(f))`` for the
    label map), which the port reads alike here; and PIL refuses each file of
    ``refused_forms``, which the port drops."""
    files = chip_smoke.image_forms_files()
    assert sorted(files) == sorted(chip_smoke.IMAGE_FORMS_DIGESTS)
    for name, data in files.items():
        label = name.startswith("label")
        path = tmp_path / f"{name}.{'png' if label or 'png' in name else 'jpg'}"
        path.write_bytes(data)
        im = Image.open(path)
        want = np.asarray(im) if label else np.asarray(im.convert("RGB"))
        assert hashlib.sha256(want.tobytes()).hexdigest() == \
            chip_smoke.IMAGE_FORMS_DIGESTS[name], name
        got = read_label_map(str(path)) if label else read_image(str(path))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=name)
    refused = chip_smoke.refused_forms(files)
    assert sorted(refused) == sorted(chip_smoke.FORMS_REFUSED)
    for name, data in refused.items():
        (tmp_path / "r.jpg").write_bytes(data)
        assert jax_read_image(str(tmp_path / "r.jpg")) is None, name
        assert read_image(str(tmp_path / "r.jpg")) is None, name
