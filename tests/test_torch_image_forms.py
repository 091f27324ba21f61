"""The port's reader on every image form JAX's reader takes through PIL 12.1
on libjpeg-turbo 3.1, on the CPU: a file PIL decodes gives PIL's pixels bit
for bit, a file PIL refuses is dropped (None, and ``CorruptImage`` from
``read_rgb``), and a format PIL reads that the port does not raises
``ValueError`` naming it.

* YCCK JPEG (PIL's CMYK file with the Adobe transform set to 2, and the
  writer's 4:2:0 YCCK with restart markers);
* block smoothing: PIL's progressive files with their last 1, 2, 3 and 5
  scans cut, and the writer's arithmetic progressive files cut to their DC
  scans (libjpeg's DC interpolation);
* arithmetic-coded sequential (SOF9) and progressive (SOF10) JPEG with
  restart intervals and DAC conditioning, and the 64 KiB read block past
  which PIL's libjpeg cannot decode them;
* lossless (SOF3) JPEG, predictors 1-7, point transforms, restarts,
  subsampled, gray, RGB and CMYK;
* interlaced and 16-bit PNG of every color type, as images and as label
  maps (``np.asarray(Image.open(f))``);
* the forms PIL refuses, dropped where JAX drops them, and the same
  records kept by JAX's ``DatasetMapperDETR`` and the port's.

The files PIL cannot write come from ``torch_image_writers``; each writer is
itself held to PIL (an arithmetic file and its Huffman twin decode alike, a
lossless file with Pt = 0 decodes to its source, a PNG reads back as its
samples).
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

import torch_image_writers as W
from ape_tpu.data import mapper as j_mapper
from ape_tpu.data.mapper import read_image as jax_read_image
from ape_tpu_torch.data.datasets.coco import load_coco_json
from ape_tpu_torch.data.image_io import CorruptImage, read_image, read_label_map, read_rgb
from ape_tpu_torch.data.jpeg import decode_jpeg
from ape_tpu_torch.data.mapper import DatasetMapperDETR
from test_torch_data import _same_example, write_dataset
from test_torch_jpeg import _patched

# (h, w): odd sizes, sizes that are not multiples of an MCU, one block, wide and tall
SIZES = ((1, 1), (7, 5), (9, 17), (16, 16), (23, 9), (37, 53), (48, 64), (33, 70))
Q75 = [W.quality_table(W.LUM_QUANT, 75), W.quality_table(W.CHROM_QUANT, 75)]
SAMPLINGS = {"420": ((2, 2), (1, 1), (1, 1)), "422": ((2, 1), (1, 1), (1, 1)),
             "444": ((1, 1), (1, 1), (1, 1)), "gray": ((1, 1),),
             "cmyk": ((1, 1), (1, 1), (1, 1), (1, 1))}


def image(h: int, w: int, seed: int = 0, channels: int = 3) -> np.ndarray:
    """Gradients plus noise, stretched past 0..255 (``test_torch_jpeg.image``)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255.0 / max(w - 1, 1), yy * 255.0 / max(h - 1, 1),
                     (xx + yy) * 127.0 / max(w + h - 2, 1), (w - 1 - xx) * 255.0 / max(w - 1, 1)],
                    -1)[..., :channels]
    return np.clip(base * 1.6 - 60 + rng.randn(h, w, channels) * 25, 0, 255).astype(np.uint8)


def size_id(s):
    return f"{s[1]}x{s[0]}"


def pil_rgb(data: bytes):
    """PIL's ``convert("RGB")`` of ``data``, or None where PIL raises."""
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception:
        return None


def same_as_jax(tmp_path, data: bytes, name: str = "a.jpg"):
    """The port's ``read_image`` of the file equals JAX's (PIL's) bit for bit;
    returns the pixels."""
    path = tmp_path / name
    path.write_bytes(data)
    want = jax_read_image(str(path))
    got = read_image(str(path))
    assert want is not None, "PIL refuses the file"
    assert got is not None and got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


def dropped_as_jax(tmp_path, data: bytes, words: str, name: str = "r.jpg"):
    """PIL refuses the file (JAX's reader returns None), the port's
    ``read_image`` returns None and its ``read_rgb`` raises ``CorruptImage``
    naming ``words``."""
    path = tmp_path / name
    path.write_bytes(data)
    assert jax_read_image(str(path)) is None, "PIL decodes the file"
    assert read_image(str(path)) is None
    with pytest.raises(CorruptImage, match=words):
        read_rgb(str(path))


def planes_for(img4: np.ndarray, kind: str) -> list:
    if kind == "gray":
        return W.planes_of(img4[..., 0], "gray")
    if kind == "cmyk":
        return W.planes_of(img4, "cmyk")
    return W.planes_of(img4[..., :3], "ycc")


# --- YCCK ---------------------------------------------------------------------

@pytest.mark.parametrize("size", SIZES, ids=size_id)
@pytest.mark.parametrize("kind", ("pil_cmyk", "pil_cmyk_progressive", "writer_420_restart"))
def test_ycck_equals_pil(tmp_path, kind, size):
    h, w = size
    img = image(h, w, seed=h + w, channels=4)
    if kind.startswith("pil"):
        buf = io.BytesIO()
        Image.fromarray(img, "CMYK").save(buf, "JPEG", progressive=kind.endswith("progressive"))
        data = _patched(buf.getvalue(), 0xEE, 15, 2)  # the Adobe transform byte: YCCK
    else:
        sampling = ((2, 2), (1, 1), (1, 1), (2, 2))
        coefs = W.coefficients(W.planes_of(img, "ycck"), sampling, Q75, table_of=[0, 1, 1, 0])
        data = W.huffman_jpeg(w, h, sampling, coefs, Q75, table_of=[0, 1, 1, 0], jfif=False,
                              adobe=2, restart=3)
    same_as_jax(tmp_path, data)


# --- block smoothing ----------------------------------------------------------

def cut_scans(data: bytes, k: int) -> bytes:
    """``data`` without its last ``k`` scans."""
    sos = [i for i in range(len(data) - 1) if data[i] == 0xFF and data[i + 1] == 0xDA]
    return data[:sos[-k]] + b"\xff\xd9"


@pytest.mark.parametrize("size", SIZES + ((17, 130),), ids=size_id)
@pytest.mark.parametrize("kind", ("420", "422", "444", "gray", "420_restart"))
def test_block_smoothing_equals_pil(tmp_path, kind, size):
    """PIL's progressive files with their last 1, 2, 3 and 5 scans cut:
    libjpeg smooths where any of the first ten coefficients is unrefined
    (and interpolates the DC where no AC scan came: gray cut to its DC scan)."""
    h, w = size
    img = image(h, w, seed=3 * h + w)
    kw = dict(progressive=True)
    if kind == "gray":
        im = Image.fromarray(img).convert("L")
    else:
        im = Image.fromarray(img)
        kw["subsampling"] = "4:" + kind[1] + ":" + kind[2]
    if kind.endswith("restart"):
        kw["restart_marker_blocks"] = 2
    buf = io.BytesIO()
    im.save(buf, "JPEG", **kw)
    for k in (1, 2, 3, 5):
        same_as_jax(tmp_path, cut_scans(buf.getvalue(), k))


@pytest.mark.parametrize("size", SIZES, ids=size_id)
@pytest.mark.parametrize("kind", ("420", "gray"))
def test_arithmetic_dc_only_smoothing_equals_pil(tmp_path, kind, size):
    """Arithmetic progressive files cut to their first DC scan (the DC
    interpolation) and to the DC and first AC scan."""
    h, w = size
    sampling = SAMPLINGS[kind]
    coefs = W.coefficients(planes_for(image(h, w, seed=h, channels=4), kind), sampling, Q75)
    script = W.progression(len(sampling))
    for scans in (script[:1], script[:2]):
        same_as_jax(tmp_path, W.arithmetic_jpeg(w, h, sampling, coefs, Q75, progressive=True,
                                                scans=scans))


# --- arithmetic coding --------------------------------------------------------

ARITH_MODES = {"sequential": dict(), "sequential_restart": dict(restart=2),
               "progressive": dict(progressive=True),
               "progressive_restart": dict(progressive=True, restart=3),
               "dac": dict(dac={("dc", 0): (2, 5), ("ac", 0): 12, ("dc", 1): (0, 3),
                                ("ac", 1): 30})}


@pytest.mark.parametrize("size", SIZES, ids=size_id)
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
@pytest.mark.parametrize("mode", sorted(ARITH_MODES))
def test_arithmetic_equals_pil(tmp_path, mode, sampling, size):
    """SOF9 and SOF10 of seeded coefficients; the writer's file and its
    Huffman twin (the same coefficients, baseline) decode alike under PIL."""
    h, w = size
    samp = SAMPLINGS[sampling]
    coefs = W.coefficients(planes_for(image(h, w, seed=h * w, channels=4), sampling), samp, Q75)
    adobe = dict(jfif=False, adobe=0) if sampling == "cmyk" else {}
    data = W.arithmetic_jpeg(w, h, samp, coefs, Q75, **ARITH_MODES[mode], **adobe)
    got = same_as_jax(tmp_path, data)
    twin = W.huffman_jpeg(w, h, samp, coefs, Q75, **adobe)
    np.testing.assert_array_equal(pil_rgb(twin), got)


def _with_comments(data: bytes, lengths) -> bytes:
    """``data`` with COM segments of the given payload lengths after SOI."""
    segs = b"".join(b"\xff\xfe" + struct.pack(">H", n + 2) + b"c" * n for n in lengths)
    return data[:2] + segs + data[2:]


@pytest.mark.parametrize("progressive", (False, True), ids=("sequential", "progressive"))
def test_arithmetic_past_pils_read_block_is_dropped(tmp_path, progressive):
    """PIL feeds libjpeg 64 KiB at a time and libjpeg's arithmetic decoder
    cannot wait for more: a scan whose data crosses the end of the bytes fed
    so far fails in PIL (JAX drops the file) and is dropped by the port;
    one that ends before it, or starts after a segment that made libjpeg
    wait for the next block, decodes."""
    h, w = 40, 48
    coefs = W.coefficients(W.planes_of(image(h, w, seed=5), "ycc"), SAMPLINGS["420"], Q75)
    data = W.arithmetic_jpeg(w, h, SAMPLINGS["420"], coefs, Q75, progressive=progressive)
    n = len(data)
    before = _with_comments(data, (60000, 65536 - 64 - 60000 - 8 - n))  # ends before 65536
    assert len(before) <= 65536 - 60
    same_as_jax(tmp_path, before)
    across = _with_comments(data, (60000, 65536 - 60000 - 8 - n // 2))  # the data crosses it
    dropped_as_jax(tmp_path, across, "64 KiB read block")
    after = _with_comments(data, (60000, 65536 - 60000 - 8 + 100))  # a COM crosses it
    same_as_jax(tmp_path, after)


# --- lossless -------------------------------------------------------------------

LOSSLESS_KINDS = {
    "gray": dict(),
    "rgb_adobe": dict(adobe=0, jfif=False),
    "rgb_ids": dict(ids=[82, 71, 66], jfif=False),
    "rgb_420": dict(sampling=[(2, 2), (1, 1), (1, 1)], jfif=False),
    "rgb_422_noninterleaved": dict(sampling=[(2, 1), (1, 1), (1, 1)], jfif=False,
                                   interleave=False),
    "cmyk": dict(adobe=0, jfif=False),
}


def lossless_planes(img4: np.ndarray, kind: str) -> list:
    if kind == "gray":
        return [img4[..., 0]]
    if kind == "cmyk":
        return [img4[..., c] for c in range(4)]
    sampling = LOSSLESS_KINDS[kind].get("sampling", [(1, 1)] * 3)
    hmax, vmax = sampling[0]
    return [img4[::vmax // v, ::hmax // h, c] for c, (h, v) in enumerate(sampling)]


@pytest.mark.parametrize("size", SIZES, ids=size_id)
@pytest.mark.parametrize("kind", sorted(LOSSLESS_KINDS))
@pytest.mark.parametrize("psv", range(1, 8))
def test_lossless_equals_pil(tmp_path, psv, kind, size):
    """SOF3 with predictor ``psv``, point transform psv % 3 and a restart
    every psv % 3 rows; with Pt = 0 PIL decodes the writer's file to its
    source (replicated where subsampled)."""
    h, w = size
    img = image(h, w, seed=psv + h, channels=4)
    planes = lossless_planes(img, kind)
    pt = psv % 3
    data = W.lossless_jpeg(planes, psv=psv, pt=pt, restart_rows=psv % 3, **LOSSLESS_KINDS[kind])
    got = same_as_jax(tmp_path, data)
    if pt == 0 and kind != "cmyk":
        sampling = LOSSLESS_KINDS[kind].get("sampling", [(1, 1)] * len(planes))
        hmax, vmax = sampling[0]
        source = np.stack([np.repeat(np.repeat(p, vmax // v, 0), hmax // hh, 1)[:h, :w]
                           for p, (hh, v) in zip(planes, sampling)], -1)
        np.testing.assert_array_equal(got, np.broadcast_to(source, got.shape))


# --- PNG ------------------------------------------------------------------------

PNG_MODES = {"L1": (0, 1), "L2": (0, 2), "L4": (0, 4), "L8": (0, 8), "L16": (0, 16),
             "RGB8": (2, 8), "RGB16": (2, 16), "P1": (3, 1), "P2": (3, 2), "P4": (3, 4),
             "P8": (3, 8), "LA8": (4, 8), "LA16": (4, 16), "RGBA8": (6, 8), "RGBA16": (6, 16)}


@pytest.mark.parametrize("size", SIZES, ids=size_id)
@pytest.mark.parametrize("mode", sorted(PNG_MODES))
@pytest.mark.parametrize("interlace", (False, True), ids=("plain", "adam7"))
def test_png_forms_equal_pil(tmp_path, interlace, mode, size):
    """``read_image`` equals PIL's ``convert("RGB")`` and ``read_label_map``
    equals ``np.asarray(Image.open(f))`` in dtype and values; PIL reads the
    writer's samples back."""
    color, depth = PNG_MODES[mode]
    h, w = size
    rng = np.random.RandomState(depth + h * w)
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    samples = rng.randint(0, 1 << depth, (h, w, channels)).astype(
        np.uint16 if depth == 16 else np.uint8)
    palette = rng.randint(0, 256, (1 << depth, 3)) if color == 3 else None
    data = W.png(samples[..., 0] if channels == 1 else samples, color, depth, interlace,
                 palette, seed=h)
    path = tmp_path / "a.png"
    path.write_bytes(data)
    same_as_jax(tmp_path, data, "a.png")
    want = np.asarray(Image.open(path))
    got = read_label_map(str(path))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if depth in (8, 16) and color in (0, 2, 3, 6):  # PIL keeps these samples as stored
        stored = samples >> 8 if depth == 16 and color != 0 else samples
        np.testing.assert_array_equal(want.reshape(stored.shape), stored)


# --- forms PIL refuses --------------------------------------------------------

def _pil_jpeg(h=48, w=64, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(image(h, w)).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _sof_patched(*pairs) -> bytes:
    """PIL's 4:2:0 file with SOF0 bytes set: (offset from its 0xFF, value) each."""
    data = _pil_jpeg()
    for offset, value in pairs:
        data = _patched(data, 0xC0, offset, value)
    return data


def _lossless_ycc() -> bytes:
    return W.lossless_jpeg([image(20, 24)[..., c] for c in range(3)], psv=1, jfif=True)


def _lossless_ycck() -> bytes:
    return W.lossless_jpeg([image(20, 24, channels=4)[..., c] for c in range(4)], psv=1,
                           jfif=False, adobe=2)


def _png_without_mode() -> bytes:
    data = W.png(np.zeros((4, 4), np.uint8), 0, 8)
    body = struct.pack(">IIBBBBB", 4, 4, 16, 3, 0, 0, 0)  # palette at 16 bits: no PNG mode
    chunk = struct.pack(">I", 13) + b"IHDR" + body + struct.pack(">I", zlib.crc32(b"IHDR" + body))
    return data[:8] + chunk + data[8 + 25:]


# name -> (file bytes, words the port's message holds)
PIL_REFUSES = {
    "12-bit": (lambda: _sof_patched((4, 12)), "12-bit"),
    "2-component": (lambda: _sof_patched((9, 2)), "2-component"),
    "5-component": (lambda: _sof_patched((9, 5)), "5-component"),
    "hierarchical_sof5": (lambda: _sof_patched((1, 0xC5)), "hierarchical"),
    "hierarchical_sof7": (lambda: _sof_patched((1, 0xC7)), "hierarchical"),
    "hierarchical_sof13": (lambda: _sof_patched((1, 0xCD)), "hierarchical"),
    "lossless_arithmetic_sof11": (lambda: _sof_patched((1, 0xCB)), "SOF11"),
    # Y sampled 3x2 beside Cb's 2x2: 3 is no multiple of 2
    "fractional_sampling": (lambda: _sof_patched((11, 0x32), (14, 0x22)), "fractional"),
    "dnl": (lambda: _sof_patched((5, 0), (6, 0)), "DNL"),  # height 0
    "lossless_ycbcr": (_lossless_ycc, "YCbCr"),
    "lossless_ycck": (_lossless_ycck, "YCCK"),
    "png_no_mode": (_png_without_mode, "no PNG mode"),
}


@pytest.mark.parametrize("case", sorted(PIL_REFUSES))
def test_forms_pil_refuses_are_dropped(tmp_path, case):
    make, words = PIL_REFUSES[case]
    data = make()
    name = "r.png" if case.startswith("png") else "r.jpg"
    dropped_as_jax(tmp_path, data, words, name)
    if not case.startswith("png"):
        with pytest.raises(CorruptImage, match=words):
            decode_jpeg(data)


def test_empty_file_is_dropped(tmp_path):
    dropped_as_jax(tmp_path, b"", "empty")


@pytest.mark.parametrize("fmt", ("GIF", "BMP", "TIFF", "WEBP", "PPM", "AVIF", "ICO", "TGA"))
def test_formats_pil_reads_raise_naming_them(tmp_path, fmt):
    """JAX trains on these (PIL reads them). The port reads GIF, BMP, WebP,
    TIFF, PPM, ICO and TGA as PIL does (``test_torch_image_containers``,
    ``test_torch_tiff``, ``test_torch_netpbm_tga_ico``); AVIF it does not
    read yet: ``read_image`` raises ``ValueError`` naming the format, never
    None."""
    path = tmp_path / f"a.{fmt.lower()}"
    Image.fromarray(image(24, 40)).save(path, fmt)  # ICO keeps the icon sizes that fit
    assert jax_read_image(str(path)) is not None
    if fmt != "AVIF":
        np.testing.assert_array_equal(read_image(str(path)), jax_read_image(str(path)))
        return
    with pytest.raises(ValueError, match=fmt) as info:
        read_image(str(path))
    assert not isinstance(info.value, CorruptImage)


# --- the mapper drops what JAX's drops -------------------------------------------

@pytest.mark.parametrize("is_train", [True, False])
def test_mapper_drops_what_jax_drops(tmp_path, is_train):
    """JAX's ``DatasetMapperDETR`` and the port's over the same records:
    good JPEGs of the new forms, one file of each form PIL refuses and a
    truncated file. The same records are kept (JAX's mapper returns None
    where PIL raises, the port's where ``read_image`` drops) with the same
    arrays; the seeded draws stay in step across the dropped records."""
    js, root = write_dataset(tmp_path / "coco", n=6, seed=7)
    dicts = load_coco_json(js, root)
    good = []
    for k, d in enumerate(dicts):
        img = np.asarray(Image.open(d["file_name"]).convert("RGB"))
        h, w = img.shape[:2]
        sampling = SAMPLINGS["420"]
        coefs = W.coefficients(W.planes_of(img, "ycc"), sampling, Q75)
        data = (W.arithmetic_jpeg(w, h, sampling, coefs, Q75, progressive=k % 2 == 1)
                if k < 2 else W.lossless_jpeg([img[..., c] for c in range(3)], psv=k % 7 + 1,
                                              adobe=0, jfif=False) if k < 4
                else _patched(_cmyk_jpeg(img), 0xEE, 15, 2))
        path = d["file_name"][:-4] + ".jpg"
        open(path, "wb").write(data)
        good.append(dict(d, file_name=path))
    bad = []
    for i, (case, (make, _)) in enumerate(sorted(PIL_REFUSES.items())):
        if case.startswith("png"):
            continue
        path = tmp_path / f"refused_{i}.jpg"
        path.write_bytes(make())
        bad.append(dict(good[i % len(good)], file_name=str(path), image_id=1000 + i))
    cut = _pil_jpeg()
    (tmp_path / "truncated.jpg").write_bytes(cut[:len(cut) // 2])
    bad.append(dict(good[0], file_name=str(tmp_path / "truncated.jpg"), image_id=999))
    records = [r for pair in zip(good, bad) for r in pair] + bad[len(good):]
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


def _cmyk_jpeg(img: np.ndarray) -> bytes:
    buf = io.BytesIO()
    cmyk = np.concatenate([img, img[..., :1] // 2], -1)
    Image.fromarray(cmyk, "CMYK").save(buf, "JPEG")
    return buf.getvalue()
