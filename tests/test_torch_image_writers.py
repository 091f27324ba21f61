"""The port's image writers held to PIL 12.1 on the CPU: ``write_image``
under every name PIL registers for a format the port reads gives the bytes
of ``Image.fromarray(x).save(path)``, except ``.webp``, whose lossy file is
held to PIL's by bounds.

* GIF (``data.gif``): Pillow's median-cut quantiser (``quantize``: the
  palette and indices of ``convert("P", palette=ADAPTIVE)``), the palette
  remap of ``_get_optimize`` on both sides of 512 x 512, the LZW encoder
  and its sub-blocks, interlace, gray images;
* PNG (``data.png``): ZipEncode's row filters, zlib at PIL's settings, the
  IDAT split;
* ICO (``data.ico``): the frame sizes of ``thumbnail``, PIL's LANCZOS
  resize (``transforms.resize_lanczos``), each frame's PNG bytes;
* the aliases: ``.jfif``, ``.jpe``, ``.mpo``, ``.apng``, ``.dib``,
  ``.pfm``, ``.icb``, ``.vda``, ``.vst`` and every name written before;
* WebP (``data.webp``): on each test image PIL decodes the port's file to
  the pixels the port's decoder gives, its PSNR is within 0.5 dB of PIL's
  file's and its size at most 1.15 x PIL's; the YUV planes are libwebp's
  (``WebPPictureImportRGB`` through ctypes) and the frame header's
  segments and quantizers are those of PIL's file;
* round trips through the port's reader and PIL (DIB files too, which the
  port reads as PIL's DIB plugin does), the names PIL writes and the port
  does not read, ``visualize_json_results`` against JAX's tool.
"""

import ctypes
import hashlib
import io
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, ImageDraw

import chip_smoke
import torch_image_writers as W
import torch_webp_encoder as E
from ape_tpu_torch.data import image_io
from ape_tpu_torch.data.gif import encode_gif, quantize
from ape_tpu_torch.data.ico import encode_ico
from ape_tpu_torch.data.image_io import read_rgb, write_image
from ape_tpu_torch.data.png import encode_png
from ape_tpu_torch.data.transforms import resize_lanczos
from ape_tpu_torch.data.webp import decode_webp, encode_webp, yuv420
from ape_tpu_torch.demo import predictor_lazy
from ape_tpu_torch.tools import visualize_json_results
from ape_tpu_torch.utils import draw

FIXTURE = Path(__file__).parent / "data" / "image_containers" / "webp_lossy.webp"


def noise(h, w, seed=0, channels=3):
    shape = (h, w) if channels == 1 else (h, w, channels)
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def gradient(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1), (xx + yy) % 256],
                    -1).astype(np.uint8)


def smooth(h, w, seed=0):
    """Noise blurred by a box filter four times: a photo-like image."""
    x = np.random.default_rng(seed).normal(size=(h + 48, w + 48, 3))
    for _ in range(4):
        x = (x[:-12] + x[3:-9] + x[6:-6] + x[9:-3] + x[12:]) / 5
        x = (x[:, :-12] + x[:, 3:-9] + x[:, 6:-6] + x[:, 9:-3] + x[:, 12:]) / 5
    x = x[:h, :w]
    return ((x - x.min()) / (x.max() - x.min()) * 255).astype(np.uint8)


def textured(h, w, seed=0):
    n = np.random.default_rng(seed + 1).integers(-20, 21, (h, w, 3))
    return np.clip(smooth(h, w, seed).astype(int) + n, 0, 255).astype(np.uint8)


def few_colours(h, w, n, seed=0):
    rng = np.random.default_rng(seed)
    colours = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    return colours[rng.integers(0, n, (h, w))]


def overlay():
    """The demo's drawing over the lossy WebP fixture (480 x 640): boxes,
    masks and labels of a seeded fake prediction, as the port's
    ``VisualizationDemo.draw`` composes them."""
    import torch

    img = read_rgb(str(FIXTURE))
    rng = np.random.RandomState(3)
    h, w = img.shape[:2]
    n = 6
    x0, y0 = rng.uniform(0, 0.7 * w, n), rng.uniform(0, 0.7 * h, n)
    boxes = np.stack([x0, y0, x0 + rng.uniform(20, 0.3 * w, n), y0 + rng.uniform(20, 0.3 * h, n)],
                     1).astype(np.float32)
    pred = {"text_list": ["person", "dog", "frisbee"],
            "instances": {"boxes": torch.from_numpy(boxes),
                          "scores": torch.from_numpy(rng.uniform(0.4, 1.0, n).astype(np.float32)),
                          "classes": torch.from_numpy(rng.randint(0, 3, n).astype(np.int64)),
                          "mask_logits": torch.from_numpy(
                              (rng.randn(n, 28, 28) * 4).astype(np.float32))}}
    demo = predictor_lazy.VisualizationDemo.__new__(predictor_lazy.VisualizationDemo)
    demo.threshold = 0.3
    return demo.draw(img, pred, with_box=True, with_mask=True)


def pil_save(img, fmt) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, fmt)
    return buf.getvalue()


def psnr(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse) if mse else 99.0


# --- GIF ---------------------------------------------------------------------

GIF_IMAGES = {
    "noise_37x53": lambda: noise(37, 53, 1),
    "noise_480x640": lambda: noise(480, 640, 2),
    "gradient_333x517": lambda: gradient(333, 517),
    "smooth_101x97": lambda: smooth(101, 97),
    "200_colours_61x77": lambda: few_colours(61, 77, 200),
    "256_colours_90x40": lambda: few_colours(90, 40, 256, seed=4),
    "2_colours_33x19": lambda: few_colours(33, 19, 2, seed=5),
    "1_colour_20x20": lambda: np.full((20, 20, 3), 9, np.uint8),
    "below_512x512": lambda: noise(400, 500, 6),
    "above_512x512": lambda: noise(600, 520, 7),
    "gray_50x40": lambda: noise(50, 40, 8, channels=1),
    "small_7x9": lambda: noise(7, 9, 9),
    "overlay_480x640": overlay,
}


@pytest.mark.parametrize("case", sorted(GIF_IMAGES))
def test_gif_is_pils_bytes(case):
    img = GIF_IMAGES[case]()
    assert encode_gif(img) == pil_save(img, "GIF")


@pytest.mark.parametrize("case", ("200_colours_61x77", "256_colours_90x40", "noise_37x53",
                                  "smooth_101x97"))
def test_quantize_is_pils_median_cut(case):
    img = GIF_IMAGES[case]()
    want = Image.fromarray(img).convert("P", palette=Image.Palette.ADAPTIVE)
    indices, palette = quantize(img)
    np.testing.assert_array_equal(palette, np.frombuffer(want.palette.palette, np.uint8)
                                  .reshape(-1, 3))
    np.testing.assert_array_equal(indices, np.asarray(want))
    if case.endswith(("61x77", "90x40")):  # 256 colours or fewer: each its own entry
        assert sorted(map(tuple, palette)) == sorted(set(map(tuple, img.reshape(-1, 3))))


# --- PNG ---------------------------------------------------------------------

@pytest.mark.parametrize("channels", (1, 3, 4), ids=("L", "RGB", "RGBA"))
@pytest.mark.parametrize("size", ((1, 1), (37, 53), (300, 400), (5, 20000), (64, 48)),
                         ids=lambda s: f"{s[1]}x{s[0]}")
def test_png_is_pils_bytes(size, channels):
    img = noise(*size, seed=size[0], channels=channels)
    if size == (64, 48):  # flat and smooth rows: the None, Up and Sub filters win
        img = np.repeat(np.repeat(img[:8, :6], 8, 0), 8, 1)
    assert encode_png(img) == pil_save(img, "PNG")


def test_png_idat_split_is_pils():
    """A 300 x 400 noise image deflates past 65536 bytes: PIL cuts its IDAT
    chunks at 65536 bytes."""
    data = encode_png(noise(300, 400, 300))
    sizes, pos = [], 8
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        if data[pos + 4:pos + 8] == b"IDAT":
            sizes.append(n)
        pos += 12 + n
    assert len(sizes) > 1 and set(sizes[:-1]) == {65536} and sizes[-1] <= 65536


# --- ICO and the LANCZOS resize --------------------------------------------------

@pytest.mark.parametrize("size", ((1, 1), (15, 300), (300, 15), (256, 256), (480, 640),
                                  (17, 300)), ids=lambda s: f"{s[1]}x{s[0]}")
def test_ico_is_pils_bytes(size):
    img = smooth(*size) if min(size) > 1 else noise(*size)
    assert encode_ico(img) == pil_save(img, "ICO")


def test_ico_of_gray_is_pils_bytes():
    img = noise(70, 90, 3, channels=1)
    assert encode_ico(img) == pil_save(img, "ICO")


@pytest.mark.parametrize("out", ((12, 16), (192, 256), (100, 33), (700, 900), (480, 33),
                                 (5, 640)), ids=lambda s: f"{s[1]}x{s[0]}")
def test_resize_lanczos_is_pils(out):
    img = noise(480, 640, 11)
    want = np.asarray(Image.fromarray(img).resize(out[::-1], Image.Resampling.LANCZOS))
    np.testing.assert_array_equal(resize_lanczos(img, *out), want)
    gray = img[..., 1]
    want = np.asarray(Image.fromarray(gray).resize(out[::-1], Image.Resampling.LANCZOS))
    np.testing.assert_array_equal(resize_lanczos(gray, *out), want)


# --- every name --------------------------------------------------------------------

EXACT_NAMES = sorted(ext for ext in image_io._ENCODERS if ext != ".webp")


@pytest.mark.parametrize("channels", (1, 3))
@pytest.mark.parametrize("ext", EXACT_NAMES)
def test_write_image_is_pils_bytes_under_every_name(tmp_path, ext, channels):
    """PIL's bytes; SGI and IM write the file's name into their header, so
    PIL saves those under the same name. PIL writes no gray QOI."""
    img = smooth(37, 53, seed=channels)
    img = img[..., 0] if channels == 1 else img
    path = tmp_path / f"w{ext}"
    fmt = Image.registered_extensions()[ext]
    if fmt == "QOI" and channels == 1:
        with pytest.raises(ValueError, match="Unsupported QOI image mode"):
            pil_save(img, fmt)
        with pytest.raises(ValueError, match="QOI"):
            write_image(str(path), img)
        return
    write_image(str(path), img)
    got = path.read_bytes()
    if image_io._ENCODERS[ext][1] in image_io._NAMED:
        Image.fromarray(img).save(path, fmt)
        assert got == path.read_bytes()
    else:
        assert got == pil_save(img, fmt)


@pytest.mark.parametrize("ext", sorted(image_io._ENCODERS))
def test_round_trip_through_both_readers(tmp_path, ext):
    img = smooth(40, 56, seed=2)
    path = tmp_path / f"r{ext}"
    write_image(str(path), img)
    got = read_rgb(str(path))
    np.testing.assert_array_equal(got, np.asarray(Image.open(path).convert("RGB")))
    if ext not in (".webp", ".gif", ".ico") and not image_io._ENCODERS[ext][0] == "jpeg":
        np.testing.assert_array_equal(got, img)


DIB_FORMS = {
    "p1": lambda rng: W.bmp(rng.integers(0, 2, (9, 13)), 1, palette=[(10, 20, 30), (200, 7, 9)]),
    "p4": lambda rng: W.bmp(rng.integers(0, 16, (9, 13)), 4, palette=rng.integers(0, 256, (16, 3))),
    "p8_os2": lambda rng: W.bmp(rng.integers(0, 256, (9, 13)), 8,
                                palette=rng.integers(0, 256, (256, 3)), header=12),
    "rle8": lambda rng: W.bmp(rng.integers(0, 4, (9, 13)), 8, palette=rng.integers(0, 256, (4, 3)),
                              compression=1),
    "rgb24": lambda rng: W.bmp(rng.integers(0, 256, (9, 13, 3)), 24),
    "bitfields565": lambda rng: W.bmp(rng.integers(0, 65536, (9, 13)), 16, compression=3,
                                      masks=(0xF800, 0x7E0, 0x1F)),
    "v5_32": lambda rng: W.bmp(rng.integers(0, 2 ** 32, (9, 13), dtype=np.uint64), 32,
                               header=124),
}


@pytest.mark.parametrize("form", sorted(DIB_FORMS))
def test_dib_reads_as_pil(tmp_path, form):
    """A BMP without its file header (a ``.dib`` file) reads as PIL's DIB
    plugin reads it."""
    data = DIB_FORMS[form](np.random.default_rng(len(form)))[14:]
    path = tmp_path / "a.dib"
    path.write_bytes(data)
    assert Image.open(path).format == "DIB" and image_io.sniff(data) == "dib"
    np.testing.assert_array_equal(read_rgb(str(path)),
                                  np.asarray(Image.open(path).convert("RGB")))


UNREAD = sorted(ext for ext, fmt in Image.registered_extensions().items()
                if fmt in Image.SAVE and ext not in image_io._ENCODERS)


@pytest.mark.parametrize("ext", UNREAD)
def test_names_pil_writes_and_the_port_does_not_read_raise(tmp_path, ext):
    path = tmp_path / f"u{ext}"
    with pytest.raises(ValueError, match=re.escape(ext)):
        write_image(str(path), smooth(16, 16))
    assert not path.exists()


# --- WebP --------------------------------------------------------------------

WEBP_IMAGES = {
    "noise_480x640": lambda: noise(480, 640, 12),
    "gradient_480x640": lambda: gradient(480, 640),
    "smooth_480x640": lambda: smooth(480, 640),
    "textured_300x400": lambda: textured(300, 400),
    "odd_37x51": lambda: smooth(37, 51, 3),
    "flat_64x64": lambda: np.full((64, 64, 3), 77, np.uint8),
    "gray_120x90": lambda: smooth(120, 90, 4)[..., 1],
    "overlay_480x640": overlay,
}
PSNR_SLACK_DB, SIZE_RATIO = 0.5, 1.15


def webp_bounds(img):
    """(the port's PSNR, PIL's PSNR, size ratio), with the port's file
    decoded by PIL and by the port's decoder to the same pixels."""
    data, ref = encode_webp(img), pil_save(img, "WEBP")
    assert data[:4] == b"RIFF" and data[8:16] == b"WEBPVP8 "
    theirs = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(decode_webp(data)[..., :3], theirs)
    rgb = img if img.ndim == 3 else np.repeat(img[..., None], 3, 2)
    ref_pixels = np.asarray(Image.open(io.BytesIO(ref)).convert("RGB"))
    return psnr(theirs, rgb), psnr(ref_pixels, rgb), len(data) / len(ref)


@pytest.mark.parametrize("case", sorted(WEBP_IMAGES))
def test_webp_within_pils_quality_and_size(case):
    mine, pils, ratio = webp_bounds(WEBP_IMAGES[case]())
    assert mine >= pils - PSNR_SLACK_DB, (mine, pils)
    assert ratio <= SIZE_RATIO, ratio


def libwebp_yuv(rgb):
    """The planes of libwebp's ``WebPPictureImportRGB``."""
    lib = E.lib()
    h, w = rgb.shape[:2]
    pic = E.Picture()
    assert lib.WebPPictureInitInternal(ctypes.byref(pic), E.ABI)
    pic.width, pic.height = w, h
    lib.WebPPictureImportRGB.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    rgb = np.ascontiguousarray(rgb)
    assert lib.WebPPictureImportRGB(ctypes.byref(pic), rgb.ctypes.data, w * 3)
    try:
        def plane(ptr, rows, stride, cols):
            return np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)),
                                         (rows, stride))[:, :cols].copy()

        uh, uw = (h + 1) // 2, (w + 1) // 2
        return (plane(pic.y, h, pic.y_stride, w), plane(pic.u, uh, pic.uv_stride, uw),
                plane(pic.v, uh, pic.uv_stride, uw))
    finally:
        lib.WebPPictureFree(ctypes.byref(pic))


@pytest.mark.parametrize("case", ("noise_480x640", "odd_37x51", "textured_300x400"))
def test_webp_yuv_is_libwebps(case):
    img = WEBP_IMAGES[case]()
    for mine, theirs in zip(yuv420(img), libwebp_yuv(img)):
        np.testing.assert_array_equal(mine, theirs)


class BoolReader:
    """RFC 6386 section 7's boolean decoder, for the frame header."""

    def __init__(self, data):
        self.data, self.pos, self.range, self.count = data, 2, 255, 0
        self.value = (data[0] << 8) | data[1]

    def bit(self, prob):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if self.value >= split << 8:
            self.range, self.value, b = self.range - split, self.value - (split << 8), 1
        else:
            self.range, b = split, 0
        while self.range < 128:
            self.value, self.range, self.count = self.value << 1, self.range << 1, self.count + 1
            if self.count == 8:
                self.count = 0
                self.value |= self.data[self.pos] if self.pos < len(self.data) else 0
                self.pos += 1
        return b

    def value_of(self, n, signed=False):
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return -v if signed and self.bit(128) else v


def frame_header(data):
    """The segment, filter and quantizer fields of a simple lossy WebP's
    key-frame header."""
    vp8 = data[20:]
    br = BoolReader(vp8[10:10 + ((vp8[0] | vp8[1] << 8 | vp8[2] << 16) >> 5)])
    br.bit(128), br.bit(128)
    out = {"segments": br.bit(128)}
    if out["segments"]:
        out["update_map"] = br.bit(128)
        if br.bit(128):
            out["absolute"] = br.bit(128)
            out["quant"] = [br.value_of(7, True) if br.bit(128) else 0 for _ in range(4)]
            out["filter"] = [br.value_of(6, True) if br.bit(128) else 0 for _ in range(4)]
        if out["update_map"]:
            out["map_proba"] = [br.value_of(8) if br.bit(128) else 255 for _ in range(3)]
    out["simple"], out["level"], out["sharpness"] = br.bit(128), br.value_of(6), br.value_of(3)
    out["lf_delta"], out["partitions"] = br.bit(128), br.value_of(2)
    out["base_q"] = br.value_of(7)
    out["deltas"] = [br.value_of(4, True) if br.bit(128) else 0 for _ in range(5)]
    return out


@pytest.mark.parametrize("case", sorted(WEBP_IMAGES))
def test_webp_segments_and_quantizers_are_libwebps(case):
    """Analysis, segments, quantizers and the segment map's probabilities
    as libwebp sets them (the filter levels can part where libwebp raises
    them for a flat macroblock whose mode choice differs)."""
    img = WEBP_IMAGES[case]()
    mine, theirs = frame_header(encode_webp(img)), frame_header(pil_save(img, "WEBP"))
    for d in (mine, theirs):
        d.pop("filter", None), d.pop("level")
    assert mine == theirs


# --- the demo's tool ---------------------------------------------------------------

def test_visualize_json_results_writes_gif_ico_webp_as_jax(monkeypatch, tmp_path):
    """JAX's ``tools/visualize_json_results.py`` and the port's over GIF,
    ICO and WebP inputs, each overlay saved under the input's name: PIL's
    bytes for the GIF and the ICO, the WebP within the bounds."""
    import tools.visualize_json_results as jvis

    (tmp_path / "img").mkdir()
    src = {"a.gif": smooth(48, 64, 1), "b.ico": smooth(40, 40, 2), "c.webp": smooth(36, 50, 3)}
    rows = []
    rng = np.random.RandomState(5)
    for name, img in src.items():
        Image.fromarray(img).save(tmp_path / "img" / name)
        h, w = img.shape[:2]
        for j in range(3):
            rows.append({"image_id": name, "category_id": j,
                         "bbox": [rng.uniform(0, w / 2), rng.uniform(0, h / 2),
                                  rng.uniform(4, w / 2), rng.uniform(4, h / 2)],
                         "score": float(rng.uniform(0.4, 1.0))})
    (tmp_path / "p.json").write_text(json.dumps(rows))
    args = ["--input", str(tmp_path / "p.json"), "--image-root", str(tmp_path / "img")]
    monkeypatch.setattr(ImageDraw.ImageDraw, "text", lambda self, *a, **k: None)
    monkeypatch.setattr(draw, "draw_label", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["visualize_json_results.py", *args, "--output",
                                      str(tmp_path / "jax")])
    jvis.main()
    written = visualize_json_results.main([*args, "--output", str(tmp_path / "port")])
    assert sorted(Path(p).name for p in written) == sorted(src)
    for name in ("a.gif", "b.ico"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    drawn = read_rgb(str(tmp_path / "img" / "c.webp"))
    for pr in rows:
        if pr["image_id"] == "c.webp":
            x, y, w, h = pr["bbox"]
            draw.draw_rectangle(drawn, [x, y, x + w, y + h], visualize_json_results.RED, width=3)
    port = np.asarray(Image.open(tmp_path / "port" / "c.webp").convert("RGB"))
    jax = np.asarray(Image.open(tmp_path / "jax" / "c.webp").convert("RGB"))
    assert psnr(port, drawn) >= psnr(jax, drawn) - PSNR_SLACK_DB
    assert (tmp_path / "port" / "c.webp").stat().st_size <= SIZE_RATIO * (
        tmp_path / "jax" / "c.webp").stat().st_size


# --- the card's writer check -----------------------------------------------------

def test_chip_smoke_writer_digests():
    """``chip_smoke.WRITER_DIGESTS`` are the SHA-256s of the encoders'
    bytes for ``writer_check_image()``: PIL's bytes for GIF, PNG and ICO,
    the port's WebP file, which is within the bounds here."""
    img = chip_smoke.writer_check_image()
    assert img.shape == (480, 640, 3)
    files = chip_smoke.writer_files(img)
    assert sorted(files) == sorted(chip_smoke.WRITER_DIGESTS)
    for name, data in files.items():
        assert hashlib.sha256(data).hexdigest() == chip_smoke.WRITER_DIGESTS[name], name
        if name != "webp":
            assert data == pil_save(img, name.upper()), name
    mine, pils, ratio = webp_bounds(img)
    assert mine >= pils - PSNR_SLACK_DB and ratio <= SIZE_RATIO


def test_chip_smoke_webp_fixture_psnr_is_pils():
    """``chip_smoke.WEBP_FIXTURE_PSNR`` is the PSNR of PIL's WebP file of the
    lossy fixture's pixels; the port's file of them passes the card's gate."""
    fixture = read_rgb(str(FIXTURE))
    pils = np.asarray(Image.open(io.BytesIO(pil_save(fixture, "WEBP"))).convert("RGB"))
    assert psnr(pils, fixture) == pytest.approx(chip_smoke.WEBP_FIXTURE_PSNR, abs=1e-9)
    mine = decode_webp(encode_webp(fixture))[..., :3]
    assert psnr(mine, fixture) >= chip_smoke.WEBP_FIXTURE_PSNR - chip_smoke.WEBP_PSNR_SLACK
