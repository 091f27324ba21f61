"""The port's JPEG codec on damaged streams, held to PIL 12.1 on
libjpeg-turbo 3.1 on the same bytes: where PIL decodes (libjpeg recovering
with a warning), the port's pixels equal PIL's bit for bit; where PIL
raises, the port raises ``CorruptImage`` and ``read_image`` drops the file
as JAX's reader does.

The damage is byte surgery on PIL's files (4:2:0, 4:4:4 and gray, baseline
and progressive, with and without restart intervals) and on the arithmetic
and lossless streams of ``torch_image_writers``:

* the entropy-coded data cut, with the rest of the file kept (a marker
  reached before the data is done: zero bits, then the rest of the restart
  interval skipped);
* restart markers removed, renumbered and duplicated (libjpeg's resync);
* stuffed 0xFF bytes spliced in, so that a code no table holds comes up;
* the file cut near the end of its data (where libjpeg waits for more
  input: only where its read-ahead reaches the end does PIL raise);
* what follows a single-scan image (PIL stops at its last row);
* a marker made inside the data of a large baseline file (libjpeg's fast
  path, which falls back to the slow one at a marker);
* missing Huffman tables (libjpeg-turbo's standard ones) and progressive
  scans out of order (a warning to libjpeg);
* random bytes changed inside the data.
"""

import io
import random

import numpy as np
import pytest
from PIL import Image

import torch_image_writers as W
from ape_tpu.data.mapper import read_image as jax_read_image
from ape_tpu_torch.data.image_io import CorruptImage, read_image
from ape_tpu_torch.data.jpeg import decode_jpeg
from test_torch_image_forms import LOSSLESS_KINDS, Q75, SAMPLINGS, image, lossless_planes


def pil_jpeg(img: np.ndarray, **options) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **options)
    return buf.getvalue()


def pil_rgb(data: bytes):
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception:
        return None


def same_as_pil(data: bytes):
    """The port decodes ``data`` to PIL's pixels, or both refuse it."""
    want = pil_rgb(data)
    if want is None:
        with pytest.raises(CorruptImage):
            decode_jpeg(data)
        return None
    np.testing.assert_array_equal(decode_jpeg(data), want)
    return want


def scans(data: bytes) -> list:
    """(start, end) of each scan's entropy-coded data."""
    out, p = [], 2
    while p < len(data) - 1:
        m = data[p + 1]
        if m == 0xD9:
            break
        if 0xD0 <= m <= 0xD7 or m == 0x01:
            p += 2
            continue
        length = data[p + 2] << 8 | data[p + 3]
        if m != 0xDA:
            p += 2 + length
            continue
        start = q = p + 2 + length
        while not (data[q] == 0xFF and data[q + 1] not in (0,) + tuple(range(0xD0, 0xD8))):
            q += 1
        out.append((start, q))
        p = q
    return out


def restarts(data: bytes, start: int, end: int) -> list:
    return [q for q in range(start, end - 1) if data[q] == 0xFF and 0xD0 <= data[q + 1] <= 0xD7]


def _arith(img, sampling, **kw):
    h, w = img.shape[:2]
    planes = W.planes_of(img, "ycc") if len(sampling) == 3 else [img[..., 0]]
    return W.arithmetic_jpeg(w, h, sampling, W.coefficients(planes, sampling, Q75), Q75, **kw)


# name -> (h, w, seed) -> file bytes
FORMS = {
    "420": lambda img: pil_jpeg(img),
    "444": lambda img: pil_jpeg(img, subsampling=0),
    "gray": lambda img: pil_jpeg(img[..., 0]),
    "420_restarts": lambda img: pil_jpeg(img, restart_marker_blocks=2),
    "444_restart_rows": lambda img: pil_jpeg(img, subsampling=0, restart_marker_rows=1),
    "progressive": lambda img: pil_jpeg(img, progressive=True),
    "progressive_gray_restarts": lambda img: pil_jpeg(img[..., 0], progressive=True,
                                                      restart_marker_rows=1),
    "progressive_restarts": lambda img: pil_jpeg(img, progressive=True, restart_marker_blocks=3),
    "arithmetic": lambda img: _arith(img, SAMPLINGS["420"]),
    "arithmetic_restarts": lambda img: _arith(img, SAMPLINGS["444"], restart=3),
    "arithmetic_progressive": lambda img: _arith(img, SAMPLINGS["420"], progressive=True),
    "lossless": lambda img: W.lossless_jpeg([img[..., c] for c in range(3)], psv=4, adobe=0,
                                            jfif=False),
    "lossless_restarts": lambda img: W.lossless_jpeg(
        lossless_planes(np.dstack([img, img[..., :1]]), "rgb_420"), psv=7, restart_rows=2,
        **LOSSLESS_KINDS["rgb_420"]),
}
WITH_RESTARTS = sorted(n for n in FORMS if "restart" in n)


def form(name: str, h: int = 61, w: int = 83, seed: int = 4) -> bytes:
    return FORMS[name](image(h, w, seed))


@pytest.mark.parametrize("cut", (0.05, 0.3, 0.77))
@pytest.mark.parametrize("which", ("first", "last"))
@pytest.mark.parametrize("name", sorted(FORMS))
def test_scan_data_cut_before_a_marker(name, which, cut):
    """The scan's data runs into the next marker: the MCU in progress reads
    zero bits, the rest of its restart interval is skipped (a sequential
    frame's blocks stay zero, a progressive frame's keep earlier scans)."""
    data = form(name)
    start, end = scans(data)[0 if which == "first" else -1]
    q = start + int((end - start) * cut)
    same_as_pil(data[:q] + data[end:])


RESTART_OPS = ["removed", "duplicated"] + [f"renumbered+{k}" for k in (1, 2, 3, 4, 6, 7)]


@pytest.mark.parametrize("at", ("first", "middle", "last"))
@pytest.mark.parametrize("op", RESTART_OPS)
@pytest.mark.parametrize("name", WITH_RESTARTS)
def test_restart_markers_out_of_place(name, op, at):
    """jpeg_resync_to_restart: an RST marker removed, duplicated or
    renumbered (action 1 discards it, 2 scans on, 3 leaves it and reads an
    empty interval)."""
    data = form(name)
    start, end = scans(data)[-1]
    marks = restarts(data, start, end)
    q = marks[{"first": 0, "middle": len(marks) // 2, "last": -1}[at]]
    if op == "removed":
        damaged = data[:q] + data[q + 2:]
    elif op == "duplicated":
        damaged = data[:q] + data[q:q + 2] + data[q:]
    else:
        out = bytearray(data)
        out[q + 1] = 0xD0 + (out[q + 1] - 0xD0 + int(op.split("+")[1])) % 8
        damaged = bytes(out)
    same_as_pil(damaged)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("name", sorted(FORMS))
def test_codes_no_table_holds(name, seed):
    """Runs of stuffed 0xFF bytes spliced into the data: a Huffman code no
    table holds decodes as 0 after 17 bits (JWRN_HUFF_BAD_CODE); the
    arithmetic decoder stops its interval; lossless reads on."""
    data = form(name, seed=seed)
    rng = random.Random(seed)
    start, end = scans(data)[rng.randrange(len(scans(data)))]
    q = rng.randrange(start, max(start + 1, end - 16))
    same_as_pil(data[:q] + b"\xff\x00" * (3 + 2 * seed) + data[q:])


@pytest.mark.parametrize("back", range(0, 12, 2))
@pytest.mark.parametrize("name", ["420", "444", "gray", "420_restarts", "progressive",
                                  "arithmetic", "lossless"])
def test_file_cut_near_the_end(name, back):
    """The file cut ``back`` bytes before the end of its last scan's data,
    no EOI: PIL raises where libjpeg's read-ahead (to 57 bits) reaches the
    end of the file, and a single-scan image that needs none of the cut
    bytes decodes."""
    data = form(name)
    end = scans(data)[-1][1]
    same_as_pil(data[:end - back])


TAILS = {
    "garbage_no_eoi": b"garbage-bytes-but-no-eoi!",
    "bytes_after_eoi": b"\xff\xd9" + b"\x00" * 10,
    "app1_cut": b"\xff\xe1\xff\xff" + b"abc",
    "second_sof": b"\xff\xc0\x00\x11" + bytes(20),
    "dht_garbage": b"\xff\xc4\xff\xff" + b"\xff" * 40,
    "unknown_marker": b"\xff\x02\xff\xd9",
}


@pytest.mark.parametrize("tail", sorted(TAILS) + ["second_sos"])
@pytest.mark.parametrize("name", ["420", "gray", "progressive", "arithmetic", "lossless"])
def test_what_follows_the_scans(name, tail):
    """A single-scan image is done once its scan is: PIL stops at its last
    row, so a cut or skipped segment after it goes unseen, while a marker
    libjpeg refuses there still fails. A multi-scan image is read to EOI."""
    data = form(name)
    start, end = scans(data)[-1]
    extra = TAILS.get(tail, b"\xff\xda\x00\x08\x01\x01\x00\x00\x3f\x00" + data[start:end]
                      + b"\xff\xd9")
    same_as_pil(data[:end] + extra)


@pytest.mark.parametrize("code", (0xE7, 0xD9, 0xC4, 0xD3, 0x05, 0xFE))
@pytest.mark.parametrize("name", ["420", "444"])
def test_marker_inside_a_large_file(name, code):
    """A marker made inside the data of a 480x640 baseline file, where
    libjpeg decodes on its fast path and falls back to the slow one at the
    marker."""
    data = form(name, 480, 640, 1)
    start, end = scans(data)[0]
    stuffed = [q for q in range(start, end - 1) if data[q] == 0xFF and data[q + 1] == 0]
    q = random.Random(code).choice(stuffed[len(stuffed) // 4:])
    same_as_pil(data[:q + 1] + bytes([code]) + data[q + 2:])


def _without(data: bytes, marker: int, first_only: bool = False) -> bytes:
    out, p = data[:2], 2
    dropped = False
    while True:
        m = data[p + 1]
        if m == 0xDA:
            return out + data[p:]
        length = data[p + 2] << 8 | data[p + 3]
        if m != marker or (first_only and dropped):
            out += data[p:p + 2 + length]
        else:
            dropped = True
        p += 2 + length


@pytest.mark.parametrize("name", ["420", "444", "gray", "420_restarts"])
def test_missing_huffman_tables_are_the_standard_ones(name):
    """Motion-JPEG style frames without DHT: libjpeg-turbo decodes them
    with the standard tables of the specification (jstdhuff.c)."""
    assert same_as_pil(_without(form(name), 0xC4)) is not None


@pytest.mark.parametrize("name", ["progressive", "progressive_restarts", "lossless"])
def test_missing_huffman_tables_refused_without_standard_ones(name):
    """Progressive and lossless frames get no standard tables: a scan whose
    table no DHT defined fails in PIL, and the port drops the file."""
    assert same_as_pil(_without(form(name), 0xC4, first_only=True)) is None


def test_progressive_scans_out_of_order():
    """An AC scan before its DC scan, or a DC scan dropped, is a warning to
    libjpeg (JWRN_BOGUS_PROGRESSION): PIL decodes both."""
    data = form("progressive")
    first = data.rindex(b"\xff\xda", 0, scans(data)[0][0])
    dc_end = scans(data)[0][1]
    second_end = scans(data)[1][1]
    assert same_as_pil(data[:first] + data[dc_end:]) is not None
    swapped = data[:first] + data[dc_end:second_end] + data[first:dc_end] + data[second_end:]
    assert same_as_pil(swapped) is not None


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("name", sorted(FORMS))
def test_random_bytes_changed(name, seed):
    """Up to four bytes of the data changed at random (markers made,
    stuffing broken, codes turned): PIL's pixels, or both refuse."""
    data = bytearray(form(name, seed=seed))
    rng = random.Random(seed * 31 + len(name))
    start = scans(bytes(data))[0][0]
    for _ in range(rng.randint(1, 4)):
        q = rng.randrange(start, len(data) - 2)
        data[q] = rng.randrange(256) if seed % 2 else data[q] ^ (1 << rng.randrange(8))
    same_as_pil(bytes(data))


def test_read_image_keeps_and_drops_as_jax(tmp_path):
    """Through the readers: a recovered file is kept with PIL's pixels, a
    truncated one dropped (None), by JAX's reader and the port's alike."""
    data = form("420_restarts")
    start, end = scans(data)[0]
    files = {"recovered.jpg": data[:(start + end) // 2] + data[end:],
             "truncated.jpg": data[:(start + end) // 2]}
    for name, body in files.items():
        path = tmp_path / name
        path.write_bytes(body)
        want, got = jax_read_image(str(path)), read_image(str(path))
        assert (want is None) == (name == "truncated.jpg") == (got is None)
        if want is not None:
            np.testing.assert_array_equal(got, want)
