"""Windows Paint (MSP) reading without PIL, as PIL 12.1's
``MspImagePlugin`` reads it, for ``image_io``.

``decode_msp`` gives what ``Image.open(f)`` holds: (samples, "1", None),
a set bit white:

* version 1 ("DanM"): the rows stored raw after the 32-byte header;
* version 2 ("LinS"): a table of each row's byte count, then the rows in
  PIL's ``MspDecoder`` runs (0, n, v: n bytes v; n > 0: the next n bytes);
  a row of count 0 is white. As in PIL, the decoded bytes run on from row
  to row whatever each row's length, and only their total must cover the
  image.

The header's 16 words must XOR to zero (else PIL's _open refuses it and
``Image.open`` asks the next plugin). Data cut short, a run cut inside its
two bytes, and too few decoded bytes raise ``CorruptImage``.

PIL writes MSP only from mode "1" images, so ``image_io.write_image``,
which takes uint8 gray or RGB, has no MSP writer: ``.msp`` raises, as
PIL's "cannot write mode RGB as MSP".
"""

from __future__ import annotations

import struct

import numpy as np

from ape_tpu_torch.data.image_io import CorruptImage, bomb_check


def claims(data: bytes):
    """False where MSP's _accept refuses ``data``, a reason where its _open
    raises a SyntaxError (a short header, a bad checksum, a size of zero),
    else True."""
    if not data.startswith((b"DanM", b"LinS")):
        return False
    if len(data) < 32:
        return "truncated MSP header"
    words = struct.unpack_from("<16H", data)
    checksum = 0
    for w in words:
        checksum ^= w
    if checksum:
        return "bad MSP checksum"
    return "an MSP image of size zero" if not words[2] or not words[3] else True


def decode_msp(data: bytes):
    """MSP bytes -> ((H, W) bool, "1", None)."""
    if claims(data) is not True:
        raise CorruptImage("not an MSP file")
    width, height = struct.unpack_from("<HH", data, 4)
    bomb_check(width, height)
    stride = (width + 7) // 8
    if data.startswith(b"DanM"):
        if len(data) < 32 + stride * height:
            raise CorruptImage("image file is truncated")
        rows = np.frombuffer(data, np.uint8, stride * height, 32)
    else:
        if len(data) < 32 + 2 * height:
            raise CorruptImage("Truncated MSP file in row map")
        counts = struct.unpack_from(f"<{height}H", data, 32)
        pos, out, blank = 32 + 2 * height, bytearray(), b"\xff" * stride
        for y, count in enumerate(counts):
            if not count:
                out += blank
                continue
            row = data[pos:pos + count]
            pos += count
            if len(row) != count:
                raise CorruptImage(f"Truncated MSP file, expected {count} bytes on row {y}")
            i = 0
            while i < count:
                run = row[i]
                i += 1
                if run == 0:
                    if i + 2 > count:
                        raise CorruptImage(f"Corrupted MSP file in row {y}")
                    out += row[i + 1:i + 2] * row[i]
                    i += 2
                else:
                    out += row[i:i + run]
                    i += run
        if len(out) < stride * height:
            raise CorruptImage("not enough image data")
        rows = np.frombuffer(bytes(out), np.uint8, stride * height)
    bits = np.unpackbits(rows.reshape(height, stride), axis=1)[:, :width]
    return bits.astype(bool), "1", None
