"""Write the WebP files ``chip_smoke.py``'s image_containers phase reads
(``tests/data/image_containers/``): the card machine has neither PIL nor
libwebp to make them. Rerun from the repository's root after changing them,
then update ``chip_smoke.IMAGE_CONTAINERS_DIGESTS`` with the SHA-256s it
prints (``tests/test_torch_image_containers.py`` holds them to PIL's):

    python tests/make_image_container_fixtures.py

Each is 640x480, from ``chip_smoke.container_image``:

* ``webp_lossy.webp``: PIL's ``save`` at quality 80 (the normal loop
  filter, one token partition);
* ``webp_alpha.webp``: lossy with an alpha channel (VP8X, ALPH coded
  lossless), PIL's ``save`` at quality 80;
* ``webp_lossless.webp``: VP8L of the image posterized to 8 levels a
  channel;
* ``webp_animated.webp``: two frames; the first, 400x300 at (120, 90) on the
  canvas, with alpha, libwebp's simple loop filter, four token partitions,
  four segments and sharpness 7 (through ``torch_webp_encoder``).
"""

import hashlib
import io
import sys
from pathlib import Path

import numpy as np
from PIL import Image

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import chip_smoke  # noqa: E402
import torch_webp_encoder as E  # noqa: E402


def _pil(image: np.ndarray, **options) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(image).save(buf, "WEBP", **options)
    return buf.getvalue()


def fixtures() -> dict:
    """name -> bytes of each WebP fixture."""
    img, alpha = chip_smoke.container_image()
    rgba = np.dstack([img, alpha])
    first = E.encode(rgba[90:390, 120:520], quality=70, filter_type=0, partitions=2, segments=4,
                     filter_sharpness=7)
    second = E.encode(rgba[::-1], quality=50)
    return {
        "webp_lossy.webp": _pil(img, quality=80),
        "webp_alpha.webp": _pil(rgba, quality=80),
        "webp_lossless.webp": _pil((img // 32 * 32 + 16).astype(np.uint8), lossless=True),
        "webp_animated.webp": E.animated([(first, 120, 90), (second, 0, 0)], (640, 480)),
    }


def main():
    out = ROOT / chip_smoke.CONTAINER_FIXTURES
    out.mkdir(parents=True, exist_ok=True)
    for name, data in fixtures().items():
        (out / name).write_bytes(data)
        pixels = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        print(f"{name}: {len(data)} bytes, PIL's pixels {hashlib.sha256(pixels.tobytes()).hexdigest()}")


if __name__ == "__main__":
    main()
