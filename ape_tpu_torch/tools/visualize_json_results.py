"""Plot saved predictions over their images (counterpart of
``tools/visualize_json_results.py``), without PIL:

    python -m ape_tpu_torch.tools.visualize_json_results --input predictions.json \\
        --image-root <dir> --output <dir> [--conf-threshold 0.3]

Each prediction (``demo_lazy``'s or an evaluator's rows: ``image_id``, an xywh
``bbox``, ``score``, ``category_name`` or ``category_id``) at or above the
threshold is drawn on its image as a red width-3 box with its label; the
image is read by ``data.image_io.read_image`` (JPEG, PNG, BMP, GIF, WebP,
TIFF, Netpbm, TGA or ICO) and written under the same basename by
``write_image`` (PIL's bytes for JPEG, PNG, BMP/DIB, GIF, ICO, TIFF, Netpbm
and TGA names, a lossy WebP file at PIL's settings for ``.webp``; another
name raises ``ValueError``). Images that are not found are
skipped, as JAX's are. The boxes equal PIL's bit for bit; the labels come from the port's
glyph table (``utils.draw.draw_label``).
"""

from __future__ import annotations

import argparse
import json
import os

RED = (255, 40, 40)


def get_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--input", required=True, help="predictions json")
    p.add_argument("--image-root", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--conf-threshold", type=float, default=0.3)
    return p


def main(argv=None):
    """Draw ``argv``'s predictions; returns the paths written."""
    from ape_tpu_torch.data.image_io import CorruptImage, read_image, write_image
    from ape_tpu_torch.utils.draw import draw_label, draw_rectangle

    args = get_parser().parse_args(argv)
    with open(args.input) as f:
        preds = json.load(f)
    by_img = {}
    for pr in preds:
        by_img.setdefault(str(pr["image_id"]), []).append(pr)

    os.makedirs(args.output, exist_ok=True)
    written = []
    for img_id, prs in by_img.items():
        path = os.path.join(args.image_root, img_id)
        if not os.path.exists(path):
            continue
        img = read_image(path)
        if img is None:
            raise CorruptImage(f"{path}: the image could not be read")
        for pr in prs:
            if pr["score"] < args.conf_threshold:
                continue
            x, y, w, h = pr["bbox"]
            draw_rectangle(img, [x, y, x + w, y + h], RED, width=3)
            label = pr.get("category_name", str(pr["category_id"]))
            draw_label(img, (x + 2, max(y - 12, 0)), f"{label} {pr['score']:.2f}", RED)
        out = os.path.join(args.output, os.path.basename(img_id))
        write_image(out, img)
        written.append(out)
    return written


if __name__ == "__main__":
    main()
