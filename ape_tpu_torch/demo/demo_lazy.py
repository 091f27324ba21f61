"""The prompted image and video demo (counterpart of ``demo/demo_lazy.py``):

    python -m ape_tpu_torch.demo.demo_lazy --config-file <config> \\
        --input img.jpg [more.jpg 'dir/*.jpg'] --output out/ \\
        --text-prompt "person,dog" [--with-mask] [--with-sseg] key=value ...

JAX's flags and outputs: one overlay a file under ``--output`` with the
input's basename (the input read by ``data.image_io.read_image``: JPEG, PNG,
BMP, GIF, WebP, TIFF, Netpbm, TGA or ICO, by content; the overlay written by
``write_image`` under every name PIL registers for those formats: PIL's
bytes for JPEG, PNG, BMP/DIB, GIF, ICO, TIFF, Netpbm and TGA names, a lossy
WebP file at PIL's settings for ``.webp``; any other name raises
``ValueError``), and ``predictions.json``
with one row an instance (every instance the model returns, score at least 0.05:
image id, category id and name, xywh box, score). ``--video-input``,
``--webcam`` and ``--grabcut`` need OpenCV and raise ``ImportError`` without
it.

``build_model`` reads the config with the port's ``LazyConfig``, builds the
model as ``tools.train_net`` does (bfloat16 on the card, float32 on the CPU),
loads ``--init-checkpoint`` (else ``train.init_checkpoint``) with
``load_checkpoint_tolerant``, builds the language tower of the config, and
wraps them in ``APE`` with ``max_text=train.num_text``; the image size is
``train.image_size`` (default 1024). It runs on the card, or on the CPU
with ``train.device=cpu`` or ``main(argv, device="cpu")``.
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import time

import torch

logger = logging.getLogger("ape_tpu_torch")


def get_parser():
    parser = argparse.ArgumentParser(description="APE demo on PyTorch")
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--input", nargs="+", help="image file(s) or glob")
    parser.add_argument("--video-input", default=None, help="video file path")
    parser.add_argument("--webcam", action="store_true", help="camera 0 stream")
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--grabcut", action="store_true", help="GrabCut mask refine")
    parser.add_argument("--output", default="", help="output dir")
    parser.add_argument("--text-prompt", default=None)
    parser.add_argument("--with-box", action="store_true", default=True)
    parser.add_argument("--with-mask", action="store_true", default=False)
    parser.add_argument("--with-sseg", action="store_true", default=False)
    parser.add_argument("--confidence-threshold", type=float, default=0.3)
    parser.add_argument("--init-checkpoint", default="")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER, help="config overrides")
    return parser


def build_model(args, device=None):
    """(APE wrapper, image size) for the parsed ``args`` (module docstring)."""
    from ape_tpu_torch.checkpoint.convert import load_checkpoint_tolerant
    from ape_tpu_torch.config import LazyConfig
    from ape_tpu_torch.device import default_device
    from ape_tpu_torch.engine.ape_wrapper import APE
    from ape_tpu_torch.tools import train_net

    cfg = LazyConfig.load(args.config_file)
    LazyConfig.apply_overrides(cfg, [o for o in (args.opts or []) if "=" in o])
    device = torch.device(default_device("demo_lazy", device or cfg.train.get("device", None)))
    model = train_net._build(cfg, device)
    init = args.init_checkpoint or cfg.train.get("init_checkpoint", "")
    if init:
        load_checkpoint_tolerant(init, model)
    model.eval()
    ape = APE(model, train_net.build_language(cfg, device),
              max_text=int(cfg.train.get("num_text", 80)), test_score_thresh=0.05)
    return ape, int(cfg.train.get("image_size", 1024))


def _rows(path, pred):
    """``predictions.json``'s rows for one image: every instance."""
    from ape_tpu_torch.demo.predictor_lazy import _host

    inst = pred.get("instances") or {"boxes": [], "classes": [], "scores": []}
    names = pred["text_list"]
    rows = []
    for box, cls, score in zip(*(_host(inst[k]) for k in ("boxes", "classes", "scores"))):
        x0, y0, x1, y1 = [float(v) for v in box]
        rows.append({"image_id": os.path.basename(path), "category_id": int(cls),
                     "category_name": names[int(cls)] if int(cls) < len(names) else "",
                     "bbox": [x0, y0, x1 - x0, y1 - y0], "score": float(score)})
    return rows


def main(argv=None, device=None):
    """Run the demo on ``argv`` (default: the command line). Returns one
    record a request: path, instances, and its device, draw and write
    seconds."""
    from ape_tpu_torch.data.image_io import CorruptImage, read_image, write_image
    from ape_tpu_torch.demo.predictor_lazy import VisualizationDemo, _cv2, run_on_video
    from ape_tpu_torch.tools.train_net import setup_logger

    setup_logger()
    args = get_parser().parse_args(argv)
    if args.video_input or args.webcam:
        cv2 = _cv2("--video-input and --webcam")
    ape, img_size = build_model(args, device)
    demo = VisualizationDemo(ape, img_size, args.confidence_threshold)

    if args.video_input or args.webcam:
        src = 0 if args.webcam else args.video_input
        writer = None
        for idx, vis in run_on_video(demo, src, text_prompt=args.text_prompt,
                                     with_box=args.with_box, with_mask=args.with_mask,
                                     max_frames=args.max_frames):
            if args.output:
                if writer is None:
                    os.makedirs(args.output, exist_ok=True)
                    h, w = vis.shape[:2]
                    writer = cv2.VideoWriter(os.path.join(args.output, "out.mp4"),
                                             cv2.VideoWriter_fourcc(*"mp4v"), 15, (w, h))
                writer.write(vis[:, :, ::-1])
            logger.info(f"frame {idx} done")
        if writer is not None:
            writer.release()
        return []

    paths = []
    for p in args.input or []:
        paths.extend(sorted(glob.glob(p)) if any(c in p for c in "*?[") else [p])
    os.makedirs(args.output or ".", exist_ok=True)

    coco_results, records = [], []
    for path in paths:
        image = read_image(path)
        if image is None:
            raise CorruptImage(f"{path}: the image could not be read")
        pred, vis = demo.run_on_image(image, text_prompt=args.text_prompt,
                                      with_box=args.with_box, with_mask=args.with_mask,
                                      with_sseg=args.with_sseg, grabcut=args.grabcut)
        rows = _rows(path, pred)
        logger.info(f"{path}: detected {len(rows)} instances in {len(pred['text_list'])}-word "
                    "vocab")
        t = time.perf_counter()
        if args.output:
            write_image(os.path.join(args.output, os.path.basename(path)), vis)
            coco_results.extend(rows)
        records.append({"path": path, "instances": len(rows), **demo.last_seconds,
                        "write": time.perf_counter() - t})
    if args.output and coco_results:
        with open(os.path.join(args.output, "predictions.json"), "w") as f:
            json.dump(coco_results, f)
    return records


if __name__ == "__main__":
    main()
