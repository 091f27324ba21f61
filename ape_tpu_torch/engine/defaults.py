"""DefaultPredictor and the argument parser (counterpart of
``ape_tpu/engine/defaults.py``). DefaultPredictor: single-image
inference against an ``APE`` wrapper. The test-time resize and pad run in torch
on the model's device: the shortest edge goes to ``image_size`` with the
longest capped at ``image_size``, bilinear as PIL resizes, then the image is
padded bottom-right to a square canvas. A ``mask_prompt`` goes into the
input under its key as given, as JAX's predictor sets it; JAX's ``APE``
reads no such key, and neither does the port's (a mask prompt reaches the
model only through ``APEDeta.forward(mask_prompt=...)``).
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


def resize_shortest_edge(image: torch.Tensor, short: int, max_size: int):
    """uint8 (H, W, 3) -> resized uint8 (h, w, 3) and the scale factor."""
    h, w = image.shape[:2]
    r = short / min(h, w)
    if max(h, w) * r > max_size:
        r = max_size / max(h, w)
    nh, nw = int(round(h * r)), int(round(w * r))
    x = image.permute(2, 0, 1)[None].float()
    x = F.interpolate(x, size=(nh, nw), mode="bilinear", align_corners=False, antialias=True)
    return x[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8), r


def normalize_and_pad(image: torch.Tensor, size: int) -> torch.Tensor:
    """uint8 (h, w, 3) -> normalized f32 (size, size, 3), zeros below and right."""
    mean = torch.tensor(PIXEL_MEAN, device=image.device)
    std = torch.tensor(PIXEL_STD, device=image.device)
    canvas = torch.zeros(size, size, 3, dtype=torch.uint8, device=image.device)
    canvas[: image.shape[0], : image.shape[1]] = image
    return (canvas.float() - mean) / std


class DefaultPredictor:
    """Single-image inference against an APE wrapper."""

    def __init__(self, ape_model, image_size: int = 1024):
        self.model = ape_model
        self.image_size = image_size

    def __call__(self, original_image: np.ndarray, text_prompt: Optional[str] = None,
                 mask_prompt: Optional[np.ndarray] = None) -> Dict:
        """original_image: RGB uint8 (H, W, 3). Returns the APE wrapper's result
        for it: instances with boxes in its pixels (and ``mask_logits``), and
        as the wrapper is configured ``sem_seg`` and ``panoptic_raw``, whose
        maps cover the padded canvas at the mask-feature resolution."""
        image = torch.as_tensor(original_image, device=self.model.device)
        h0, w0 = image.shape[:2]
        resized, r = resize_shortest_edge(image, self.image_size, self.image_size)
        inp = {
            "image": normalize_and_pad(resized, self.image_size),
            "image_size": torch.tensor(resized.shape[:2], dtype=torch.int32),
            "height": h0,
            "width": w0,
            "scale": r,
        }
        if text_prompt:
            inp["text_prompt"] = text_prompt
        if mask_prompt is not None:
            inp["mask_prompt"] = mask_prompt
        return self.model([inp])[0]


def default_argument_parser():
    """The command line of ``tools/train_net.py`` (JAX's parser, detectron2's
    flags): ``--config-file``, ``--resume``, ``--eval-only``, ``--num-gpus``
    (ranks on this machine, ``parallel.mesh.launch``), the multi-machine
    flags (``--num-machines``, ``--machine-rank``, ``--dist-url``), and
    ``key=value`` config overrides."""
    parser = argparse.ArgumentParser(description="APE on PyTorch: training and evaluation")
    parser.add_argument("--config-file", default="", metavar="FILE")
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--eval-only", action="store_true")
    parser.add_argument("--num-gpus", type=int, default=1)
    parser.add_argument("--num-machines", type=int, default=1)
    parser.add_argument("--machine-rank", type=int, default=0)
    parser.add_argument("--dist-url", default="auto")
    parser.add_argument("opts", help="dotted-path config overrides, e.g. train.max_iter=100",
                        default=None, nargs=argparse.REMAINDER)
    return parser
