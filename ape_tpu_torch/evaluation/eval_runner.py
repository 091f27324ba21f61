"""The host side of one image's evaluation (counterpart of
``ape_tpu/evaluation/eval_runner.py``): PIL's bilinear resizes in NumPy,
the instance masks pasted into their boxes, and the per-image bodies of
JAX's semantic and panoptic evaluation loops. The loaders that feed them
wait for the port's data path.

JAX resizes with PIL's ``Image.resize(..., BILINEAR)``; the card machine
has no PIL, so ``pil_resize`` reproduces it: a triangle filter of support
1, widened by the scale when a side shrinks, taps past the edge dropped and
the rest renormalised, one axis after the other (columns first), the
coefficients in f64. Float maps (PIL's mode "F") sum the taps in f64 in
PIL's order and store each pass as f32; uint8 maps (mode "L") take the
coefficients to 22-bit fixed point, sum in integers from half a unit,
shift and clip each pass to 0..255, PIL's own rounding, so a pixel near 127
thresholds as it does under PIL.

The model's maps (``sem_seg``, ``panoptic_raw``'s mask logits) cover the
padded square canvas at the mask-feature resolution; JAX resizes the
whole canvas to the ground truth's (h, w), and these steps do the same
(ROADMAP Queue 3, trait 14).
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence, Set, Tuple

import numpy as np

from ape_tpu_torch.evaluation.other_evals import PanopticEvaluator, SemSegEvaluator
from ape_tpu_torch.evaluation.panoptic_merge import panoptic_merge

PRECISION_BITS = 32 - 8 - 2  # PIL's fixed point for 8-bit resampling
CHUNK = 8  # maps a thread resizes at a time


def _coefficients(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """PIL's ``precompute_coeffs`` for the bilinear filter: per output
    pixel the first input tap (out_size,) and the tap weights (out_size,
    ksize), zero past the taps that lie inside the input."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    starts = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.float64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [max(0.0, 1.0 - abs((x + xmin - center + 0.5) * ss)) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        starts[xx] = xmin
        weights[xx, :xmax] = [w / ww for w in k] if ww != 0.0 else k
    return starts, weights


def _fixed_point(weights: np.ndarray) -> np.ndarray:
    """PIL's ``normalize_coeffs_8bpc``: the weights to 22-bit fixed point,
    rounded half away from zero by truncation."""
    scaled = weights * (1 << PRECISION_BITS)
    return np.where(scaled < 0, scaled - 0.5, scaled + 0.5).astype(np.int64)


def _resample(x: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One PIL pass along ``axis`` of a float32 or uint8 array: the taps
    summed in PIL's order (a tap whose weight is 0 everywhere is skipped:
    it would add 0)."""
    in_size = x.shape[axis]
    starts, weights = _coefficients(in_size, out_size)
    integer = x.dtype == np.uint8
    coeffs = _fixed_point(weights) if integer else weights
    shape = [1] * x.ndim
    shape[axis] = out_size
    acc = np.full(x.shape[:axis] + (out_size,) + x.shape[axis + 1:],
                  1 << (PRECISION_BITS - 1) if integer else 0.0,
                  np.int64 if integer else np.float64)
    term = np.empty_like(acc)
    for k in range(weights.shape[1]):
        if not coeffs[:, k].any():
            continue
        taps = x.take(np.minimum(starts + k, in_size - 1), axis=axis)
        np.multiply(taps, coeffs[:, k].reshape(shape), out=term)
        acc += term
    if integer:
        return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return acc.astype(np.float32)


def pil_resize(x: np.ndarray, h: int, w: int) -> np.ndarray:
    """``np.asarray(Image.fromarray(x).resize((w, h), Image.BILINEAR))`` for
    a float32 or uint8 array (..., H, W): columns first, then rows; a side
    that keeps its size is not resampled."""
    if x.dtype not in (np.float32, np.uint8):
        raise TypeError(f"pil_resize takes float32 or uint8 maps, not {x.dtype}")
    if x.shape[-1] != w:
        x = _resample(x, w, x.ndim - 1)
    if x.shape[-2] != h:
        x = _resample(x, h, x.ndim - 2)
    return x


def paste_masks(mask_logits: np.ndarray, boxes: np.ndarray, h: int, w: int) -> List[np.ndarray]:
    """Per-instance full-image binary masks from feature-res logits + boxes:
    the sigmoid to uint8, PIL's bilinear resize to (h, w), then > 127 inside
    the box rounded to pixels and clipped to the image."""
    out = []
    for i in range(len(boxes)):
        prob = 1.0 / (1.0 + np.exp(-mask_logits[i]))
        full = pil_resize((prob * 255).astype(np.uint8), h, w)
        m = np.zeros((h, w), bool)
        x0, y0, x1, y1 = [int(round(v)) for v in boxes[i]]
        x0, y0 = max(x0, 0), max(y0, 0)
        x1, y1 = min(x1, w), min(y1, h)
        if x1 > x0 and y1 > y0:
            m[y0:y1, x0:x1] = full[y0:y1, x0:x1] > 127
        out.append(m)
    return out


def upsample_prob_maps(probs: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear resize (T, Hm, Wm) -> (T, h, w) f32 as PIL's mode "F", in
    chunks of CHUNK maps on a thread a core this process may run on
    (NumPy releases the GIL in its loops; JAX resizes one map at a time, a
    thread)."""
    probs = np.asarray(probs, np.float32)
    out = np.empty((probs.shape[0], h, w), np.float32)

    def resize(i):
        out[i:i + CHUNK] = pil_resize(probs[i:i + CHUNK], h, w)

    starts = range(0, probs.shape[0], CHUNK)
    with ThreadPoolExecutor(max(1, min(len(starts), len(os.sched_getaffinity(0))))) as pool:
        list(pool.map(resize, starts))  # reads every result: a failed chunk raises
    return out


def sem_seg_step(sem_seg: np.ndarray, gt: np.ndarray, evaluator: SemSegEvaluator) -> np.ndarray:
    """One image of JAX's ``_eval_sem_seg``: the per-class maps (T, Hm, Wm)
    resized to the ground truth's (h, w), their argmax into the evaluator
    against ``gt`` (h, w). Returns the predicted label map."""
    h, w = gt.shape[:2]
    pred = upsample_prob_maps(sem_seg, h, w).argmax(0)
    evaluator.process(pred, gt)
    return pred


def panoptic_step(raw: Dict[str, np.ndarray], gt_seg: np.ndarray, gt_info: Sequence[dict],
                  thing_ids: Set[int], evaluator: PanopticEvaluator):
    """One image of JAX's ``_eval_panoptic``: ``panoptic_raw``'s mask logits
    resized to the ground truth's (h, w), their sigmoid, the merge, and the
    segments into the evaluator against ``gt_seg`` and ``gt_info``. Returns
    (segment map (h, w) int32, segments_info)."""
    h, w = gt_seg.shape[:2]
    masks_prob = 1.0 / (1.0 + np.exp(-upsample_prob_maps(raw["mask_logits"], h, w)))
    seg, info = panoptic_merge(raw["scores"], raw["labels"], raw["raw_scores"], masks_prob,
                               thing_ids)
    evaluator.process(seg, info, np.asarray(gt_seg), list(gt_info))
    return seg, info


def to_host(out):
    """A result of the port's ``APE`` (tensors on its device) as NumPy on
    the host, f32 for floating maps, for the steps above."""
    if isinstance(out, dict):
        return {k: to_host(v) for k, v in out.items()}
    if hasattr(out, "detach"):
        t = out.detach()
        return (t.float() if t.is_floating_point() else t).cpu().numpy()
    return out
