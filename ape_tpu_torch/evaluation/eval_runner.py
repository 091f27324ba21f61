"""The evaluation runner (counterpart of ``ape_tpu/evaluation/
eval_runner.py``): ``evaluate_dataset`` routes a registered dataset by its
evaluator type; the COCO and LVIS routes (``_eval_detection``) run the
port's ``APE`` on each mapped image, paste the instance masks into their
boxes, and feed ``COCOEvaluator`` or ``LVISEvaluator``. The OID, semantic,
referring and panoptic routes raise, naming ROADMAP Queue 1 #3's item; the
per-image bodies of the semantic and panoptic loops are here already
(``sem_seg_step``, ``panoptic_step``).

JAX resizes with PIL's ``Image.resize(..., BILINEAR)``; ``pil_resize``
(``data.transforms``) is PIL's, bit for bit, so a pixel near 127
thresholds as it does under PIL.

The model's maps (``sem_seg``, ``panoptic_raw``'s mask logits) cover the
padded square canvas at the mask-feature resolution; JAX resizes the
whole canvas to the ground truth's (h, w), and these steps do the same
(ROADMAP Queue 3, trait 14).
"""

from __future__ import annotations

import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from ape_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog
from ape_tpu_torch.data.transforms import pil_resize
from ape_tpu_torch.evaluation.other_evals import PanopticEvaluator, SemSegEvaluator
from ape_tpu_torch.evaluation.panoptic_merge import panoptic_merge

logger = logging.getLogger("ape_tpu_torch")

CHUNK = 8  # maps a thread resizes at a time


def paste_masks(mask_logits: np.ndarray, boxes: np.ndarray, h: int, w: int) -> List[np.ndarray]:
    """Per-instance full-image binary masks from feature-res logits + boxes:
    the sigmoid to uint8, PIL's bilinear resize to (h, w), then > 127 inside
    the box rounded to pixels and clipped to the image. The resizes run
    CHUNK masks at a time on a thread a core."""
    n = len(boxes)
    out = [np.zeros((h, w), bool) for _ in range(n)]

    def paste(i0):
        prob = 1.0 / (1.0 + np.exp(-np.asarray(mask_logits[i0:i0 + CHUNK])))
        full = pil_resize((prob * 255).astype(np.uint8), h, w)
        for i in range(i0, min(i0 + CHUNK, n)):
            x0, y0, x1, y1 = [int(round(v)) for v in boxes[i]]
            x0, y0 = max(x0, 0), max(y0, 0)
            x1, y1 = min(x1, w), min(y1, h)
            if x1 > x0 and y1 > y0:
                out[i][y0:y1, x0:x1] = full[i - i0, y0:y1, x0:x1] > 127

    starts = range(0, n, CHUNK)
    if n:
        with ThreadPoolExecutor(max(1, min(len(starts), len(os.sched_getaffinity(0))))) as pool:
            list(pool.map(paste, starts))  # reads every result: a failed chunk raises
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


def resolve_evaluator_type(dataset_name: str, override: Optional[str] = None) -> str:
    if override:
        return override
    return MetadataCatalog.get(dataset_name).get("evaluator_type", "coco")


def _eval_detection(ape, dataset_name, mapper, iou_types, max_dets, lvis, rank, world_size):
    """The COCO and LVIS route: each image through ``ape``, its instances
    to the host, masks pasted at the image's size for segm, into one
    evaluator per IoU type. Returns the metrics and, beside them,
    ``inference_on_dataset``'s stage seconds and image count, with the
    compute split into ``seconds/device`` (the forward, to a synchronised
    card) and ``seconds/postprocess`` (the copy to the host and the
    pasting)."""
    import torch

    from ape_tpu_torch.data.build import build_detection_test_loader
    from ape_tpu_torch.engine.trainer import inference_on_dataset
    from ape_tpu_torch.evaluation.coco_eval import COCOEvaluator
    from ape_tpu_torch.evaluation.lvis_eval import LVISEvaluator

    dicts = DatasetCatalog.get(dataset_name)
    loader = build_detection_test_loader(dataset_name, mapper, rank, world_size)
    cls = LVISEvaluator if lvis else COCOEvaluator
    evaluators = {t: cls(dicts, t, max_dets) for t in iou_types}
    stages = {"seconds/device": 0.0, "seconds/postprocess": 0.0}

    def forward(ex):
        t0 = time.perf_counter()
        pred = ape([ex])[0]
        if ape.device.type == "cuda":
            torch.cuda.synchronize(ape.device)
        t1 = time.perf_counter()
        inst = to_host(pred.get("instances", {}))
        boxes = np.asarray(inst.get("boxes", np.zeros((0, 4))))
        h, w = ex.get("height", 0), ex.get("width", 0)
        record = {
            "image_id": ex.get("image_id", ex.get("dataset_dict", {}).get("image_id", 0)),
            "instances": {
                "boxes": boxes,
                "scores": np.asarray(inst.get("scores", [])),
                "classes": np.asarray(inst.get("classes", [])),
            },
        }
        if "segm" in iou_types and "mask_logits" in inst and h and w:
            record["instances"]["masks"] = paste_masks(inst["mask_logits"], boxes, h, w)
        stages["seconds/device"] += t1 - t0
        stages["seconds/postprocess"] += time.perf_counter() - t1
        return record

    return {**inference_on_dataset(forward, loader, list(evaluators.values())), **stages}


# the routes that wait, and the ROADMAP item that ports each
_WAITING = {
    "oid": "the OID, D3 and unified evaluators",
    "sem_seg": "the semantic, panoptic and copy-paste mappers and the remaining _eval_* loops",
    "refcoco": "the remaining _eval_* loops",
    "panoptic": "the semantic, panoptic and copy-paste mappers and the remaining _eval_* loops",
}


def evaluate_dataset(
    ape,
    dataset_name: str,
    mapper,
    iou_types=("bbox",),
    max_dets: int = 100,
    rank: int = 0,
    world_size: int = 1,
    evaluator_type: Optional[str] = None,
) -> Dict[str, float]:
    """Route by evaluator type (reference tools/train_net.py:455-472): coco,
    coco_panoptic_seg and lvis run ``_eval_detection``; the other routes
    raise until ported. The metrics come with the stage seconds
    (``_eval_detection``)."""
    ape.set_eval_dataset(dataset_name)
    etype = resolve_evaluator_type(dataset_name, evaluator_type)
    if etype in ("coco", "coco_panoptic_seg", "lvis"):
        return _eval_detection(ape, dataset_name, mapper, iou_types, max_dets,
                               lvis=(etype == "lvis"), rank=rank, world_size=world_size)
    if etype in _WAITING:
        raise NotImplementedError(f"{dataset_name}: the {etype!r} evaluation is not ported yet "
                                  f"(ROADMAP Queue 1 #3: {_WAITING[etype]})")
    raise ValueError(f"unknown evaluator_type {etype!r} for {dataset_name}")
