"""The evaluation runner (counterpart of ``ape_tpu/evaluation/
eval_runner.py``): ``evaluate_dataset`` routes a registered dataset by its
evaluator type, each route running the port's ``APE`` on every mapped image
as JAX's loop does: COCO and LVIS (instances, masks pasted into their boxes,
``COCOEvaluator`` or ``LVISEvaluator``), OpenImages (``OIDEvaluator``), the
semantic maps (``SemSegEvaluator``), the referring expressions (one forward
an expression, ``RefCOCOEvaluator``) and the panoptic merge
(``PanopticEvaluator``). Each returns its metrics with the seconds of each
stage and what it ran and scored (``_Stages``).

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

from ape_tpu_torch.data.catalog import DatasetCatalog, MetadataCatalog, get_text_list
from ape_tpu_torch.data.transforms import pil_resize, polygons_to_mask, rle_decode
from ape_tpu_torch.evaluation.other_evals import (
    PanopticEvaluator,
    RefCOCOEvaluator,
    SemSegEvaluator,
)
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


def panoptic_segments(raw: Dict[str, np.ndarray], h: int, w: int, thing_ids: Set[int]):
    """``panoptic_raw``'s mask logits resized to (h, w), their sigmoid and
    the merge: (segment map (h, w) int32, segments_info)."""
    masks_prob = 1.0 / (1.0 + np.exp(-upsample_prob_maps(raw["mask_logits"], h, w)))
    return panoptic_merge(raw["scores"], raw["labels"], raw["raw_scores"], masks_prob, thing_ids)


def panoptic_step(raw: Dict[str, np.ndarray], gt_seg: np.ndarray, gt_info: Sequence[dict],
                  thing_ids: Set[int], evaluator: PanopticEvaluator):
    """One image of JAX's ``_eval_panoptic``: ``panoptic_segments`` at the
    ground truth's (h, w), and the segments into the evaluator against
    ``gt_seg`` and ``gt_info``. Returns (segment map, segments_info)."""
    seg, info = panoptic_segments(raw, *gt_seg.shape[:2], thing_ids)
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


class _Stages:
    """The seconds of an evaluation loop by stage: ``data`` (the loader's
    read and map), ``device`` (the forward, to a synchronised card),
    ``postprocess`` (the copy to the host, resizes, pasting, the merge) and
    ``eval`` (the evaluator's per-image work and its final reduction); and
    the counts: ``images`` mapped and run, ``forwards`` of the model and
    ``scored`` (what reached the evaluator: images, or expressions for the
    referring route)."""

    def __init__(self, ape):
        self.ape = ape
        self.seconds = {k: 0.0 for k in ("data", "device", "postprocess", "eval")}
        self.counts = {"images": 0, "forwards": 0, "scored": 0}
        self._t = time.perf_counter()

    def lap(self, stage: str) -> None:
        """Add the time since the last lap to ``stage``."""
        t = time.perf_counter()
        self.seconds[stage] += t - self._t
        self._t = t

    def forward(self, inputs: Dict) -> Dict:
        """``ape`` on one input, timed as ``device``; its result on the host,
        timed as ``postprocess``."""
        import torch

        pred = self.ape([inputs])[0]
        if self.ape.device.type == "cuda":
            torch.cuda.synchronize(self.ape.device)
        self.lap("device")
        self.counts["forwards"] += 1
        out = to_host(pred)
        self.lap("postprocess")
        return out

    def results(self, metrics: Dict) -> Dict:
        return {**metrics, **{f"seconds/{k}": v for k, v in self.seconds.items()},
                **self.counts}


def _instances_record(ex, inst, iou_types=()) -> Dict:
    """An image's instances as the COCO, LVIS and OID evaluators read them
    (masks pasted at the image's size for segm)."""
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
    return record


def _eval_instances(ape, dataset_name, mapper, evaluators, iou_types, rank, world_size):
    """Each image through ``ape``, its instances to the host, into the
    evaluators, by ``inference_on_dataset``: its metrics, stage seconds and
    image count, with the compute split into ``seconds/device`` and
    ``seconds/postprocess`` (the copy to the host and the pasting)."""
    from ape_tpu_torch.data.build import build_detection_test_loader
    from ape_tpu_torch.engine.trainer import inference_on_dataset

    loader = build_detection_test_loader(dataset_name, mapper, rank, world_size)
    stages = _Stages(ape)

    def forward(ex):
        stages.lap("data")  # the loop's own seconds/data stand
        inst = stages.forward(ex).get("instances", {})
        record = _instances_record(ex, inst, iou_types)
        stages.lap("postprocess")
        return record

    out = inference_on_dataset(forward, loader, evaluators)
    out.update({"seconds/device": stages.seconds["device"],
                "seconds/postprocess": stages.seconds["postprocess"],
                "forwards": stages.counts["forwards"], "scored": out["images"]})
    return out


def _eval_detection(ape, dataset_name, mapper, iou_types, max_dets, lvis, rank, world_size):
    """The COCO and LVIS route: one evaluator per IoU type."""
    from ape_tpu_torch.evaluation.coco_eval import COCOEvaluator
    from ape_tpu_torch.evaluation.lvis_eval import LVISEvaluator

    dicts = DatasetCatalog.get(dataset_name)
    cls = LVISEvaluator if lvis else COCOEvaluator
    evaluators = [cls(dicts, t, max_dets) for t in iou_types]
    return _eval_instances(ape, dataset_name, mapper, evaluators, iou_types, rank, world_size)


def _eval_oid(ape, dataset_name, mapper, max_dets, rank, world_size):
    """The OpenImages route: boxes into ``OIDEvaluator`` with the metadata's
    ``class_ancestors``."""
    from ape_tpu_torch.evaluation.oid_eval import OIDEvaluator

    dicts = DatasetCatalog.get(dataset_name)
    meta = MetadataCatalog.get(dataset_name)
    ev = OIDEvaluator(dicts, ancestors=meta.get("class_ancestors"), max_dets=max_dets)
    return _eval_instances(ape, dataset_name, mapper, [ev], (), rank, world_size)


def _eval_sem_seg(ape, dataset_name, mapper, rank, world_size):
    """The semantic route, JAX's loop: every image through ``ape``; where it
    has a ground truth (a ``sem_seg`` array, else the ``sem_seg_file_name``
    label map) the maps resized to it, their argmax scored. The class count
    is the metadata's vocabulary, read before the loader."""
    from ape_tpu_torch.data.build import build_detection_test_loader
    from ape_tpu_torch.data.image_io import read_label_map

    meta = MetadataCatalog.get(dataset_name)
    num_classes = len(get_text_list(meta))
    ev = SemSegEvaluator(num_classes, ignore_label=meta.get("ignore_label", 255))
    loader = build_detection_test_loader(dataset_name, mapper, rank, world_size)
    stages = _Stages(ape)
    for ex in loader():
        stages.lap("data")
        stages.counts["images"] += 1
        pred = stages.forward(ex)
        if "sem_seg" not in pred:
            continue
        dd = ex.get("dataset_dict", {})
        gt = dd.get("sem_seg")
        if gt is None and dd.get("sem_seg_file_name"):
            gt = read_label_map(dd["sem_seg_file_name"])
        if gt is None:
            continue
        h, w = gt.shape[:2]
        labels = upsample_prob_maps(np.asarray(pred["sem_seg"]), h, w).argmax(0)
        stages.lap("postprocess")
        ev.process(labels, gt)
        stages.counts["scored"] += 1
        stages.lap("eval")
    if stages.counts["scored"] == 0:
        logger.warning(f"{dataset_name}: no semantic GT found")
    metrics = ev.evaluate()
    stages.lap("eval")
    return stages.results(metrics)


def _gt_mask_of(ann, h, w):
    seg = ann.get("segmentation")
    if seg is None or not h or not w:
        return None
    if isinstance(seg, dict):
        return rle_decode(seg, h, w)
    if isinstance(seg, list) and seg:
        return polygons_to_mask(seg, h, w)
    return np.asarray(seg, bool) if np.ndim(seg) == 2 else None


def _eval_refcoco(ape, dataset_name, mapper, rank, world_size):
    """P@0.5-0.9 of the top-1 box per referring expression, plus segm
    oIoU/mIoU of the top-1 mask when GT masks exist and the model emits them
    (reference refcoco_evaluation.py:31-753, segm derivation :391-413). An
    annotation's expressions are its ``expressions`` or ``expression``; its
    ``bbox`` is read as (x, y, w, h) (ROADMAP Queue 3, trait 24)."""
    from ape_tpu_torch.data.build import build_detection_test_loader

    ev = RefCOCOEvaluator()
    loader = build_detection_test_loader(dataset_name, mapper, rank, world_size)
    stages = _Stages(ape)
    for ex in loader():
        stages.lap("data")
        stages.counts["images"] += 1
        dd = ex.get("dataset_dict", {})
        h, w = ex.get("height", 0), ex.get("width", 0)
        for ann in dd.get("annotations", []):
            exprs = ann.get("expressions") or ([] if "expression" not in ann else [ann["expression"]])
            if not exprs:
                continue
            x, y, bw, bh = ann["bbox"]
            gt = np.asarray([x, y, x + bw, y + bh], np.float32)
            gmask = _gt_mask_of(ann, h, w)
            for expr in exprs:
                ex2 = dict(ex)
                ex2["text_prompt"] = expr
                inst = stages.forward(ex2).get("instances", {})
                boxes = np.asarray(inst.get("boxes", np.zeros((0, 4))))
                scores = np.asarray(inst.get("scores", np.zeros((0,))))
                stages.counts["scored"] += 1
                if len(boxes) == 0:
                    ev._total += 1
                    if gmask is not None:
                        ev.process_mask(None, gmask)
                    stages.lap("eval")
                    continue
                top = int(scores.argmax())
                pmask = None
                if gmask is not None and "mask_logits" in inst:
                    pmask = paste_masks(np.asarray(inst["mask_logits"])[top:top + 1],
                                        boxes[top:top + 1], h, w)[0]
                stages.lap("postprocess")
                ev.process(boxes[top], gt, pmask, gmask)
                stages.lap("eval")
    metrics = ev.evaluate()
    stages.lap("eval")
    return stages.results(metrics)


def _eval_panoptic(ape, dataset_name, mapper, rank, world_size):
    """The panoptic route, JAX's loop: every image through ``ape`` with
    ``panoptic_on``; where its record carries ``pan_seg`` (an id map) and
    ``segments_info``, the merge at that map's size scored. A record of
    ``load_coco_panoptic`` carries the map's file only, so it is run and not
    scored (ROADMAP Queue 3, trait 20)."""
    from ape_tpu_torch.data.build import build_detection_test_loader

    meta = MetadataCatalog.get(dataset_name)
    text_list = get_text_list(meta)
    thing = set(meta.get("thing_ids", range(len(meta.get("thing_classes", []) or []))))
    ev = PanopticEvaluator(len(text_list), thing_ids=thing)
    was = ape.panoptic_on
    ape.panoptic_on = True
    loader = build_detection_test_loader(dataset_name, mapper, rank, world_size)
    stages = _Stages(ape)
    try:
        for ex in loader():
            stages.lap("data")
            stages.counts["images"] += 1
            raw = stages.forward(ex).get("panoptic_raw")
            dd = ex.get("dataset_dict", {})
            gt_seg, gt_info = dd.get("pan_seg"), dd.get("segments_info")
            if raw is None or gt_seg is None:
                continue
            seg, info = panoptic_segments(raw, *gt_seg.shape[:2], thing)
            stages.lap("postprocess")
            ev.process(seg, info, np.asarray(gt_seg), list(gt_info))
            stages.counts["scored"] += 1
            stages.lap("eval")
    finally:
        ape.panoptic_on = was
    metrics = ev.evaluate()
    stages.lap("eval")
    return stages.results(metrics)


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
    coco_panoptic_seg and lvis to ``_eval_detection``, oid (at least 1000
    detections an image), sem_seg, refcoco and panoptic to their loops; any
    other type (d3 among them, as in JAX) raises ValueError. The metrics
    come with the stage seconds (``seconds/data``, ``device``,
    ``postprocess``, ``eval``) and the counts (``images``, ``forwards``,
    ``scored``)."""
    ape.set_eval_dataset(dataset_name)
    etype = resolve_evaluator_type(dataset_name, evaluator_type)
    if etype in ("coco", "coco_panoptic_seg", "lvis"):
        return _eval_detection(ape, dataset_name, mapper, iou_types, max_dets,
                               lvis=(etype == "lvis"), rank=rank, world_size=world_size)
    if etype == "oid":
        return _eval_oid(ape, dataset_name, mapper, max(max_dets, 1000), rank, world_size)
    if etype == "sem_seg":
        return _eval_sem_seg(ape, dataset_name, mapper, rank, world_size)
    if etype == "refcoco":
        return _eval_refcoco(ape, dataset_name, mapper, rank, world_size)
    if etype == "panoptic":
        return _eval_panoptic(ape, dataset_name, mapper, rank, world_size)
    raise ValueError(f"unknown evaluator_type {etype!r} for {dataset_name}")
