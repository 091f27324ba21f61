"""Semantic / panoptic / grounding evaluators (a copy of
``ape_tpu/evaluation/other_evals.py``; the box IoU is ``coco_eval``'s):
  * SemSegEvaluator (detectron2, used by reference configs): per-class IoU
    confusion matrix -> mIoU, fwIoU, pACC.
  * RefCOCOEvaluator (ape/evaluation/refcoco_evaluation.py:31-753): precision at
    IoU 0.5..0.9 of the top-1 box per referring expression.
  * PanopticEvaluator (PQ/SQ/RQ, panopticapi semantics): segment matching at
    IoU > 0.5, per-class PQ aggregation.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from ape_tpu_torch.evaluation.coco_eval import box_iou_xyxy


class SemSegEvaluator:
    def __init__(self, num_classes: int, ignore_label: int = 255):
        self.num_classes = num_classes
        self.ignore_label = ignore_label
        self._conf = np.zeros((num_classes, num_classes), np.int64)

    def reset(self):
        self._conf[:] = 0

    def process(self, pred: np.ndarray, gt: np.ndarray):
        """pred/gt: (H, W) int label maps."""
        keep = gt != self.ignore_label
        p = pred[keep].astype(np.int64)
        g = gt[keep].astype(np.int64)
        idx = g * self.num_classes + p
        self._conf += np.bincount(
            idx, minlength=self.num_classes**2
        ).reshape(self.num_classes, self.num_classes)

    def evaluate(self) -> Dict[str, float]:
        conf = self._conf.astype(np.float64)
        tp = np.diag(conf)
        gt_total = conf.sum(1)
        pred_total = conf.sum(0)
        union = gt_total + pred_total - tp
        iou = np.where(union > 0, tp / np.maximum(union, 1), np.nan)
        acc = np.where(gt_total > 0, tp / np.maximum(gt_total, 1), np.nan)
        freq = gt_total / max(gt_total.sum(), 1)
        return {
            "sem_seg/mIoU": 100 * float(np.nanmean(iou)),
            "sem_seg/fwIoU": 100 * float(np.nansum(iou * freq)),
            "sem_seg/mACC": 100 * float(np.nanmean(acc)),
            "sem_seg/pACC": 100 * float(tp.sum() / max(gt_total.sum(), 1)),
        }


class RefCOCOEvaluator:
    """Top-1 box precision at IoU thresholds for referring expressions; when
    masks are supplied, also segm oIoU/mIoU (reference
    refcoco_evaluation.py:391-413: oIoU = total intersection / total union
    over all expressions, mIoU = mean per-expression mask IoU — a missed
    expression contributes its GT area to the union and IoU 0)."""

    THRESHOLDS = (0.5, 0.6, 0.7, 0.8, 0.9)

    def __init__(self):
        self._hits = {t: 0 for t in self.THRESHOLDS}
        self._total = 0
        self._mask_inter = 0.0
        self._mask_union = 0.0
        self._mask_ious: List[float] = []

    def reset(self):
        self.__init__()

    def process(
        self,
        pred_box: np.ndarray,
        gt_box: np.ndarray,
        pred_mask: Optional[np.ndarray] = None,
        gt_mask: Optional[np.ndarray] = None,
    ):
        """Boxes xyxy; pred_* are from the highest-scoring instance for the
        expression. Masks (H, W) bool, same resolution."""
        iou = float(box_iou_xyxy(pred_box[None], gt_box[None])[0, 0])
        self._total += 1
        for t in self.THRESHOLDS:
            self._hits[t] += iou > t
        if gt_mask is not None:
            self.process_mask(pred_mask, gt_mask)

    def process_mask(self, pred_mask: Optional[np.ndarray], gt_mask: np.ndarray):
        g = np.asarray(gt_mask, bool)
        if pred_mask is None:
            inter, union = 0.0, float(g.sum())
        else:
            p = np.asarray(pred_mask, bool)
            inter = float(np.logical_and(p, g).sum())
            union = float(np.logical_or(p, g).sum())
        self._mask_inter += inter
        self._mask_union += union
        self._mask_ious.append(inter / max(union, 1.0))

    def evaluate(self) -> Dict[str, float]:
        n = max(self._total, 1)
        out = {f"refcoco/P@{t}": 100.0 * self._hits[t] / n for t in self.THRESHOLDS}
        if self._mask_ious:
            out["refcoco/oIoU"] = 100.0 * self._mask_inter / max(self._mask_union, 1.0)
            out["refcoco/mIoU"] = 100.0 * float(np.mean(self._mask_ious))
        return out


class PanopticEvaluator:
    """PQ = sum IoU(TP) / (|TP| + 0.5|FP| + 0.5|FN|), matched at IoU > 0.5."""

    def __init__(self, num_classes: int, thing_ids: Optional[set] = None):
        self.num_classes = num_classes
        self.thing_ids = thing_ids or set()
        self._iou_sum = np.zeros(num_classes)
        self._tp = np.zeros(num_classes, np.int64)
        self._fp = np.zeros(num_classes, np.int64)
        self._fn = np.zeros(num_classes, np.int64)

    def reset(self):
        self.__init__(self.num_classes, self.thing_ids)

    def process(self, pred_seg, pred_info: List[dict], gt_seg, gt_info: List[dict]):
        """*seg: (H, W) int segment-id maps; *info: [{id, category_id}]."""
        pred_cat = {s["id"]: s["category_id"] for s in pred_info}
        gt_cat = {s["id"]: s["category_id"] for s in gt_info}
        # joint histogram of (gt_id, pred_id) overlaps
        combo = gt_seg.astype(np.int64) * (2**20) + pred_seg.astype(np.int64)
        ids, counts = np.unique(combo, return_counts=True)
        inter = {(int(i // 2**20), int(i % 2**20)): int(c) for i, c in zip(ids, counts)}
        gt_areas = defaultdict(int)
        pred_areas = defaultdict(int)
        for (g, p), c in inter.items():
            gt_areas[g] += c
            pred_areas[p] += c
        matched_gt, matched_pred = set(), set()
        for (g, p), c in inter.items():
            if g == 0 or p == 0 or g not in gt_cat or p not in pred_cat:
                continue
            if gt_cat[g] != pred_cat[p]:
                continue
            union = gt_areas[g] + pred_areas[p] - c
            iou = c / max(union, 1)
            if iou > 0.5:
                cat = gt_cat[g]
                self._tp[cat] += 1
                self._iou_sum[cat] += iou
                matched_gt.add(g)
                matched_pred.add(p)
        for g, cat in gt_cat.items():
            if g not in matched_gt and gt_areas.get(g, 0) > 0:
                self._fn[cat] += 1
        for p, cat in pred_cat.items():
            if p not in matched_pred and pred_areas.get(p, 0) > 0:
                self._fp[cat] += 1

    def evaluate(self) -> Dict[str, float]:
        denom = self._tp + 0.5 * self._fp + 0.5 * self._fn
        valid = denom > 0
        pq = np.where(valid, self._iou_sum / np.maximum(denom, 1e-9), np.nan)
        sq = np.where(self._tp > 0, self._iou_sum / np.maximum(self._tp, 1), np.nan)
        rq = np.where(valid, self._tp / np.maximum(denom, 1e-9), np.nan)
        out = {
            "panoptic/PQ": 100 * float(np.nanmean(pq[valid])) if valid.any() else float("nan"),
            "panoptic/SQ": 100 * float(np.nanmean(sq[valid])) if valid.any() else float("nan"),
            "panoptic/RQ": 100 * float(np.nanmean(rq[valid])) if valid.any() else float("nan"),
        }
        if self.thing_ids:
            th = np.asarray([c in self.thing_ids for c in range(self.num_classes)])
            for name, m in (("th", th & valid), ("st", ~th & valid)):
                out[f"panoptic/PQ_{name}"] = (
                    100 * float(np.nanmean(pq[m])) if m.any() else float("nan")
                )
        return out


def aggregate_benchmark_suite(results: Dict[str, Dict[str, float]], key: str = "bbox/AP"):
    """mean + median over a suite (ODinW/SegInW/RF100 aggregation —
    tools/train_net.py:474-509)."""
    vals = [r[key] for r in results.values() if key in r and np.isfinite(r[key])]
    if not vals:
        return {}
    return {
        f"suite/mean_{key}": float(np.mean(vals)),
        f"suite/median_{key}": float(np.median(vals)),
    }
