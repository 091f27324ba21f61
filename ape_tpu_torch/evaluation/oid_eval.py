"""OpenImages hierarchical AP, the "google protocol" (a copy of
``ape_tpu/evaluation/oid_eval.py``, NumPy only): each detection also counts
for its class's ancestors; detections of classes in neither the image's
positive nor its negative label set are dropped; one IoU threshold (0.5),
greedy in score order against the best-overlapping ground truth; group-of
boxes match by intersection over the detection and give one true positive
each at the best matched score; AP is the exact VOC area under the
monotonised precision-recall curve (reference oideval.py:31-905).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Set

import numpy as np

from ape_tpu_torch.evaluation.coco_eval import box_iou_xyxy


def build_ancestors(hierarchy: dict, name_to_id: Dict[str, int]) -> Dict[int, Set[int]]:
    """Ancestor sets from an OID hierarchy tree ({"LabelName", "Subcategory"}).

    The root node (or any node whose LabelName is not in ``name_to_id``) is
    treated as virtual and excluded from ancestor sets.
    """
    fas: Dict[int, Set[int]] = defaultdict(set)

    def dfs(node) -> Set[int]:
        cur = name_to_id.get(node.get("LabelName"), -1)
        childs: Set[int] = set()
        for sub in node.get("Subcategory", []):
            childs |= dfs(sub)
        if cur != -1:
            for c in childs:
                fas[c].add(cur)
            childs.add(cur)
        return childs

    dfs(hierarchy)
    return dict(fas)


def voc_average_precision(precision: np.ndarray, recall: np.ndarray) -> float:
    """Exact area under the monotonized PR curve (oideval.py:31-77)."""
    if precision.size == 0:
        return 0.0
    recall = np.concatenate([[0.0], recall, [1.0]])
    precision = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(precision) - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    idx = np.where(recall[1:] != recall[:-1])[0] + 1
    return float(np.sum((recall[idx] - recall[idx - 1]) * precision[idx]))


class OIDEvaluator:
    """Accumulates predictions and computes hierarchical AP.

    dataset_dicts: [{image_id, annotations: [{category_id, bbox xyxy,
    iscrowd?}], neg_category_ids?, pos_category_ids?}]. GT must already be
    hierarchy-expanded (the OID registration does this).
    """

    def __init__(
        self,
        dataset_dicts: List[dict],
        ancestors: Optional[Dict[int, Set[int]]] = None,
        expand_pred_label: bool = True,
        max_dets: int = 1000,
        iou_thresh: float = 0.5,
    ):
        self.ancestors = ancestors or {}
        self.expand = expand_pred_label
        self.max_dets = max_dets
        self.iou_thresh = iou_thresh
        self._gts = defaultdict(list)
        self._img_pos: Dict[int, Set[int]] = {}
        self._img_neg: Dict[int, Set[int]] = {}
        self._cats: Set[int] = set()
        self._cat_img_count = defaultdict(set)
        self._img_ids = []
        for d in dataset_dicts:
            img_id = d["image_id"]
            self._img_ids.append(img_id)
            pos = set()
            for ann in d.get("annotations", []):
                cat = int(ann["category_id"])
                self._gts[(img_id, cat)].append(ann)
                pos.add(cat)
                self._cats.add(cat)
                self._cat_img_count[cat].add(img_id)
            self._img_pos[img_id] = set(d.get("pos_category_ids", [])) | pos
            self._img_neg[img_id] = set(d.get("neg_category_ids", []))
        self._dets = defaultdict(list)

    def reset(self):
        self._dets = defaultdict(list)

    def process(self, predictions: List[dict]):
        """predictions: [{image_id, instances: {boxes, scores, classes}}]."""
        for p in predictions:
            img_id = p["image_id"]
            if img_id not in self._img_pos:
                continue
            inst = p["instances"]
            allowed = self._img_pos[img_id] | self._img_neg[img_id]
            for i in range(len(inst["scores"])):
                cat = int(inst["classes"][i])
                cats = {cat} | (self.ancestors.get(cat, set()) if self.expand else set())
                det = {
                    "bbox": np.asarray(inst["boxes"][i], np.float64),
                    "score": float(inst["scores"][i]),
                }
                for c in cats:
                    # federated filtering (oideval.py:209-214)
                    if c in allowed:
                        self._dets[(img_id, c)].append(det)

    def _match_img_cat(self, img_id: int, cat: int):
        """Google-style per-(image, category) matching (oideval.py:299-394).

        Returns (scores, tp_flags, num_gt) or None when both sides are empty.
        """
        gts = self._gts.get((img_id, cat), [])
        dets = sorted(
            self._dets.get((img_id, cat), []), key=lambda d: -d["score"]
        )[: self.max_dets]
        if not gts and not dets:
            return None
        if not dets:
            return np.zeros(0), np.zeros(0, bool), len(gts)

        normal = [g for g in gts if not g.get("iscrowd", 0)]
        groups = [g for g in gts if g.get("iscrowd", 0)]
        dbox = np.asarray([d["bbox"] for d in dets], np.float64)
        scores = np.asarray([d["score"] for d in dets], np.float64)
        n = len(dets)
        tp = np.zeros(n, bool)
        matched_group = np.zeros(n, bool)

        if normal:
            iou = box_iou_xyxy(dbox, np.asarray([g["bbox"] for g in normal]))
            best = iou.argmax(1)
            gt_taken = np.zeros(len(normal), bool)
            for i in range(n):
                g = best[i]
                if (not tp[i]) and iou[i, g] >= self.iou_thresh and not matched_group[i]:
                    if not gt_taken[g]:
                        tp[i] = True
                        gt_taken[g] = True

        group_scores = np.zeros(0)
        if groups:
            gbox = np.asarray([g["bbox"] for g in groups])
            ioa = box_iou_xyxy(dbox, gbox, iscrowd=np.ones(len(groups), bool))
            best = ioa.argmax(1)
            gsc = np.zeros(len(groups))
            for i in range(n):
                g = best[i]
                if (not tp[i]) and ioa[i, g] >= self.iou_thresh and not matched_group[i]:
                    matched_group[i] = True
                    gsc[g] = max(gsc[g], scores[i])
            group_scores = gsc[gsc > 0]

        keep = ~matched_group
        out_scores = np.concatenate([scores[keep], group_scores])
        out_tp = np.concatenate([tp[keep], np.ones(len(group_scores), bool)])
        return out_scores, out_tp, len(gts)

    def evaluate(self) -> Dict[str, float]:
        aps, recalls = {}, {}
        for cat in sorted(self._cats):
            all_scores, all_tp, num_gt = [], [], 0
            for img_id in self._img_ids:
                r = self._match_img_cat(img_id, cat)
                if r is None:
                    continue
                s, t, g = r
                all_scores.append(s)
                all_tp.append(t)
                num_gt += g
            if num_gt == 0:
                continue
            scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
            tps = np.concatenate(all_tp) if all_tp else np.zeros(0, bool)
            order = np.argsort(-scores, kind="mergesort")
            tps = tps[order].astype(float)
            tp_cum = np.cumsum(tps)
            fp_cum = np.cumsum(1.0 - tps)
            rc = tp_cum / num_gt
            pr = tp_cum / np.maximum(tp_cum + fp_cum, np.spacing(1))
            # monotonize (oideval.py:575-581) then exact-area AP
            for i in range(len(pr) - 1, 0, -1):
                pr[i - 1] = max(pr[i - 1], pr[i])
            aps[cat] = voc_average_precision(pr, rc)
            recalls[cat] = float(rc[-1]) if len(rc) else 0.0

        if not aps:
            return {"bbox/AP": float("nan")}
        buckets = {"r": [], "c": [], "f": []}
        for cat, ap in aps.items():
            n = len(self._cat_img_count[cat])
            buckets["r" if n < 10 else "c" if n < 100 else "f"].append(ap)
        out = {
            "bbox/AP": 100 * float(np.mean(list(aps.values()))),
            "bbox/AP50": 100 * float(np.mean(list(aps.values()))),
            f"bbox/AR@{self.max_dets}": 100 * float(np.mean(list(recalls.values()))),
        }
        for k, v in buckets.items():
            out[f"bbox/AP{k}"] = 100 * float(np.mean(v)) if v else float("nan")
        self.per_class_ap = aps
        return out
