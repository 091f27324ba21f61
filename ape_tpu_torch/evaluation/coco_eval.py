"""COCO-style detection and segmentation evaluation (a copy of
``ape_tpu/evaluation/coco_eval.py``, NumPy only): AP at IoU .5:.95 with
101-point interpolation, AP50 and AP75, AP small/medium/large and per-class
AP, pycocotools' per-image matching (crowd ground truth matched by
intersection over the detection, ignored regions, ``max_dets`` a class and
image); box IoU and mask IoU (RLE, polygons rasterized as PIL does by
``data.transforms``). ``box_iou_xyxy`` is the port's one box IoU: the
referring evaluator of ``other_evals`` reads it from here.
"""

from __future__ import annotations

import logging
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from ape_tpu_torch.data.transforms import polygons_to_mask, rle_decode

logger = logging.getLogger("ape_tpu_torch")

IOU_THRS = np.linspace(0.5, 0.95, 10)
RECALL_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}


def box_iou_xyxy(a: np.ndarray, b: np.ndarray, iscrowd: Optional[np.ndarray] = None):
    """(N,4) x (M,4) -> (N,M); crowd GTs use IoF (intersection over detection)."""
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    if iscrowd is not None:
        union = np.where(iscrowd[None, :], area_a[:, None], union)
    return inter / np.maximum(union, 1e-9)


def mask_iou(dets: List, gts: List, iscrowd: Optional[np.ndarray] = None) -> np.ndarray:
    """RLE/binary-mask IoU matrix."""
    hw = [None]

    def to_mask(m):
        if isinstance(m, dict):
            out = rle_decode(m)
        elif isinstance(m, list):  # COCO polygon list (rasterized at det size)
            assert hw[0] is not None, "polygon GT needs a dense det mask for sizing"
            out = polygons_to_mask(m, *hw[0])
        else:
            out = np.asarray(m, bool)
        if hw[0] is None:
            hw[0] = out.shape
        return out

    dm = [to_mask(m) for m in dets]
    gm = [to_mask(m) for m in gts]
    out = np.zeros((len(dm), len(gm)))
    for j, g in enumerate(gm):
        ga = g.sum()
        for i, d in enumerate(dm):
            inter = np.logical_and(d, g).sum()
            if iscrowd is not None and iscrowd[j]:
                denom = d.sum()
            else:
                denom = d.sum() + ga - inter
            out[i, j] = inter / max(denom, 1)
    return out


class COCOEvaluator:
    """Accumulates {image_id, category_id, bbox xyxy, score, segmentation?}
    predictions vs GT dicts and computes COCO metrics."""

    def __init__(
        self,
        dataset_dicts: List[dict],
        iou_type: str = "bbox",
        max_dets: int = 100,
        class_names: Optional[List[str]] = None,
    ):
        self.iou_type = iou_type
        self.max_dets = max_dets
        self.class_names = class_names
        self._gts = defaultdict(list)  # (img_id, cat) -> list of gt dicts
        self._gt_imgs = set()
        self._cats = set()
        for d in dataset_dicts:
            img_id = d["image_id"]
            self._gt_imgs.add(img_id)
            for ann in d.get("annotations", []):
                cat = ann["category_id"]
                self._cats.add(cat)
                self._gts[(img_id, cat)].append(ann)
        self._dets = defaultdict(list)

    def reset(self):
        self._dets = defaultdict(list)

    def process(self, predictions: List[dict]):
        """predictions: list of {image_id, instances: {boxes, scores, classes, masks?}}"""
        for p in predictions:
            img_id = p["image_id"]
            inst = p["instances"]
            n = len(inst["scores"])
            for i in range(n):
                det = {
                    "bbox": np.asarray(inst["boxes"][i], np.float64),
                    "score": float(inst["scores"][i]),
                }
                if "masks" in inst and inst["masks"] is not None:
                    det["segmentation"] = inst["masks"][i]
                self._dets[(img_id, int(inst["classes"][i]))].append(det)

    def _evaluate_img_cat(self, img_id, cat, area_rng=(0.0, 1e10)):
        """Per-(image, category, area-range) greedy matching — the pycocotools
        evaluateImg protocol: GT outside the range (or crowd/ignore) is IGNORE,
        GTs sort ignored-last, dets in score order prefer non-ignored matches,
        and unmatched dets outside the range are ignored rather than FPs."""
        gts = list(self._gts.get((img_id, cat), []))
        dets = sorted(
            self._dets.get((img_id, cat), []), key=lambda d: -d["score"]
        )[: self.max_dets]
        if not gts and not dets:
            return None
        lo, hi = area_rng
        gt_area = [g.get("area", _box_area(g["bbox"])) for g in gts]
        ignore0 = [
            bool(g.get("ignore", 0) or g.get("iscrowd", 0))
            or not (lo <= a < hi)
            for g, a in zip(gts, gt_area)
        ]
        order = sorted(range(len(gts)), key=lambda i: ignore0[i])  # ignored last
        gts = [gts[i] for i in order]
        ignore = np.asarray([ignore0[i] for i in order], bool)
        iscrowd = np.asarray([g.get("iscrowd", 0) for g in gts], bool)
        if dets and gts:
            if self.iou_type == "segm":
                ious = mask_iou(
                    [d.get("segmentation") for d in dets],
                    [g.get("segmentation") for g in gts],
                    iscrowd,
                )
            else:
                ious = box_iou_xyxy(
                    np.asarray([d["bbox"] for d in dets]),
                    np.asarray([g["bbox"] for g in gts]),
                    iscrowd,
                )
        else:
            ious = np.zeros((len(dets), len(gts)))

        t = len(IOU_THRS)
        dt_m = -np.ones((t, len(dets)), np.int64)
        dt_ig = np.zeros((t, len(dets)), bool)
        gt_m = -np.ones((t, len(gts)), np.int64)
        det_area = np.asarray([_box_area(d["bbox"]) for d in dets])
        for ti, thr in enumerate(IOU_THRS):
            for di in range(len(dets)):
                best, best_iou = -1, min(thr, 1 - 1e-10)
                for gi in range(len(gts)):
                    if gt_m[ti, gi] >= 0 and not iscrowd[gi]:
                        continue
                    # gts sorted ignored-last: stop once a real match exists
                    if best >= 0 and not ignore[best] and ignore[gi]:
                        break
                    if ious[di, gi] >= best_iou:
                        best_iou = ious[di, gi]
                        best = gi
                if best >= 0:
                    dt_m[ti, di] = best
                    gt_m[ti, best] = di
                    dt_ig[ti, di] = ignore[best]
                elif not (lo <= det_area[di] < hi):
                    dt_ig[ti, di] = True
        return {
            "scores": np.asarray([d["score"] for d in dets]),
            "tp": (dt_m >= 0) & ~dt_ig,  # (T, D)
            "ig": dt_ig,
            "num_gt": int((~ignore).sum()),
        }

    def evaluate(self) -> Dict[str, float]:
        cats = sorted(self._cats | {c for (_, c) in self._dets})
        per_class_ap = {}
        ap_all, ap50, ap75 = [], [], []
        ap_area = {k: [] for k in ("small", "medium", "large")}
        for cat in cats:
            aps = {}
            for area_name, rng in AREA_RNG.items():
                evals = []
                for img_id in self._gt_imgs:
                    e = self._evaluate_img_cat(img_id, cat, rng)
                    if e is not None:
                        evals.append(e)
                aps[area_name] = self._accumulate(evals) if evals else None
            if aps["all"] is not None:
                per_class_ap[cat] = float(np.mean(aps["all"]))
                ap_all.append(aps["all"].mean())
                ap50.append(aps["all"][0])
                ap75.append(aps["all"][5])
            for k in ("small", "medium", "large"):
                if aps[k] is not None:
                    ap_area[k].append(aps[k].mean())
        suffix = "segm" if self.iou_type == "segm" else "bbox"
        results = {
            f"{suffix}/AP": 100 * float(np.mean(ap_all)) if ap_all else float("nan"),
            f"{suffix}/AP50": 100 * float(np.mean(ap50)) if ap50 else float("nan"),
            f"{suffix}/AP75": 100 * float(np.mean(ap75)) if ap75 else float("nan"),
        }
        for k in ("small", "medium", "large"):
            v = ap_area[k]
            results[f"{suffix}/AP{k[0]}"] = 100 * float(np.mean(v)) if v else float("nan")
        self.per_class_ap = per_class_ap
        return results

    def save_pr_curves(self, path) -> None:
        """Dump class-averaged interpolated PR curves + score-at-recall as npz
        {precision (T, R), recall (R,), scores (T, R)} — the input format of
        utils/plot_utils.plot_precision_recall (reference dumps pycocotools'
        eval pickle; this is the same T x R content without the pickle)."""
        prs, scs = [], []
        for cat in sorted(self._cats | {c for (_, c) in self._dets}):
            evals = []
            for img_id in self._gt_imgs:
                e = self._evaluate_img_cat(img_id, cat, (0.0, 1e10))
                if e is not None:
                    evals.append(e)
            got = self._accumulate(evals, return_curves=True) if evals else None
            if got is None:
                continue
            _aps, pr, sc = got
            prs.append(pr)
            scs.append(sc)
        t, r = len(IOU_THRS), len(RECALL_THRS)
        precision = np.mean(prs, axis=0) if prs else np.zeros((t, r))
        scores = np.mean(scs, axis=0) if scs else np.zeros((t, r))
        np.savez(path, precision=precision, recall=np.asarray(RECALL_THRS), scores=scores)

    @staticmethod
    def _accumulate(evals: List[dict], return_curves: bool = False):
        """Per-IoU-threshold AP via 101-point interpolated PR (accumulate())."""
        num_gt = sum(e["num_gt"] for e in evals)
        if num_gt == 0:
            return None
        scores = np.concatenate([e["scores"] for e in evals])
        if scores.size == 0:
            aps = np.zeros(len(IOU_THRS))
            if return_curves:
                z = np.zeros((len(IOU_THRS), len(RECALL_THRS)))
                return aps, z, z
            return aps
        tps = np.concatenate([e["tp"] for e in evals], axis=1)
        igs = np.concatenate([e["ig"] for e in evals], axis=1)
        order = np.argsort(-scores, kind="stable")
        tps = tps[:, order]
        igs = igs[:, order]
        scores_sorted = scores[order]
        aps = np.zeros(len(IOU_THRS))
        pr_curves = np.zeros((len(IOU_THRS), len(RECALL_THRS)))
        sc_curves = np.zeros((len(IOU_THRS), len(RECALL_THRS)))
        for ti in range(len(IOU_THRS)):
            tp = tps[ti] & ~igs[ti]
            fp = ~tps[ti] & ~igs[ti]
            tp_c = np.cumsum(tp)
            fp_c = np.cumsum(fp)
            recall = tp_c / num_gt
            precision = tp_c / np.maximum(tp_c + fp_c, 1e-9)
            for i in range(len(precision) - 1, 0, -1):
                precision[i - 1] = max(precision[i - 1], precision[i])
            idx = np.searchsorted(recall, RECALL_THRS, side="left")
            valid = idx < len(precision)
            safe = np.minimum(idx, len(precision) - 1)
            pr = np.where(valid, precision[safe], 0.0)
            aps[ti] = pr.mean()
            if return_curves:
                pr_curves[ti] = pr
                sc_curves[ti] = np.where(valid, scores_sorted[safe], 0.0)
        if return_curves:
            return aps, pr_curves, sc_curves
        return aps


def _box_area(b):
    return max(b[2] - b[0], 0) * max(b[3] - b[1], 0)
