"""LVIS-flavor evaluation (a copy of ``ape_tpu/evaluation/lvis_eval.py``),
the LVIS API's federated-evaluation semantics:
  * max_dets=300 per image (no per-class cap);
  * AP plus rare/common/frequent buckets from per-category image counts;
  * federated filtering: detections whose class is in neither the image's GT
    categories nor its ``neg_category_ids`` are dropped (the detector is not
    judged where presence is unverified);
  * ``not_exhaustive_category_ids``: unmatched detections of those categories
    on that image are ignored rather than counted as false positives.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional

import numpy as np

from ape_tpu_torch.evaluation.coco_eval import COCOEvaluator

logger = logging.getLogger("ape_tpu_torch")


class LVISEvaluator(COCOEvaluator):
    def __init__(
        self,
        dataset_dicts: List[dict],
        iou_type: str = "bbox",
        max_dets: int = 300,
        category_image_counts: Optional[Dict[int, int]] = None,
    ):
        super().__init__(dataset_dicts, iou_type, max_dets)
        if category_image_counts is None:
            # derive from the dataset: images per category
            from collections import defaultdict

            imgs = defaultdict(set)
            for d in dataset_dicts:
                for a in d.get("annotations", []):
                    imgs[a["category_id"]].add(d["image_id"])
            category_image_counts = {c: len(s) for c, s in imgs.items()}
        self.category_image_counts = category_image_counts
        self._img_allowed = {}
        self._img_not_exhaustive = {}
        for d in dataset_dicts:
            img_id = d["image_id"]
            pos = {a["category_id"] for a in d.get("annotations", [])}
            self._img_allowed[img_id] = pos | set(d.get("neg_category_ids", []))
            self._img_not_exhaustive[img_id] = set(
                d.get("not_exhaustive_category_ids", [])
            )

    def process(self, predictions):
        """Federated filtering before the COCO-style accumulation."""
        filtered = []
        for p in predictions:
            img_id = p["image_id"]
            allowed = self._img_allowed.get(img_id)
            if allowed is None or not p.get("instances"):
                filtered.append(p)
                continue
            inst = p["instances"]
            import numpy as _np

            keep = _np.asarray([int(c) in allowed for c in inst["classes"]], bool)
            new = {k: (_np.asarray(v)[keep] if k != "masks" else
                       [m for m, kk in zip(v, keep) if kk])
                   for k, v in inst.items() if v is not None}
            filtered.append({**p, "instances": new})
        super().process(filtered)

    def _evaluate_img_cat(self, img_id, cat, area_rng=(0.0, 1e10)):
        e = super()._evaluate_img_cat(img_id, cat, area_rng)
        if e is not None and cat in self._img_not_exhaustive.get(img_id, ()):
            # unmatched dets of a not-exhaustively-annotated class: ignore
            e["ig"] = e["ig"] | ~e["tp"]
        return e

    def evaluate(self) -> Dict[str, float]:
        results = super().evaluate()
        suffix = "segm" if self.iou_type == "segm" else "bbox"
        buckets = {"r": [], "c": [], "f": []}
        for cat, ap in getattr(self, "per_class_ap", {}).items():
            n = self.category_image_counts.get(cat, 0)
            if n < 10:
                buckets["r"].append(ap)
            elif n <= 100:
                buckets["c"].append(ap)
            else:
                buckets["f"].append(ap)
        for k, v in buckets.items():
            results[f"{suffix}/AP{k}"] = 100 * float(np.mean(v)) if v else float("nan")
        return results
