"""D-cube (D³, described object detection) evaluation (a copy of
``ape_tpu/evaluation/d3_eval.py``): COCO AP under the FULL, PRES (presence)
and ABS (absence) views of the descriptions, the results suffixed
``_FULL``/``_PRES``/``_ABS``; in the "intra" group each image's predicted
classes are local sentence indices mapped through its ``sent_ids`` (those
beyond them dropped), in the "inter" group they are global ids (reference
d3_evaluation.py:34-441). ``evaluate_dataset`` has no route to it, as JAX's
has none.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set

import numpy as np

from ape_tpu_torch.evaluation.coco_eval import COCOEvaluator

MODES = ("FULL", "PRES", "ABS")


def _filter_dicts(dataset_dicts: List[dict], cats: Optional[Set[int]]) -> List[dict]:
    if cats is None:
        return dataset_dicts
    out = []
    for d in dataset_dicts:
        d = dict(d)
        d["annotations"] = [
            a for a in d.get("annotations", []) if a["category_id"] in cats
        ]
        out.append(d)
    return out


class D3Evaluator:
    """COCO AP under the three D³ description views.

    dataset_dicts: COCO-format dicts whose category ids are global description
    ids. ``pres_ids``/``abs_ids``: the presence/absence description-id sets
    (the reference ships them as separate GT jsons; sets express the same
    split). ``group``: "intra" (per-image sentence lists, predictions carry
    local indices + each example provides ``sent_ids``) or "inter".
    """

    def __init__(
        self,
        dataset_dicts: List[dict],
        pres_ids: Optional[Iterable[int]] = None,
        abs_ids: Optional[Iterable[int]] = None,
        group: str = "inter",
        iou_type: str = "bbox",
        max_dets: int = 100,
    ):
        assert group in ("intra", "inter"), group
        self.group = group
        pres = set(pres_ids) if pres_ids is not None else None
        ab = set(abs_ids) if abs_ids is not None else None
        self._mode_cats: Dict[str, Optional[Set[int]]] = {
            "FULL": None,
            "PRES": pres,
            "ABS": ab,
        }
        self._evals = {}
        for mode, cats in self._mode_cats.items():
            if mode != "FULL" and cats is None:
                continue
            self._evals[mode] = COCOEvaluator(
                _filter_dicts(dataset_dicts, cats), iou_type, max_dets
            )

    def reset(self):
        for ev in self._evals.values():
            ev.reset()

    def process(self, predictions: List[dict]):
        """predictions: [{image_id, sent_ids?, instances: {boxes, scores, classes}}]."""
        for p in predictions:
            inst = p["instances"]
            classes = np.asarray(inst["classes"], np.int64)
            boxes = np.asarray(inst["boxes"], np.float64)
            scores = np.asarray(inst["scores"], np.float64)
            if self.group == "intra":
                sent_ids = list(p.get("sent_ids", []))
                keep = classes < len(sent_ids)
                classes = np.asarray(
                    [sent_ids[c] for c in classes[keep]], np.int64
                )
                boxes, scores = boxes[keep], scores[keep]
            for mode, ev in self._evals.items():
                cats = self._mode_cats[mode]
                if cats is None:
                    m = np.ones(len(scores), bool)
                else:
                    m = np.asarray([c in cats for c in classes], bool)
                ev.process(
                    [
                        {
                            "image_id": p["image_id"],
                            "instances": {
                                "boxes": boxes[m],
                                "scores": scores[m],
                                "classes": classes[m],
                            },
                        }
                    ]
                )

    def evaluate(self) -> Dict[str, float]:
        out = {}
        for mode, ev in self._evals.items():
            for k, v in ev.evaluate().items():
                out[f"{k}_{mode}"] = v
        return out
