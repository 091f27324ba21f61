"""Unified-label-space evaluation (a copy of
``ape_tpu/evaluation/unified_eval.py``): map each prediction's unified class
id back to the dataset's own (``build_map_back``; one unified id to many for
novel-class evaluation, ``build_map_back_novel``, the detection repeated),
drop the unmapped ones, and hand the rest to the dataset's evaluator
(reference multi_dataset_evaluator.py:24-382). No caller in JAX or here.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np


def build_map_back(label_map: Sequence[Union[int, str]]) -> Dict[int, int]:
    """label_map[i] = unified id of the dataset's i-th category
    (multi_dataset_evaluator.py:148-151): inverts to {unified_id: native_idx}."""
    return {int(v): i for i, v in enumerate(label_map)}


def build_map_back_novel(novel_classes_map: Sequence[Sequence[int]]) -> Dict[int, List[int]]:
    """novel_classes_map[c] = list of unified ids matching native class c
    (:140-147): inverts to {unified_id: [native_idx, ...]}."""
    out: Dict[int, List[int]] = {}
    for c, match in enumerate(novel_classes_map):
        for m in match:
            out.setdefault(int(m), []).append(c)
    return out


class UnifiedEvaluator:
    """Wraps a native evaluator (COCOEvaluator / OIDEvaluator / ...) with
    unified-id map-back. ``map_back`` values may be ints or lists of ints
    (novel-classes fan-out, map_back_unified_id_novel_classes :54-65)."""

    def __init__(self, base_evaluator, map_back: Dict[int, Union[int, List[int]]]):
        self.base = base_evaluator
        self.map_back = map_back

    def reset(self):
        self.base.reset()

    def process(self, predictions: List[dict]):
        for p in predictions:
            inst = p["instances"]
            classes = np.asarray(inst["classes"], np.int64)
            boxes = np.asarray(inst["boxes"], np.float64)
            scores = np.asarray(inst["scores"], np.float64)
            masks = inst.get("masks")
            nb, ns, nc, nm = [], [], [], []
            for i, c in enumerate(classes):
                mapped = self.map_back.get(int(c))
                if mapped is None:
                    continue  # prediction outside this dataset's label space
                for m in mapped if isinstance(mapped, (list, tuple)) else [mapped]:
                    nb.append(boxes[i])
                    ns.append(scores[i])
                    nc.append(m)
                    if masks is not None:
                        nm.append(masks[i])
            rec = {
                "image_id": p["image_id"],
                "instances": {
                    "boxes": np.asarray(nb, np.float64).reshape(-1, 4),
                    "scores": np.asarray(ns, np.float64),
                    "classes": np.asarray(nc, np.int64),
                },
            }
            if masks is not None:
                rec["instances"]["masks"] = nm
            self.base.process([rec])

    def evaluate(self) -> Dict[str, float]:
        return self.base.evaluate()
