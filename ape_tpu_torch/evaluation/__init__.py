"""The host side of evaluation (counterpart of ``ape_tpu/evaluation/``):
the COCO, LVIS, OpenImages, D-cube, unified, semantic, panoptic and
referring evaluators, the panoptic merge, PIL's bilinear resizes in NumPy,
and ``evaluate_dataset``'s routes. NumPy only on the host: no PIL, no cv2
and nothing of ``ape_tpu``. JAX's exports but its ``panoptic_merge``
function, which would hide the module of that name: it is
``panoptic_merge.panoptic_merge`` here."""

from .coco_eval import COCOEvaluator, box_iou_xyxy, mask_iou
from .d3_eval import D3Evaluator
from .eval_runner import evaluate_dataset, paste_masks
from .lvis_eval import LVISEvaluator
from .oid_eval import OIDEvaluator, build_ancestors
from .other_evals import (
    PanopticEvaluator,
    RefCOCOEvaluator,
    SemSegEvaluator,
    aggregate_benchmark_suite,
)
from .unified_eval import UnifiedEvaluator, build_map_back, build_map_back_novel

__all__ = ["COCOEvaluator", "D3Evaluator", "LVISEvaluator", "OIDEvaluator", "PanopticEvaluator",
           "RefCOCOEvaluator", "SemSegEvaluator", "UnifiedEvaluator", "aggregate_benchmark_suite",
           "box_iou_xyxy", "build_ancestors", "build_map_back", "build_map_back_novel",
           "evaluate_dataset", "mask_iou", "paste_masks"]
