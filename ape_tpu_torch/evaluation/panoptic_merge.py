"""Host-side panoptic merging (a copy of ``ape_tpu/evaluation/panoptic_merge.py``,
which the port may not import): argmax over score-weighted prob masks,
overlap-threshold filtering, stuff deduplication into one segment per
class, thing/stuff routing by ``thing_ids`` (the reference's
_postprocess_panoptic, deformable_detr_segm_vl.py:920-998).
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

import numpy as np


def panoptic_merge(
    scores: np.ndarray,  # (K,) transformed scores
    labels: np.ndarray,  # (K,) class ids
    raw_scores: np.ndarray,  # (K,) raw sigmoid max (for thresholding)
    masks_prob: np.ndarray,  # (K, H, W) sigmoid mask probs at target size
    thing_ids: Set[int],
    object_mask_threshold: float = 0.25,
    overlap_threshold: float = 0.8,
    prob: float = 0.5,
) -> Tuple[np.ndarray, List[Dict]]:
    """Returns (panoptic_seg (H, W) int32 segment ids, segments_info)."""
    keep = raw_scores > object_mask_threshold
    cur_scores = scores[keep]
    cur_classes = labels[keep]
    cur_masks = masks_prob[keep]

    h, w = masks_prob.shape[-2:]
    panoptic_seg = np.zeros((h, w), np.int32)
    segments_info: List[Dict] = []
    if cur_masks.shape[0] == 0:
        return panoptic_seg, segments_info

    cur_prob_masks = cur_scores[:, None, None] * cur_masks
    cur_mask_ids = cur_prob_masks.argmax(0)

    current_segment_id = 0
    stuff_memory: Dict[int, int] = {}
    for k in range(cur_classes.shape[0]):
        pred_class = int(cur_classes[k])
        isthing = pred_class in thing_ids
        mask = (cur_mask_ids == k) & (cur_masks[k] >= prob)
        mask_area = int((cur_mask_ids == k).sum())
        original_area = int((cur_masks[k] >= prob).sum())
        if mask_area == 0 or original_area == 0 or not mask.any():
            continue
        if mask_area / original_area < overlap_threshold:
            continue
        if not isthing:
            if pred_class in stuff_memory:
                panoptic_seg[mask] = stuff_memory[pred_class]
                continue
            stuff_memory[pred_class] = current_segment_id + 1
        current_segment_id += 1
        panoptic_seg[mask] = current_segment_id
        segments_info.append(
            {"id": current_segment_id, "isthing": isthing, "category_id": pred_class}
        )
    return panoptic_seg, segments_info
