"""Instance inference postprocessing (counterpart of
``ape_tpu/modeling/ape_deta/postprocess.py``): score threshold, a fixed
pre-NMS top-k over the (queries x classes) scores, class-aware greedy NMS,
then the top ``topk`` survivors. Outputs keep fixed shapes with a validity
mask, as in JAX.
"""

from __future__ import annotations

from typing import Dict

import torch

from ape_tpu_torch.ops.box_ops import box_cxcywh_to_xyxy
from ape_tpu_torch.ops.nms import NEG_INF, batched_nms_mask, topk as top_k


def instance_inference(
    logits: torch.Tensor,  # (K, T)
    boxes: torch.Tensor,  # (K, 4) cxcywh normalized
    image_size: torch.Tensor,  # (2,) valid (h, w) in input pixels
    class_valid: torch.Tensor,  # (T,) bool
    score_thresh: float = 0.05,
    nms_thresh: float = 0.5,
    topk: int = 300,
    pre_nms: int = 2000,
) -> Dict[str, torch.Tensor]:
    """Returns boxes (topk, 4) xyxy in input pixels, scores, classes,
    query_idx and valid, each (topk,)."""
    k, t = logits.shape
    scores = torch.sigmoid(logits.float())
    scores = torch.where(class_valid[None, :], scores, torch.zeros_like(scores))
    hw = image_size.float()
    whwh = torch.stack([hw[1], hw[0], hw[1], hw[0]])
    bx = torch.minimum((box_cxcywh_to_xyxy(boxes.float()) * whwh).clamp(min=0.0), whwh)

    flat = scores.reshape(-1)
    flat = torch.where(flat > score_thresh, flat, torch.full_like(flat, NEG_INF))
    cand_scores, cand_idx = top_k(flat, min(pre_nms, k * t))
    cand_valid = cand_scores > NEG_INF / 2
    cand_q = torch.div(cand_idx, t, rounding_mode="floor")
    cand_c = cand_idx % t
    cand_boxes = bx[cand_q]

    keep = batched_nms_mask(cand_boxes, cand_scores, cand_c, nms_thresh, valid=cand_valid)
    masked = torch.where(keep, cand_scores, torch.full_like(cand_scores, NEG_INF))
    n = min(topk, masked.shape[0])
    sel_scores, sel = top_k(masked, n)
    if n < topk:  # fewer candidates than slots: pad below
        sel_scores = torch.cat([sel_scores, sel_scores.new_full((topk - n,), NEG_INF)])
        sel = torch.cat([sel, sel.new_zeros(topk - n)])
    valid = sel_scores > NEG_INF / 2
    return {
        "boxes": cand_boxes[sel],
        "scores": torch.where(valid, sel_scores, torch.zeros_like(sel_scores)),
        "classes": cand_c[sel],
        "query_idx": cand_q[sel],
        "valid": valid,
    }
