"""Inference postprocessing (counterpart of
``ape_tpu/modeling/ape_deta/postprocess.py``).

Instances: score threshold, a fixed pre-NMS top-k over the (queries x
classes) scores, class-aware greedy NMS, then the top ``topk`` survivors.
Outputs keep fixed shapes with a validity mask, as in JAX.

Semantic and panoptic: per-class probability maps from the query masks, the
per-query (score, label) of the panoptic merge under the softmax(sigmoid / T)
transform, and the stuff-score routing. The merge of masks into segments
(``ape_tpu/evaluation``) runs on the host and is not ported.
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


def _class_probs(logits: torch.Tensor, class_valid: torch.Tensor, pano_temp: float,
                 transform_eval: bool) -> torch.Tensor:
    """sigmoid of the (K, T) logits, 0 at invalid classes, then with
    ``transform_eval`` a softmax of sigmoid / pano_temp over the valid classes."""
    cls = torch.sigmoid(logits.float())
    cls = torch.where(class_valid[None, :], cls, torch.zeros_like(cls))
    if transform_eval:
        cls = torch.softmax(torch.where(class_valid[None, :], cls / pano_temp,
                                        torch.full_like(cls, -torch.inf)), -1)
    return cls


def semantic_inference(
    logits: torch.Tensor,  # (K, T)
    mask_logits: torch.Tensor,  # (K, Hm, Wm)
    class_valid: torch.Tensor,  # (T,) bool
    pano_temp: float = 0.06,
    transform_eval: bool = True,
) -> torch.Tensor:
    """Per-class semantic probability maps (T, Hm, Wm) at mask-feature resolution."""
    cls = _class_probs(logits, class_valid, pano_temp, transform_eval)
    masks = torch.sigmoid(mask_logits.float())
    k, hm, wm = masks.shape
    return torch.matmul(cls.t(), masks.reshape(k, hm * wm)).reshape(-1, hm, wm)


def panoptic_scores(
    logits: torch.Tensor,  # (K, T)
    class_valid: torch.Tensor,  # (T,) bool
    pano_temp: float = 0.06,
    transform_eval: bool = True,
):
    """Device half of panoptic inference: per-query (score, label) under the
    softmax(sigmoid / T) transform, plus the raw sigmoid max for thresholding."""
    sig = _class_probs(logits, class_valid, pano_temp, False)
    raw_scores = sig.max(-1).values
    if not transform_eval:
        return raw_scores, sig.argmax(-1), raw_scores
    scores, labels = _class_probs(logits, class_valid, pano_temp, True).max(-1)
    return scores, labels, raw_scores


def get_stuff_score(
    logits: torch.Tensor,  # (K, T)
    thing_mask: torch.Tensor,  # (T,) bool, True where the class is a thing
    stuff_prob_thing: float = -1.0,
) -> torch.Tensor:
    """(K, 1 + T): one "things" column (the best thing score, or the constant
    ``stuff_prob_thing`` when positive), then the stuff classes' scores with
    the things zeroed."""
    sig = torch.sigmoid(logits.float())
    zeros = torch.zeros_like(sig)
    stuff = torch.where(~thing_mask[None, :], sig, zeros)
    if stuff_prob_thing > 0:
        things = torch.full_like(sig[:, :1], stuff_prob_thing)
    else:
        things = torch.where(thing_mask[None, :], sig, zeros).max(-1, keepdim=True).values
    return torch.cat([things, stuff], -1)
