"""Fixed-shape assigners for DETA training (counterpart of
``ape_tpu/modeling/ape_deta/matchers.py``), batched over images where JAX
maps one image with ``vmap``.

Assignments are dense ``(B, K)`` int64 tensors holding a gt index or -1, over
padded gt slots with validity masks. Random subsampling draws its noise from
an explicit ``torch.Generator`` (JAX: an explicit PRNG key); the two give
different numbers, so only a subsample that keeps every positive agrees.

The Hungarian matcher of ``use_stage2=False`` (focal, L1 and GIoU costs)
assigns by JAX's auction (``auction_assign``), run on the host: one copy of
every (layer, image) cost matrix of a criterion call comes over at once
(one host sync), the auctions bid in lockstep in NumPy with JAX's f32
arithmetic, and the assignments go back to the card by a pinned,
asynchronous copy.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ape_tpu_torch.ops.box_ops import box_cxcywh_to_xyxy, box_iou, generalized_box_iou
from ape_tpu_torch.utils.rows import WHOLE, Rows

NEG = -1e9


def threshold_match(
    iou: torch.Tensor,  # (B, G, K)
    gt_valid: torch.Tensor,  # (B, G)
    thresholds: Tuple[float, ...],
    labels: Tuple[int, ...],
    allow_low_quality: bool = True,
):
    """detectron2-style Matcher. Returns (matched_idx (B, K), label (B, K) in labels)."""
    iou = torch.where(gt_valid[..., None], iou, torch.full_like(iou, -1.0))
    matched_val, matched_idx = iou.max(dim=1)
    label = _threshold_labels(matched_val, thresholds, labels)
    if allow_low_quality:
        label = torch.where(_low_quality(iou, gt_valid), torch.ones_like(label), label)
    return matched_idx, torch.where(gt_valid.any(1, keepdim=True), label, torch.zeros_like(label))


def _low_quality(iou: torch.Tensor, gt_valid: torch.Tensor) -> torch.Tensor:
    """(B, K): the proposal is the best match of some valid gt with IoU > 0."""
    gt_best = iou.max(dim=2, keepdim=True).values
    return ((iou == gt_best) & gt_valid[..., None] & (gt_best > 0)).any(1)


def _threshold_labels(matched_val, thresholds, labels):
    label = torch.full(matched_val.shape, labels[0], dtype=torch.long, device=matched_val.device)
    bounds = (-float("inf"),) + tuple(thresholds) + (float("inf"),)
    for i, lab in enumerate(labels):
        hit = (matched_val >= bounds[i]) & (matched_val < bounds[i + 1])
        label = torch.where(hit, torch.full_like(label, lab), label)
    return label


def subsample_positives(pos_mask: torch.Tensor, max_pos: int,
                        generator: Optional[torch.Generator] = None,
                        rows: Rows = WHOLE) -> torch.Tensor:
    """Randomly keep at most max_pos True entries per row of (B, K); the
    noise is drawn at the global batch and cut to ``rows``."""
    noise = rows.rand(pos_mask.shape, 0, generator, pos_mask.device)
    score = torch.where(pos_mask, noise, torch.full_like(noise, -1.0))
    keep_n = pos_mask.sum(1, keepdim=True).clamp(max=max_pos)
    order = torch.argsort(-score, dim=1)
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(order.shape[1], device=order.device).expand_as(order))
    return pos_mask & (rank < keep_n)


def topk_per_gt(assign_gt: torch.Tensor, iou: torch.Tensor, k: int) -> torch.Tensor:
    """Keep at most k proposals per gt, highest IoU first. assign_gt (B, K), iou (B, G, K)."""
    g = iou.shape[1]
    k = min(k, iou.shape[2])
    mine = assign_gt[:, None, :] == torch.arange(g, device=iou.device)[None, :, None]  # (B, G, K)
    scores = torch.where(mine, iou, torch.full_like(iou, NEG))
    kth = scores.topk(k, dim=2).values[..., -1:]
    keep = mine & (scores >= kth) & (scores > NEG / 2)
    return torch.where(keep.any(1), assign_gt, torch.full_like(assign_gt, -1))


def stage2_assign(
    gt_boxes: torch.Tensor,  # (B, G, 4) cxcywh
    gt_valid: torch.Tensor,  # (B, G)
    init_reference: torch.Tensor,  # (B, K, 4) cxcywh, detached
    num_queries: int,
    positive_fraction: float = 0.25,
    iou_thresh: float = 0.6,
    max_k: int = 4,
    generator: Optional[torch.Generator] = None,
    rows: Rows = WHOLE,
) -> torch.Tensor:
    """Stage2Assigner -> assign (B, K): gt index or -1."""
    iou, _ = box_iou(box_cxcywh_to_xyxy(gt_boxes), box_cxcywh_to_xyxy(init_reference))
    iou = torch.where(gt_valid[..., None], iou, torch.full_like(iou, -1.0))
    matched_idx, label = threshold_match(iou, gt_valid, (iou_thresh,), (0, 1))
    pos = subsample_positives(label == 1, int(num_queries * positive_fraction), generator, rows)
    assign = torch.where(pos, matched_idx, torch.full_like(matched_idx, -1))
    return topk_per_gt(assign, iou, max_k)


def stage1_assign(
    gt_boxes: torch.Tensor,  # (B, G, 4) cxcywh
    gt_valid: torch.Tensor,  # (B, G)
    anchors: torch.Tensor,  # (B, S, 4) cxcywh
    anchor_valid: torch.Tensor,  # (B, S)
    t_low: float = 0.3,
    t_high: float = 0.7,
    batch_size_per_image: int = 256,
    positive_fraction: float = 0.5,
    max_k: int = 4,
    generator: Optional[torch.Generator] = None,
    rows: Rows = WHOLE,
) -> torch.Tensor:
    """Stage1Assigner on the encoder's anchors -> assign (B, S)."""
    iou, _ = box_iou(box_cxcywh_to_xyxy(gt_boxes), box_cxcywh_to_xyxy(anchors))
    iou = torch.where(gt_valid[..., None] & anchor_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    matched_val, matched_idx = iou.max(dim=1)
    label = _threshold_labels(matched_val, (t_low, t_high), (0, -1, 1))
    label = torch.where(_low_quality(iou, gt_valid) & anchor_valid, torch.ones_like(label), label)
    pos = subsample_positives((label == 1) & anchor_valid,
                              int(batch_size_per_image * positive_fraction), generator, rows)
    assign = torch.where(pos, matched_idx, torch.full_like(matched_idx, -1))
    assign = topk_per_gt(assign, iou, max_k)
    return torch.where(gt_valid.any(1, keepdim=True), assign, torch.full_like(assign, -1))


# ---------------------------------------------------------------------------
# Hungarian matcher (JAX's auction, on the host)
# ---------------------------------------------------------------------------


def focal_class_cost(logits: torch.Tensor, gt_labels: torch.Tensor, alpha: float = 0.25,
                     gamma: float = 2.0) -> torch.Tensor:
    """detrex focal_loss_cost: (..., K, C) logits x (..., G) labels -> (..., K, G)."""
    p = torch.sigmoid(logits)
    neg = (1 - alpha) * p**gamma * (-torch.log((1 - p).clamp(min=1e-8)))
    pos = alpha * (1 - p) ** gamma * (-torch.log(p.clamp(min=1e-8)))
    cost = pos - neg
    idx = gt_labels[..., None, :].expand(*cost.shape[:-1], gt_labels.shape[-1])
    return cost.gather(-1, idx)


def hungarian_cost_matrix(
    pred_logits: torch.Tensor,  # (B, K, C)
    pred_boxes: torch.Tensor,  # (B, K, 4) cxcywh
    gt_labels: torch.Tensor,  # (B, G)
    gt_boxes: torch.Tensor,  # (B, G, 4)
    gt_valid: torch.Tensor,  # (B, G)
    cost_class: float = 2.0,
    cost_bbox: float = 5.0,
    cost_giou: float = 2.0,
) -> torch.Tensor:
    """(B, K, G) matching cost; an invalid gt's column is 1e6."""
    cc = focal_class_cost(pred_logits, gt_labels)
    cb = (pred_boxes[:, :, None, :] - gt_boxes[:, None, :, :]).abs().sum(-1)
    cg = -generalized_box_iou(box_cxcywh_to_xyxy(pred_boxes), box_cxcywh_to_xyxy(gt_boxes))
    cost = cost_class * cc + cost_bbox * cb + cost_giou * cg
    return torch.where(gt_valid[:, None, :], cost, torch.full_like(cost, 1e6))


def auction_assign(cost: np.ndarray, gt_valid: np.ndarray, eps: float = 1e-3,
                   num_iters: int = 2000) -> np.ndarray:
    """JAX's auction (``ape_tpu.modeling.ape_deta.matchers.auction_assign``)
    on P problems at once: cost (P, K, G) f32, lower is better, gt_valid (P,
    G). Each round, every problem with an unassigned valid gt lets its first
    one bid for the proposal of the highest value (benefit - price; ties to
    the first), raising its price by the gap to the second-best value plus
    eps and taking it from its owner; at most ``num_iters`` rounds. The
    arithmetic is JAX's, in f32, so the assignment is JAX's. Returns
    assign (P, K) int64: gt index or -1."""
    cost = np.asarray(cost, np.float32)
    gt_valid = np.asarray(gt_valid, bool)
    p_count, k, g = cost.shape
    benefit = -np.transpose(cost, (0, 2, 1))  # (P, G, K)
    prices = np.zeros((p_count, k), np.float32)
    owner = np.full((p_count, k), -1, np.int64)
    has = np.zeros((p_count, g), bool)
    eps = np.float32(eps)
    with np.errstate(invalid="ignore", over="ignore"):
        for _ in range(num_iters):
            unassigned = gt_valid & ~has
            rows = np.flatnonzero(unassigned.any(1))
            if rows.size == 0:
                break
            bidder = unassigned[rows].argmax(1)
            values = benefit[rows, bidder] - prices[rows]  # (R, K)
            best = values.argmax(1)
            v1 = values[np.arange(rows.size), best]
            values[np.arange(rows.size), best] = -np.inf
            v2 = values.max(1)
            prices[rows, best] = prices[rows, best] + (v1 - v2) + eps
            prev = owner[rows, best]
            lost = prev >= 0
            has[rows[lost], prev[lost]] = False
            owner[rows, best] = bidder
            has[rows, bidder] = True
    return owner


# counts of the host syncs the Hungarian matcher makes (one per call)
SYNCS = {"hungarian": 0}


def hungarian_match(
    heads: Sequence[dict],  # each {"pred_logits": (B, K, C), "pred_boxes": (B, K, 4)}
    gt_labels: torch.Tensor,  # (B, G)
    gt_boxes: torch.Tensor,  # (B, G, 4)
    gt_valid: torch.Tensor,  # (B, G)
) -> torch.Tensor:
    """The Hungarian assignment of every head at once, at the criterion's
    cost weights (class 2, L1 5, GIoU 2): (len(heads), B, K) int64 on the
    heads' device, gt index or -1. The costs and the validity come to the
    host in one copy (one sync); the assignments go back by a pinned,
    non-blocking copy."""
    with torch.no_grad():
        cost = torch.stack([hungarian_cost_matrix(h["pred_logits"].float(), h["pred_boxes"].float(),
                                                  gt_labels, gt_boxes, gt_valid) for h in heads])
        n, b, k, g = cost.shape
        packed = torch.cat([cost.reshape(-1), gt_valid.float().reshape(-1)]).cpu().numpy()
    SYNCS["hungarian"] += 1
    valid = np.broadcast_to(packed[n * b * k * g:].reshape(1, b, g) > 0.5, (n, b, g))
    assign = auction_assign(packed[: n * b * k * g].reshape(n * b, k, g), valid.reshape(n * b, g))
    out = torch.from_numpy(assign.reshape(n, b, k))
    if cost.is_cuda:
        return out.pin_memory().to(cost.device, non_blocking=True)
    return out
