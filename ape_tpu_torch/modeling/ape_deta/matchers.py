"""Fixed-shape assigners for DETA training (counterpart of
``ape_tpu/modeling/ape_deta/matchers.py``), batched over images where JAX
maps one image with ``vmap``.

Assignments are dense ``(B, K)`` int64 tensors holding a gt index or -1, over
padded gt slots with validity masks. Random subsampling draws its noise from
an explicit ``torch.Generator`` (JAX: an explicit PRNG key); the two give
different numbers, so only a subsample that keeps every positive agrees.

Not ported yet: the auction Hungarian matcher, which the criterion uses only
with ``use_stage2=False``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ape_tpu_torch.ops.box_ops import box_cxcywh_to_xyxy, box_iou

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
                        generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Randomly keep at most max_pos True entries per row of (B, K)."""
    gen_device = generator.device if generator is not None else pos_mask.device
    noise = torch.rand(pos_mask.shape, generator=generator, device=gen_device).to(pos_mask.device)
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
) -> torch.Tensor:
    """Stage2Assigner -> assign (B, K): gt index or -1."""
    iou, _ = box_iou(box_cxcywh_to_xyxy(gt_boxes), box_cxcywh_to_xyxy(init_reference))
    iou = torch.where(gt_valid[..., None], iou, torch.full_like(iou, -1.0))
    matched_idx, label = threshold_match(iou, gt_valid, (iou_thresh,), (0, 1))
    pos = subsample_positives(label == 1, int(num_queries * positive_fraction), generator)
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
) -> torch.Tensor:
    """Stage1Assigner on the encoder's anchors -> assign (B, S)."""
    iou, _ = box_iou(box_cxcywh_to_xyxy(gt_boxes), box_cxcywh_to_xyxy(anchors))
    iou = torch.where(gt_valid[..., None] & anchor_valid[:, None, :], iou, torch.full_like(iou, -1.0))
    matched_val, matched_idx = iou.max(dim=1)
    label = _threshold_labels(matched_val, (t_low, t_high), (0, -1, 1))
    label = torch.where(_low_quality(iou, gt_valid) & anchor_valid, torch.ones_like(label), label)
    pos = subsample_positives((label == 1) & anchor_valid,
                              int(batch_size_per_image * positive_fraction), generator)
    assign = torch.where(pos, matched_idx, torch.full_like(matched_idx, -1))
    assign = topk_per_gt(assign, iou, max_k)
    return torch.where(gt_valid.any(1, keepdim=True), assign, torch.full_like(assign, -1))
