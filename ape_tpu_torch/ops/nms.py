"""Greedy NMS as a tiled fixpoint (counterpart of ``ape_tpu/ops/nms.py``).

Boxes are sorted by score once; tiles of T boxes are finalized in order.
Within a tile, exact greedy is reached by a confirmed-set fixpoint: a box with
no surviving potential suppressor is kept, boxes suppressed by kept boxes are
eliminated; each iteration decides at least the earliest undecided box. Each
finished tile suppresses all later boxes with one (T x N) IoU pass.

The fixpoint's loop test reads a device flag on the host: one host sync per
fixpoint iteration (typically 2-4 per tile). ``nms_mask`` takes a leading
batch of independent problems so the first-stage select runs its per-level
NMS problems together, with one sync per iteration for the whole batch.
"""

from __future__ import annotations

import torch

NEG_INF = -1e10
TILE = 256


def sort_desc(x: torch.Tensor, dim: int = -1):
    """Stable descending sort: equal values keep index order, as ``lax.top_k``."""
    return torch.sort(x, dim=dim, descending=True, stable=True)


def topk(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dim; ties by lower index."""
    vals, idx = sort_desc(x)
    return vals[..., :k], idx[..., :k]


def _iou_tile_vs_all(tile_boxes: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """IoU of (..., T, 4) against (..., N, 4) -> (..., T, N)."""
    a_t = (tile_boxes[..., 2] - tile_boxes[..., 0]).clamp(min=0) * (
        tile_boxes[..., 3] - tile_boxes[..., 1]).clamp(min=0)
    a_n = (boxes[..., 2] - boxes[..., 0]).clamp(min=0) * (boxes[..., 3] - boxes[..., 1]).clamp(min=0)
    lt = torch.maximum(tile_boxes[..., :, None, :2], boxes[..., None, :, :2])
    rb = torch.minimum(tile_boxes[..., :, None, 2:], boxes[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / torch.clamp(a_t[..., :, None] + a_n[..., None, :] - inter, min=1e-9)


def _greedy_fixpoint(alive: torch.Tensor, sup: torch.Tensor) -> torch.Tensor:
    """Exact greedy keep mask within a tile: alive (G, T), sup (G, T, T) strict upper."""
    t = alive.shape[-1]
    kept = torch.zeros_like(alive)
    elim = ~alive
    for _ in range(t):
        undecided = alive & ~kept & ~elim
        if not bool(undecided.any()):  # host sync
            break
        potential = kept | undecided
        has_pot_sup = (sup & potential[..., :, None]).any(-2)
        kept = kept | (undecided & ~has_pot_sup)
        sup_by_kept = (sup & kept[..., :, None]).any(-2)
        elim = elim | (alive & sup_by_kept)
    return kept


def nms_mask(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Exact greedy NMS. boxes (..., N, 4) xyxy, scores (..., N) -> bool keep (..., N).

    Leading dims are independent problems. Entries with ``valid == False`` (or
    score == NEG_INF) are never kept.
    """
    batch_shape = scores.shape[:-1]
    n = scores.shape[-1]
    boxes = boxes.reshape(-1, n, 4)
    scores = scores.reshape(-1, n)
    g = scores.shape[0]
    if n == 0:
        return torch.zeros(*batch_shape, 0, dtype=torch.bool, device=scores.device)
    if valid is not None:
        scores = torch.where(valid.reshape(-1, n), scores, torch.full_like(scores, NEG_INF))
    order = torch.argsort(-scores, dim=-1, stable=True)
    t = min(TILE, max(8, n))
    pad = (-n) % t
    boxes_s = torch.nn.functional.pad(torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)), (0, 0, 0, pad))
    alive = torch.nn.functional.pad(torch.gather(scores, 1, order) > NEG_INF / 2, (0, pad))
    np_ = n + pad
    kept = torch.zeros(g, np_, dtype=torch.bool, device=scores.device)
    idx_all = torch.arange(np_, device=scores.device)
    tri = torch.triu(torch.ones(t, t, dtype=torch.bool, device=scores.device), diagonal=1)
    for start in range(0, np_, t):
        iou = _iou_tile_vs_all(boxes_s[:, start : start + t], boxes_s)  # (G, T, Np)
        m = iou[:, :, start : start + t]
        kept_t = _greedy_fixpoint(alive[:, start : start + t], tri & (m > iou_threshold))
        kept[:, start : start + t] = kept_t
        sup_later = (kept_t[..., :, None] & (iou > iou_threshold)).any(-2)
        alive = alive & ~(sup_later & (idx_all >= start + t))
    keep = torch.zeros(g, n, dtype=torch.bool, device=scores.device)
    keep.scatter_(1, order, kept[:, :n])
    return keep.reshape(*batch_shape, n)


def batched_nms_mask(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    idxs: torch.Tensor,
    iou_threshold: float,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Class-aware NMS of (N, 4) boxes via the coordinate-offset trick."""
    if boxes.shape[0] == 0:
        return torch.zeros(0, dtype=torch.bool, device=boxes.device)
    max_coord = boxes.abs().max() + 1.0
    offsets = idxs.to(boxes.dtype) * (2.0 * max_coord)
    return nms_mask(boxes + offsets[:, None], scores, iou_threshold, valid)
