"""Small numeric helpers (counterpart of ``ape_tpu/ops/misc.py``)."""

from __future__ import annotations

import torch


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Clamped logit with the DINO-style eps=1e-3 that ``ape_tpu`` uses."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps)) - torch.log((1.0 - x).clamp(min=eps))


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor, alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """Elementwise sigmoid focal loss (RetinaNet); no reduction."""
    p = torch.sigmoid(logits).clamp(1e-8, 1 - 1e-8)
    ce = torch.nn.functional.softplus(logits) - logits * targets  # BCE with logits
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss
