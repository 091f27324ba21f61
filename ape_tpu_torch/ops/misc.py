"""Small numeric helpers (counterpart of ``ape_tpu/ops/misc.py``)."""

from __future__ import annotations

import torch


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    """Clamped logit with the DINO-style eps=1e-3 that ``ape_tpu`` uses."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps)) - torch.log((1.0 - x).clamp(min=eps))
