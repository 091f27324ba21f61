"""Sine position embeddings (counterpart of ``ape_tpu/ops/posemb.py``)."""

from __future__ import annotations

import math

import torch


def position_embedding_sine(mask: torch.Tensor, num_pos_feats: int = 128) -> torch.Tensor:
    """mask: (B, H, W) bool, True = VALID pixel. Returns (B, H, W, 2*num_pos_feats) f32.

    detrex PositionEmbeddingSine(temperature=10000, normalize=True,
    offset=-0.5), as the reference configures it.
    """
    not_mask = mask.to(torch.float32)
    y_embed = torch.cumsum(not_mask, dim=1)
    x_embed = torch.cumsum(not_mask, dim=2)
    y_embed = (y_embed - 0.5) / (y_embed[:, -1:, :] + 1e-6) * (2 * math.pi)
    x_embed = (x_embed - 0.5) / (x_embed[:, :, -1:] + 1e-6) * (2 * math.pi)

    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=mask.device)
    dim_t = 10000.0 ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / num_pos_feats)

    pos_x = x_embed[..., None] / dim_t
    pos_y = y_embed[..., None] / dim_t
    # interleave sin/cos over pairs, as torch's stack(sin, cos, dim=4).flatten(3)
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()], dim=-1).flatten(-2)
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()], dim=-1).flatten(-2)
    return torch.cat([pos_y, pos_x], dim=-1)
