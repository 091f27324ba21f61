"""MultiScaleDeformableAttention module (counterpart of
``ape_tpu/layers/msda_module.py``).

  * mode="window" (encoder): queries are the pyramid grid; offsets are value-
    level pixels around each query's grid center, clipped to the window radius
    (``ops.msda_dispatch.ms_deform_attn_window``). ``grid_corrections`` carry
    the per-batch valid-ratio shift so padded batches stay exact.
  * mode="exact" (decoder): normalized locations ``ref + off / P * wh * 0.5``
    for 4-d box references (``ops.msda_dispatch.ms_deform_attn_exact``).

Both go to the CUDA gather kernel for CUDA tensors. Parameter names are the
reference's: sampling_offsets, attention_weights, value_proj, output_proj.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ape_tpu_torch.layers.common import Linear
from ape_tpu_torch.ops.msda_dispatch import (
    level_sizes,
    ms_deform_attn_exact,
    ms_deform_attn_window,
)


def _offset_bias_init(num_heads: int, num_levels: int, num_points: int) -> np.ndarray:
    """Directional ring init: head h points at angle 2*pi*h/H, point p at radius p+1."""
    thetas = np.arange(num_heads, dtype=np.float64) * (2.0 * math.pi / num_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, num_levels, num_points, 1))
    for p in range(num_points):
        grid[:, :, p, :] *= p + 1
    return grid.reshape(-1).astype(np.float32)


class MultiScaleDeformableAttention(nn.Module):
    def __init__(
        self,
        embed_dim: int = 256,
        num_heads: int = 8,
        num_levels: int = 4,
        num_points: int = 4,
        window_radius: int = 4,
    ):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.num_levels = num_levels
        self.num_points = num_points
        self.window_radius = window_radius
        self.sampling_offsets = Linear(embed_dim, num_heads * num_levels * num_points * 2)
        self.attention_weights = Linear(embed_dim, num_heads * num_levels * num_points)
        self.value_proj = Linear(embed_dim, embed_dim)
        self.output_proj = Linear(embed_dim, embed_dim)
        with torch.no_grad():
            nn.init.zeros_(self.sampling_offsets.weight)
            self.sampling_offsets.bias.copy_(
                torch.from_numpy(_offset_bias_init(num_heads, num_levels, num_points))
            )
            nn.init.zeros_(self.attention_weights.weight)
            nn.init.zeros_(self.attention_weights.bias)

    def forward(
        self,
        query: torch.Tensor,  # (B, Q, C)
        value: torch.Tensor,  # (B, S, C)
        spatial_shapes: Sequence[Tuple[int, int]],
        reference_points: torch.Tensor,  # (B, Q, L, 2) or (B, Q, L, 4), normalized
        identity: Optional[torch.Tensor] = None,
        query_pos: Optional[torch.Tensor] = None,
        key_padding_mask: Optional[torch.Tensor] = None,  # (B, S) True = PAD
        mode: str = "exact",
        grid_corrections: Optional[torch.Tensor] = None,  # (B, Q, L, 2) pixel shift
    ) -> torch.Tensor:
        b, q, _ = query.shape
        s = value.shape[1]
        h, l, p = self.num_heads, self.num_levels, self.num_points
        if identity is None:
            identity = query
        if query_pos is not None:
            query = query + query_pos

        v = self.value_proj(value)
        if key_padding_mask is not None:
            v = v.masked_fill(key_padding_mask[..., None], 0.0)
        v = v.reshape(b, s, h, self.embed_dim // h)

        offsets = self.sampling_offsets(query).reshape(b, q, h, l, p, 2)
        weights = self.attention_weights(query).reshape(b, q, h, l * p)
        weights = torch.softmax(weights.float(), dim=-1).to(v.dtype).reshape(b, q, h, l, p)

        if mode == "window":
            if reference_points.shape[-1] != 2:
                raise ValueError("window mode requires 2-point references")
            pixel_offsets = offsets.float()
            if grid_corrections is not None:
                pixel_offsets = pixel_offsets + grid_corrections[:, :, None, :, None, :]
            out = ms_deform_attn_window(v, spatial_shapes, pixel_offsets, weights, self.window_radius)
        elif mode == "exact":
            refs = reference_points[:, :, None, :, None, :].float()
            if reference_points.shape[-1] == 2:
                norm = level_sizes(spatial_shapes, query.device)
                loc = refs + offsets.float() / norm[None, None, None, :, None, :]
            elif reference_points.shape[-1] == 4:
                loc = refs[..., :2] + offsets.float() / p * refs[..., 2:] * 0.5
            else:
                raise ValueError(tuple(reference_points.shape))
            out = ms_deform_attn_exact(v, spatial_shapes, loc, weights)
        else:
            raise ValueError(f"unknown MSDA mode {mode!r}")
        return identity + self.output_proj(out)
