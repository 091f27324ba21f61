"""Multi-scale deformable attention: the plain exact bilinear version.

Counterpart of ``ape_tpu/ops/msda.py``. Semantics are bilinear sampling with
``align_corners=False`` and zero padding: pixel coordinate = ``loc * size -
0.5``; corners outside the level contribute zero. This is the CPU path of the
MSDA ops in ``msda_dispatch.py`` and the oracle of the CUDA kernel
(``csrc/msda_fwd.cu``).

Conventions (batch-first, the JAX layouts):
  value:              (B, S, H, D)   S = sum(H_l * W_l)
  spatial_shapes:     ((H_0, W_0), ...) Python ints
  sampling_locations: (B, Q, H, L, P, 2)  normalized, last dim (x, y)
  attention_weights:  (B, Q, H, L, P)
  returns:            (B, Q, H * D) in value's dtype
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def level_start_index(spatial_shapes: Sequence[Tuple[int, int]]):
    """Start offsets of each level in the flattened token axis, and the total."""
    starts = [0]
    for h, w in spatial_shapes:
        starts.append(starts[-1] + h * w)
    return tuple(starts[:-1]), starts[-1]


def sample_level(value_l, loc_l, w_l, height: int, width: int) -> torch.Tensor:
    """Weighted bilinear samples of one level, summed over points.

    value_l (B, HW, H, D) f32, loc_l (B, Q, H, P, 2), w_l (B, Q, H, P) -> (B, Q, H, D) f32.
    """
    b, q, h, p = w_l.shape
    d = value_l.shape[-1]
    x = loc_l[..., 0] * width - 0.5
    y = loc_l[..., 1] * height - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    # keep the integer cast in range for far-out (or non-finite) locations
    ix0 = x0.clamp(-2, width + 1).nan_to_num(-2).long()
    iy0 = y0.clamp(-2, height + 1).nan_to_num(-2).long()
    rows = value_l.permute(0, 2, 1, 3).reshape(b * h, height * width, d)

    out = None
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        ix = ix0 + dx
        iy = iy0 + dy
        valid = (ix >= 0) & (ix < width) & (iy >= 0) & (iy < height)
        cw = (fx if dx else 1.0 - fx) * (fy if dy else 1.0 - fy)
        cw = torch.where(valid, cw * w_l, torch.zeros_like(cw))
        lin = iy.clamp(0, height - 1) * width + ix.clamp(0, width - 1)  # (B, Q, H, P)
        idx = lin.permute(0, 2, 1, 3).reshape(b * h, q * p, 1).expand(-1, -1, d)
        g = torch.gather(rows, 1, idx).reshape(b, h, q, p, d)
        contrib = (g * cw.permute(0, 2, 1, 3)[..., None]).sum(3)  # (B, H, Q, D)
        out = contrib if out is None else out + contrib
    return out.permute(0, 2, 1, 3)


def ms_deform_attn(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int]],
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """Plain exact MSDA; accumulates in f32 and returns value's dtype."""
    spatial_shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    b, s, h, d = value.shape
    _, q, _, l, p, _ = sampling_locations.shape
    starts, total = level_start_index(spatial_shapes)
    if total != s or l != len(spatial_shapes):
        raise ValueError(f"value length {s} / {l} levels do not match {spatial_shapes}")
    value32 = value.float()
    loc = sampling_locations.float()
    att = attention_weights.float()
    out = torch.zeros(b, q, h, d, dtype=torch.float32, device=value.device)
    for lvl, (hh, ww) in enumerate(spatial_shapes):
        value_l = value32[:, starts[lvl] : starts[lvl] + hh * ww]
        out = out + sample_level(value_l, loc[:, :, :, lvl], att[:, :, :, lvl], hh, ww)
    return out.reshape(b, q, h * d).to(value.dtype)
