"""ViT backbone utilities (counterpart of ``ape_tpu/modeling/backbone/vit_utils.py``):
window partition, 2-D axial RoPE tables, bicubic position-embedding resize.

Tensors are channels-last (B, H, W, C), as in the JAX package. The RoPE tables
and the bicubic resize matrices are numpy constants, computed once per shape.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def window_partition(x: torch.Tensor, window: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(B, H, W, C) -> (B * nWin, window, window, C), padding H and W up as needed."""
    b, h, w, c = x.shape
    pad_h = (window - h % window) % window
    pad_w = (window - w % window) % window
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // window, window, wp // window, window, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c)
    return x, (hp, wp)


def window_unpartition(
    windows: torch.Tensor, window: int, pad_hw: Tuple[int, int], hw: Tuple[int, int]
) -> torch.Tensor:
    """Inverse of window_partition, cropping any padding."""
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // window // window)
    x = windows.reshape(b, hp // window, wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


@functools.lru_cache(maxsize=32)
def rope_2d_table(
    half_head_dim: int, seq_len: int, pt_seq_len: int = 16, theta: float = 10000.0
) -> Tuple[np.ndarray, np.ndarray]:
    """EVA-02 "fast" 2-D axial RoPE tables: (cos, sin), each (seq_len**2, 2*half_head_dim)."""
    dim = half_head_dim
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2)[: dim // 2].astype(np.float64) / dim))
    t = np.arange(seq_len, dtype=np.float64) / seq_len * pt_seq_len
    f = np.repeat(np.einsum("n,f->nf", t, freqs), 2, axis=-1)  # (seq, dim)
    fh = np.broadcast_to(f[:, None, :], (seq_len, seq_len, dim))
    fw = np.broadcast_to(f[None, :, :], (seq_len, seq_len, dim))
    full = np.concatenate([fh, fw], axis=-1).reshape(seq_len * seq_len, 2 * dim)
    return np.cos(full).astype(np.float32), np.sin(full).astype(np.float32)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """Pairwise rotation: (x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...)."""
    x = x.reshape(*x.shape[:-1], -1, 2)
    return torch.stack([-x[..., 1], x[..., 0]], dim=-1).flatten(-2)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., tokens, head_dim); cos/sin: (tokens, head_dim)."""
    return x * cos + rotate_half(x) * sin


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel (torch's bicubic uses a=-0.75)."""
    ax = np.abs(x)
    return np.where(
        ax <= 1,
        (a + 2) * ax**3 - (a + 3) * ax**2 + 1,
        np.where(ax < 2, a * ax**3 - 5 * a * ax**2 + 8 * a * ax - 4 * a, 0.0),
    )


@functools.lru_cache(maxsize=64)
def bicubic_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) matrix M with M @ v == torch's bicubic resize of v
    (align_corners=False, border-replicate index clamping)."""
    m = np.zeros((out_size, in_size), dtype=np.float64)
    scale = in_size / out_size
    for i in range(out_size):
        src = (i + 0.5) * scale - 0.5
        i0 = int(np.floor(src))
        frac = src - i0
        for k in range(-1, 3):
            m[i, min(max(i0 + k, 0), in_size - 1)] += _cubic_kernel(np.array(k - frac))[()]
    return m.astype(np.float32)


def resize_abs_pos(abs_pos: torch.Tensor, has_cls_token: bool, hw: Tuple[int, int]) -> torch.Tensor:
    """Bicubic-resize (1, num_positions, C) pretraining position embeddings to
    the token grid: returns (1, h, w, C)."""
    h, w = hw
    if has_cls_token:
        abs_pos = abs_pos[:, 1:]
    n = abs_pos.shape[1]
    size = int(round(float(np.sqrt(n))))
    if size * size != n:
        raise ValueError(f"non-square pos embed: {n}")
    grid = abs_pos.reshape(size, size, -1)
    if size == h and size == w:
        return grid[None]
    my = torch.as_tensor(bicubic_resize_matrix(size, h), device=grid.device, dtype=grid.dtype)
    mx = torch.as_tensor(bicubic_resize_matrix(size, w), device=grid.device, dtype=grid.dtype)
    out = torch.einsum("hs,stc->htc", my, grid)
    out = torch.einsum("wt,htc->hwc", mx, out)
    return out[None]
