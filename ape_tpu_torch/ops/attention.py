"""Global self-attention of the ViT's global blocks.

``global_attention`` launches the flash-attention kernel ``csrc/attn_fwd.cu``
for CUDA tensors and takes the plain version for CPU tensors. It replaces the
JAX library Pallas kernel ``flash_attention`` that
``ape_tpu/modeling/backbone/eva_vit.py:111-136`` calls on the TPU; off the TPU
JAX runs the einsum path, which ``global_attention_plain`` mirrors.

Layout: q, k, v and the result are (B, H, N, Dh), as in JAX.
"""

from __future__ import annotations

import torch

from ape_tpu_torch.ops import _build

HEAD_DIMS = (32, 64, 128)
_NO_GRAD_MSG = "backward kernels land with Ti training"


def global_attention_plain(q, k, v, scale: float) -> torch.Tensor:
    """softmax((q * scale) k^T) v with the softmax in f32; result in v's dtype."""
    logits = torch.matmul(q * scale, k.transpose(-1, -2))
    attn = torch.softmax(logits.float(), dim=-1).to(v.dtype)
    return torch.matmul(attn, v)


def attn_fwd_cuda(q, k, v, scale: float) -> torch.Tensor:
    """Launch ``csrc/attn_fwd.cu`` on (B, H, N, Dh) tensors."""
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"attn_fwd takes equal (B, H, N, Dh) q, k, v: {q.shape} {k.shape} {v.shape}")
    b, h, n, dh = q.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"attn_fwd takes head_dim in {HEAD_DIMS}, got {dh}")
    if q.dtype not in (torch.float32, torch.bfloat16) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"attn_fwd takes f32 or bf16 q, k, v of one dtype: {q.dtype} {k.dtype} {v.dtype}")
    for t in (q, k, v):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("attn_fwd takes CUDA tensors on one device")
        if not t.is_contiguous():
            raise ValueError("attn_fwd takes contiguous tensors")
        if t.requires_grad:
            raise NotImplementedError(_NO_GRAD_MSG)
    out = torch.empty_like(q)
    err = _build.library().ape_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, n, dh, float(scale),
        int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "attn_fwd")
    _build.LAUNCHES["attn_fwd"] += 1
    return out


def global_attention(q, k, v, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over all tokens: (B, H, N, Dh) -> (B, H, N, Dh)."""
    if q.is_cuda:
        return attn_fwd_cuda(q, k, v, scale)
    if q.device.type == "cpu":
        return global_attention_plain(q, k, v, scale)
    raise ValueError(f"no attention implementation for device {q.device}")
