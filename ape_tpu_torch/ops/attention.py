"""Global self-attention of the ViT's global blocks.

``global_attention`` launches the flash-attention kernel ``csrc/attn_fwd.cu``
for CUDA tensors and takes the plain version for CPU tensors. It replaces the
JAX library Pallas kernel ``flash_attention`` that
``ape_tpu/modeling/backbone/eva_vit.py:111-136`` calls on the TPU; off the TPU
JAX runs the einsum path, which ``global_attention_plain`` mirrors.
Gradients on the card run ``csrc/attn_bwd.cu`` (the library kernel's two
backward kernels, dK/dV and dQ, after a pre-pass for rowsum(dO * O)), from
the log-sum-exp the forward saves; on the CPU, torch autograd of the plain
version. In bf16 the forward and dK/dV run on the tensor cores (mma.sync,
P and dS rounded to bf16 before their second product); in f32 every kernel
is plain f32 FMAs.

``attn_fwd_tiles`` runs the same forward at another tile (K11,
``csrc/attn_fwd_tiles.cu``), the counterpart of the block-size study of
``experiments/backbone_fix_probe.py``; ``attn_tile_smem`` is the shared
memory a tile takes, in plain Python, and a tile that does not fit a block
is refused before any launch.

Layout: q, k, v and the result are (B, H, N, Dh), as in JAX.
"""

from __future__ import annotations

import torch

from ape_tpu_torch.ops import _build

HEAD_DIMS = (32, 64, 128)
# K11's tiles (queries, keys a block); K5 is (64, 64)
TILES = ((32, 32), (64, 64), (64, 128), (128, 64), (128, 128))
SMEM_LIMIT = 232448  # dynamic shared memory one block may take on an H100 (227 KB)


def global_attention_plain(q, k, v, scale: float) -> torch.Tensor:
    """softmax((q * scale) k^T) v with the softmax in f32; result in v's dtype."""
    logits = torch.matmul(q * scale, k.transpose(-1, -2))
    attn = torch.softmax(logits.float(), dim=-1).to(v.dtype)
    return torch.matmul(attn, v)


def _check(name, *tensors):
    """Equal (B, H, N, Dh) shapes, one f32 or bf16 dtype, contiguous, one CUDA
    device; bf16 rows start 16-byte aligned (the kernels copy them by cp.async)."""
    q = tensors[0]
    if q.dim() != 4 or any(t.shape != q.shape for t in tensors):
        raise ValueError(f"{name} takes equal (B, H, N, Dh) tensors: {[tuple(t.shape) for t in tensors]}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{name} takes head_dim in {HEAD_DIMS}, got {q.shape[-1]}")
    if q.dtype not in (torch.float32, torch.bfloat16) or any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"{name} takes f32 or bf16 tensors of one dtype: {[t.dtype for t in tensors]}")
    for t in tensors:
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} takes CUDA tensors on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{name} takes bf16 tensors at 16-byte aligned addresses")


def attn_fwd_cuda(q, k, v, scale: float, with_lse: bool = False):
    """Launch ``csrc/attn_fwd.cu`` on (B, H, N, Dh) tensors. with_lse: also
    return the (B, H, N) f32 log-sum-exp of the scaled scores."""
    _check("attn_fwd", q, k, v)
    b, h, n, dh = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b, h, n, dtype=torch.float32, device=q.device) if with_lse else None
    err = _build.library().ape_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if with_lse else None, b * h, n, dh, float(scale),
        int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "attn_fwd")
    _build.LAUNCHES["attn_fwd"] += 1
    return (out, lse) if with_lse else out


def attn_bwd_delta_cuda(out, grad_out) -> torch.Tensor:
    """Launch the pre-pass of ``csrc/attn_bwd.cu``: rowsum(grad_out * out), (B, H, N) f32."""
    _check("attn_bwd_delta", out, grad_out)
    b, h, n, dh = out.shape
    delta = torch.empty(b, h, n, dtype=torch.float32, device=out.device)
    err = _build.library().ape_attn_bwd_delta(
        out.data_ptr(), grad_out.data_ptr(), delta.data_ptr(), b * h, n, dh,
        int(out.dtype == torch.bfloat16), torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(err, "attn_bwd_delta")
    _build.LAUNCHES["attn_bwd_delta"] += 1
    return delta


def _check_rows(name, q, *rows):
    for t in rows:
        if (t.dtype != torch.float32 or tuple(t.shape) != tuple(q.shape[:3])
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name} takes contiguous f32 (B, H, N) lse and delta on q's device, "
                             f"got {t.dtype} {tuple(t.shape)}")


def attn_bwd_dkv_cuda(q, k, v, grad_out, lse, delta, scale: float):
    """Launch the dK/dV kernel of ``csrc/attn_bwd.cu``; returns (dk, dv)."""
    _check("attn_bwd_dkv", q, k, v, grad_out)
    _check_rows("attn_bwd_dkv", q, lse, delta)
    b, h, n, dh = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _build.library().ape_attn_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), grad_out.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, n, dh, float(scale),
        int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "attn_bwd_dkv")
    _build.LAUNCHES["attn_bwd_dkv"] += 1
    return dk, dv


def attn_bwd_dq_cuda(q, k, v, grad_out, lse, delta, scale: float) -> torch.Tensor:
    """Launch the dQ kernel of ``csrc/attn_bwd.cu``."""
    _check("attn_bwd_dq", q, k, v, grad_out)
    _check_rows("attn_bwd_dq", q, lse, delta)
    b, h, n, dh = q.shape
    dq = torch.empty_like(q)
    err = _build.library().ape_attn_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), grad_out.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), b * h, n, dh, float(scale),
        int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "attn_bwd_dq")
    _build.LAUNCHES["attn_bwd_dq"] += 1
    return dq


def attn_bwd_cuda(q, k, v, out, grad_out, lse, scale: float):
    """(dq, dk, dv) of ``attn_fwd_cuda`` from its output and log-sum-exp:
    the delta pre-pass, then the dK/dV and dQ kernels."""
    delta = attn_bwd_delta_cuda(out, grad_out)
    dk, dv = attn_bwd_dkv_cuda(q, k, v, grad_out, lse, delta, scale)
    return attn_bwd_dq_cuda(q, k, v, grad_out, lse, delta, scale), dk, dv


class _FlashAttention(torch.autograd.Function):
    """attn_fwd.cu forward (saving the log-sum-exp), attn_bwd.cu backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = attn_fwd_cuda(q, k, v, scale, with_lse=True)
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = attn_bwd_cuda(q, k, v, out, grad_out.contiguous(), lse, ctx.scale)
        return dq, dk, dv, None


def attn_tile_smem(bq: int, bk: int, dh: int, dtype: torch.dtype) -> int:
    """Shared bytes of csrc/attn_fwd.cuh's block at a tile. f32 body: the
    transposed query and key tiles, the value tile and the probabilities, in
    f32, rows padded by 4. bf16 body: the query tile and two buffers each of
    the key and value tiles, in bf16, rows padded by 8."""
    if dtype == torch.bfloat16:
        return 2 * (bq + 4 * bk) * (dh + 8)
    return 4 * (dh * (bq + 4) + dh * (bk + 4) + bk * dh + bk * (bq + 4))


def attn_tile_fits(bq: int, bk: int, dh: int, dtype: torch.dtype) -> bool:
    return attn_tile_smem(bq, bk, dh, dtype) <= SMEM_LIMIT


def _check_tile(bq: int, bk: int, dh: int, dtype: torch.dtype) -> None:
    if (bq, bk) not in TILES:
        raise ValueError(f"attn_fwd_tiles takes the tiles {TILES}, got {(bq, bk)}")
    if not attn_tile_fits(bq, bk, dh, dtype):
        raise ValueError(f"tile {(bq, bk)} at head_dim {dh} in {dtype} needs "
                         f"{attn_tile_smem(bq, bk, dh, dtype)} bytes of shared memory; "
                         f"a block has {SMEM_LIMIT}")


def attn_fwd_tiles_cuda(q, k, v, scale: float, bq: int, bk: int) -> torch.Tensor:
    """Launch ``csrc/attn_fwd_tiles.cu`` at the tile (bq, bk) on (B, H, N, Dh)
    tensors."""
    _check("attn_fwd_tiles", q, k, v)
    b, h, n, dh = q.shape
    _check_tile(bq, bk, dh, q.dtype)
    out = torch.empty_like(q)
    err = _build.library().ape_attn_fwd_tiles(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h, n, dh, float(scale),
        int(q.dtype == torch.bfloat16), bq, bk, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "attn_fwd_tiles")
    _build.LAUNCHES["attn_fwd_tiles"] += 1
    return out


def attn_fwd_tiles(q, k, v, scale: float, bq: int, bk: int) -> torch.Tensor:
    """The attention forward at a tile: the kernel for CUDA tensors, the
    plain version for CPU tensors; a tile that does not fit is refused on
    both."""
    if q.is_cuda:
        return attn_fwd_tiles_cuda(q, k, v, scale, bq, bk)
    if q.device.type == "cpu":
        _check_tile(bq, bk, q.shape[-1], q.dtype)
        return global_attention_plain(q, k, v, scale)
    raise ValueError(f"no attention implementation for device {q.device}")


def global_attention(q, k, v, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over all tokens: (B, H, N, Dh) -> (B, H, N, Dh)."""
    if q.is_cuda:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            return _FlashAttention.apply(q, k, v, scale)
        return attn_fwd_cuda(q, k, v, scale)
    if q.device.type == "cpu":
        return global_attention_plain(q, k, v, scale)
    raise ValueError(f"no attention implementation for device {q.device}")
