"""EVA-02 ViT backbone + SimpleFeaturePyramid (counterpart of
``ape_tpu/modeling/backbone/eva_vit.py``), with the APE-Ti flags only: packed
qkv with q/v-only bias, 2-D RoPE, windowed and global blocks, packed SwiGLU.

Tokens stay channels-last (B, H, W, C) as in the JAX package; the pyramid's
convolutions run channels-first inside. Global blocks (window_size 0) run
``ops.attention.global_attention`` (the CUDA flash kernel on the card);
windowed blocks (196 tokens) stay plain matmul + softmax, as JAX leaves them
to an XLA einsum.

Parameter names are the reference's (vit_eva02.py): ``net.blocks.{i}.attn.qkv``,
``net.patch_embed.proj``, ``simfp_{stage}.{index}``, ...
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ape_tpu_torch.layers.common import LayerNorm, Linear
from ape_tpu_torch.modeling.backbone.vit_utils import (
    apply_rope,
    resize_abs_pos,
    rope_2d_table,
    window_partition,
    window_unpartition,
)
from ape_tpu_torch.ops.attention import global_attention


class Attention(nn.Module):
    """EVA attention: packed qkv without bias, q/v-only bias, 2-D RoPE on q and k."""

    def __init__(self, dim: int, num_heads: int, global_attn: bool):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.global_attn = global_attn
        self.qkv = Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.proj = Linear(dim, dim)

    def forward(self, x, rope_cos, rope_sin):
        b, h, w, c = x.shape
        n = h * w
        head_dim = self.dim // self.num_heads
        scale = head_dim**-0.5
        q, k, v = self.qkv(x.reshape(b, n, c)).chunk(3, dim=-1)
        q = q + self.q_bias.to(q.dtype)
        v = v + self.v_bias.to(v.dtype)
        q, k, v = (t.reshape(b, n, self.num_heads, head_dim).transpose(1, 2) for t in (q, k, v))
        q = apply_rope(q, rope_cos.to(q.dtype), rope_sin.to(q.dtype))
        k = apply_rope(k, rope_cos.to(k.dtype), rope_sin.to(k.dtype))
        if self.global_attn:
            out = global_attention(q.contiguous(), k.contiguous(), v.contiguous(), scale)
        else:
            attn = torch.matmul(q * scale, k.transpose(-1, -2))
            attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
            out = torch.matmul(attn, v)
        out = out.transpose(1, 2).reshape(b, n, self.dim)
        return self.proj(out).reshape(b, h, w, self.dim)


class SwiGLU(nn.Module):
    """EVA-02's packed SwiGLU (xops_SwiGLU: w12 packed, then w3)."""

    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.w12 = Linear(dim, 2 * hidden_dim)
        self.w3 = Linear(hidden_dim, dim)

    def forward(self, x):
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(x1) * x2)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_hidden_dim: int, window_size: int = 0):
        super().__init__()
        self.window_size = window_size
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, global_attn=window_size == 0)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = SwiGLU(dim, mlp_hidden_dim)

    def forward(self, x, rope_cos, rope_sin):
        y = self.norm1(x)
        if self.window_size > 0:
            h, w = y.shape[1], y.shape[2]
            y, pad_hw = window_partition(y, self.window_size)
        y = self.attn(y, rope_cos, rope_sin)
        if self.window_size > 0:
            y = window_unpartition(y, self.window_size, pad_hw, (h, w))
        x = x + y
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    """Non-overlapping patchify as reshape + matmul on a Conv2d-shaped weight."""

    def __init__(self, in_chans: int, embed_dim: int, patch_size: int):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)

    def forward(self, x):
        """x: (B, H, W, C) -> (B, H/p, W/p, D)."""
        b, h, w, c = x.shape
        p = self.proj.kernel_size[0]
        x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, h // p, w // p, p * p * c)
        kernel = self.proj.weight.permute(2, 3, 1, 0).reshape(p * p * c, -1)
        return x @ kernel.to(x.dtype) + self.proj.bias.to(x.dtype)


class EVAViT(nn.Module):
    """Plain ViT with windowed and global blocks producing one stride-16 map."""

    def __init__(
        self,
        patch_size: int = 16,
        embed_dim: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        mlp_ratio: float = 4 * 2 / 3,
        window_size: int = 14,
        window_block_indexes: Sequence[int] = (),
        pretrain_img_size: int = 224,
        pretrain_use_cls_token: bool = True,
        pt_hw_seq_len: int = 16,
        packed_swiglu: bool = True,
        subln: bool = False,
        use_rel_pos: bool = False,
        postnorm: bool = False,
        mlp_type: str = "swiglu",
    ):
        super().__init__()
        if subln or use_rel_pos or postnorm or mlp_type != "swiglu" or not packed_swiglu:
            raise NotImplementedError("the port's EVAViT has the APE-Ti flags only")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.window_size = window_size
        self.pt_hw_seq_len = pt_hw_seq_len
        self.pretrain_use_cls_token = pretrain_use_cls_token
        self.window_block_indexes = tuple(window_block_indexes)
        self.patch_embed = PatchEmbed(3, embed_dim, patch_size)
        num_positions = (pretrain_img_size // patch_size) ** 2 + int(pretrain_use_cls_token)
        self.pos_embed = nn.Parameter(torch.zeros(1, num_positions, embed_dim))
        nn.init.trunc_normal_(self.pos_embed, std=0.02)
        self.blocks = nn.ModuleList(
            Block(
                embed_dim,
                num_heads,
                int(embed_dim * mlp_ratio),
                window_size if i in self.window_block_indexes else 0,
            )
            for i in range(depth)
        )

    def _rope(self, seq_len: int, device):
        half = self.embed_dim // self.num_heads // 2
        cos, sin = rope_2d_table(half, seq_len, self.pt_hw_seq_len)
        return torch.as_tensor(cos, device=device), torch.as_tensor(sin, device=device)

    def forward(self, x):
        """x: (B, H, W, 3) -> (B, H/16, W/16, embed_dim)."""
        x = self.patch_embed(x)
        b, h, w, c = x.shape
        x = x + resize_abs_pos(self.pos_embed, self.pretrain_use_cls_token, (h, w)).to(x.dtype)
        rope_w = self._rope(self.window_size, x.device)
        rope_g = self._rope(h, x.device)
        for i, blk in enumerate(self.blocks):
            x = blk(x, *(rope_w if i in self.window_block_indexes else rope_g))
        return x


class ConvLN(nn.Conv2d):
    """detectron2 Conv2d(norm=LN): bias-free conv + LayerNorm over channels (NCHW)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int):
        super().__init__(in_channels, out_channels, kernel, padding=kernel // 2, bias=False)
        self.norm = LayerNorm(out_channels, eps=1e-6)

    def forward(self, x):
        x = F.conv2d(x, self.weight.to(x.dtype), None, self.stride, self.padding)
        return self.norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class _ConvTranspose2d(nn.ConvTranspose2d):
    def forward(self, x):
        return F.conv_transpose2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.stride)


class _ChannelLN(LayerNorm):
    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


class SimpleFeaturePyramid(nn.Module):
    """ViTDet SimpleFeaturePyramid: scale the stride-16 map to p{stage} maps,
    plus the LastLevelMaxPool p6. Returns {"p3": (B, H, W, C), ...} channels-last.

    ``simfp_{stage}`` Sequential indices follow the reference: scale 4.0 is
    (deconv, LN, GELU, deconv, conv1x1, conv3x3), 2.0 is (deconv, conv1x1,
    conv3x3), 1.0 is (conv1x1, conv3x3), 0.5 is (maxpool, conv1x1, conv3x3).
    """

    def __init__(self, net: EVAViT, out_channels: int = 256,
                 scale_factors: Sequence[float] = (4.0, 2.0, 1.0, 0.5)):
        super().__init__()
        self.net = net
        self.out_channels = out_channels
        self.scale_factors = tuple(scale_factors)
        dim = net.embed_dim
        self.stages = []
        for scale in self.scale_factors:
            if scale == 4.0:
                layers = [_ConvTranspose2d(dim, dim // 2, 2, stride=2), _ChannelLN(dim // 2, eps=1e-6),
                          nn.GELU(), _ConvTranspose2d(dim // 2, dim // 4, 2, stride=2)]
                width = dim // 4
            elif scale == 2.0:
                layers, width = [_ConvTranspose2d(dim, dim // 2, 2, stride=2)], dim // 2
            elif scale == 1.0:
                layers, width = [], dim
            elif scale == 0.5:
                layers, width = [nn.MaxPool2d(2, 2)], dim
            else:
                raise NotImplementedError(scale)
            layers += [ConvLN(width, out_channels, 1), ConvLN(out_channels, out_channels, 3)]
            stage = int(math.log2(16 / scale))
            self.add_module(f"simfp_{stage}", nn.Sequential(*layers))
            self.stages.append(stage)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        feat = self.net(x).permute(0, 3, 1, 2)
        results = {}
        for stage in self.stages:
            results[f"p{stage}"] = getattr(self, f"simfp_{stage}")(feat).permute(0, 2, 3, 1)
        results["p6"] = results[f"p{self.stages[-1]}"][:, ::2, ::2]
        return results
