"""Transformer building blocks (counterpart of ``ape_tpu/layers/common.py``):
MultiheadAttention, FFN and MLP, plus the dtype-following Linear and LayerNorm
every port module builds on.

Dtype policy, as in the JAX package: parameters are f32, compute runs in the
dtype of the activations (the model dtype); ``Linear`` and ``LayerNorm`` cast
their parameters to the input's dtype. Softmax runs in f32.

Parameter names are the reference's detectron2/detrex names, so that
``ape_tpu.checkpoint.convert.convert_torch_state_dict`` maps a port state dict
onto the JAX tree.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

NEG_INF = -1e9


class Linear(nn.Linear):
    """nn.Linear computing in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm over the last dim, computing in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x, self.normalized_shape, self.weight.to(x.dtype), self.bias.to(x.dtype), self.eps
        )


class _PackedInProj(nn.Module):
    """Parameter holder named like torch's nn.MultiheadAttention (packed in_proj)."""

    def __init__(self, embed_dim: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = Linear(embed_dim, embed_dim)
        nn.init.xavier_uniform_(self.in_proj_weight)


class MultiheadAttention(nn.Module):
    """Standard MHA with the residual added inside (detrex MultiheadAttention)."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.attn = _PackedInProj(embed_dim)

    def forward(
        self,
        query: torch.Tensor,  # (B, Q, C)
        key: Optional[torch.Tensor] = None,
        value: Optional[torch.Tensor] = None,
        identity: Optional[torch.Tensor] = None,
        query_pos: Optional[torch.Tensor] = None,
        key_pos: Optional[torch.Tensor] = None,
        key_padding_mask: Optional[torch.Tensor] = None,  # (B, K) True = PAD
    ) -> torch.Tensor:
        if key is None:
            key = query
        if value is None:
            value = key
        if identity is None:
            identity = query
        if query_pos is not None:
            query = query + query_pos
        if key_pos is not None:
            key = key + key_pos
        b, q, c = query.shape
        k = key.shape[1]
        h = self.num_heads
        hd = c // h
        w = self.attn.in_proj_weight.to(query.dtype)
        bias = self.attn.in_proj_bias.to(query.dtype)
        qp = F.linear(query, w[:c], bias[:c]).reshape(b, q, h, hd).transpose(1, 2)
        kp = F.linear(key, w[c : 2 * c], bias[c : 2 * c]).reshape(b, k, h, hd).transpose(1, 2)
        vp = F.linear(value, w[2 * c :], bias[2 * c :]).reshape(b, k, h, hd).transpose(1, 2)
        logits = torch.matmul(qp * hd**-0.5, kp.transpose(-1, -2))
        if key_padding_mask is not None:
            logits = logits.masked_fill(key_padding_mask[:, None, None, :], NEG_INF)
        attn = torch.softmax(logits.float(), dim=-1).to(vp.dtype)
        out = torch.matmul(attn, vp).transpose(1, 2).reshape(b, q, c)
        return identity + self.attn.out_proj(out)


class FFN(nn.Module):
    """Two-layer feedforward with the residual added inside (detrex FFN)."""

    def __init__(self, embed_dim: int, feedforward_dim: int):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(Linear(embed_dim, feedforward_dim), nn.ReLU()),
            Linear(feedforward_dim, embed_dim),
        )

    def forward(self, x: torch.Tensor, identity: Optional[torch.Tensor] = None) -> torch.Tensor:
        return (x if identity is None else identity) + self.layers(x)


class MLP(nn.Module):
    """DETR head MLP: n Linear layers with ReLU between."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, num_layers: int):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1)
        self.layers = nn.ModuleList(
            Linear(i, o) for i, o in zip(dims, [hidden_dim] * (num_layers - 1) + [output_dim])
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x
