"""The EVA-CLIP text transformer (counterpart of
``ape_tpu/modeling/text/clip_text.py``): token and position embeddings,
pre-LN residual blocks with causal attention (mask -1e9, softmax in f32),
exact GELU (or with ``quick_gelu`` OpenAI CLIP's x * sigmoid(1.702 x), its
only architectural difference), ``ln_final``, ``text_projection``; per-token projected states and
the state at the end-of-text token, found as the argmax of the token ids.

The tower is frozen in APE and small beside the vision model's work per
image, so it stays plain matmuls, as JAX leaves it to XLA einsums.

Parameter names are the reference's (eva02_clip/transformer.py):
``token_embedding``, ``positional_embedding``,
``transformer.resblocks.{i}.{ln_1, attn.in_proj_weight, attn.in_proj_bias,
attn.out_proj, ln_2, mlp.c_fc, mlp.c_proj}``, ``ln_final``,
``text_projection``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ape_tpu_torch.layers.common import LayerNorm, Linear

CAUSAL_FILL = -1e9


class _Attention(nn.Module):
    """Parameter holder named like torch's nn.MultiheadAttention (packed in_proj)."""

    def __init__(self, width: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = Linear(width, width)
        nn.init.xavier_uniform_(self.in_proj_weight)


class _Mlp(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = Linear(width, 4 * width)
        self.c_proj = Linear(4 * width, width)


class TextBlock(nn.Module):
    def __init__(self, width: int, heads: int, quick_gelu: bool = False):
        super().__init__()
        self.heads = heads
        self.quick_gelu = quick_gelu
        self.ln_1 = LayerNorm(width, eps=1e-5)
        self.attn = _Attention(width)
        self.ln_2 = LayerNorm(width, eps=1e-5)
        self.mlp = _Mlp(width)

    def forward(self, x: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        hd = c // self.heads
        y = F.linear(self.ln_1(x), self.attn.in_proj_weight.to(x.dtype),
                     self.attn.in_proj_bias.to(x.dtype))
        q, k, v = (t.reshape(b, n, self.heads, hd).transpose(1, 2) for t in y.chunk(3, dim=-1))
        logits = torch.matmul(q * hd**-0.5, k.transpose(-1, -2)) + causal.to(q.dtype)
        attn = torch.softmax(logits.float(), -1).to(v.dtype)
        y = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, c)
        x = x + self.attn.out_proj(y)
        y = self.mlp.c_fc(self.ln_2(x))
        y = y * torch.sigmoid(1.702 * y) if self.quick_gelu else F.gelu(y, approximate="none")
        return x + self.mlp.c_proj(y)


class _Resblocks(nn.Module):
    def __init__(self, width: int, heads: int, layers: int, quick_gelu: bool):
        super().__init__()
        self.resblocks = nn.ModuleList(TextBlock(width, heads, quick_gelu) for _ in range(layers))


class CLIPTextTransformer(nn.Module):
    def __init__(self, vocab_size: int = 49408, context_length: int = 77, width: int = 1024,
                 heads: int = 16, layers: int = 24, output_dim: int = 1024,
                 quick_gelu: bool = False):
        super().__init__()
        self.context_length = context_length
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(0.01 * torch.randn(context_length, width))
        self.transformer = _Resblocks(width, heads, layers, quick_gelu)
        self.ln_final = LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(width**-0.5 * torch.randn(width, output_dim))

    def forward(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (B, ctx) int -> (eot (B, out), per-token states (B, ctx, out))."""
        x = self.token_embedding(tokens) + self.positional_embedding
        n = self.context_length
        causal = torch.full((n, n), CAUSAL_FILL, device=x.device).triu_(1)
        for block in self.transformer.resblocks:
            x = block(x, causal)
        xx = self.ln_final(x) @ self.text_projection.to(x.dtype)
        eot = xx[torch.arange(xx.shape[0], device=xx.device), tokens.argmax(-1)]
        return eot, xx
