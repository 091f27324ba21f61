"""Region-text alignment head (counterpart of ``ape_tpu/layers/align.py``)."""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from ape_tpu_torch.layers.common import Linear

CLAMP = 50000.0


class VisionLanguageAlign(nn.Module):
    """Open-vocabulary logits = scaled query-token dot products:

    logits[b,q,t] = (x[b,q] . proj(normalize(emb)[b,t] / 2)) / exp(log_scale)
                    + (normalize(emb)[b,t] . bias_lang + bias0)
    """

    def __init__(self, embed_dim: int, embed_dim_language: int):
        super().__init__()
        self.log_scale = nn.Parameter(torch.zeros(1))
        self.bias_lang = nn.Parameter(torch.zeros(embed_dim_language))
        self.bias0 = nn.Parameter(torch.full((1,), -math.log((1 - 0.01) / 0.01)))  # prior 0.01
        self.dot_product_projection_text = Linear(embed_dim_language, embed_dim)

    def forward(self, x: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
        """x: (B, Q, embed_dim); embedding: (B, T, embed_dim_language) -> (B, Q, T)."""
        emb = embedding.to(x.dtype)
        emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True).clamp(min=1e-12)
        tokens = self.dot_product_projection_text(emb / 2.0)
        token_bias = emb @ self.bias_lang.to(emb.dtype) + self.bias0.to(emb.dtype)
        logits = torch.matmul(x, tokens.transpose(-1, -2)) / torch.exp(self.log_scale.to(x.dtype))
        return (logits + token_bias[:, None, :]).clamp(-CLAMP, CLAMP)
