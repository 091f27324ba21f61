"""Region-text alignment heads (counterpart of ``ape_tpu/layers/align.py``):
``VisionLanguageAlign``, the binary ``StillClassifier`` and the Detic-style
``ZeroShotFC`` over a class-embedding bank (for example
``modeling.text.get_clip_embeddings``'s)."""

from __future__ import annotations

import math
from typing import Optional

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


class StillClassifier(nn.Module):
    """Binary objectness head: one logit a query (``body``)."""

    def __init__(self, hidden_dim: int):
        super().__init__()
        self.body = Linear(hidden_dim, 1)

    def forward(self, x: torch.Tensor, lang_feat=None) -> torch.Tensor:
        return self.body(x)


class ZeroShotFC(nn.Module):
    """Zero-shot classifier against a class-embedding bank given at call
    time: project to ``proj_dim`` (``linear``); with ``norm_weight`` scale
    the projection to norm ``norm_temperature`` (or ``temperature``) and
    the bank's rows to norm 1; logits = projection @ bank^T, plus the
    learned ``cls_bias`` (initialised to ``use_bias``) when ``use_bias`` is
    not 0."""

    def __init__(self, input_dim: int, proj_dim: int = 512, temperature: float = 50.0,
                 use_bias: float = 0.0, norm_weight: bool = True,
                 norm_temperature: Optional[float] = None):
        super().__init__()
        self.temperature = temperature
        self.use_bias = use_bias
        self.norm_weight = norm_weight
        self.norm_temperature = norm_temperature
        self.linear = Linear(input_dim, proj_dim)
        if use_bias:
            self.cls_bias = nn.Parameter(torch.full((1,), float(use_bias)))

    def forward(self, x: torch.Tensor, zs_weight: torch.Tensor) -> torch.Tensor:
        """x: (..., input_dim); zs_weight: (num_classes, proj_dim) -> (..., num_classes)."""
        x = self.linear(x)
        zs = zs_weight
        if self.norm_weight:
            t = self.norm_temperature or self.temperature
            x = t * x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-12)
            zs = zs / torch.linalg.vector_norm(zs, dim=-1, keepdim=True).clamp(min=1e-12)
        logits = x @ zs.T.to(x.dtype)
        if self.use_bias:
            logits = logits + self.cls_bias.to(logits.dtype)
        return logits
