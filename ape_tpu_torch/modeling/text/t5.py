"""The T5 encoder stack (``T5EncoderModel``'s ``encoder``, the ``encoder`` of
``T5ForConditionalGeneration``) from a ``config.json``: the bucketed
relative position bias of the first layer (``relative_attention_num_buckets``,
``relative_attention_max_distance``, bidirectional), shared by the others,
with the padding mask added to it; T5's RMS ``LayerNorm`` without a mean or a
bias; no attention scaling; the ``feed_forward_proj`` ``relu`` or
``gated-gelu`` (tanh GELU). The module names are ``transformers``' T5Stack's."""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

_FEED_FORWARD = ("relu", "gated-gelu")


class T5LayerNorm(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def forward(self, x):
        var = x.float().pow(2).mean(-1, keepdim=True)
        return self.weight * (x * torch.rsqrt(var + self.eps)).to(self.weight.dtype)


def relative_position_bucket(relative_position, num_buckets: int, max_distance: int):
    """Bidirectional buckets of key - query offsets (``transformers``'
    ``_relative_position_bucket``)."""
    num_buckets //= 2
    buckets = (relative_position > 0).long() * num_buckets
    n = relative_position.abs()
    max_exact = num_buckets // 2
    large = max_exact + (torch.log(n.float() / max_exact) / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).long()
    large = large.clamp(max=num_buckets - 1)
    return buckets + torch.where(n < max_exact, n, large)


class T5Attention(nn.Module):
    def __init__(self, cfg: dict, has_relative_attention_bias: bool):
        super().__init__()
        d, self.heads, self.d_kv = cfg["d_model"], cfg["num_heads"], cfg["d_kv"]
        inner = self.heads * self.d_kv
        self.q = nn.Linear(d, inner, bias=False)
        self.k = nn.Linear(d, inner, bias=False)
        self.v = nn.Linear(d, inner, bias=False)
        self.o = nn.Linear(inner, d, bias=False)
        self.num_buckets = cfg.get("relative_attention_num_buckets", 32)
        self.max_distance = cfg.get("relative_attention_max_distance", 128)
        if has_relative_attention_bias:
            self.relative_attention_bias = nn.Embedding(self.num_buckets, self.heads)

    def position_bias(self, n: int, device):
        pos = torch.arange(n, device=device)
        buckets = relative_position_bucket(pos[None, :] - pos[:, None], self.num_buckets,
                                           self.max_distance)
        return self.relative_attention_bias(buckets).permute(2, 0, 1)[None]  # (1, H, n, n)

    def forward(self, x, bias):
        b, n, _ = x.shape

        def split(t):
            return t.view(b, n, self.heads, self.d_kv).transpose(1, 2)

        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        logits = q @ k.transpose(-1, -2) + bias
        probs = logits.float().softmax(-1).type_as(logits)
        return self.o((probs @ v).transpose(1, 2).reshape(b, n, -1))


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: dict, has_relative_attention_bias: bool):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_relative_attention_bias)
        self.layer_norm = T5LayerNorm(cfg["d_model"], cfg.get("layer_norm_epsilon", 1e-6))

    def forward(self, x, bias):
        return x + self.SelfAttention(self.layer_norm(x), bias)


class T5DenseActDense(nn.Module):
    """``relu``: wo(relu(wi(x))); ``gated-gelu``: wo(gelu_tanh(wi_0(x)) * wi_1(x))."""

    def __init__(self, cfg: dict):
        super().__init__()
        d, f = cfg["d_model"], cfg["d_ff"]
        self.gated = cfg.get("feed_forward_proj", "relu") == "gated-gelu"
        if self.gated:
            self.wi_0, self.wi_1 = nn.Linear(d, f, bias=False), nn.Linear(d, f, bias=False)
        else:
            self.wi = nn.Linear(d, f, bias=False)
        self.wo = nn.Linear(f, d, bias=False)

    def forward(self, x):
        if self.gated:
            return self.wo(F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x))
        return self.wo(F.relu(self.wi(x)))


class T5LayerFF(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.DenseReluDense = T5DenseActDense(cfg)
        self.layer_norm = T5LayerNorm(cfg["d_model"], cfg.get("layer_norm_epsilon", 1e-6))

    def forward(self, x):
        return x + self.DenseReluDense(self.layer_norm(x))


class T5Block(nn.Module):
    def __init__(self, cfg: dict, first: bool):
        super().__init__()
        self.layer = nn.ModuleList([T5LayerSelfAttention(cfg, first), T5LayerFF(cfg)])

    def forward(self, x, bias):
        return self.layer[1](self.layer[0](x, bias))


class T5Encoder(nn.Module):
    """``forward(input_ids, attention_mask)`` -> ``last_hidden_state``
    (B, L, d_model), after ``final_layer_norm``."""

    def __init__(self, cfg: dict):
        super().__init__()
        if cfg.get("feed_forward_proj", "relu") not in _FEED_FORWARD:
            raise NotImplementedError(f"T5 feed_forward_proj {cfg['feed_forward_proj']!r}: the "
                                      f"port has {_FEED_FORWARD}")
        self.config = dict(cfg)
        self.embed_tokens = nn.Embedding(cfg["vocab_size"], cfg["d_model"])
        self.block = nn.ModuleList(T5Block(cfg, i == 0) for i in range(cfg["num_layers"]))
        self.final_layer_norm = T5LayerNorm(cfg["d_model"], cfg.get("layer_norm_epsilon", 1e-6))

    def forward(self, input_ids, attention_mask):
        x = self.embed_tokens(input_ids)
        mask = attention_mask[:, None, None, :].to(x.dtype)
        bias = (self.block[0].layer[0].SelfAttention.position_bias(x.shape[1], x.device)
                + (1.0 - mask) * torch.finfo(x.dtype).min)
        for block in self.block:
            x = block(x, bias)
        return self.final_layer_norm(x)
