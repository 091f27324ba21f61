"""``BertModel`` without the pooler (``add_pooling_layer=False``), from a
``config.json``: word, position and token-type (all 0) embeddings, then
post-LN layers (``layer_norm_eps``, 1e-12 in the published configs) with
the exact (erf) GELU; the padding mask added to the attention logits as
``transformers`` builds it, ``(1 - mask) * finfo.min``. The module names
are ``transformers``' so a checkpoint's names map by prefix alone
(``hf_files.model_key``)."""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F


def _check(cfg: dict) -> None:
    if cfg.get("hidden_act", "gelu") != "gelu":
        raise NotImplementedError(f"BERT hidden_act {cfg['hidden_act']!r}: the port has 'gelu'")
    if cfg.get("position_embedding_type", "absolute") != "absolute":
        raise NotImplementedError(f"BERT position_embedding_type "
                                  f"{cfg['position_embedding_type']!r}: the port has 'absolute'")


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        h = cfg["hidden_size"]
        self.word_embeddings = nn.Embedding(cfg["vocab_size"], h)
        self.position_embeddings = nn.Embedding(cfg.get("max_position_embeddings", 512), h)
        self.token_type_embeddings = nn.Embedding(cfg.get("type_vocab_size", 2), h)
        self.LayerNorm = nn.LayerNorm(h, eps=cfg.get("layer_norm_eps", 1e-12))

    def forward(self, input_ids):
        pos = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = self.word_embeddings(input_ids) + self.token_type_embeddings(torch.zeros_like(input_ids))
        return self.LayerNorm(x + self.position_embeddings(pos)[None])


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        h = cfg["hidden_size"]
        self.heads = cfg["num_attention_heads"]
        self.query, self.key, self.value = nn.Linear(h, h), nn.Linear(h, h), nn.Linear(h, h)

    def forward(self, x, mask_bias):
        b, n, h = x.shape

        def split(t):
            return t.view(b, n, self.heads, h // self.heads).transpose(1, 2)

        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        logits = q @ k.transpose(-1, -2) / math.sqrt(h // self.heads) + mask_bias
        return (logits.softmax(-1) @ v).transpose(1, 2).reshape(b, n, h)


class _DenseNorm(nn.Module):
    """``BertSelfOutput`` and ``BertOutput``: dense, then LayerNorm of the sum
    with the residual."""

    def __init__(self, d_in: int, cfg: dict):
        super().__init__()
        self.dense = nn.Linear(d_in, cfg["hidden_size"])
        self.LayerNorm = nn.LayerNorm(cfg["hidden_size"], eps=cfg.get("layer_norm_eps", 1e-12))

    def forward(self, x, residual):
        return self.LayerNorm(self.dense(x) + residual)


class BertAttention(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = _DenseNorm(cfg["hidden_size"], cfg)

    def forward(self, x, mask_bias):
        return self.output(self.self(x, mask_bias), x)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.dense = nn.Linear(cfg["hidden_size"], cfg["intermediate_size"])

    def forward(self, x):
        return F.gelu(self.dense(x))


class BertLayer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = _DenseNorm(cfg["intermediate_size"], cfg)

    def forward(self, x, mask_bias):
        x = self.attention(x, mask_bias)
        return self.output(self.intermediate(x), x)


class BertEncoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg) for _ in range(cfg["num_hidden_layers"]))


class BertModel(nn.Module):
    """``forward(input_ids, attention_mask)`` -> ``last_hidden_state``
    (B, L, hidden_size)."""

    def __init__(self, cfg: dict):
        super().__init__()
        _check(cfg)
        self.config = dict(cfg)
        self.embeddings = BertEmbeddings(cfg)
        self.encoder = BertEncoder(cfg)

    def forward(self, input_ids, attention_mask):
        x = self.embeddings(input_ids)
        mask_bias = (1.0 - attention_mask[:, None, None, :].to(x.dtype)) * torch.finfo(x.dtype).min
        for layer in self.encoder.layer:
            x = layer(x, mask_bias)
        return x
