"""``LlamaModel`` from a ``config.json``: RMSNorm at ``rms_norm_eps``, RoPE
at ``rope_theta`` on the halves layout (``rotate_half``), SwiGLU, grouped KV
heads where ``num_key_value_heads`` < heads, and a causal mask combined
with the padding mask. Positions are 0..L-1 whatever the padding, as
``transformers`` gives them (``position_ids = cache_position``), so a
left-padded text's features depend on how far it is padded. A masked logit
is ``finfo.min``, so a pad row that sees no key attends evenly rather than
to NaN. The module names are ``transformers``'."""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


def _check(cfg: dict) -> None:
    if cfg.get("hidden_act", "silu") != "silu":
        raise NotImplementedError(f"Llama hidden_act {cfg['hidden_act']!r}: the port has 'silu'")
    if cfg.get("rope_scaling"):
        raise NotImplementedError(f"Llama rope_scaling {cfg['rope_scaling']!r}: the port has "
                                  "plain RoPE")


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def forward(self, x):
        x32 = x.float()
        x32 = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + self.eps)
        return self.weight * x32.to(x.dtype)


def rope(x, positions, theta: float):
    """RoPE on the halves layout: x (B, H, L, D), positions (L,)."""
    d = x.shape[-1]
    inv_freq = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.int64, device=x.device)
                                .float() / d))
    freqs = positions.float()[:, None] * inv_freq[None, :]
    emb = torch.cat((freqs, freqs), -1)
    cos, sin = emb.cos().to(x.dtype), emb.sin().to(x.dtype)
    half = d // 2
    rotated = torch.cat((-x[..., half:], x[..., :half]), -1)
    return x * cos + rotated * sin


class LlamaAttention(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        h = cfg["hidden_size"]
        self.heads = cfg["num_attention_heads"]
        self.kv_heads = cfg.get("num_key_value_heads") or self.heads
        self.head_dim = cfg.get("head_dim") or h // self.heads
        self.theta = float(cfg.get("rope_theta", 10000.0))
        bias = bool(cfg.get("attention_bias", False))
        self.q_proj = nn.Linear(h, self.heads * self.head_dim, bias=bias)
        self.k_proj = nn.Linear(h, self.kv_heads * self.head_dim, bias=bias)
        self.v_proj = nn.Linear(h, self.kv_heads * self.head_dim, bias=bias)
        self.o_proj = nn.Linear(self.heads * self.head_dim, h, bias=bias)

    def forward(self, x, allowed, positions):
        b, n, _ = x.shape
        q = self.q_proj(x).view(b, n, self.heads, self.head_dim).transpose(1, 2)
        k = self.k_proj(x).view(b, n, self.kv_heads, self.head_dim).transpose(1, 2)
        v = self.v_proj(x).view(b, n, self.kv_heads, self.head_dim).transpose(1, 2)
        q, k = rope(q, positions, self.theta), rope(k, positions, self.theta)
        rep = self.heads // self.kv_heads
        k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
        logits = (q @ k.transpose(-1, -2)) * self.head_dim ** -0.5
        logits = logits.masked_fill(~allowed, torch.finfo(logits.dtype).min)
        probs = logits.float().softmax(-1).to(q.dtype)
        return self.o_proj((probs @ v).transpose(1, 2).reshape(b, n, -1))


class LlamaMLP(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        h, f = cfg["hidden_size"], cfg["intermediate_size"]
        bias = bool(cfg.get("mlp_bias", False))
        self.gate_proj = nn.Linear(h, f, bias=bias)
        self.up_proj = nn.Linear(h, f, bias=bias)
        self.down_proj = nn.Linear(f, h, bias=bias)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        eps = cfg.get("rms_norm_eps", 1e-6)
        self.self_attn = LlamaAttention(cfg)
        self.mlp = LlamaMLP(cfg)
        self.input_layernorm = RMSNorm(cfg["hidden_size"], eps)
        self.post_attention_layernorm = RMSNorm(cfg["hidden_size"], eps)

    def forward(self, x, allowed, positions):
        x = x + self.self_attn(self.input_layernorm(x), allowed, positions)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    """``forward(input_ids, attention_mask)`` -> the hidden state after the
    final norm (``last_hidden_state``, which is ``hidden_states[-1]``),
    (B, L, hidden_size)."""

    def __init__(self, cfg: dict):
        super().__init__()
        _check(cfg)
        self.config = dict(cfg)
        self.embed_tokens = nn.Embedding(cfg["vocab_size"], cfg["hidden_size"])
        self.layers = nn.ModuleList(LlamaDecoderLayer(cfg) for _ in range(cfg["num_hidden_layers"]))
        self.norm = RMSNorm(cfg["hidden_size"], cfg.get("rms_norm_eps", 1e-6))

    def forward(self, input_ids, attention_mask):
        n = input_ids.shape[1]
        positions = torch.arange(n, device=input_ids.device)
        causal = positions[None, :] <= positions[:, None]
        allowed = causal[None, None] & attention_mask[:, None, None, :].bool()
        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            x = layer(x, allowed, positions)
        return self.norm(x)
