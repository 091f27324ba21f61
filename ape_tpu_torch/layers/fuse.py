"""GLIP-style bi-directional vision-language fusion (counterpart of
``ape_tpu/layers/fuse.py``): one logit matrix shared by both directions, a
softmax per direction, the +-50000 clamps, layer-scale gammas, pre-LN.

Every step runs in the dtype JAX runs it in: the projections, the shared
logits, their clamps and the language side's max subtraction in the
activations' dtype (bf16 on the card, where the clamp at 50000 rounds to
49920), and only the two softmaxes in f32, cast back. The vision side masks
invalid text with -inf; the language side takes no vision mask
(``use_attention_mask_v=False``, as every APE config).

Parameter names are the reference's (fuse_helper.py,
vision_language_fusion.py): ``b_attn.attn.{v,l,values_v,values_l,out_v,
out_l}_proj``, ``b_attn.gamma_v``, ``b_attn.gamma_l``,
``b_attn.layer_norm_v``, ``b_attn.layer_norm_l``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from ape_tpu_torch.layers.common import LayerNorm, Linear

CLAMP = 50000.0


class BiMultiHeadAttention(nn.Module):
    def __init__(self, v_dim: int, l_dim: int, embed_dim: int, num_heads: int):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.v_proj = Linear(v_dim, embed_dim)
        self.l_proj = Linear(l_dim, embed_dim)
        self.values_v_proj = Linear(v_dim, embed_dim)
        self.values_l_proj = Linear(l_dim, embed_dim)
        self.out_v_proj = Linear(embed_dim, v_dim)
        self.out_l_proj = Linear(embed_dim, l_dim)

    def forward(self, v: torch.Tensor, l: torch.Tensor,
                valid_l: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """v: (B, Nv, v_dim), l: (B, Nl, l_dim), valid_l: (B, Nl) True = valid.
        Returns the updates (B, Nv, v_dim) and (B, Nl, l_dim)."""
        b, nv, _ = v.shape
        nl = l.shape[1]
        h = self.num_heads
        hd = self.embed_dim // h

        def heads(x, n):
            return x.reshape(b, n, h, hd).transpose(1, 2)  # (B, H, N, hd)

        q_v = heads(self.v_proj(v) * hd**-0.5, nv)
        k_l = heads(self.l_proj(l), nl)
        val_v = heads(self.values_v_proj(v), nv)
        val_l = heads(self.values_l_proj(l), nl)

        logits = torch.matmul(q_v, k_l.transpose(-1, -2)).clamp_(-CLAMP, CLAMP)  # (B, H, Nv, Nl)

        # language -> attends over the vision tokens
        logits_l = logits.transpose(-1, -2)
        logits_l = (logits_l - logits_l.amax(-1, keepdim=True)).clamp_(-CLAMP, CLAMP)
        attn_l = torch.softmax(logits_l.float(), -1).to(v.dtype)
        del logits_l
        out_l = torch.matmul(attn_l, val_v)
        del attn_l

        # vision -> attends over the language tokens; the mask out of place,
        # since autograd keeps the language side's max input, a view of logits
        if valid_l is not None:
            logits = logits.masked_fill(~valid_l[:, None, None, :], -torch.inf)
        attn_v = torch.softmax(logits.float(), -1).to(v.dtype)
        del logits
        out_v = torch.matmul(attn_v, val_l)
        del attn_v

        out_v = out_v.transpose(1, 2).reshape(b, nv, self.embed_dim)
        out_l = out_l.transpose(1, 2).reshape(b, nl, self.embed_dim)
        return self.out_v_proj(out_v), self.out_l_proj(out_l)


class BiAttentionBlock(nn.Module):
    """Pre-LN bi-attention with layer-scale (fuse_helper.py:178-232)."""

    def __init__(self, v_dim: int, l_dim: int, embed_dim: int, num_heads: int,
                 init_values: float = 1e-4):
        super().__init__()
        self.layer_norm_v = LayerNorm(v_dim, eps=1e-5)
        self.layer_norm_l = LayerNorm(l_dim, eps=1e-5)
        self.attn = BiMultiHeadAttention(v_dim, l_dim, embed_dim, num_heads)
        self.gamma_v = nn.Parameter(torch.full((v_dim,), float(init_values)))
        self.gamma_l = nn.Parameter(torch.full((l_dim,), float(init_values)))

    def forward(self, v, l, valid_l=None):
        vn = self.layer_norm_v(v)
        # text may come in f32 to a bf16 model: normed in its own dtype, then
        # rounded, as flax's LayerNorm(dtype=...) computes it
        ln = self.layer_norm_l(l).to(vn.dtype)
        dv, dl = self.attn(vn, ln, valid_l)
        # the reference's quirk (fuse_helper.py:223-230): the residual adds to
        # the normed input, not to the block's input
        return vn + self.gamma_v.to(dv.dtype) * dv, ln + self.gamma_l.to(dl.dtype) * dl


class VisionLanguageFusion(nn.Module):
    """The encoder's fusion layer: the reference's checkpointing wrapper
    around ``b_attn``, a ``BiAttentionBlock``. Returns (v, l) updated."""

    def __init__(self, v_dim: int, l_dim: int, embed_dim: int, num_heads: int,
                 init_values: float = 1e-4):
        super().__init__()
        self.b_attn = BiAttentionBlock(v_dim, l_dim, embed_dim, num_heads, init_values)

    def forward(self, v, l, valid_l=None):
        return self.b_attn(v, l, valid_l)
