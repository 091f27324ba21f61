"""EVA ViT backbone + SimpleFeaturePyramid (counterpart of
``ape_tpu/modeling/backbone/eva_vit.py``): q/v-only bias, windowed and global
blocks, and one module for every tree of ``configs/``. APE-Ti's EVA-02 packs
qkv and SwiGLU's w12 under 2-D RoPE; APE-L_D's EVA-02-CLIP (``subln``,
``inner_attn_ln``, ``swiglu_subln``) projects q, k and v apart, normalizes
the attention output before ``proj``, and normalizes SwiGLU's hidden layer
(``ffn_ln``) before ``w3``. ViTDet and EVA-01 (``rope=False``,
``mlp_type="gelu"``, ``use_rel_pos``) add decomposed relative positions to
the attention logits and run a GELU MLP (``fc1``, ``fc2``); ViT-E
(``postnorm``) normalizes each sublayer's output inside its residual branch
in place of its input.

Tokens stay channels-last (B, H, W, C) as in the JAX package; the pyramid's
convolutions run channels-first inside. A global block (window_size 0)
takes ``ops.attention.global_attention`` (the CUDA flash kernel, K5, on the
card) under JAX's own condition for its library kernel (eva_vit.py:114-120):
head width 32, 64 or 128 and no relative positions. Every other block,
windowed or global (rel-pos, EVA-01-CLIP-g's head width 88, ViT-E's 112),
runs the plain product here: the scaled logits in the compute dtype, the
relative-position terms added in it, softmax in f32, the second product;
JAX runs those blocks as XLA einsums, outside any Pallas kernel.

Relative-position tables are sized at construction, (2 h - 1, head_dim) and
(2 w - 1, head_dim) for the block's input (h, w): the window for a windowed
block, the token grid of ``img_size`` for a global one, as JAX creates them
at its init input. A forward at another grid raises in ``get_rel_pos``.

Stochastic depth (``DropPath``) drops both residual branches of a block per
sample in ``train()`` mode, at rates rising linearly with depth, as JAX's
``deterministic=False``; in ``eval()`` it is the identity. ``EVAViT`` draws
every block's keep masks at once from the caller's ``torch.Generator``
(``draw_keep``) and copies them to the device in one transfer, so a run on
the card and one on the CPU given generators of one seed drop the same
branches. A dropped branch is still computed, as in JAX.

Parameter names are the reference's (vit_eva02.py, vit_eva_clip.py, vit_eva.py):
``net.blocks.{i}.attn.qkv`` or ``.attn.{q,k,v}_proj``, ``.attn.inner_attn_ln``,
``.attn.rel_pos_{h,w}``, ``.mlp.w12`` or ``.mlp.{w1,w2}``, ``.mlp.ffn_ln``,
``.mlp.fc{1,2}``, ``net.patch_embed.proj``, ``simfp_{stage}.{index}``, ...
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from ape_tpu_torch.layers.common import LayerNorm, Linear
from ape_tpu_torch.modeling.backbone.vit_utils import (
    add_decomposed_rel_pos,
    apply_rope,
    resize_abs_pos,
    rope_2d_table,
    window_partition,
    window_unpartition,
)
from ape_tpu_torch.ops.attention import HEAD_DIMS, global_attention
from ape_tpu_torch.ops.tables import device_table
from ape_tpu_torch.utils.rows import WHOLE, Rows


class Attention(nn.Module):
    """EVA attention: q, k and v projected without bias (packed as ``qkv``, or
    apart under ``subln``), q/v-only bias, 2-D RoPE on q and k where the
    caller passes its tables, under ``use_rel_pos`` the decomposed
    relative positions of a block whose input is ``input_size`` (h, w), and
    under ``inner_attn_ln`` a LayerNorm (eps 1e-6) on the output before
    ``proj``. ``flash``: the block runs K5 (``global_attention``), fixed here
    by JAX's rule; otherwise the plain product."""

    def __init__(self, dim: int, num_heads: int, global_attn: bool, subln: bool = False,
                 inner_attn_ln: bool = False, use_rel_pos: bool = False,
                 input_size: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.subln = subln
        self.use_rel_pos = use_rel_pos
        head_dim = dim // num_heads
        self.flash = global_attn and head_dim in HEAD_DIMS and not use_rel_pos
        if subln:
            self.q_proj = Linear(dim, dim, bias=False)
            self.k_proj = Linear(dim, dim, bias=False)
            self.v_proj = Linear(dim, dim, bias=False)
        else:
            self.qkv = Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        if use_rel_pos:
            h, w = input_size
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * h - 1, head_dim))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * w - 1, head_dim))
        self.inner_attn_ln = LayerNorm(dim, eps=1e-6) if inner_attn_ln else None
        self.proj = Linear(dim, dim)

    def forward(self, x, rope_cos, rope_sin):
        b, h, w, c = x.shape
        n = h * w
        head_dim = self.dim // self.num_heads
        scale = head_dim**-0.5
        x = x.reshape(b, n, c)
        if self.subln:
            q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        else:
            q, k, v = self.qkv(x).chunk(3, dim=-1)
        q = q + self.q_bias.to(q.dtype)
        v = v + self.v_bias.to(v.dtype)
        q, k, v = (t.reshape(b, n, self.num_heads, head_dim).transpose(1, 2) for t in (q, k, v))
        if rope_cos is not None:
            q = apply_rope(q, rope_cos.to(q.dtype), rope_sin.to(q.dtype))
            k = apply_rope(k, rope_cos.to(k.dtype), rope_sin.to(k.dtype))
        if self.flash:
            out = global_attention(q.contiguous(), k.contiguous(), v.contiguous(), scale)
        else:
            attn = torch.matmul(q * scale, k.transpose(-1, -2))
            if self.use_rel_pos:  # on the unscaled q, after any RoPE
                attn = add_decomposed_rel_pos(
                    attn.reshape(b * self.num_heads, n, n), q.reshape(b * self.num_heads, n, -1),
                    self.rel_pos_h, self.rel_pos_w, (h, w), (h, w)).reshape(b, self.num_heads, n, n)
            attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
            out = torch.matmul(attn, v)
        out = out.transpose(1, 2).reshape(b, n, self.dim)
        if self.inner_attn_ln is not None:
            out = self.inner_attn_ln(out)
        return self.proj(out).reshape(b, h, w, self.dim)


class SwiGLU(nn.Module):
    """SwiGLU: EVA-02's packed ``w12`` (xops_SwiGLU), or EVA-CLIP's ``w1`` and
    ``w2`` apart, with ``subln`` a LayerNorm ``ffn_ln`` (eps 1e-6) on the
    hidden layer; then ``w3``."""

    def __init__(self, dim: int, hidden_dim: int, packed: bool = True, subln: bool = False):
        super().__init__()
        self.packed = packed
        if packed:
            self.w12 = Linear(dim, 2 * hidden_dim)
        else:
            self.w1 = Linear(dim, hidden_dim)
            self.w2 = Linear(dim, hidden_dim)
        self.ffn_ln = LayerNorm(hidden_dim, eps=1e-6) if subln else None
        self.w3 = Linear(hidden_dim, dim)

    def forward(self, x):
        if self.packed:
            x1, x2 = self.w12(x).chunk(2, dim=-1)
        else:
            x1, x2 = self.w1(x), self.w2(x)
        hidden = F.silu(x1) * x2
        if self.ffn_ln is not None:
            hidden = self.ffn_ln(hidden)
        return self.w3(hidden)


class Mlp(nn.Module):
    """EVA-01's plain MLP (timm's): ``fc1``, exact GELU, ``fc2``."""

    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden_dim)
        self.fc2 = Linear(hidden_dim, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class DropPath(nn.Module):
    """Stochastic depth per sample (JAX's ``DropPath``, timm's semantics): in
    ``train()`` mode at a rate above 0, each sample's branch ``x`` is scaled
    by 1 / keep or zeroed, by the sample's entry of ``keep_mask`` (B,) bool,
    which the caller draws (``draw_keep``); otherwise the identity."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, keep_mask: Optional[torch.Tensor]) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if keep_mask is None:
            raise ValueError(f"drop path at rate {self.rate} in train() needs its keep mask "
                             "(draw_keep)")
        keep = 1.0 - self.rate
        mask = keep_mask.view(-1, *(1,) * (x.dim() - 1))
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def draw_keep(rates: Sequence[float], batch: int, device,
              generator: Optional[torch.Generator] = None, rows: Rows = WHOLE) -> torch.Tensor:
    """Keep masks (len(rates), 2, batch) bool on ``device``: entry [i, j, b]
    keeps branch j of block i for sample b with probability 1 - rates[i]
    (JAX's ``bernoulli``: a uniform below the keep rate). All are drawn on
    the generator's device (the CPU's default one without a generator), then
    copied in one transfer; drawn at the global batch and cut to ``rows``."""
    gen_device = generator.device if generator is not None else "cpu"
    u = rows.rand((len(rates), 2, batch), 2, generator, gen_device)
    keep = torch.tensor([1.0 - r for r in rates], device=gen_device)
    return (u < keep[:, None, None]).to(device)


class Block(nn.Module):
    """A pre-norm block, x + attn(norm1(x)), then x + mlp(norm2(x)); under
    ``postnorm`` (ViT-E) x + norm1(attn(x)), then x + norm2(mlp(x)), each
    norm inside its residual branch. ``mlp_type``: "swiglu" or "gelu".
    ``input_size``: the token grid, which sizes a global block's
    relative-position tables."""

    def __init__(self, dim: int, num_heads: int, mlp_hidden_dim: int, window_size: int = 0,
                 subln: bool = False, inner_attn_ln: bool = False, packed_swiglu: bool = True,
                 swiglu_subln: bool = False, drop_path: float = 0.0, mlp_type: str = "swiglu",
                 use_rel_pos: bool = False, postnorm: bool = False,
                 input_size: Optional[Tuple[int, int]] = None):
        super().__init__()
        if mlp_type not in ("swiglu", "gelu"):
            raise ValueError(f"mlp_type is 'swiglu' or 'gelu', got {mlp_type!r}")
        self.window_size = window_size
        self.postnorm = postnorm
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, window_size == 0, subln, inner_attn_ln, use_rel_pos,
                              (window_size, window_size) if window_size > 0 else input_size)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = (Mlp(dim, mlp_hidden_dim) if mlp_type == "gelu"
                    else SwiGLU(dim, mlp_hidden_dim, packed_swiglu, swiglu_subln))
        self.drop_path = DropPath(drop_path)  # of both branches, as JAX's two

    def forward(self, x, rope_cos, rope_sin, keep_mask: Optional[torch.Tensor] = None):
        """keep_mask: (2, B) bool, this block's keep masks of the attention
        and the MLP branch; read in ``train()`` mode at a rate above 0."""
        y = x if self.postnorm else self.norm1(x)
        if self.window_size > 0:
            h, w = y.shape[1], y.shape[2]
            y, pad_hw = window_partition(y, self.window_size)
        y = self.attn(y, rope_cos, rope_sin)
        if self.window_size > 0:
            y = window_unpartition(y, self.window_size, pad_hw, (h, w))
        if self.postnorm:
            y = self.norm1(y)
        keep1, keep2 = (None, None) if keep_mask is None else keep_mask
        x = x + self.drop_path(y, keep1)
        y = self.mlp(x if self.postnorm else self.norm2(x))
        if self.postnorm:
            y = self.norm2(y)
        return x + self.drop_path(y, keep2)


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


@device_table
def _rope_on(half: int, seq_len: int, pt_seq_len: int, device):
    """The RoPE (cos, sin) tables on ``device`` (cached: read-only)."""
    cos, sin = rope_2d_table(half, seq_len, pt_seq_len)
    return torch.as_tensor(cos, device=device), torch.as_tensor(sin, device=device)


class EVAViT(nn.Module):
    """Plain ViT with windowed and global blocks producing one stride-16 map.
    ``img_size`` (an int, or (H, W)) sizes the global blocks'
    relative-position tables under ``use_rel_pos``; ``rope=False`` applies
    no RoPE table (EVA-01, ViTDet, ViT-E)."""

    def __init__(
        self,
        img_size: Union[int, Tuple[int, int]] = 1024,
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
        rope: bool = True,
        packed_swiglu: bool = True,
        subln: bool = False,
        inner_attn_ln: bool = False,
        swiglu_subln: bool = False,
        drop_path_rate: float = 0.0,
        use_rel_pos: bool = False,
        postnorm: bool = False,
        mlp_type: str = "swiglu",
    ):
        super().__init__()
        img_h, img_w = (img_size, img_size) if isinstance(img_size, int) else img_size
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.window_size = window_size
        self.pt_hw_seq_len = pt_hw_seq_len
        self.rope = rope
        self.pretrain_use_cls_token = pretrain_use_cls_token
        self.window_block_indexes = tuple(window_block_indexes)
        self.drop_path_rates = [drop_path_rate * i / max(depth - 1, 1) for i in range(depth)]
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
                subln=subln,
                inner_attn_ln=inner_attn_ln,
                packed_swiglu=packed_swiglu,
                swiglu_subln=swiglu_subln,
                drop_path=self.drop_path_rates[i],
                mlp_type=mlp_type,
                use_rel_pos=use_rel_pos,
                postnorm=postnorm,
                input_size=(img_h // patch_size, img_w // patch_size),
            )
            for i in range(depth)
        )

    def _rope(self, seq_len: int, device):
        if not self.rope:
            return None, None
        return _rope_on(self.embed_dim // self.num_heads // 2, seq_len, self.pt_hw_seq_len, device)

    def forward(self, x, generator: Optional[torch.Generator] = None, rows: Rows = WHOLE):
        """x: (B, H, W, 3) -> (B, H/16, W/16, embed_dim). In ``train()`` mode
        with drop path the keep masks come from ``generator`` (``draw_keep``
        at ``rows``)."""
        x = self.patch_embed(x)
        b, h, w, c = x.shape
        x = x + resize_abs_pos(self.pos_embed, self.pretrain_use_cls_token, (h, w)).to(x.dtype)
        rope_w = self._rope(self.window_size, x.device)
        rope_g = self._rope(h, x.device)
        keep = None
        if self.training and any(self.drop_path_rates):
            keep = draw_keep(self.drop_path_rates, b, x.device, generator, rows)
        for i, blk in enumerate(self.blocks):
            x = blk(x, *(rope_w if i in self.window_block_indexes else rope_g),
                    None if keep is None else keep[i])
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
    plus the LastLevelMaxPool p6 (unless ``top_block`` is False). Returns {"p3": (B, H, W, C), ...} channels-last.

    ``simfp_{stage}`` Sequential indices follow the reference: scale 4.0 is
    (deconv, LN, GELU, deconv, conv1x1, conv3x3), 2.0 is (deconv, conv1x1,
    conv3x3), 1.0 is (conv1x1, conv3x3), 0.5 is (maxpool, conv1x1, conv3x3).
    """

    def __init__(self, net: EVAViT, out_channels: int = 256,
                 scale_factors: Sequence[float] = (4.0, 2.0, 1.0, 0.5), top_block: bool = True):
        super().__init__()
        self.net = net
        self.top_block = top_block
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

    def forward(self, x, generator: Optional[torch.Generator] = None,
                rows: Rows = WHOLE) -> Dict[str, torch.Tensor]:
        feat = self.net(x, generator, rows).permute(0, 3, 1, 2)
        results = {}
        for stage in self.stages:
            results[f"p{stage}"] = getattr(self, f"simfp_{stage}")(feat).permute(0, 2, 3, 1)
        if self.top_block:
            results["p6"] = results[f"p{self.stages[-1]}"][:, ::2, ::2]
        return results
