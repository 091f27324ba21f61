"""APE core vision model (counterpart of ``ape_tpu/modeling/ape_deta/model.py``):

  backbone (SimpleFeaturePyramid) -> ChannelMapper neck -> 5-level tokens, sine
  position embeddings and per-level validity masks -> two-stage DETA
  transformer -> per-decoder-layer VisionLanguageAlign class logits, and with
  ``mask_on`` the MaskDINO-style mask head: a pixel decoder from one level of
  the encoder memory plus a lateral backbone map, and mask logits as the
  product of each query's ``mask_embed`` with the pixel features.

The outputs are JAX's: the last layer's heads and, in training mode only,
the earlier layers' as ``aux_outputs`` (with masks only under ``aux_mask``)
and the first stage's as ``enc_outputs``, which the criterion reads.

Feature maps are channels-last (B, H, W, C) between modules, as in JAX.
Parameter names are the reference's (``neck.convs.{i}.conv``,
``class_embed.{i}``, the binary first-stage head as the last ``class_embed``,
``lateral_conv`` / ``output_conv`` with their ``norm``, ``mask_conv``,
``mask_embed`` or ``mask_embed.{i}``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ape_tpu_torch.layers.align import VisionLanguageAlign
from ape_tpu_torch.layers.common import MLP, Linear
from ape_tpu_torch.modeling.ape_deta.transformer import DeformableDetrTransformer
from ape_tpu_torch.ops.posemb import position_embedding_sine

PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)


def _group_norm(x: torch.Tensor, gn: nn.GroupNorm) -> torch.Tensor:
    """GroupNorm of an NCHW map, computing in the map's dtype."""
    return F.group_norm(x, gn.num_groups, gn.weight.to(x.dtype), gn.bias.to(x.dtype), gn.eps)


class Conv2d(nn.Conv2d):
    """detectron2 Conv2d: a conv with an optional GroupNorm ``norm`` after it
    (NCHW), computing in the input's dtype."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int = 1,
                 bias: bool = True, norm: Optional[nn.GroupNorm] = None):
        super().__init__(in_channels, out_channels, kernel, stride=stride, padding=kernel // 2,
                         bias=bias)
        self.norm = norm

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        x = F.conv2d(x, self.weight.to(x.dtype), bias, self.stride, self.padding)
        return x if self.norm is None else _group_norm(x, self.norm)


class _ConvGN(nn.Module):
    """The neck's conv + GroupNorm. A second class only because the
    reference's checkpoint nests both (detrex ChannelMapper:
    ``convs.{i}.conv``, ``convs.{i}.gn``) where the mask head's Conv2d holds
    its weight itself (``lateral_conv.weight``, ``lateral_conv.norm``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int,
                 num_groups: int):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel, stride)
        self.gn = nn.GroupNorm(num_groups, out_channels, eps=1e-5)

    def forward(self, x):
        return _group_norm(self.conv(x), self.gn)


def upsample_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear upsampling of an NCHW map, as ``jax.image.resize(...,
    "bilinear")`` computes it. The two agree (half-pixel centres, edges
    clamped) only when no side shrinks: JAX antialiases a downsample."""
    if size[0] < x.shape[-2] or size[1] < x.shape[-1]:
        raise ValueError(f"upsample_bilinear takes no downsample: {tuple(x.shape[-2:])} -> {size}")
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False, antialias=False)


class ChannelMapper(nn.Module):
    """Per-level 1x1 conv + GroupNorm(32) to a common width; with num_outs
    above the input count, stride-2 3x3 extra convs, the first on the raw last
    input and the rest chained (detrex ChannelMapper). Dict of (B, H, W, C)
    maps in, dict out: the inputs under their names, extras as ``extra{i}``."""

    def __init__(self, in_features: Sequence[str], in_channels: int, out_channels: int = 256,
                 num_outs: int = 5, num_groups: int = 32):
        super().__init__()
        self.in_features = tuple(in_features)
        self.convs = nn.ModuleList(
            _ConvGN(in_channels, out_channels, 1, 1, num_groups) for _ in self.in_features)
        self.extra_convs = nn.ModuleList(
            _ConvGN(in_channels if i == 0 else out_channels, out_channels, 3, 2, num_groups)
            for i in range(num_outs - len(self.in_features)))

    def forward(self, feats: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = {}
        for name, conv in zip(self.in_features, self.convs):
            out[name] = conv(feats[name].permute(0, 3, 1, 2))
        prev = feats[self.in_features[-1]].permute(0, 3, 1, 2)
        for i, conv in enumerate(self.extra_convs):
            prev = out[f"extra{i}"] = conv(prev)
        return {k: v.permute(0, 2, 3, 1) for k, v in out.items()}


def level_valid_masks(image_sizes: torch.Tensor, image_hw: Tuple[int, int],
                      level_shapes: Sequence[Tuple[int, int]]):
    """Nearest-downsampled top-left validity masks: cell (y, x) of an (H_l, W_l)
    level is valid iff y < ceil(h * H_l / H) and x < ceil(w * W_l / W)."""
    hh, ww = image_hw
    masks = []
    for hl, wl in level_shapes:
        vh = torch.ceil(image_sizes[:, 0].float() * hl / hh).long()
        vw = torch.ceil(image_sizes[:, 1].float() * wl / ww).long()
        ys = torch.arange(hl, device=image_sizes.device)[None, :, None]
        xs = torch.arange(wl, device=image_sizes.device)[None, None, :]
        masks.append((ys < vh[:, None, None]) & (xs < vw[:, None, None]))
    return masks


class APEDeta(nn.Module):
    """The vision model. Returns raw heads; no postprocessing."""

    def __init__(
        self,
        backbone: nn.Module,
        neck: ChannelMapper,
        transformer: DeformableDetrTransformer,
        embed_dim: int = 256,
        embed_dim_language: int = 1024,
        in_features: Sequence[str] = ("p2", "p3", "p4", "p5", "p6"),
        mask_on: bool = True,
        mask_in_feature: str = "p2",
        mask_encode_level: int = 0,
        aux_mask: bool = False,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.transformer = transformer
        self.embed_dim = embed_dim
        self.in_features = tuple(in_features)
        self.dtype = dtype
        num_layers = len(transformer.decoder.layers)
        binary = Linear(embed_dim, 1)
        nn.init.constant_(binary.bias, PRIOR_BIAS)
        self.class_embed = nn.ModuleList(
            [VisionLanguageAlign(embed_dim, embed_dim_language) for _ in range(num_layers)]
            + [binary])
        self.mask_on = mask_on
        self.mask_in_feature = mask_in_feature
        self.mask_encode_level = mask_encode_level
        self.aux_mask = aux_mask
        if mask_on:
            self.lateral_conv = Conv2d(backbone.out_channels, embed_dim, 1, bias=False,
                                       norm=nn.GroupNorm(32, embed_dim, eps=1e-5))
            self.output_conv = Conv2d(embed_dim, embed_dim, 3, bias=False,
                                      norm=nn.GroupNorm(32, embed_dim, eps=1e-5))
            self.mask_conv = Conv2d(embed_dim, embed_dim, 1, bias=False)
            if aux_mask:
                self.mask_embed = nn.ModuleList(MLP(embed_dim, embed_dim, embed_dim, 3)
                                                for _ in range(num_layers))
            else:
                self.mask_embed = MLP(embed_dim, embed_dim, embed_dim, 3)

    def pixel_decoder(self, memory: torch.Tensor, level_shapes, backbone_feats) -> torch.Tensor:
        """Mask features (B, C, Hm, Wm): encoder memory level
        ``mask_encode_level`` (upsampled to the lateral map's size if smaller)
        plus the lateral 1x1 conv and GroupNorm of the backbone's
        ``mask_in_feature``, then a 3x3 conv, GroupNorm, ReLU and a 1x1 conv."""
        lvl = self.mask_encode_level
        start = sum(h * w for h, w in level_shapes[:lvl])
        hl, wl = level_shapes[lvl]
        enc = memory[:, start:start + hl * wl].reshape(-1, hl, wl, self.embed_dim)
        enc = enc.permute(0, 3, 1, 2)
        lat = self.lateral_conv(backbone_feats[self.mask_in_feature].permute(0, 3, 1, 2))
        if lat.shape[-2:] != enc.shape[-2:]:
            enc = upsample_bilinear(enc, tuple(lat.shape[-2:]))
        return self.mask_conv(F.relu(self.output_conv(lat + enc)))

    def mask_logits(self, layer: int, state: torch.Tensor, mask_features: torch.Tensor):
        """einsum("bqc,bchw->bqhw") of the layer's mask embedding (B, K, C)
        with the mask features (B, C, Hm, Wm)."""
        embed = self.mask_embed[layer] if self.aux_mask else self.mask_embed
        b, c, hm, wm = mask_features.shape
        return torch.matmul(embed(state), mask_features.reshape(b, c, hm * wm)).reshape(
            b, -1, hm, wm)

    def forward(
        self,
        images: torch.Tensor,  # (B, H, W, 3) normalized, padded square
        image_sizes: torch.Tensor,  # (B, 2) valid (h, w) pixels
        text_features: torch.Tensor,  # (B, T, Cl)
        text_valid: torch.Tensor,  # (B, T) bool
    ) -> Dict[str, torch.Tensor]:
        backbone_feats = self.backbone(images.to(self.dtype))
        feats = self.neck(backbone_feats)
        multi_level_feats = [feats[f] for f in self.in_features]
        level_shapes = [(f.shape[1], f.shape[2]) for f in multi_level_feats]
        masks = level_valid_masks(image_sizes, tuple(images.shape[1:3]), level_shapes)
        pos = [position_embedding_sine(m, num_pos_feats=self.embed_dim // 2).to(self.dtype)
               for m in masks]
        tr = self.transformer(multi_level_feats, masks, pos, enc_class_head=self.class_embed[-1])

        text = text_features.to(self.dtype)
        fill = torch.full((), -1e4, dtype=text.dtype, device=text.device)
        # inference reads the last decoder layer only; the earlier class heads
        # serve the auxiliary losses of training
        layers = len(tr["inter_states"]) if self.training else 1
        logits = [torch.where(text_valid[:, None, :], head(state, text), fill)
                  for head, state in zip(self.class_embed[-1 - layers : -1],
                                         tr["inter_states"][-layers:])]
        coords = tr["output_coords"]
        out = {
            "pred_logits": logits[-1],  # (B, K, T)
            "pred_boxes": coords[-1],  # (B, K, 4) cxcywh in [0, 1]
            "first_stage_indices": tr["first_stage_indices"],  # (B, K)
            "memory": tr["memory"],  # (B, S, C)
        }
        aux = [{"pred_logits": lo, "pred_boxes": bx} for lo, bx in zip(logits[:-1], coords[:-1])]
        if self.mask_on:
            mask_features = self.pixel_decoder(tr["memory"], level_shapes, backbone_feats)
            states = tr["inter_states"]
            out["pred_masks"] = self.mask_logits(len(states) - 1, states[-1], mask_features)
            out["mask_features"] = mask_features.permute(0, 2, 3, 1)  # (B, Hm, Wm, C)
            if self.training and self.aux_mask:
                for i, a in enumerate(aux):
                    a["pred_masks"] = self.mask_logits(i, states[i], mask_features)
        if self.training:
            out.update({
                "aux_outputs": aux,
                "init_reference": tr["init_reference"],  # (B, K, 4)
                "enc_outputs": {
                    "pred_logits": tr["enc_logits"][..., None],  # (B, S, 1)
                    "pred_boxes": tr["enc_coords"],  # (B, S, 4)
                    "anchors": tr["proposals"],  # (B, S, 4)
                    "valid": tr["proposal_valid"],  # (B, S)
                },
                "text_features": text,  # (B, T, Cl)
            })
        return out
