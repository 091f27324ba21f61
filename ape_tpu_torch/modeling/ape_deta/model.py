"""APE core vision model without the mask head (counterpart of
``ape_tpu/modeling/ape_deta/model.py``):

  backbone (SimpleFeaturePyramid) -> ChannelMapper neck -> 5-level tokens, sine
  position embeddings and per-level validity masks -> two-stage DETA
  transformer -> per-decoder-layer VisionLanguageAlign class logits.

The outputs are JAX's: the last layer's heads and, in training mode only,
the earlier layers' as ``aux_outputs`` and the first stage's as
``enc_outputs``, which the criterion reads.

Feature maps are channels-last (B, H, W, C) between modules, as in JAX.
Parameter names are the reference's (``neck.convs.{i}.conv``,
``class_embed.{i}``, the binary first-stage head as the last ``class_embed``).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ape_tpu_torch.layers.align import VisionLanguageAlign
from ape_tpu_torch.layers.common import Linear
from ape_tpu_torch.modeling.ape_deta.transformer import DeformableDetrTransformer
from ape_tpu_torch.ops.posemb import position_embedding_sine

PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)


class _ConvGN(nn.Module):
    """Conv2d + GroupNorm on NCHW, computing in the input's dtype."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int,
                 num_groups: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel, stride=stride,
                              padding=kernel // 2)
        self.gn = nn.GroupNorm(num_groups, out_channels, eps=1e-5)

    def forward(self, x):
        c = self.conv
        x = F.conv2d(x, c.weight.to(x.dtype), c.bias.to(x.dtype), c.stride, c.padding)
        return F.group_norm(x, self.gn.num_groups, self.gn.weight.to(x.dtype),
                            self.gn.bias.to(x.dtype), self.gn.eps)


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
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if mask_on:
            raise NotImplementedError("the port's APEDeta has no mask head yet (mask_on=False)")
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

    def forward(
        self,
        images: torch.Tensor,  # (B, H, W, 3) normalized, padded square
        image_sizes: torch.Tensor,  # (B, 2) valid (h, w) pixels
        text_features: torch.Tensor,  # (B, T, Cl)
        text_valid: torch.Tensor,  # (B, T) bool
    ) -> Dict[str, torch.Tensor]:
        feats = self.neck(self.backbone(images.to(self.dtype)))
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
        if self.training:
            out.update({
                "aux_outputs": [{"pred_logits": lo, "pred_boxes": bx}
                                for lo, bx in zip(logits[:-1], coords[:-1])],
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
