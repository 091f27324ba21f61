"""APE core vision model (counterpart of ``ape_tpu/modeling/ape_deta/model.py``):

  backbone (SimpleFeaturePyramid, or the R50 family's ResNet) -> ChannelMapper
  neck -> 5-level tokens, sine position embeddings and per-level validity
  masks -> two-stage DETA transformer (or Deformable-DETR's single-stage one)
  -> per-decoder-layer VisionLanguageAlign class logits (against the text, or
  the closed vocabulary's learned ``class_embedding``), and with
  ``mask_on`` the MaskDINO-style mask head: a pixel decoder from one level of
  the encoder memory plus a lateral backbone map, and mask logits as the
  product of each query's ``mask_embed`` with the pixel features.

A mask prompt (B, H, W) bool over the padded image limits the first
stage's proposals to the cells it covers: each level takes every
(H // H_l)-th row and (W // W_l)-th column of it, as JAX subsamples it.

With a fusing transformer (APE-L_D) the encoder's fusion layers see the
text, a single zero or learned token, or nothing (``fusion_text_mode``), and
the class heads align to the fused or the original text
(``align_on_fused``), as JAX's ``APEDeta`` routes them.

The outputs are JAX's: the last layer's heads, the text the heads aligned
to (``text_features``) and, in training mode only,
the earlier layers' as ``aux_outputs`` (with masks only under ``aux_mask``)
and the first stage's as ``enc_outputs``, which the criterion reads.

Feature maps are channels-last (B, H, W, C) between modules, as in JAX.
Parameter names are the reference's (``neck.convs.{i}.conv``,
``class_embed.{i}``, the binary first-stage head as the last ``class_embed``,
``lateral_conv`` / ``output_conv`` with their ``norm``, ``mask_conv``,
``mask_embed`` or ``mask_embed.{i}``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ape_tpu_torch.layers.align import VisionLanguageAlign
from ape_tpu_torch.layers.common import MLP, Linear
from ape_tpu_torch.modeling.ape_deta.transformer import PRIOR_BIAS, DeformableDetrTransformer
from ape_tpu_torch.ops.posemb import position_embedding_sine
from ape_tpu_torch.utils.rows import WHOLE, Rows


def _group_norm(x: torch.Tensor, gn: nn.GroupNorm) -> torch.Tensor:
    """GroupNorm of an NCHW map in the map's dtype: a bf16 map is normalised
    in f32 with the f32 scale and bias and rounded once, as flax's GroupNorm
    (and layers.common.LayerNorm)."""
    return F.group_norm(x.float(), gn.num_groups, gn.weight.float(), gn.bias.float(),
                        gn.eps).to(x.dtype)


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
    maps in, dict out: the inputs under their names, extras as ``extra{i}``.
    in_channels: one width for every input, or one per input (R50's res3-res5:
    512, 1024, 2048)."""

    def __init__(self, in_features: Sequence[str], in_channels: Sequence[int] | int,
                 out_channels: int = 256, num_outs: int = 5, num_groups: int = 32):
        super().__init__()
        self.in_features = tuple(in_features)
        widths = ([in_channels] * len(self.in_features) if isinstance(in_channels, int)
                  else list(in_channels))
        if len(widths) != len(self.in_features):
            raise ValueError(f"ChannelMapper: {len(widths)} widths for {self.in_features}")
        self.convs = nn.ModuleList(
            _ConvGN(w, out_channels, 1, 1, num_groups) for w in widths)
        self.extra_convs = nn.ModuleList(
            _ConvGN(widths[-1] if i == 0 else out_channels, out_channels, 3, 2, num_groups)
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


def flatten_mask_prompt(mask_prompt: torch.Tensor, level_shapes) -> torch.Tensor:
    """(B, H, W) bool -> (B, S): level (H_l, W_l) reads every (H // H_l)-th
    row and (W // W_l)-th column from the first, as JAX's ``mask_prompt[:,
    ::sy, ::sx]``. A level whose size does not divide the image's gets more
    cells than it has, and JAX fails on the shapes; so does this."""
    b, hh, ww = mask_prompt.shape
    pieces = []
    for hl, wl in level_shapes:
        piece = mask_prompt[:, :: hh // hl, :: ww // wl]
        if tuple(piece.shape[1:]) != (hl, wl):
            raise ValueError(f"mask_prompt {hh}x{ww} subsampled to level {hl}x{wl} gives "
                             f"{tuple(piece.shape[1:])}: the level's size must divide the image's")
        pieces.append(piece.reshape(b, -1))
    return torch.cat(pieces, 1)


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
        name_prompt_fusion_feature: bool = False,
        num_learned_classes: int = 0,
        dtype: torch.dtype = torch.float32,
    ):
        """name_prompt_fusion_feature: hold the learned fusion token (1, 1,
        Cl) that ``fusion_text_mode="learnable"`` fuses; JAX creates it on
        the first call in that mode. num_learned_classes: the closed
        vocabulary's learned class bank ``class_embedding`` (N, Cl), which
        replaces the text passed to the forward, all valid (DETA and
        Deformable-DETR R50: 80)."""
        super().__init__()
        self.backbone = backbone
        self.neck = neck
        self.transformer = transformer
        self.embed_dim = embed_dim
        self.in_features = tuple(in_features)
        self.dtype = dtype
        if name_prompt_fusion_feature:
            self.name_prompt_fusion_feature = nn.Parameter(torch.randn(1, 1, embed_dim_language))
        self.num_learned_classes = num_learned_classes
        if num_learned_classes:
            self.class_embedding = nn.Parameter(
                0.02 * torch.randn(num_learned_classes, embed_dim_language))
        num_layers = len(transformer.decoder.layers)
        heads = [VisionLanguageAlign(embed_dim, embed_dim_language) for _ in range(num_layers)]
        if transformer.as_two_stage:  # the first stage's binary objectness head
            binary = Linear(embed_dim, 1)
            nn.init.constant_(binary.bias, PRIOR_BIAS)
            heads.append(binary)
        self.class_embed = nn.ModuleList(heads)
        self.mask_on = mask_on
        self.mask_in_feature = mask_in_feature
        self.mask_encode_level = mask_encode_level
        self.aux_mask = aux_mask
        if mask_on:
            width = backbone.out_channels  # one int (SFP), or a dict by name (ResNet)
            width = width[mask_in_feature] if isinstance(width, dict) else width
            self.lateral_conv = Conv2d(width, embed_dim, 1, bias=False,
                                       norm=nn.GroupNorm(32, embed_dim, eps=1e-5))
            self.output_conv = Conv2d(embed_dim, embed_dim, 3, bias=False,
                                      norm=nn.GroupNorm(32, embed_dim, eps=1e-5))
            self.mask_conv = Conv2d(embed_dim, embed_dim, 1, bias=False)
            if aux_mask:
                self.mask_embed = nn.ModuleList(MLP(embed_dim, embed_dim, embed_dim, 3)
                                                for _ in range(num_layers))
            else:
                self.mask_embed = MLP(embed_dim, embed_dim, embed_dim, 3)

    def _fusion_text(self, mode: str, text_features, text_valid):
        """(text, valid) that the encoder's fusion layers see under ``mode``."""
        if mode == "text":
            return text_features, text_valid
        if mode == "none":
            return None, None
        b = text_features.shape[0]
        if mode == "learnable":
            tok = self.name_prompt_fusion_feature
        elif mode == "zero":
            tok = text_features.new_zeros(1, 1, text_features.shape[-1])
        else:
            raise ValueError(f"fusion_text_mode {mode!r}: one of text, zero, learnable, none")
        return (tok.expand(b, 1, -1).to(self.dtype),
                torch.ones(b, 1, dtype=torch.bool, device=text_valid.device))

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
        align_on_fused: bool = True,
        fusion_text_mode: str = "text",
        generator: Optional[torch.Generator] = None,
        mask_prompt: Optional[torch.Tensor] = None,
        rows: Rows = WHOLE,
    ) -> Dict[str, torch.Tensor]:
        """fusion_text_mode: what the fusion layers see: ``"text"`` the text
        features, ``"zero"`` one zero token, ``"learnable"`` the learned
        token (built with ``name_prompt_fusion_feature``), ``"none"`` nothing
        (no fusion). align_on_fused: the class heads align to the fused text,
        else to the original; only ``"text"`` has fused text to align to. A
        model without fusion layers gives the same outputs under both.
        generator: the backbone's drop-path draws in ``train()`` mode (JAX's
        ``rngs={"dropout": rng}``), drawn at the global batch of which
        ``images`` are the ``rows`` (``utils.rows``). With a class bank the
        text passed in is not read. mask_prompt: (B, H, W) bool, where the
        first stage may propose."""
        if self.num_learned_classes:
            b = images.shape[0]
            text_features = self.class_embedding[None].expand(b, -1, -1).to(self.dtype)
            text_valid = torch.ones(b, self.num_learned_classes, dtype=torch.bool,
                                    device=images.device)
        backbone_feats = self.backbone(images.to(self.dtype), generator, rows)
        feats = self.neck(backbone_feats)
        multi_level_feats = [feats[f] for f in self.in_features]
        level_shapes = [(f.shape[1], f.shape[2]) for f in multi_level_feats]
        masks = level_valid_masks(image_sizes, tuple(images.shape[1:3]), level_shapes)
        pos = [position_embedding_sine(m, num_pos_feats=self.embed_dim // 2).to(self.dtype)
               for m in masks]
        fusion_text, fusion_valid = self._fusion_text(fusion_text_mode, text_features, text_valid)
        num_layers = len(self.transformer.decoder.layers)
        enc_head = self.class_embed[num_layers] if len(self.class_embed) > num_layers else None
        prompt = None if mask_prompt is None else flatten_mask_prompt(mask_prompt, level_shapes)
        tr = self.transformer(multi_level_feats, masks, pos, enc_class_head=enc_head,
                              text=fusion_text, text_valid=fusion_valid, mask_prompt=prompt)

        fused = align_on_fused and fusion_text_mode == "text"
        text = (tr["text"] if fused else text_features).to(self.dtype)
        fill = torch.full((), -1e4, dtype=text.dtype, device=text.device)
        # inference reads the last decoder layer only; the earlier class heads
        # serve the auxiliary losses of training
        layers = len(tr["inter_states"]) if self.training else 1
        logits = [torch.where(text_valid[:, None, :], head(state, text), fill)
                  for head, state in zip(self.class_embed[num_layers - layers : num_layers],
                                         tr["inter_states"][-layers:])]
        coords = tr["output_coords"]
        out = {
            "pred_logits": logits[-1],  # (B, K, T)
            "pred_boxes": coords[-1],  # (B, K, 4) cxcywh in [0, 1]
            "memory": tr["memory"],  # (B, S, C)
            "text_features": text,  # (B, T, Cl) the text the heads aligned to
        }
        if "first_stage_indices" in tr:  # two-stage: (B, K) the selected proposals
            out["first_stage_indices"] = tr["first_stage_indices"]
        if "first_stage_heads" in tr:  # proposal_ambiguous: (B, S) each proposal's head
            out["first_stage_heads"] = tr["first_stage_heads"]
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
            })
        return out
