"""Model factories (counterpart of ``ape_tpu/modeling/build.py``):

* APE-Ti: EVA-02-Ti backbone (192-d, 12 blocks, 3 heads, window 14, packed
  SwiGLU), the 6+6-layer deformable transformer with 900 queries, no
  vision-language fusion;
* APE-L_D: EVA-02-CLIP-L backbone (1024-d, 24 blocks, 16 heads, window 32,
  subln, inner attention LN, SwiGLU with ``ffn_ln``, position table
  pretrained at 336), the same transformer with a vision-language fusion
  layer before each encoder layer (embed 2048, 8 heads, layer scale 1/6).

Both carry by default the mask head on the finest pyramid level.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from ape_tpu_torch.device import default_device
from ape_tpu_torch.modeling.ape_deta.model import APEDeta, ChannelMapper
from ape_tpu_torch.modeling.ape_deta.transformer import (
    DeformableDetrTransformer,
    DeformableTransformerDecoder,
    DeformableTransformerEncoder,
)
from ape_tpu_torch.modeling.backbone.eva_vit import EVAViT, SimpleFeaturePyramid


def window_indexes(depth: int):
    """2/3 of the blocks windowed, every third global."""
    return tuple(i for i in range(depth) if (i + 1) % 3 != 0)


def pyramid_features(scale_factors: Sequence[float]):
    """(SFP output names, the 5 neck levels): SFP emits p{log2(16/scale)} per
    scale plus the top-block p6; the neck extends to 5 levels with extra convs."""
    sfp = sorted({f"p{int(math.log2(16 / s))}" for s in scale_factors} | {"p6"},
                 key=lambda n: int(n[1:]))
    return tuple(sfp), tuple(sfp + [f"extra{i}" for i in range(5 - len(sfp))])


def build_backbone_l(scale_factors: Sequence[float] = (4.0, 2.0, 1.0, 0.5),
                     drop_path_rate: float = 0.0, depth: int = 24) -> SimpleFeaturePyramid:
    """EVA-02-CLIP-L and its pyramid (``vitl_eva02_clip.py``); every third
    block global. ``depth`` below 24 cuts the backbone for tests and checks."""
    return SimpleFeaturePyramid(
        EVAViT(patch_size=16, embed_dim=1024, depth=depth, num_heads=16, mlp_ratio=4 * 2 / 3,
               window_size=32, window_block_indexes=window_indexes(depth),
               pretrain_img_size=336, pt_hw_seq_len=16, packed_swiglu=False, subln=True,
               inner_attn_ln=True, swiglu_subln=True, drop_path_rate=drop_path_rate),
        out_channels=256, scale_factors=scale_factors)


def build_transformer(num_queries: int = 900, num_layers: int = 6, vl_fusion: bool = False,
                      embed_dim_language: int = 1024, window_radius: int = 4,
                      use_act_checkpoint: bool = False) -> DeformableDetrTransformer:
    """The two-stage transformer of every APE build: 256-d, 8 heads, FFN 2048,
    5 levels; with ``vl_fusion`` its encoder's fusion layers are APE-L_D's
    (embed 2048, 8 heads, layer scale 1/6)."""
    return DeformableDetrTransformer(
        DeformableTransformerEncoder(embed_dim=256, num_heads=8, feedforward_dim=2048,
                                     num_layers=num_layers, num_feature_levels=5,
                                     window_radius=window_radius,
                                     use_act_checkpoint=use_act_checkpoint,
                                     vl_fusion=vl_fusion, vl_embed_dim=2048, vl_num_heads=8,
                                     vl_init_values=1.0 / 6,
                                     embed_dim_language=embed_dim_language),
        DeformableTransformerDecoder(embed_dim=256, num_heads=8, feedforward_dim=2048,
                                     num_layers=num_layers, num_feature_levels=5,
                                     use_act_checkpoint=use_act_checkpoint),
        embed_dim=256, num_feature_levels=5, two_stage_num_proposals=num_queries)


def build_ape_ti(
    num_queries: int = 900,
    embed_dim_language: int = 1024,
    mask_on: bool = True,
    window_radius: int = 4,
    scale_factors: Sequence[float] = (4.0, 2.0, 1.0, 0.5),
    dtype: torch.dtype = torch.float32,
    use_act_checkpoint: bool = False,
    mask_encode_level: int = 0,
    aux_mask: bool = False,
    device=None,
) -> APEDeta:
    """APE-Ti for any square input size (shapes follow the input). The
    defaults are JAX's: the masked model on the 4-scale pyramid (levels p2 …
    p6), whose mask head reads the finest backbone map and encoder level. The
    reference latency protocol passes ``mask_on=False`` and
    ``scale_factors=(2.0, 1.0, 0.5)``: the neck then extends the pyramid to 5
    levels with one stride-2 extra conv. use_act_checkpoint recomputes every
    encoder and decoder layer in the backward (training at 1024^2).

    The model lies on ``device``: by default the CUDA card, and with no card
    it raises rather than fall back to the CPU; pass ``device="cpu"`` to
    build it there."""
    device = default_device("build_ape_ti", device)
    sfp_names, levels = pyramid_features(scale_factors)
    backbone = SimpleFeaturePyramid(
        EVAViT(patch_size=16, embed_dim=192, depth=12, num_heads=3,
               mlp_ratio=4 * 2 / 3, window_size=14, window_block_indexes=window_indexes(12),
               pretrain_img_size=224, pt_hw_seq_len=16),
        out_channels=256, scale_factors=scale_factors)
    transformer = build_transformer(num_queries, 6, False, embed_dim_language, window_radius,
                                    use_act_checkpoint)
    return APEDeta(
        backbone, ChannelMapper(sfp_names, 256, 256, num_outs=5), transformer,
        embed_dim=256, embed_dim_language=embed_dim_language, in_features=levels,
        mask_on=mask_on, mask_in_feature=levels[0], mask_encode_level=mask_encode_level,
        aux_mask=aux_mask, dtype=dtype).to(device)


def build_ape_l_d(
    num_queries: int = 900,
    embed_dim_language: int = 1024,
    mask_on: bool = True,
    window_radius: int = 4,
    use_act_checkpoint: bool = True,
    drop_path_rate: float = 0.4,
    scale_factors: Sequence[float] = (4.0, 2.0, 1.0, 0.5),
    dtype: torch.dtype = torch.float32,
    name_prompt_fusion_feature: bool = False,
    depth: int = 24,
    num_layers: int = 6,
    device=None,
) -> APEDeta:
    """APE-L_D, the flagship: the EVA-02-CLIP-L backbone and the transformer
    whose encoder fuses vision and language, with JAX's defaults (the masked
    model on the 4-scale pyramid, recompute, drop path 0.4 by depth). The
    reference latency protocol passes ``mask_on=False`` and
    ``scale_factors=(2.0, 1.0, 0.5)``. Drop path is the identity in
    ``eval()`` mode; in ``train()`` mode it drops branches by the masks
    the forward's ``generator`` draws. Training passes
    ``build_optimizer(model, vit_num_layers=24)`` to ``make_train_step``.
    name_prompt_fusion_feature: hold the learned token of
    ``fusion_text_mode="learnable"``. depth and num_layers (backbone blocks,
    encoder and decoder layers) cut the model for tests and checks.

    The model lies on ``device``, by the rule of ``build_ape_ti``."""
    device = default_device("build_ape_l_d", device)
    sfp_names, levels = pyramid_features(scale_factors)
    transformer = build_transformer(num_queries, num_layers, True, embed_dim_language,
                                    window_radius, use_act_checkpoint)
    return APEDeta(
        build_backbone_l(scale_factors, drop_path_rate, depth),
        ChannelMapper(sfp_names, 256, 256, num_outs=5), transformer,
        embed_dim=256, embed_dim_language=embed_dim_language, in_features=levels,
        mask_on=mask_on, mask_in_feature=levels[0],
        name_prompt_fusion_feature=name_prompt_fusion_feature, dtype=dtype).to(device)
