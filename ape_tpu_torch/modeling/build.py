"""Model factories (counterpart of ``ape_tpu/modeling/build.py``):

* APE-Ti: EVA-02-Ti backbone (192-d, 12 blocks, 3 heads, window 14, packed
  SwiGLU), the 6+6-layer deformable transformer with 900 queries, no
  vision-language fusion;
* APE-L_D: EVA-02-CLIP-L backbone (1024-d, 24 blocks, 16 heads, window 32,
  subln, inner attention LN, SwiGLU with ``ffn_ln``, position table
  pretrained at 336), the same transformer with a vision-language fusion
  layer before each encoder layer (embed 2048, 8 heads, layer scale 1/6);
* APE-L (``build_ape_l``, the ADE20k, LVIS and ODinW recipes on
  ``configs/common/backbone/vitl_eva02.py``): the non-CLIP EVA-02-L
  (1024-d, 24 blocks, 16 heads, window 16 with every sixth block global,
  ``subln``, SwiGLU unpacked with ``ffn_ln``, no inner attention LN,
  position table pretrained at 224), the transformer without fusion, or
  with its ``_vlf_`` twin's.

All carry by default the mask head on the finest pyramid level. Every
two-stage build takes ``proposal_ambiguous``: copies of the first stage's
heads whose per-proposal argmax wins (the ``*_mdl``, ``_mp`` and eval
configs set 1). The
ResNet-50 family (``configs/common/models/ape_deta_r50.py``): a FrozenBN
ResNet-50 (``freeze_at=1``) whose res3-res5 the neck maps to 5 levels with
two stride-2 extra convs, the mask head's lateral map on res2:

* APE-DETA R50 (``build_ape_r50``): open vocabulary, masked, 900 queries,
  DETA's two-stage select; with ``vl_fusion`` the fusion layers of
  ``ape_deta_r50_vlf_12ep.py``; with ``num_learned_classes=80`` DETA R50,
  closed vocabulary (``deformable_deta_segm_r50_12ep.py``);
* Deformable-DETR R50 (``build_deformable_detr_r50``): 300 queries, no
  masks, a class bank of 80, single-stage or two-stage by a plain top-k,
  with or without box refinement (``configs/COCO_Detection/
  deformable_detr/``).

Their optimizer is the R50 recipe's (``engine.optimizer.R50_RECIPE``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from ape_tpu_torch.device import default_device
from ape_tpu_torch.modeling.ape_deta.model import APEDeta, ChannelMapper
from ape_tpu_torch.modeling.ape_deta.transformer import (
    DeformableDetrTransformer,
    DeformableTransformerDecoder,
    DeformableTransformerEncoder,
)
from ape_tpu_torch.modeling.backbone.eva_vit import EVAViT, SimpleFeaturePyramid
from ape_tpu_torch.modeling.backbone.resnet import ResNet

# the R50 family's neck: res3-res5 and two stride-2 extras, the mask head on res2
R50_NECK_IN = ("res3", "res4", "res5")
R50_LEVELS = R50_NECK_IN + ("extra0", "extra1")


def window_indexes(depth: int, every: int = 3):
    """The windowed blocks: all but every ``every``-th, which is global."""
    return tuple(i for i in range(depth) if (i + 1) % every != 0)


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


def build_backbone_l_eva02(scale_factors: Sequence[float], drop_path_rate: float,
                           depth: int) -> SimpleFeaturePyramid:
    """The non-CLIP EVA-02-L and its pyramid (``vitl_eva02.py``): window 16,
    every sixth block global, position table pretrained at 224, no inner
    attention LN; SwiGLU unpacked, as JAX's EVAViT default (the config sets
    no ``packed_swiglu``). ``depth`` below 24 cuts it for tests and checks."""
    return SimpleFeaturePyramid(
        EVAViT(patch_size=16, embed_dim=1024, depth=depth, num_heads=16, mlp_ratio=4 * 2 / 3,
               window_size=16, window_block_indexes=window_indexes(depth, 6),
               pretrain_img_size=224, pt_hw_seq_len=16, packed_swiglu=False, subln=True,
               swiglu_subln=True, drop_path_rate=drop_path_rate),
        out_channels=256, scale_factors=scale_factors)


def build_transformer(num_queries: int = 900, num_layers: int = 6, vl_fusion: bool = False,
                      embed_dim_language: int = 1024, window_radius: int = 4,
                      use_act_checkpoint: bool = False, as_two_stage: bool = True,
                      assign_first_stage: bool = True, with_box_refine: bool = True,
                      proposal_ambiguous: int = 0) -> DeformableDetrTransformer:
    """The transformer of every APE build: 256-d, 8 heads, FFN 2048, 5
    levels, by default two-stage with DETA's select and box refinement;
    with ``vl_fusion`` its encoder's fusion layers are APE-L_D's (embed
    2048, 8 heads, layer scale 1/6); ``proposal_ambiguous`` copies of the
    first stage's heads."""
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
                                     use_act_checkpoint=use_act_checkpoint,
                                     with_box_refine=with_box_refine,
                                     enc_bbox_head=as_two_stage,
                                     proposal_ambiguous=proposal_ambiguous),
        embed_dim=256, num_feature_levels=5, two_stage_num_proposals=num_queries,
        as_two_stage=as_two_stage, assign_first_stage=assign_first_stage)


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
    proposal_ambiguous: int = 0,
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
                                    use_act_checkpoint, proposal_ambiguous=proposal_ambiguous)
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
    proposal_ambiguous: int = 0,
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
                                    window_radius, use_act_checkpoint,
                                    proposal_ambiguous=proposal_ambiguous)
    return APEDeta(
        build_backbone_l(scale_factors, drop_path_rate, depth),
        ChannelMapper(sfp_names, 256, 256, num_outs=5), transformer,
        embed_dim=256, embed_dim_language=embed_dim_language, in_features=levels,
        mask_on=mask_on, mask_in_feature=levels[0],
        name_prompt_fusion_feature=name_prompt_fusion_feature, dtype=dtype).to(device)


def build_ape_l(
    vl_fusion: bool = False,
    mask_on: bool = True,
    scale_factors: Sequence[float] = (4.0, 2.0, 1.0, 0.5),
    dtype: torch.dtype = torch.float32,
    depth: int = 24,
    num_layers: int = 6,
    proposal_ambiguous: int = 0,
    device=None,
) -> APEDeta:
    """APE-L on the non-CLIP EVA-02-L, as
    ``configs/ADE20k_PanopticSegmentation/ape_deta/ape_deta_vitl_eva02_lsj1024.py``
    and ``configs/LVIS_InstanceSegmentation/ape_deta/ape_deta_vitl_eva02_lsj1024_cp_24ep.py``
    build it: the masked model on the 4-scale pyramid, 900 queries, drop
    path 0.4 by depth, no fusion and no recompute. ``vl_fusion``: their
    ``_vlf_`` twins, whose encoder puts a fusion layer (embed 2048, layer
    scale 1/6) before each layer and recomputes its layers in the backward
    (the configs set ``encoder.use_act_checkpoint`` alone: the decoder keeps
    its activations); their APE fuses name prompts against the zero token,
    the wrapper's default. The reference latency protocol passes
    ``mask_on=False`` and ``scale_factors=(2.0, 1.0, 0.5)``. The text tower
    of these recipes is ``EVA02CLIP(width=768, heads=12, layers=12,
    output_dim=1024)``. Train with ``build_optimizer(model,
    vit_num_layers=24)``. depth and num_layers cut the model for tests and
    checks.

    The model lies on ``device``, by the rule of ``build_ape_ti``."""
    device = default_device("build_ape_l", device)
    sfp_names, levels = pyramid_features(scale_factors)
    transformer = build_transformer(900, num_layers, vl_fusion,
                                    proposal_ambiguous=proposal_ambiguous)
    transformer.encoder.use_act_checkpoint = vl_fusion
    return APEDeta(
        build_backbone_l_eva02(scale_factors, 0.4, depth),
        ChannelMapper(sfp_names, 256, 256, num_outs=5), transformer,
        embed_dim=256, embed_dim_language=1024, in_features=levels,
        mask_on=mask_on, mask_in_feature=levels[0], dtype=dtype).to(device)


def build_backbone_r50() -> ResNet:
    """The R50 family's backbone: FrozenBN ResNet-50, res2-res5, the
    gradient stopped at the stem (``freeze_at=1``)."""
    return ResNet()


def _r50_model(transformer, mask_on: bool, num_learned_classes: int,
               dtype: torch.dtype) -> APEDeta:
    backbone = build_backbone_r50()
    neck = ChannelMapper(R50_NECK_IN, [backbone.out_channels[n] for n in R50_NECK_IN], 256,
                         num_outs=5)
    return APEDeta(backbone, neck, transformer, embed_dim=256, embed_dim_language=1024,
                   in_features=R50_LEVELS,
                   mask_on=mask_on, mask_in_feature="res2", mask_encode_level=0,
                   num_learned_classes=num_learned_classes, dtype=dtype)


def build_ape_r50(
    mask_on: bool = True,
    num_queries: int = 900,
    vl_fusion: bool = False,
    num_learned_classes: int = 0,
    use_act_checkpoint: Optional[bool] = None,
    window_radius: int = 4,
    num_layers: int = 6,
    proposal_ambiguous: int = 0,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> APEDeta:
    """APE-DETA R50 (``ape_deta_r50_12ep.py``): the ResNet-50, the two-stage
    transformer with DETA's select and box refinement, 900 queries, masked.
    vl_fusion: the fusion layers of ``ape_deta_r50_vlf_12ep.py`` (embed 2048,
    layer scale 1/6; APE's name prompts fuse the zero token, its default).
    num_learned_classes: DETA R50's class bank (80), which takes the place
    of the text. use_act_checkpoint recomputes the encoder's and decoder's
    layers in the backward; by default on with the fusion, as the VLF
    recipe. num_layers cuts the encoder and the decoder for tests and
    checks. proposal_ambiguous: 1 in the two ``_mp`` recipes
    (``ape_deta_r50_24ep_mp.py``, ``ape_deta_r50_50ep_mp.py``). Train with
    ``build_optimizer(model, **R50_RECIPE)``.

    The model lies on ``device``, by the rule of ``build_ape_ti``."""
    device = default_device("build_ape_r50", device)
    if use_act_checkpoint is None:
        use_act_checkpoint = vl_fusion
    transformer = build_transformer(num_queries, num_layers, vl_fusion, 1024, window_radius,
                                    use_act_checkpoint, proposal_ambiguous=proposal_ambiguous)
    return _r50_model(transformer, mask_on, num_learned_classes, dtype).to(device)


def build_deformable_detr_r50(
    as_two_stage: bool = False,
    with_box_refine: bool = False,
    window_radius: int = 4,
    num_layers: int = 6,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> APEDeta:
    """Deformable-DETR R50 (``deformable_detr_r50_50ep.py`` and its
    ``_with_box_refinement_`` and ``_two_stage_`` files): the ResNet-50, 300
    queries, no masks, the class bank of 80; single-stage learned queries
    with 2-d references unless ``as_two_stage`` (the encoder's proposals by
    a plain top-k, ``assign_first_stage=False``). Its criterion matches
    every layer by the Hungarian (``use_stage2=False``).

    The model lies on ``device``, by the rule of ``build_ape_ti``."""
    device = default_device("build_deformable_detr_r50", device)
    transformer = build_transformer(300, num_layers, False, 1024, window_radius,
                                    as_two_stage=as_two_stage, assign_first_stage=False,
                                    with_box_refine=with_box_refine)
    return _r50_model(transformer, False, 80, dtype).to(device)
