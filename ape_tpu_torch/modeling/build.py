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

Every ViT backbone of ``configs/`` is an entry of ``VIT_TREES``: the
``EVAViT`` arguments of one backbone, copied from the config file it names
(the 11 files of ``configs/common/backbone/`` and the trees the task
configs write inline). ``build_backbone_vit`` builds an entry's
SimpleFeaturePyramid and ``build_ape_vit`` the APE-DETA model around it, as
``configs/common/models/ape_deta.py`` does: ViTDet-B/L (relative positions,
GELU MLP, no RoPE), EVA-01-L and ViT-g (with and without CLIP), EVA-02-L
and EVA-02-CLIP-L at LSJ 1536, ViT-E (post-norm), open vocabulary or with
a class bank (the DETA configs), with or without the ``_vlf_`` fusion.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

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


def _tree(config: str, **kw) -> dict:
    """One VIT_TREES entry: JAX's EVAViT defaults (the port's packs SwiGLU
    by default, JAX's does not), overridden by what ``config`` sets."""
    return {"config": config, "img_size": 1024, "patch_size": 16, "mlp_ratio": 4 * 2 / 3,
            "pretrain_img_size": 224, "pt_hw_seq_len": 16, "rope": True, "packed_swiglu": False,
            "subln": False, "inner_attn_ln": False, "swiglu_subln": False, "mlp_type": "swiglu",
            "use_rel_pos": False, "postnorm": False, "drop_path_rate": 0.0, **kw}


_BACKBONE = "configs/common/backbone/"
_EVA02_L = dict(embed_dim=1024, depth=24, num_heads=16, subln=True, swiglu_subln=True)
_EVA02_CLIP_L = dict(_EVA02_L, window_size=32, window_block_indexes=window_indexes(24),
                     pretrain_img_size=336, inner_attn_ln=True, drop_path_rate=0.4)
_EVA01 = dict(rope=False, mlp_type="gelu")  # EVA-01 and ViTDet: GELU MLP, no RoPE
_VITB = dict(_EVA01, embed_dim=768, depth=12, num_heads=12, window_size=14,
             window_block_indexes=window_indexes(12))
_VITG = dict(_EVA01, embed_dim=1408, depth=40, num_heads=16,
             window_block_indexes=window_indexes(40, 4))
_VITG_EVA01 = dict(_VITG, mlp_ratio=6144 / 1408, drop_path_rate=0.6)
_VITE = dict(_EVA01, embed_dim=1792, depth=64, num_heads=16, mlp_ratio=8.571428571428571,
             window_size=32, window_block_indexes=window_indexes(64, 4), use_rel_pos=True,
             postnorm=True, drop_path_rate=0.4)
# Each backbone of configs/: EVAViT's arguments and the file they come from.
# The inline ViTDet, EVA-01-L and ViT-g trees set no mlp_ratio, so their GELU
# MLPs take JAX's default 4 * 2 / 3 (ROADMAP Queue 3, trait 17).
VIT_TREES = {
    "vitt_eva02": _tree(_BACKBONE + "vitt_eva02.py", embed_dim=192, depth=12, num_heads=3,
                        window_size=14, window_block_indexes=window_indexes(12),
                        packed_swiglu=True),
    "vitl_eva02_clip": _tree(_BACKBONE + "vitl_eva02_clip.py", **_EVA02_CLIP_L),
    "vitl_eva02_clip_1536": _tree(_BACKBONE + "vitl_eva02_clip_1536.py", **_EVA02_CLIP_L,
                                  img_size=1536),
    "vitl_eva02": _tree(_BACKBONE + "vitl_eva02.py", **_EVA02_L, window_size=16,
                        window_block_indexes=window_indexes(24, 6), drop_path_rate=0.4),
    "vitl_eva02_1536": _tree(_BACKBONE + "vitl_eva02_1536.py", **_EVA02_L, img_size=1536,
                             window_size=32, window_block_indexes=window_indexes(24),
                             drop_path_rate=0.4),
    "vitl_eva02_deta": _tree(
        "configs/COCO_Detection/deformable_deta/deformable_deta_vitl_eva02_lsj1024_cp_12ep.py",
        **_EVA02_L, window_size=16, window_block_indexes=window_indexes(24, 6)),
    "vitb": _tree("configs/COCO_Detection/deformable_deta/deformable_deta_vitb_lsj1024_12ep.py",
                  **_VITB, use_rel_pos=True),
    "vitb_clip_openai": _tree("configs/COCO_Detection/deformable_deta/"
                              "deformable_deta_vitb_clip_openai_lsj1024_cp_12ep.py", **_VITB),
    "vitl": _tree("configs/COCO_InstanceSegmentation/ape_deta/ape_deta_vitl_lsj1024_cp_12ep.py",
                  **_EVA01, embed_dim=1024, depth=24, num_heads=16, window_size=14,
                  window_block_indexes=window_indexes(24, 6), use_rel_pos=True),
    "vitl_eva": _tree("configs/COCO_Detection/deformable_deta/"
                      "deformable_deta_vitl_eva_lsj1024_cp_12ep.py", **_EVA01, embed_dim=1024,
                      depth=24, num_heads=16, window_size=16,
                      window_block_indexes=window_indexes(24, 4), use_rel_pos=True),
    "vitg_eva": _tree("configs/COCO_Detection/deformable_deta/"
                      "deformable_deta_vitg_eva_lsj1024_12ep.py", **_VITG, window_size=16,
                      use_rel_pos=True),
    "vitg_eva01": _tree(_BACKBONE + "vitg_eva01.py", **_VITG_EVA01, window_size=16,
                        use_rel_pos=True),
    "vitg_eva01_1536": _tree(_BACKBONE + "vitg_eva01_1536.py", **_VITG_EVA01, img_size=1536,
                             window_size=32, use_rel_pos=True),
    "vitg_eva01_clip_1024": _tree(_BACKBONE + "vitg_eva01_clip_1024.py", **_VITG_EVA01,
                                  window_size=32),
    "vitg_eva01_clip_1536": _tree(_BACKBONE + "vitg_eva01_clip_1536.py", **_VITG_EVA01,
                                  img_size=1536, window_size=32),
    "vite_eva02_clip_1024": _tree(_BACKBONE + "vite_eva02_clip_1024.py", **_VITE),
    "vite_eva02_clip_1536": _tree(_BACKBONE + "vite_eva02_clip_1536.py", **_VITE, img_size=1536),
}


def vit_args(tree: str, depth: Optional[int] = None,
             img_size: Union[int, Tuple[int, int], None] = None) -> dict:
    """EVAViT's arguments of VIT_TREES[tree]. ``depth`` cuts the tree to
    its first blocks, each windowed or global as in the tree; ``img_size``
    resizes the global blocks' relative-position tables (cut checks on
    smaller images)."""
    kw = {k: v for k, v in VIT_TREES[tree].items() if k != "config"}
    if depth is not None:
        kw["depth"] = depth
        kw["window_block_indexes"] = tuple(i for i in kw["window_block_indexes"] if i < depth)
    if img_size is not None:
        kw["img_size"] = img_size
    return kw


def build_backbone_vit(tree: str, scale_factors: Sequence[float] = (4.0, 2.0, 1.0, 0.5),
                       depth: Optional[int] = None,
                       img_size: Union[int, Tuple[int, int], None] = None,
                       drop_path_rate: Optional[float] = None) -> SimpleFeaturePyramid:
    """VIT_TREES[tree] and its pyramid (256 channels); ``depth`` and
    ``img_size`` as ``vit_args``; ``drop_path_rate`` in place of the tree's
    (``build_ape_l_d``'s protocol builds L_D without drop path)."""
    kw = vit_args(tree, depth, img_size)
    if drop_path_rate is not None:
        kw["drop_path_rate"] = drop_path_rate
    return SimpleFeaturePyramid(EVAViT(**kw), out_channels=256, scale_factors=scale_factors)


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
    img_size: int = 1024,
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
    num_layers: int = 6,
    num_learned_classes: int = 0,
    device=None,
) -> APEDeta:
    """APE-Ti for any square input size (shapes follow the input). The
    defaults are JAX's: the masked model on the 4-scale pyramid (levels p2 …
    p6), whose mask head reads the finest backbone map and encoder level. The
    reference latency protocol passes ``mask_on=False`` and
    ``scale_factors=(2.0, 1.0, 0.5)``: the neck then extends the pyramid to 5
    levels with one stride-2 extra conv. use_act_checkpoint recomputes every
    encoder and decoder layer in the backward (training at 1024^2).
    num_layers cuts the encoder and the decoder for checks. img_size sizes
    the backbone's position tables; num_learned_classes > 0 selects the
    closed-vocabulary head (a learned class bank in place of the text).

    The model lies on ``device``: by default the CUDA card, and with no card
    it raises rather than fall back to the CPU; pass ``device="cpu"`` to
    build it there."""
    device = default_device("build_ape_ti", device)
    sfp_names, levels = pyramid_features(scale_factors)
    backbone = build_backbone_vit("vitt_eva02", scale_factors, img_size=img_size)
    transformer = build_transformer(num_queries, num_layers, False, embed_dim_language,
                                    window_radius, use_act_checkpoint,
                                    proposal_ambiguous=proposal_ambiguous)
    return APEDeta(
        backbone, ChannelMapper(sfp_names, 256, 256, num_outs=5), transformer,
        embed_dim=256, embed_dim_language=embed_dim_language, in_features=levels,
        mask_on=mask_on, mask_in_feature=levels[0], mask_encode_level=mask_encode_level,
        aux_mask=aux_mask, num_learned_classes=num_learned_classes, dtype=dtype).to(device)


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
        build_backbone_vit("vitl_eva02_clip", scale_factors, depth, drop_path_rate=drop_path_rate),
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

    The model is built on ``device`` by ``build_ape_vit``."""
    return build_ape_vit("vitl_eva02", vl_fusion, mask_on=mask_on, scale_factors=scale_factors,
                         dtype=dtype, depth=depth, num_layers=num_layers,
                         proposal_ambiguous=proposal_ambiguous, device=device)


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


def build_ape_vit(
    tree: str,
    vl_fusion: bool = False,
    num_learned_classes: int = 0,
    mask_on: bool = True,
    scale_factors: Sequence[float] = (4.0, 2.0, 1.0, 0.5),
    dtype: torch.dtype = torch.float32,
    depth: Optional[int] = None,
    num_layers: int = 6,
    proposal_ambiguous: int = 0,
    img_size: Union[int, Tuple[int, int], None] = None,
    device=None,
) -> APEDeta:
    """APE-DETA on the ViT backbone VIT_TREES[tree], as
    ``configs/common/models/ape_deta.py`` builds it: 900 queries, the
    two-stage DETA select with box refinement, 5 levels, by default masked
    on the 4-scale pyramid. vl_fusion: the ``_vlf_`` recipes' fusion layer
    before each encoder layer (embed 2048, layer scale 1/6).
    num_learned_classes: the DETA configs' class bank (80 or 1203) in place
    of the text. With the fusion the encoder recomputes its layers in the
    backward, as the ``_vlf_`` recipes set ``encoder.use_act_checkpoint``
    alone (the decoder keeps its activations); without it nothing is
    recomputed. proposal_ambiguous: copies of the first stage's heads, by the
    rule of ``build_transformer``. Drop path follows the tree. Train
    with ``build_optimizer(model, vit_num_layers=<the tree's depth>)``. The
    1536 trees serve behind ``DefaultPredictor(image_size=1536)``. depth,
    num_layers and img_size cut the model for tests and checks.

    The model is built on ``device`` itself (``with torch.device``), so that
    ViT-E's 4.35 B parameters take no host memory; by default the CUDA card,
    by the rule of ``build_ape_ti``; ``device="meta"`` builds the structure
    alone."""
    device = default_device("build_ape_vit", device)
    sfp_names, levels = pyramid_features(scale_factors)
    with torch.device(device):
        transformer = build_transformer(900, num_layers, vl_fusion,
                                        proposal_ambiguous=proposal_ambiguous)
        transformer.encoder.use_act_checkpoint = vl_fusion
        model = APEDeta(
            build_backbone_vit(tree, scale_factors, depth, img_size),
            ChannelMapper(sfp_names, 256, 256, num_outs=5), transformer,
            embed_dim=256, embed_dim_language=1024, in_features=levels, mask_on=mask_on,
            mask_in_feature=levels[0], num_learned_classes=num_learned_classes, dtype=dtype)
    return model.to(device)
