"""Helpers for the tests that hold ``ape_tpu_torch`` against ``ape_tpu``.

Both sides get the same weights: seeded numpy values in the shapes of the
flax params (no bias stays at zero), carried into the port with
``state_dict_from_jax``. A port module is
loaded under the full-model name of the place it holds in APE, so one
converter serves every module test.
"""

import os
import re

import numpy as np
import torch

import jax
import jax.numpy as jnp

from tests.parity_harness import DIMS



def cap_torch_threads():
    """Give each pytest-xdist worker its share of the cores for torch's
    intra-op threads, and at least two. Left alone, each of N workers
    starts one thread per core, so the port's tiny models run N-fold
    oversubscribed and their times measure the neighbours. Not one thread:
    the summation order of one thread moves two entries of
    test_torch_masks.py's masked sem_seg (magnitude ~25) 1.2e-4 from JAX's,
    past that test's 1e-4, where two to eight threads stay inside it. One
    process keeps torch's default."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        torch.set_num_threads(max(2, len(os.sched_getaffinity(0)) // workers))


# every worker imports every test module while it collects, so this runs in
# each worker before any of the port's tests
cap_torch_threads()

PROTOCOL_SCALES = (2.0, 1.0, 0.5)
MASKED_SCALES = (4.0, 2.0, 1.0, 0.5)


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def unflatten(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = jnp.asarray(v)
    return tree


def _synth(key, shape, rng, heads, points):
    """A seeded value for one flax leaf: fan-in scaled kernels, norm scales
    near 1, the MSDA ring init on offset biases, small noise elsewhere."""
    from ape_tpu.layers.msda_module import _offset_bias_init

    noise = rng.normal(0.0, 0.05, shape)
    if key.endswith(("/gamma_v", "/gamma_l")):
        # layer scales large enough that the fusion moves its outputs
        return 0.5 + noise
    if key.endswith("/kernel"):
        return rng.normal(0.0, 1.0 / np.sqrt(np.prod(shape[:-1])), shape)
    if key.endswith("/var"):  # FrozenBN statistics far from identity, so that
        return rng.uniform(0.5, 2.0, shape)  # a swapped mean and var shows
    if key.endswith("/mean"):
        return rng.normal(0.0, 0.5, shape)
    if key.endswith("/scale"):
        return 1.0 + noise
    if key.endswith("sampling_offsets/bias"):
        levels = shape[0] // (2 * heads * points)
        return _offset_bias_init(heads, levels, points) + noise
    return noise


def init_params(module, *args, seed=0, heads=DIMS["heads"], points=4, **kwargs):
    """Seeded numpy params with the shapes of ``module.init(*args, **kwargs)``
    (traced, not compiled): returns (flat numpy dict, param tree for ``apply``).
    ``heads`` and ``points`` size the MSDA ring init of offset biases."""
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: module.init(key, *args, **kwargs))["params"]
    rng = np.random.RandomState(seed)
    flat = {k: _synth(k, v.shape, rng, heads, points).astype(np.float32)
            for k, v in sorted(flatten(shapes).items())}
    return flat, unflatten(flat)


def load_port(module, flat, jax_prefix, torch_prefix):
    """Load flax params of a module that sits at ``jax_prefix`` in the APE tree
    into the port module that sits at ``torch_prefix`` (strict)."""
    from ape_tpu_torch.checkpoint.convert import state_dict_from_jax

    sd = state_dict_from_jax({jax_prefix + k: v for k, v in flat.items()})
    module.load_state_dict({k[len(torch_prefix):]: v for k, v in sd.items()}, strict=True)
    return module.eval()


def model_pair(jax_model, torch_model, zero_encoder_offsets=False, **init_kw):
    """An ape_tpu APEDeta and the port's with the same seeded weights:
    (jax model, param tree, flat params, port model). With
    ``zero_encoder_offsets`` the encoder's sampling_offsets kernels are 0, as
    the reference initialises them. ``init_kw`` go to the JAX model's init
    (``fusion_text_mode="learnable"`` creates the learned fusion token)."""
    flat, _ = init_params(jax_model, *(jnp.asarray(a) for a in tiny_inputs()), **init_kw)
    if zero_encoder_offsets:
        flat = {k: (np.zeros_like(v) if re.fullmatch(r"transformer/encoder/.*sampling_offsets/kernel", k)
                    else v) for k, v in flat.items()}
    return jax_model, unflatten(flat), flat, load_port(torch_model, flat, "", "")


# The tiny APE-L_D: EVA-02-CLIP blocks (subln, inner attention LN, SwiGLU's
# ffn_ln unpacked), three blocks with the last global, windows of 8 tokens,
# the position table pretrained at 336 (21^2 + 1 rows, resized to 16^2), and
# a fusion layer before each encoder layer (embed 64, 2 heads).
L_D_VIT = dict(subln=True, inner_attn_ln=True, swiglu_subln=True, packed_swiglu=False,
               depth=3, window_size=8, window_block_indexes=(0, 1), pretrain_img_size=336)
L_D_FUSION = dict(vl_fusion=True, vl_embed_dim=64, vl_num_heads=2, vl_init_values=1.0 / 6)
# The tiny non-CLIP EVA-02-L (configs/common/backbone/vitl_eva02.py): subln
# attention without the inner LayerNorm, SwiGLU unpacked with ffn_ln, six
# blocks with every sixth global (block 5), windows of 4 tokens, the
# position table pretrained at 224.
L_VIT = dict(subln=True, inner_attn_ln=False, swiglu_subln=True, packed_swiglu=False, depth=6,
             window_size=4, window_block_indexes=(0, 1, 2, 3, 4), pretrain_img_size=224)

# The tiny ViTDet-L (the inline tree of
# configs/COCO_InstanceSegmentation/ape_deta/ape_deta_vitl_lsj1024_cp_12ep.py):
# no RoPE, decomposed relative positions, GELU MLP; three blocks with the
# last global, windows of 3 tokens (the 16^2 grid padded to 18^2).
VITDET_VIT = dict(rope=False, use_rel_pos=True, mlp_type="gelu", packed_swiglu=False, depth=3,
                  window_size=3, window_block_indexes=(0, 1), pretrain_img_size=224)
# The tiny EVA-01 ViT-g trees, at ViT-g's head width 88 (2 heads over 176),
# every fourth block global: three windows of 3 tokens (the 16^2 grid padded
# to 18^2), then a global block. The DETA recipe's
# (configs/LVIS_Detection/deformable_deta/deformable_deta_vitg_eva_lsj1024_cp_24ep.py:
# relative positions, its inline tree's GELU MLP at JAX's default ratio, no
# drop path) and EVA-01-CLIP-g's (configs/common/backbone/vitg_eva01_clip_1536.py:
# no relative positions, the GELU MLP at 6144/1408, drop path 0.6).
VITG_DIMS = dict(DIMS, vit_embed=176, vit_heads=2)
VITG_DETA_VIT = dict(VITDET_VIT, depth=4, window_block_indexes=(0, 1, 2))
VITG_CLIP_VIT = dict(VITG_DETA_VIT, use_rel_pos=False, mlp_ratio=6144 / 1408, drop_path_rate=0.6)
# the DETA recipe's closed vocabulary: LVIS's 1203 classes, learned
VITG_LEARNED_CLASSES = 1203


def jax_tiny(d=DIMS, window_radius=4, scale_factors=PROTOCOL_SCALES, vit=None, fusion=None,
             proposal_ambiguous=0, **apedeta_kw):
    """ape_tpu APEDeta at the parity-harness dims on the given pyramid; the
    neck extends it to 5 levels. ``vit`` overrides EVAViT's arguments and
    ``fusion`` adds the encoder's (L_D_VIT, L_D_FUSION); the decoder holds
    ``proposal_ambiguous`` copies of the first stage's heads;
    ``apedeta_kw`` (mask_on, aux_mask, ...) go to APEDeta; the mask head
    reads the finest level."""
    from ape_tpu.modeling.ape_deta.model import APEDeta, ChannelMapper
    from ape_tpu.modeling.ape_deta.transformer import (
        DeformableDetrTransformer,
        DeformableTransformerDecoder,
        DeformableTransformerEncoder,
    )
    from ape_tpu.modeling.backbone.eva_vit import EVAViT, SimpleFeaturePyramid
    from ape_tpu_torch.modeling.build import pyramid_features

    _, levels = pyramid_features(scale_factors)
    vit = {"depth": d["vit_depth"], "window_size": d["win"], "window_block_indexes": (0,),
           "pretrain_img_size": 224, "packed_swiglu": True, "mlp_ratio": 4 * 2 / 3,
           **(vit or {})}
    backbone = SimpleFeaturePyramid(
        net=EVAViT(img_size=d["img"], patch_size=16, embed_dim=d["vit_embed"],
                   num_heads=d["vit_heads"], pt_hw_seq_len=16, **vit),
        out_channels=d["embed"], scale_factors=scale_factors)
    transformer = DeformableDetrTransformer(
        encoder=DeformableTransformerEncoder(
            embed_dim=d["embed"], num_heads=d["heads"], feedforward_dim=d["ffn"],
            num_layers=d["layers"], num_feature_levels=5, window_radius=window_radius,
            embed_dim_language=d["ldim"], **(fusion or {})),
        decoder=DeformableTransformerDecoder(
            embed_dim=d["embed"], num_heads=d["heads"], feedforward_dim=d["ffn"],
            num_layers=d["layers"], num_feature_levels=5, look_forward_twice=False,
            proposal_ambiguous=proposal_ambiguous),
        num_feature_levels=5, two_stage_num_proposals=d["queries"], assign_first_stage=True)
    return APEDeta(
        backbone=backbone, neck=ChannelMapper(out_channels=d["embed"], num_outs=5),
        transformer=transformer, embed_dim=d["embed"], embed_dim_language=d["ldim"],
        num_queries=d["queries"], in_features=levels, mask_in_feature=levels[0],
        **{"mask_on": False, **apedeta_kw})


def torch_tiny(d=DIMS, window_radius=4, scale_factors=PROTOCOL_SCALES, vit=None, fusion=None,
               proposal_ambiguous=0, **apedeta_kw):
    """The port's APEDeta at the same dims and pyramid."""
    from ape_tpu_torch.modeling.ape_deta.model import APEDeta, ChannelMapper
    from ape_tpu_torch.modeling.ape_deta.transformer import (
        DeformableDetrTransformer,
        DeformableTransformerDecoder,
        DeformableTransformerEncoder,
    )
    from ape_tpu_torch.modeling.backbone.eva_vit import EVAViT, SimpleFeaturePyramid
    from ape_tpu_torch.modeling.build import pyramid_features

    sfp, levels = pyramid_features(scale_factors)
    vit = {"depth": d["vit_depth"], "window_size": d["win"], "window_block_indexes": (0,),
           "pretrain_img_size": 224, "mlp_ratio": 4 * 2 / 3, **(vit or {})}
    backbone = SimpleFeaturePyramid(
        EVAViT(img_size=d["img"], patch_size=16, embed_dim=d["vit_embed"],
               num_heads=d["vit_heads"], pt_hw_seq_len=16, **vit),
        out_channels=d["embed"], scale_factors=scale_factors)
    transformer = DeformableDetrTransformer(
        DeformableTransformerEncoder(d["embed"], d["heads"], d["ffn"], d["layers"], 5,
                                     window_radius=window_radius, embed_dim_language=d["ldim"],
                                     **(fusion or {})),
        DeformableTransformerDecoder(d["embed"], d["heads"], d["ffn"], d["layers"], 5,
                                     proposal_ambiguous=proposal_ambiguous),
        embed_dim=d["embed"], num_feature_levels=5, two_stage_num_proposals=d["queries"])
    return APEDeta(backbone, ChannelMapper(sfp, d["embed"], d["embed"], num_outs=5),
                   transformer, embed_dim=d["embed"], embed_dim_language=d["ldim"],
                   in_features=levels, mask_in_feature=levels[0],
                   **{"mask_on": False, **apedeta_kw})


def jax_tiny_protocol(d=DIMS, window_radius=4):
    """ape_tpu APEDeta at the parity-harness dims with the protocol pyramid."""
    return jax_tiny(d, window_radius)


def torch_tiny_protocol(d=DIMS, window_radius=4):
    """The port's APEDeta at the same dims."""
    return torch_tiny(d, window_radius)


def jax_tiny_masked(d=DIMS, window_radius=4, **kw):
    """ape_tpu APEDeta at the parity-harness dims as APE-Ti builds it by
    default: the 4-scale pyramid (levels p2 ... p6) and the mask head."""
    return jax_tiny(d, window_radius, MASKED_SCALES, mask_on=True, **kw)


def torch_tiny_masked(d=DIMS, window_radius=4, **kw):
    """The port's masked APEDeta at the same dims."""
    return torch_tiny(d, window_radius, MASKED_SCALES, mask_on=True, **kw)


def jax_tiny_l_d(d=DIMS, **kw):
    """ape_tpu APEDeta as a tiny APE-L_D on the protocol pyramid."""
    return jax_tiny(d, vit=L_D_VIT, fusion=L_D_FUSION, **kw)


def torch_tiny_l_d(d=DIMS, **kw):
    """The port's tiny APE-L_D, holding the learned fusion token."""
    return torch_tiny(d, vit=L_D_VIT, fusion=L_D_FUSION, name_prompt_fusion_feature=True, **kw)


def jax_tiny_l(d=DIMS, vl_fusion=False, **kw):
    """ape_tpu APEDeta as a tiny APE-L (the non-CLIP tree), masked on the
    4-scale pyramid; with ``vl_fusion`` its _vlf_ twin."""
    return jax_tiny(d, 4, MASKED_SCALES, vit=L_VIT, fusion=L_D_FUSION if vl_fusion else None,
                    mask_on=True, **kw)


def torch_tiny_l(d=DIMS, vl_fusion=False, **kw):
    """The port's tiny APE-L, or its _vlf_ twin."""
    return torch_tiny(d, 4, MASKED_SCALES, vit=L_VIT, fusion=L_D_FUSION if vl_fusion else None,
                      mask_on=True, **kw)


def jax_tiny_vitdet(d=DIMS, **kw):
    """ape_tpu APEDeta as a tiny ViTDet-L APE-DETA, masked on the 4-scale
    pyramid."""
    return jax_tiny(d, 4, MASKED_SCALES, vit=VITDET_VIT, mask_on=True, **kw)


def torch_tiny_vitdet(d=DIMS, **kw):
    """The port's tiny ViTDet-L APE-DETA."""
    return torch_tiny(d, 4, MASKED_SCALES, vit=VITDET_VIT, mask_on=True, **kw)


def jax_tiny_vitg(deta: bool, d=VITG_DIMS, **kw):
    """ape_tpu APEDeta as a tiny ViT-g on the 4-scale pyramid: with ``deta``
    the DETA recipe's (no masks, VITG_LEARNED_CLASSES learned classes),
    else EVA-01-CLIP-g's (masked, open vocabulary)."""
    if deta:
        return jax_tiny(d, 4, MASKED_SCALES, vit=VITG_DETA_VIT, mask_on=False,
                        num_learned_classes=VITG_LEARNED_CLASSES, **kw)
    return jax_tiny(d, 4, MASKED_SCALES, vit=VITG_CLIP_VIT, mask_on=True, **kw)


def torch_tiny_vitg(deta: bool, d=VITG_DIMS, **kw):
    """The port's tiny ViT-g of the same recipe."""
    if deta:
        return torch_tiny(d, 4, MASKED_SCALES, vit=VITG_DETA_VIT, mask_on=False,
                          num_learned_classes=VITG_LEARNED_CLASSES, **kw)
    return torch_tiny(d, 4, MASKED_SCALES, vit=VITG_CLIP_VIT, mask_on=True, **kw)


def tiny_inputs(d=DIMS, seed=3, h=None, w=None):
    """Normalized, padded NHWC image (1, img, img, 3), sizes (1, 2), text
    features (1, T, ldim) with the last slot invalid, and text_valid."""
    rng = np.random.RandomState(seed)
    h = h or d["img"]
    w = w or d["img"]
    img = np.zeros((1, d["img"], d["img"], 3), np.float32)
    img[0, :h, :w] = rng.randn(h, w, 3)
    sizes = np.asarray([[h, w]], np.int32)
    text = rng.randn(1, d["num_text"] + 1, d["ldim"]).astype(np.float32)
    valid = np.arange(d["num_text"] + 1)[None] < d["num_text"]
    return img, sizes, text, valid


# The tiny R50 trees (configs/tests/ape_deta_tiny_r50.py): the real
# depth-50 FrozenBN ResNet at 64^2, its res3-res5 mapped to 5 levels (8^2,
# 4^2, 2^2, 1^2, 1^2) at width 64 by the neck's two stride-2 extras, 2 + 2
# layers, 24 queries; the mask head's lateral map on res2 (16^2).
R50_DIMS = dict(DIMS, img=256, queries=24)
R50_NECK_IN = ("res3", "res4", "res5")
R50_LEVELS = R50_NECK_IN + ("extra0", "extra1")
# the variants: APE-DETA R50 (masked or not), its fusion tree, DETA R50's
# class bank, and Deformable-DETR R50 single-stage, with box refinement, and
# two-stage with box refinement; (transformer keywords, APEDeta keywords)
R50_TREES = {
    "ape": ({}, {"mask_on": True}),
    "ape_protocol": ({}, {}),
    "ape_vlf": ({"fusion": L_D_FUSION}, {"mask_on": True}),
    "deta": ({}, {"mask_on": True, "num_learned_classes": 10}),
    "detr": ({"as_two_stage": False, "assign_first_stage": False, "with_box_refine": False},
             {"num_learned_classes": 10}),
    "detr_refine": ({"as_two_stage": False, "assign_first_stage": False,
                     "with_box_refine": True}, {"num_learned_classes": 10}),
    "detr_two_stage": ({"as_two_stage": True, "assign_first_stage": False,
                        "with_box_refine": True}, {"num_learned_classes": 10}),
}


def jax_tiny_r50(tree: str, d=R50_DIMS, window_radius=4):
    """ape_tpu APEDeta as the tiny R50 tree ``tree`` of R50_TREES."""
    from ape_tpu.modeling.ape_deta.model import APEDeta, ChannelMapper
    from ape_tpu.modeling.ape_deta.transformer import (
        DeformableDetrTransformer,
        DeformableTransformerDecoder,
        DeformableTransformerEncoder,
    )
    from ape_tpu.modeling.backbone.resnet import ResNet

    tr_kw, kw = R50_TREES[tree]
    tr_kw = dict(tr_kw)
    fusion = tr_kw.pop("fusion", None)
    refine = tr_kw.pop("with_box_refine", True)
    transformer = DeformableDetrTransformer(
        encoder=DeformableTransformerEncoder(
            embed_dim=d["embed"], num_heads=d["heads"], feedforward_dim=d["ffn"],
            num_layers=d["layers"], num_feature_levels=5, window_radius=window_radius,
            embed_dim_language=d["ldim"], **(fusion or {})),
        decoder=DeformableTransformerDecoder(
            embed_dim=d["embed"], num_heads=d["heads"], feedforward_dim=d["ffn"],
            num_layers=d["layers"], num_feature_levels=5, look_forward_twice=False,
            with_box_refine=refine),
        num_feature_levels=5, two_stage_num_proposals=d["queries"], **tr_kw)
    return APEDeta(
        backbone=ResNet(depth=50, freeze_at=1),
        neck=ChannelMapper(out_channels=d["embed"], in_features=R50_NECK_IN, num_outs=5),
        transformer=transformer, embed_dim=d["embed"], embed_dim_language=d["ldim"],
        num_queries=d["queries"], in_features=R50_LEVELS, mask_in_feature="res2",
        **{"mask_on": False, **kw})


def torch_tiny_r50(tree: str, d=R50_DIMS, window_radius=4):
    """The port's APEDeta as the same tiny R50 tree."""
    from ape_tpu_torch.modeling.ape_deta.model import APEDeta, ChannelMapper
    from ape_tpu_torch.modeling.ape_deta.transformer import (
        DeformableDetrTransformer,
        DeformableTransformerDecoder,
        DeformableTransformerEncoder,
    )
    from ape_tpu_torch.modeling.backbone.resnet import ResNet

    tr_kw, kw = R50_TREES[tree]
    tr_kw = dict(tr_kw)
    fusion = tr_kw.pop("fusion", None)
    refine = tr_kw.pop("with_box_refine", True)
    backbone = ResNet()
    transformer = DeformableDetrTransformer(
        DeformableTransformerEncoder(d["embed"], d["heads"], d["ffn"], d["layers"], 5,
                                     window_radius=window_radius, embed_dim_language=d["ldim"],
                                     **(fusion or {})),
        DeformableTransformerDecoder(d["embed"], d["heads"], d["ffn"], d["layers"], 5,
                                     with_box_refine=refine,
                                     enc_bbox_head=tr_kw.get("as_two_stage", True)),
        embed_dim=d["embed"], num_feature_levels=5, two_stage_num_proposals=d["queries"], **tr_kw)
    neck = ChannelMapper(R50_NECK_IN, [backbone.out_channels[n] for n in R50_NECK_IN],
                         d["embed"], num_outs=5)
    return APEDeta(backbone, neck, transformer, embed_dim=d["embed"],
                   embed_dim_language=d["ldim"], in_features=R50_LEVELS,
                   mask_in_feature="res2", **{"mask_on": False, **kw})
