"""Model zoo and the config-driven builders (counterpart of
``ape_tpu/model_zoo/model_zoo.py``): APE's five released models by name
(``MODELS``), their config files (``get_config_file``, ``get_config``), and
the port's model and criterion built from a config tree.

A config's ``model`` node names JAX's flax modules (``ModelTarget``s, see
``config.lazy``); ``build_model`` reads the tree and builds the port's
``APEDeta`` from ``modeling``'s classes: each node's arguments are JAX's
field defaults overridden by the node, mapped onto the port's, and the
neck's input widths come from the backbone (flax infers them at init). The
model has the parameter names and shapes of ``state_dict_from_jax`` of
JAX's init of the same tree. ``build_criterion`` builds the port's
``DeformableCriterion`` from a criterion node. A JAX argument the port has
no counterpart for is accepted at JAX's default only; any other value
raises, naming the argument.

``get`` builds a zoo model without fetching anything: ``checkpoint`` is a
local path or nothing (the card machine has no network).
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Optional, Sequence

import torch

from ape_tpu_torch.config.lazy import (
    ConfigDict,
    LazyConfig,
    LazyNode,
    _deep_copy,
    instantiate,
    resolve_interpolations,
    target_name,
)
from ape_tpu_torch.device import default_device

logger = logging.getLogger("ape_tpu_torch")

# name -> (config path under configs/, the released checkpoint's path in the
# HF repo shenyunhang/APE); the port reads checkpoints from local files only
MODELS = {
    "APE-L_A": (
        "LVISCOCOCOCOSTUFF_O365_OID_VG/ape_deta/"
        "ape_deta_vitl_eva02_clip_vlf_lsj1024_cp_720k_mdl.py",
        "configs/LVISCOCOCOCOSTUFF_O365_OID_VG/ape_deta/"
        "ape_deta_vitl_eva02_lsj_cp_720k_20230504_002019/model_final.pth",
    ),
    "APE-L_B": (
        "LVISCOCOCOCOSTUFF_O365_OID_VGR_REFCOCO/ape_deta/"
        "ape_deta_vitl_eva02_clip_vlf_lsj1024_cp_720k_mdl.py",
        "configs/LVISCOCOCOCOSTUFF_O365_OID_VGR_REFCOCO/ape_deta/"
        "ape_deta_vitl_eva02_vlf_lsj_cp_1080k_20230702_225418/model_final.pth",
    ),
    "APE-L_C": (
        "LVISCOCOCOCOSTUFF_O365_OID_VGR_SA1B_REFCOCO/ape_deta/"
        "ape_deta_vitl_eva02_clip_vlf_lsj1024_cp_1080k_mdl.py",
        "configs/LVISCOCOCOCOSTUFF_O365_OID_VGR_SA1B_REFCOCO/ape_deta/"
        "ape_deta_vitl_eva02_vlf_lsj_cp_1080k_20230702_210950/model_final.pth",
    ),
    "APE-L_D": (
        "LVISCOCOCOCOSTUFF_O365_OID_VGR_SA1B_REFCOCO_GQA_PhraseCut_Flickr30k/"
        "ape_deta/ape_deta_vitl_eva02_clip_vlf_lsj1024_cp_16x4_1080k_mdl.py",
        "configs/LVISCOCOCOCOSTUFF_O365_OID_VGR_SA1B_REFCOCO_GQA_PhraseCut_Flickr30k/"
        "ape_deta/ape_deta_vitl_eva02_clip_vlf_lsj1024_cp_16x4_1080k_mdl_20230829_162438/"
        "model_final.pth",
    ),
    "APE-Ti": (
        "LVISCOCOCOCOSTUFF_O365_OID_VGR_SA1B_REFCOCO_GQA_PhraseCut_Flickr30k/"
        "ape_deta/ape_deta_vitt_eva02_vlf_lsj1024_cp_16x4_1080k_mdl.py",
        "configs/LVISCOCOCOCOSTUFF_O365_OID_VGR_SA1B_REFCOCO_GQA_PhraseCut_Flickr30k/"
        "ape_deta/ape_deta_vitt_eva02_vlf_lsj1024_cp_16x4_1080k_mdl_20240203_230000/"
        "model_final.pth",
    ),
}

CONFIGS_ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), "..", "..", "configs"))


def get_config_file(config_path: str) -> str:
    """The on-disk path of a config: a zoo name ("APE-Ti") or a path under
    the repository's ``configs/``."""
    rel = MODELS[config_path][0] if config_path in MODELS else config_path
    cfg_file = os.path.join(CONFIGS_ROOT, rel)
    if not os.path.exists(cfg_file):
        raise RuntimeError(f"{config_path} not available in Model Zoo!")
    return cfg_file


def get_config(config_path: str, checkpoint: str = "") -> ConfigDict:
    """A zoo config; ``checkpoint`` (a local file) becomes its
    ``train.init_checkpoint``."""
    cfg = LazyConfig.load(get_config_file(config_path))
    if checkpoint:
        cfg.train["init_checkpoint"] = checkpoint
    return cfg


# JAX's field defaults of each model target (ape_tpu/modeling/*), which a
# config node overrides
_EVAVIT = dict(img_size=1024, patch_size=16, embed_dim=768, depth=12, num_heads=12,
               mlp_ratio=4 * 2 / 3, window_size=14, window_block_indexes=(), use_abs_pos=True,
               pretrain_img_size=224, pretrain_use_cls_token=True, pt_hw_seq_len=16, rope=True,
               subln=False, inner_attn_ln=False, packed_swiglu=False, swiglu_subln=False,
               mlp_type="swiglu", use_rel_pos=False, postnorm=False, drop_path_rate=0.0)
_SFP = dict(out_channels=256, scale_factors=(4.0, 2.0, 1.0, 0.5), top_block=True)
_RESNET = dict(depth=50, out_features=("res2", "res3", "res4", "res5"), freeze_at=1,
               stem_out_channels=64)
_NECK = dict(out_channels=256, num_groups=32, in_features=None, num_outs=None)
_ENCODER = dict(embed_dim=256, num_heads=8, feedforward_dim=2048, num_layers=6,
                num_feature_levels=5, num_points=4, window_radius=4, vl_fusion=False,
                vl_embed_dim=2048, vl_num_heads=8, vl_init_values=1e-4, embed_dim_language=1024,
                use_act_checkpoint=False)
_DECODER = dict(embed_dim=256, num_heads=8, feedforward_dim=2048, num_layers=6,
                num_feature_levels=5, num_points=4, look_forward_twice=True,
                with_box_refine=True, use_act_checkpoint=False, proposal_ambiguous=0)
_TRANSFORMER = dict(num_feature_levels=5, two_stage_num_proposals=900, as_two_stage=True,
                    assign_first_stage=True, pre_nms_topk=1000, nms_thresh_enc=0.9)
_APEDETA = dict(neck=None, embed_dim=256, embed_dim_language=1024, num_queries=900,
                in_features=("p2", "p3", "p4", "p5", "p6"), mask_on=True,
                mask_in_feature="p2", mask_encode_level=0, aux_mask=False,
                num_learned_classes=0, num_classes=0)
_BUILD_APE_TI = dict(img_size=1024, num_queries=900, embed_dim_language=1024, mask_on=True,
                     window_radius=4, num_learned_classes=0, use_act_checkpoint=False,
                     proposal_ambiguous=0, scale_factors=(4.0, 2.0, 1.0, 0.5))
_CRITERION = dict(losses=("class", "boxes", "masks"), alpha=0.25, gamma=2.0, num_queries=900,
                  use_stage2=True, stage2_iou_thresh=0.6, stage2_max_k=4, use_stage1=True,
                  stage1_t_low=0.3, stage1_t_high=0.7, stage1_max_k=4, cost_class=2.0,
                  cost_bbox=5.0, cost_giou=2.0, use_fed_loss=False, fed_loss_num_classes=50,
                  fed_loss_cls_weights=None, fed_loss_pad_type=None, mask_point_sample=False,
                  mask_num_points=12544, mask_oversample_ratio=3.0,
                  mask_importance_sample_ratio=0.75, mask_max_masks=128)
# JAX's criterion arguments the port takes at JAX's defaults only
_CRITERION_FIXED = ("use_stage1", "cost_class", "cost_bbox", "cost_giou")
_MODELING = "ape_tpu.modeling."


def _args(node: Dict, defaults: Dict, name: str, fixed: Sequence[str] = ()) -> Dict[str, Any]:
    """JAX's defaults overridden by the node (its ``dtype`` aside, which the
    builder's argument sets); an argument in ``fixed`` (one the port has no
    counterpart for) must keep JAX's default."""
    kw = dict(defaults)
    for k, v in node.items():
        if k in ("_target_", "dtype"):
            continue
        if k not in defaults:
            raise TypeError(f"{name}: unknown argument {k!r}")
        kw[k] = v
    for k in fixed:
        if kw[k] != defaults[k]:
            raise NotImplementedError(f"{name}: the port has no {k}={kw[k]!r} (only JAX's "
                                      f"default {defaults[k]!r})")
    return kw


def _check_target(node, name: str):
    got = target_name(node["_target_"]) if isinstance(node, LazyNode) else None
    if got != _MODELING + name:
        raise TypeError(f"expected a {_MODELING + name} node, got {got or type(node).__name__}")


def _backbone(node):
    """(module, {output name: channels}) of a SimpleFeaturePyramid or ResNet node."""
    from ape_tpu_torch.modeling.backbone.eva_vit import EVAViT, SimpleFeaturePyramid
    from ape_tpu_torch.modeling.backbone.resnet import ResNet

    name = target_name(node["_target_"])
    if name == _MODELING + "backbone.resnet.ResNet":
        _args(node, _RESNET, name, fixed=tuple(_RESNET))
        net = ResNet()
        return net, dict(net.out_channels)
    _check_target(node, "backbone.eva_vit.SimpleFeaturePyramid")
    sfp = _args(node, {"net": None, **_SFP}, name)
    _check_target(sfp["net"], "backbone.eva_vit.EVAViT")
    vit = _args(sfp["net"], _EVAVIT, _MODELING + "backbone.eva_vit.EVAViT", fixed=("use_abs_pos",))
    vit.pop("use_abs_pos")
    vit["window_block_indexes"] = tuple(vit["window_block_indexes"])
    module = SimpleFeaturePyramid(EVAViT(**vit), sfp["out_channels"],
                                  tuple(sfp["scale_factors"]), sfp["top_block"])
    names = [f"p{s}" for s in module.stages] + (["p6"] if sfp["top_block"] else [])
    return module, {n: sfp["out_channels"] for n in names}


def _transformer(node):
    from ape_tpu_torch.modeling.ape_deta.transformer import (
        DeformableDetrTransformer,
        DeformableTransformerDecoder,
        DeformableTransformerEncoder,
    )

    _check_target(node, "ape_deta.transformer.DeformableDetrTransformer")
    kw = _args(node, {"encoder": None, "decoder": None, **_TRANSFORMER},
               _MODELING + "ape_deta.transformer.DeformableDetrTransformer")
    _check_target(kw["encoder"], "ape_deta.transformer.DeformableTransformerEncoder")
    _check_target(kw["decoder"], "ape_deta.transformer.DeformableTransformerDecoder")
    enc = _args(kw["encoder"], _ENCODER, _MODELING + "ape_deta.transformer.DeformableTransformerEncoder")
    dec = _args(kw["decoder"], _DECODER, _MODELING + "ape_deta.transformer.DeformableTransformerDecoder")
    encoder = DeformableTransformerEncoder(**enc)
    decoder = DeformableTransformerDecoder(enc_bbox_head=kw["as_two_stage"], **dec)
    return DeformableDetrTransformer(
        encoder, decoder, embed_dim=enc["embed_dim"], num_feature_levels=kw["num_feature_levels"],
        two_stage_num_proposals=kw["two_stage_num_proposals"], as_two_stage=kw["as_two_stage"],
        assign_first_stage=kw["assign_first_stage"], pre_nms_topk=kw["pre_nms_topk"],
        nms_thresh_enc=kw["nms_thresh_enc"])


def _ape_deta(node, dtype):
    from ape_tpu_torch.modeling.ape_deta.model import APEDeta, ChannelMapper

    name = _MODELING + "ape_deta.model.APEDeta"
    kw = _args(node, {"backbone": None, "transformer": None, **_APEDETA}, name)
    backbone, widths = _backbone(kw["backbone"])
    if kw["neck"] is None:
        raise NotImplementedError(f"{name}: the port's APEDeta needs a ChannelMapper neck")
    _check_target(kw["neck"], "ape_deta.model.ChannelMapper")
    neck = _args(kw["neck"], _NECK, _MODELING + "ape_deta.model.ChannelMapper")
    feats = list(neck["in_features"]) if neck["in_features"] else sorted(widths)
    return APEDeta(
        backbone,
        ChannelMapper(feats, [widths[f] for f in feats], neck["out_channels"],
                      num_outs=neck["num_outs"] or len(feats), num_groups=neck["num_groups"]),
        _transformer(kw["transformer"]), embed_dim=kw["embed_dim"],
        embed_dim_language=kw["embed_dim_language"], in_features=tuple(kw["in_features"]),
        mask_on=kw["mask_on"], mask_in_feature=kw["mask_in_feature"],
        mask_encode_level=kw["mask_encode_level"], aux_mask=kw["aux_mask"],
        num_learned_classes=kw["num_learned_classes"], dtype=dtype)


def _ape_ti(node, dtype, device):
    """JAX's ``build_ape_ti`` target: the port's builder of the same name."""
    from ape_tpu_torch.modeling.build import build_ape_ti

    return build_ape_ti(**_args(node, _BUILD_APE_TI, _MODELING + "build.build_ape_ti"),
                        dtype=dtype, device=device)


def _resolved(cfg) -> ConfigDict:
    """The model and criterion nodes with every ``${..}`` resolved against a
    root holding both, as JAX's trainer instantiates them together."""
    crit = cfg.get("criterions", None) or ([cfg.criterion] if "criterion" in cfg else [])
    root = _deep_copy(ConfigDict(model=cfg.model, criterions=list(crit)))
    return resolve_interpolations(root)


def build_model(cfg, device=None, dtype: torch.dtype = torch.float32):
    """The port's model of ``cfg.model`` (module docstring), on ``device``:
    by default the CUDA card, and with no card it raises rather than fall
    back to the CPU (``device="cpu"`` builds there, ``"meta"`` the
    structure alone). ``dtype`` is the compute dtype (parameters stay
    f32)."""
    device = default_device("build_model", device)
    node = _resolved(cfg)["model"]
    name = target_name(node["_target_"])
    with torch.device(device):
        if name == _MODELING + "build.build_ape_ti":
            model = _ape_ti(node, dtype, device)
        else:
            _check_target(node, "ape_deta.model.APEDeta")
            model = _ape_deta(node, dtype)
    return model.to(device)


def build_criterion(cfg, index: Optional[int] = None):
    """The port's ``DeformableCriterion`` of ``cfg.criterion`` (or of
    ``cfg.criterions[index]``): JAX's arguments, its matcher costs and
    ``use_stage1`` accepted at JAX's defaults only; a
    ``fed_loss_cls_weights`` node is instantiated."""
    from ape_tpu_torch.modeling.ape_deta.criterion import DeformableCriterion

    crits = _resolved(cfg)["criterions"]
    node = crits[index or 0]
    name = _MODELING + "ape_deta.criterion.DeformableCriterion"
    _check_target(node, "ape_deta.criterion.DeformableCriterion")
    kw = _args(node, {"num_classes": None, "weight_dict": None, **_CRITERION}, name,
               fixed=_CRITERION_FIXED)
    for k in _CRITERION_FIXED:
        kw.pop(k)
    weights = kw["fed_loss_cls_weights"]
    if isinstance(weights, LazyNode):
        weights = instantiate(weights)
    kw["fed_loss_cls_weights"] = None if weights is None else torch.as_tensor(weights,
                                                                             dtype=torch.float32)
    kw["weight_dict"] = dict(kw["weight_dict"])
    kw["losses"] = tuple(kw["losses"])
    return DeformableCriterion(**kw)


def get(config_path: str, checkpoint: str = "", device=None, dtype: torch.dtype = torch.float32):
    """The port's model of a zoo entry (or config path), built by
    ``build_model``; with ``checkpoint`` (a local file of reference names)
    its weights are loaded by ``load_checkpoint_tolerant``. Nothing is
    fetched."""
    from ape_tpu_torch.checkpoint.convert import load_checkpoint_tolerant

    model = build_model(get_config(config_path), device=device, dtype=dtype)
    if checkpoint:
        if not os.path.exists(checkpoint):
            raise FileNotFoundError(f"{checkpoint}: the port loads local checkpoints only")
        load_checkpoint_tolerant(checkpoint, model)
    return model
