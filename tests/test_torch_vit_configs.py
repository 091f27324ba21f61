"""The port's ViT trees (``modeling/build.py``'s VIT_TREES) against the
configs that JAX instantiates, at full size and with no allocation:

* each entry's EVAViT arguments equal those its named config instantiates
  (read as ``tests/test_backbone_parity.py::test_backbone_configs_construct``
  reads them); every file of ``configs/common/backbone/`` has its entry;
* each global block's route (K5, or the plain product) is JAX's rule
  (``eva_vit.py:114-120``, without its TPU and length terms);
* every task config on a tree that only `build_ape_vit` builds (33, and the 5
  ``deformable_deta_*_vitl_eva02_*`` ones on the non-CLIP EVA-02-L) holds
  its entry's backbone, and ``build_ape_vit`` reads its class bank, masks,
  fusion and recompute;
* the full-size port tree, built on the meta device, has exactly the
  parameter names and shapes of ``jax.eval_shape`` of JAX's, through
  ``state_dict_from_jax``'s names
  (ViT-E 4.35 B, ViT-g 1.01 B parameters).

The weight round trips and the optimizer's layer ids and decay sets are in
``tests/test_torch_vit_convert.py``.
"""

import dataclasses
import functools
import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ape_tpu.config import ConfigDict, LazyConfig, instantiate
from ape_tpu.modeling.backbone import eva_vit as j_vit
from ape_tpu_torch.checkpoint import convert
from ape_tpu_torch.modeling.build import VIT_TREES, build_ape_vit, build_backbone_vit, vit_args
from tests.torch_parity import flatten

ROOT = os.path.join(os.path.dirname(__file__), "..")
FIELDS = tuple(f.name for f in dataclasses.fields(j_vit.EVAViT)
               if f.name not in ("parent", "name", "dtype"))
# the task configs on the trees that build_ape_vit alone builds, by tree
# (ViTDet-B 2 + 1, ViTDet-L 5, EVA-01-L 2, EVA-01-g inline 4, the 1536 and
# ViT-E trees 1 + 2 + 6 + 4 + 6; and the DETA configs on EVA-02-L, 5)
NEW_CONFIGS = {"vitb": 2, "vitb_clip_openai": 1, "vitl": 5, "vitl_eva": 2, "vitg_eva": 4,
               "vitg_eva01_1536": 1, "vitg_eva01_clip_1536": 2, "vite_eva02_clip_1024": 6,
               "vitl_eva02_1536": 4, "vitl_eva02_clip_1536": 6, "vitl_eva02_deta": 5}


def _fields(net) -> dict:
    return {f: tuple(v) if isinstance(v := getattr(net, f), (list, tuple)) else v for f in FIELDS}


def _config_backbone(cfg):
    """The SimpleFeaturePyramid node of a backbone file or a task config."""
    return cfg.backbone if "backbone" in cfg else cfg.model.backbone


def _jax_backbone(node):
    return instantiate(ConfigDict(backbone=node))["backbone"]


def _tree_of(fields: dict):
    """The VIT_TREES entries whose arguments are ``fields``."""
    return [t for t in VIT_TREES if _fields(j_vit.EVAViT(**vit_args(t))) == fields]


@functools.lru_cache(maxsize=1)
def _task_configs():
    """{tree: [(path, config)]} over every task config whose backbone is an
    EVAViT (each must hold exactly one entry's arguments; ``configs/tests/``
    holds the tiny test tree, no task)."""
    out = {}
    for path in sorted(glob.glob(os.path.join(ROOT, "configs", "**", "*.py"), recursive=True)):
        if f"{os.sep}common{os.sep}" in path or f"configs{os.sep}tests{os.sep}" in path:
            continue
        cfg = LazyConfig.load(path)
        node = cfg.get("model", {}).get("backbone")
        if not node or "EVAViT" not in str(node.get("net", {}).get("_target_", "")):
            continue
        trees = _tree_of(_fields(_jax_backbone(node).net))
        assert len(trees) == 1, (path, trees)
        out.setdefault(trees[0], []).append((os.path.relpath(path, ROOT), cfg))
    return out


@pytest.mark.parametrize("tree", list(VIT_TREES))
def test_tree_settings_and_routes_match_the_config(tree):
    cfg = LazyConfig.load(os.path.join(ROOT, VIT_TREES[tree]["config"]))
    jax_bb = _jax_backbone(_config_backbone(cfg))
    assert jax_bb.out_channels == 256 and tuple(jax_bb.scale_factors) == (4.0, 2.0, 1.0, 0.5)
    want = _fields(jax_bb.net)
    assert _fields(j_vit.EVAViT(**vit_args(tree))) == want
    with torch.device("meta"):
        net = build_backbone_vit(tree).net
    head_dim = want["embed_dim"] // want["num_heads"]
    assert len(net.blocks) == want["depth"]
    for i, block in enumerate(net.blocks):
        windowed = i in want["window_block_indexes"]
        assert block.window_size == (want["window_size"] if windowed else 0)
        # JAX's library kernel: a global block, head width 32/64/128, no rel-pos
        assert block.attn.flash == (not windowed and head_dim in (32, 64, 128)
                                    and not want["use_rel_pos"])
        hidden = int(want["embed_dim"] * want["mlp_ratio"])
        fc = block.mlp.fc1 if want["mlp_type"] == "gelu" else block.mlp.w3
        assert hidden in fc.weight.shape and block.postnorm == want["postnorm"]
    assert net.rope == want["rope"]


def test_every_backbone_file_has_its_tree():
    files = sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(ROOT, "configs", "common", "backbone", "*.py")))
    named = sorted(os.path.basename(t["config"]) for t in VIT_TREES.values()
                   if "common/backbone" in t["config"])
    assert len(files) == 11 and named == files


def test_build_ape_vit_alone_builds_38_task_configs():
    found = {t: len(v) for t, v in _task_configs().items() if t in NEW_CONFIGS}
    assert found == NEW_CONFIGS and sum(found.values()) == 38


@pytest.mark.parametrize("tree", list(NEW_CONFIGS))
def test_task_configs_build_with_build_ape_vit(tree):
    """Each config's class bank, masks, fusion and recompute, read into
    build_ape_vit's call, give the model the config builds."""
    for path, cfg in _task_configs()[tree]:
        m = cfg.model
        enc, dec = m.transformer.encoder, m.transformer.decoder
        assert m.num_queries == 900 and "scale_factors" not in m.backbone, path
        assert dec.get("proposal_ambiguous", 0) == 0 and not dec.get("use_act_checkpoint"), path
        kw = dict(vl_fusion=bool(enc.get("vl_fusion", False)),
                  num_learned_classes=m.get("num_learned_classes", 0), mask_on=m.mask_on)
        model = build_ape_vit(tree, device="meta", **kw)
        assert model.num_learned_classes == kw["num_learned_classes"], path
        assert model.mask_on is bool(kw["mask_on"]), path
        assert (model.transformer.encoder.vl_layers is not None) == kw["vl_fusion"], path
        assert bool(model.transformer.encoder.use_act_checkpoint) == bool(
            enc.get("use_act_checkpoint", False)), path
        assert model.transformer.decoder.use_act_checkpoint is False, path
        assert model.transformer.two_stage_num_proposals == 900, path
        if kw["vl_fusion"]:
            assert enc.vl_embed_dim == 2048 and enc.vl_init_values == pytest.approx(1 / 6)
            assert model.transformer.encoder.vl_layers[0].b_attn.attn.v_proj.weight.shape[0] == 2048


def _strided_zeros(shape):
    """A zero array of ``shape`` that takes no memory (every stride 0)."""
    return np.lib.stride_tricks.as_strided(np.zeros(1, np.float32), shape, (0,) * len(shape))


def _jax_shapes(tree, depth=None):
    """Flat {key: shape} of JAX's SimpleFeaturePyramid on VIT_TREES[tree], by
    eval_shape at its own img_size."""
    args = vit_args(tree, depth)
    jm = j_vit.SimpleFeaturePyramid(net=j_vit.EVAViT(**args), out_channels=256)
    x = jnp.zeros((1, args["img_size"], args["img_size"], 3))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x))["params"]
    return {k: tuple(v.shape) for k, v in flatten(shapes).items()}


PARAMS_BILLIONS = {"vite_eva02_clip_1024": 4.35, "vite_eva02_clip_1536": 4.35,
                   "vitg_eva01": 1.01, "vitg_eva01_clip_1536": 1.01}


@pytest.mark.parametrize("tree", list(VIT_TREES))
def test_full_size_tree_has_jax_names_and_shapes(tree):
    want = {}
    for key, shape in _jax_shapes(tree).items():
        name, value = convert._convert_one("backbone/" + key, _strided_zeros(shape), (), 0)
        want[name] = tuple(value.shape)
    with torch.device("meta"):
        model = build_backbone_vit(tree)
    got = {f"backbone.{n}": tuple(p.shape) for n, p in model.named_parameters()}
    assert got == want
    if tree in PARAMS_BILLIONS:
        net = sum(p.numel() for p in model.net.parameters())
        assert round(net / 1e9, 2) == PARAMS_BILLIONS[tree]
