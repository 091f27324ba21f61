"""The port's ViT trees' weights and optimizer against ape_tpu's on the CPU:

* the weight round trip with JAX's ``convert_torch_state_dict`` is exact
  (flax -> port -> flax): the whole ViTDet-B DETA model and ViTDet-L's
  backbone at full size, ViT-g and ViT-E cut to 4 blocks (their full size
  is 4-17 GB of numpy), each taken strictly by the port's build function;
* the optimizer's layer ids and decay sets for 40 and 64 blocks equal
  JAX's ``lr_multiplier_tree`` and the decay mask of its ``build_optimizer``;
  the DETA ViT-g recipe's whole model at full size (its names from
  ``jax.eval_shape`` and the meta device) has JAX's multipliers at 40
  blocks and the recipe's decay, and its optimizer's groups carry them.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ape_tpu.config import LazyConfig, instantiate
from ape_tpu.modeling.backbone import eva_vit as j_vit
from ape_tpu_torch.checkpoint import convert
from ape_tpu_torch.checkpoint.convert import state_dict_from_jax
from ape_tpu_torch.engine.optimizer import decays, lr_multiplier_tree
from ape_tpu_torch.modeling.backbone.eva_vit import EVAViT, SimpleFeaturePyramid
from ape_tpu_torch.modeling.build import VIT_TREES, build_ape_vit, build_backbone_vit, vit_args
from tests.test_torch_vit_configs import ROOT, _jax_shapes, _strided_zeros
from tests.torch_parity import flatten


def _round_trip(flat, model, no_rule=frozenset()):
    """flax -> port -> flax: every leaf back exactly, but ``no_rule`` (leaves
    JAX's converter has no rule for, which the port's state_dict holds as
    given); ``model`` takes the state_dict strictly."""
    from ape_tpu.checkpoint.convert import convert_torch_state_dict

    sd = state_dict_from_jax(flat)
    model.load_state_dict(sd, strict=True, assign=True)
    back = convert_torch_state_dict({k: v.numpy() for k, v in sd.items()})
    assert sorted(back) == sorted(set(flat) - no_rule)
    for k in back:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    for k in no_rule:
        np.testing.assert_array_equal(sd[k.replace("/", ".")].numpy(), flat[k], err_msg=k)


def test_vitdet_b_deta_weights_round_trip_at_full_size():
    """The whole ViTDet-B DETA model that JAX instantiates from its config,
    at 1024^2 (the rel-pos tables' size): flax -> port -> flax exactly but
    the class bank, which JAX's converter has no rule for, and
    build_ape_vit takes the state_dict strictly."""
    cfg = LazyConfig.load(os.path.join(ROOT, VIT_TREES["vitb"]["config"]))
    jm = instantiate(cfg.model)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 1024, 1024, 3)), jnp.asarray([[1024, 1024]]),
        jnp.zeros((1, 4, 1024)), jnp.ones((1, 4), bool)))["params"]
    gen = np.random.default_rng(0)
    flat = {k: gen.standard_normal(v.shape, np.float32) for k, v in flatten(shapes).items()}
    assert flat["backbone/net/blocks_2/attn/rel_pos_h"].shape == (127, 64)
    assert flat["backbone/net/blocks_0/attn/rel_pos_w"].shape == (27, 64)
    assert flat["backbone/net/blocks_0/mlp/fc1/kernel"].shape == (768, 2048)
    with torch.device("meta"):
        model = build_ape_vit("vitb", num_learned_classes=80, mask_on=False, device="meta")
    _round_trip(flat, model, {"class_embedding"})


@pytest.mark.parametrize("tree,depth", [("vitl", None), ("vitg_eva01", 4),
                                        ("vite_eva02_clip_1024", 4)])
def test_backbone_weights_round_trip(tree, depth):
    """ViTDet-L's backbone at full size, ViT-g's and ViT-E's cut to 4 blocks
    (their full size is 4-17 GB of numpy): flax -> port -> flax exactly,
    taken strictly by build_backbone_vit; ViT-E's post-norm blocks keep
    norm1 and norm2."""
    gen = np.random.default_rng(1)
    flat = {"backbone/" + k: gen.standard_normal(s, np.float32)
            for k, s in _jax_shapes(tree, depth).items()}
    assert any(k.endswith("attn/rel_pos_h") for k in flat)
    with torch.device("meta"):
        backbone = build_backbone_vit(tree, depth=depth)
    model = torch.nn.Module()
    model.backbone = backbone
    _round_trip(flat, model)


def _decayed_by_jax(params, depth):
    """The leaves JAX's optimizer decays: one update from zero gradients
    moves exactly those (by lr * multiplier * wd * param)."""
    from ape_tpu.engine.optimizer import build_optimizer

    tx = build_optimizer(params, base_lr=1.0, vit_num_layers=depth)
    updates, _ = tx.update(jax.tree.map(jnp.zeros_like, params), tx.init(params), params)
    return {k for k, v in flatten(updates).items() if np.abs(np.asarray(v)).max() > 0}


@pytest.mark.parametrize("tree,depth", [("vitg_eva01", 40), ("vite_eva02_clip_1024", 64)])
def test_optimizer_layer_ids_and_decay_for_deep_trees(tree, depth):
    """ViT-g's 40 and ViT-E's 64 blocks at narrow width: every parameter's
    lr multiplier and whether it decays equal JAX's; the relative-position
    tables are 2-D and decay."""
    from ape_tpu.engine.optimizer import lr_multiplier_tree as j_lr_multiplier_tree

    args = dict(vit_args(tree), embed_dim=32, num_heads=2, img_size=64)
    jm = j_vit.SimpleFeaturePyramid(net=j_vit.EVAViT(**args), out_channels=16)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    params = {"backbone": jax.tree.map(lambda v: jnp.ones(v.shape), shapes["params"])}
    names = {k: convert._convert_one(k, _strided_zeros(v.shape), (), 0)[0]
             for k, v in flatten(params).items()}
    want_mult = {names[k]: float(v) for k, v in
                 flatten(j_lr_multiplier_tree(params, depth, 0.8)).items()}
    want_decay = {names[k] for k in _decayed_by_jax(params, depth)}
    model = torch.nn.Module()
    model.backbone = SimpleFeaturePyramid(EVAViT(**args), out_channels=16)
    got_mult = lr_multiplier_tree(model, depth, 0.8)
    assert sorted(got_mult) == sorted(want_mult)
    for name, m in got_mult.items():
        assert m == pytest.approx(want_mult[name], rel=1e-12), name
    got_decay = {n for n, p in model.named_parameters() if decays(n, p)}
    assert got_decay == want_decay
    assert f"backbone.net.blocks.{depth - 1}.attn.rel_pos_h" in got_decay
    assert got_mult["backbone.net.blocks.0.attn.qkv.weight"] == pytest.approx(0.8 ** depth)


VITG_DETA_CONFIG = "configs/LVIS_Detection/deformable_deta/deformable_deta_vitg_eva_lsj1024_cp_24ep.py"


def _constant(value: float, shape):
    """An f32 array of ``shape`` holding ``value`` everywhere, in one element
    of memory (every stride 0)."""
    return np.lib.stride_tricks.as_strided(np.full(1, value, np.float32), shape, (0,) * len(shape))


def test_vitg_deta_recipe_lr_multipliers_match_jax_at_full_size():
    """The DETA ViT-g recipe's whole model at full size (40 blocks of width
    1408, 1203 learned classes), its names from ``jax.eval_shape`` and from
    the port's build on the meta device, so that none of its 0.78 B
    parameters is allocated: the port's ``lr_multiplier_tree`` equals JAX's
    at the config's ``vit_num_layers=40`` and decay 0.8, by name through
    the converter, and ``build_optimizer(**cfg.optimizer)`` gives each
    parameter base_lr times its multiplier (before the warmup's factor)."""
    from ape_tpu.engine.optimizer import lr_multiplier_tree as j_lr_multiplier_tree
    from ape_tpu_torch.config import LazyConfig as PortLazyConfig
    from ape_tpu_torch.engine.optimizer import build_optimizer
    from ape_tpu_torch.model_zoo import build_model

    cfg = LazyConfig.load(os.path.join(ROOT, VITG_DETA_CONFIG))
    opt = dict(cfg.optimizer)
    assert (opt["vit_num_layers"], opt["layer_decay"]) == (40, 0.8)
    jm = instantiate(cfg.model)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 3)), jnp.asarray([[256, 256]]),
        jnp.zeros((1, 4, 1024)), jnp.ones((1, 4), bool)))["params"]
    mults = flatten(j_lr_multiplier_tree(shapes, opt["vit_num_layers"], opt["layer_decay"]))
    shapes = {k: tuple(v.shape) for k, v in flatten(shapes).items()}
    # the backbone leaf by leaf (its converted views are never copied), the
    # rest (50 M parameters) through the whole converter
    want = {}
    for key, shape in shapes.items():
        if key.startswith("backbone/"):
            name, value = convert._convert_one(key, _constant(float(mults[key]), shape), (), 0)
            want[name] = float(value.flat[0])
    rest = state_dict_from_jax({k: _constant(float(mults[k]), s) for k, s in shapes.items()
                                if not k.startswith("backbone/")})
    want.update({k: float(v.flatten()[0]) for k, v in rest.items()})

    port_cfg = PortLazyConfig.load(os.path.join(ROOT, VITG_DETA_CONFIG))
    model = build_model(port_cfg, device="meta")
    assert len(model.backbone.net.blocks) == 40 and model.num_learned_classes == 1203
    got = lr_multiplier_tree(model, opt["vit_num_layers"], opt["layer_decay"])
    assert sorted(got) == sorted(want)
    for name, m in got.items():
        assert m == pytest.approx(want[name], rel=1e-6), name
    assert round(sum(p.numel() for p in model.parameters()) / 1e9, 2) == 0.78
    assert got["backbone.net.blocks.0.attn.qkv.weight"] == pytest.approx(0.8 ** 40)
    assert got["backbone.net.patch_embed.proj.weight"] == pytest.approx(0.8 ** 41)
    assert got["backbone.net.blocks.39.attn.rel_pos_h"] == pytest.approx(0.8)
    assert got["class_embedding"] == 1.0
    optimizer, _ = build_optimizer(model, **{k: v for k, v in opt.items() if k != "grad_clip"})
    lr = {id(p): g["initial_lr"] for g in optimizer.param_groups for p in g["params"]}
    for name, p in model.named_parameters():
        assert lr[id(p)] == pytest.approx(opt["base_lr"] * want[name], rel=1e-6), name
